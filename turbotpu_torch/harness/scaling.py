"""Scaling-efficiency benchmark: decoded Mbit/s at 1 device against n.

Counterpart of turbotpu/harness/scaling.py.  Runs the data-parallel decode
(dist/data_parallel.py) over meshes of growing `data` and reports
throughput per mesh plus efficiency against the one-device run scaled
linearly, timed with CUDA events (harness/bench.py::event_ms).

What it measures depends on the mesh: a local mesh holds every data row on
the one device and decodes the rows one after another, so on one card only
data=1 is a measurement; larger local meshes check the structure (the same
decode code, each row's outputs equal to the one-row decode of the same
codewords), and their times are those of n batches on one card.  Each
record says which (`physical_devices`).  Numbers for n > 1 need n cards
(a process mesh, one rank per card).  With device="cpu" nothing is timed:
the meshes run once for the structure check only.
"""

from __future__ import annotations

import torch

from .._device import resolve_device
from ..decoder.turbo import DecoderConfig
from ..dist.data_parallel import decode_batch_sharded
from ..dist.mesh import make_mesh
from .bench import event_ms, make_decode_inputs


def bench_scaling(cfg: DecoderConfig, per_device_batch: int,
                  device_counts: list[int] | None = None,
                  n_timed: int = 8, seed: int = 0, device="cuda") -> list[dict]:
    """One record per mesh of `data` = n in device_counts (default: 1 and
    the card count, if more than one): devices, B, mbit_per_s, efficiency,
    physical_devices, rows_equal_one_device."""
    dev = resolve_device(device)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 1
    if device_counts is None:
        device_counts = sorted({1, n_cards})
    B_max = per_device_batch * max(device_counts)
    inputs = tuple(x.to(dev) for x in make_decode_inputs(
        cfg.K, B_max, seed, with_crc=cfg.early_term == "crc"))
    # every codeword decodes alone, so a mesh's hard bits equal the
    # one-row decode of the same codewords
    ref = decode_batch_sharded(make_mesh(data=1, seq=1, device=dev),
                               cfg)(*inputs)[0]
    out, base = [], None
    for n in device_counts:
        B = per_device_batch * n
        fn = decode_batch_sharded(make_mesh(data=n, seq=1, device=dev), cfg)
        args = tuple(x[:B] for x in inputs)
        rec = {"devices": n, "B": B, "physical_devices": 1,
               "rows_equal_one_device": bool(torch.equal(fn(*args)[0],
                                                         ref[:B]))}
        if dev.type == "cuda":
            wall = event_ms(lambda: fn(*args), n_timed) / 1e3
            mbps = B * cfg.K / wall / 1e6
            base = base or mbps
            rec.update(wall_s_per_batch=wall, mbit_per_s=mbps,
                       efficiency=mbps / (base * n),
                       device=torch.cuda.get_device_name(dev))
        else:
            rec.update(wall_s_per_batch=None, mbit_per_s=None,
                       efficiency=None, device="cpu")
        out.append(rec)
    return out
