"""C5 acceptance runner: a large codeword batch decoded by the
sequence-sharded decoder on a (data, seq) mesh, boundary metrics exchanged
between the chunks every iteration.

Counterpart of turbotpu/harness/c5.py.  On one card the mesh is local: all
shards in this process on the card, so seq=2 really cuts every trellis in
two (the reference, short of devices, falls back to seq=1).  With
backend="process" each rank of an initialised torch.distributed world
(dist/multihost.init_distributed) holds one shard and makes its own data
row's frames.  Run as

    python -m turbotpu_torch.cli c5 [--seq 2] [--nii --window 256] [--xch dma]

Time per batch is CUDA-event timed (harness/bench.event_ms) over decode and
error count, after one untimed batch; on the CPU (device="cpu", tiny shapes
only) the host clock stands in and the record says so.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .._device import resolve_device
from ..decoder.turbo import DecoderConfig
from ..dist.data_parallel import count_errors_sharded
from ..dist.mesh import make_mesh
from ..dist.multihost import host_local_batch, init_distributed, make_global_array
from ..dist.seq_parallel import decode_seq_sharded, effective_seq_groups
from ..golden import numpy_ref as npr
from ..spec.crc import CRC24A_POLY, crc_attach
from .bench import event_ms


def make_batch(K: int, B: int, ebn0_db: float, seed: int, interleaver="lte",
               with_crc=True, n_unique: int = 64):
    """Host-side noisy batch: n_unique distinct codewords tiled to B, noise
    drawn after tiling so every row is an i.i.d. channel draw.  Returns
    (bits (B, K) int8, [ls, lp1, lp2, tail1, tail2] fp32), numpy."""
    from ..spec.qpp import qpp_perm
    from ..spec.umts import umts_perm
    rng = np.random.default_rng(seed)
    perm = qpp_perm(K) if interleaver == "lte" else umts_perm(K)
    bits = []
    parts = [[] for _ in range(5)]
    for _ in range(min(B, n_unique)):
        if with_crc:
            row = crc_attach(rng.integers(0, 2, K - 24).astype(np.int8),
                             CRC24A_POLY)
        else:
            row = rng.integers(0, 2, K).astype(np.int8)
        bits.append(row)
        for i, x in enumerate(npr.turbo_encode(row, perm)):
            parts[i].append(x)
    reps = -(-B // len(bits))
    bits = np.tile(np.stack(bits), (reps, 1))[:B]
    sigma = np.sqrt(1 / (2 * 10 ** (ebn0_db / 10) / 3))
    noisy = []
    for p in parts:
        a = np.tile(np.stack(p).astype(np.float64), (reps, 1))[:B]
        y = (1 - 2 * a) + sigma * rng.normal(size=a.shape)
        noisy.append((2 * y / sigma ** 2).astype(np.float32))
    return bits, noisy


def c5_config(K=6144, n_iters=6, siso="cuda", io_dtype="bfloat16", nii=False,
              window=0, boundary_xch="ppermute", early_term="crc",
              ext_dtype="", seq_groups=1) -> DecoderConfig:
    """The decoder configuration run_c5 runs (max-log, scale 0.75)."""
    return DecoderConfig(K=K, n_iters=n_iters, mode="maxlog", ext_scale=0.75,
                         early_term=early_term, siso=siso, io_dtype=io_dtype,
                         nii=nii, window=window, boundary_xch=boundary_xch,
                         ext_dtype=ext_dtype, seq_groups=seq_groups)


def run_c5(K: int = 6144, B: int = 4096, ebn0_db: float = 0.8,
           n_iters: int = 6, data: int | None = None, seq: int = 2,
           n_timed: int = 4, seed: int = 0, verbose: bool = True,
           siso: str = "cuda", io_dtype: str = "bfloat16",
           nii: bool = False, window: int = 0,
           boundary_xch: str = "ppermute",
           early_term: str = "crc", ext_dtype: str = "",
           seq_groups: int = 1, backend: str = "local",
           device="cuda") -> dict:
    dev = resolve_device(device)
    if backend == "process":
        init_distributed(backend="nccl" if dev.type == "cuda" else "gloo")
        if not torch.distributed.is_initialized():
            raise RuntimeError("backend='process' needs torch.distributed: "
                               "set TURBOTPU_COORDINATOR, TURBOTPU_NUM_PROCS "
                               "and TURBOTPU_PROC_ID")
    mesh = make_mesh(data, seq, backend=backend, device=dev)
    cfg = c5_config(K, n_iters, siso, io_dtype, nii, window, boundary_xch,
                    early_term, ext_dtype, seq_groups)
    decode = decode_seq_sharded(mesh, cfg)
    count = count_errors_sharded(mesh)

    B_local = host_local_batch(B, mesh)
    row = mesh.shards[0][0] if backend == "process" else 0
    bits_l, noisy_l = make_batch(K, B_local, ebn0_db, seed + row)
    args = [make_global_array(x, mesh) for x in noisy_l]
    ref = make_global_array(bits_l, mesh)

    hard, iters, _ = decode(*args)
    bit, frame = (int(x) for x in count(hard, ref))

    def once():
        h, _, _ = decode(*args)
        count(h, ref)

    n_timed = max(n_timed, 1)
    if dev.type == "cuda":
        wall, timer = event_ms(once, n_timed) / 1e3, "cuda_events"
    else:
        t0 = time.perf_counter()
        for _ in range(n_timed):
            once()
        wall, timer = (time.perf_counter() - t0) / n_timed, "host_clock"
    world = (torch.distributed.get_world_size() if backend == "process"
             else 1)
    rec = {
        "K": K, "B": B, "mesh": mesh.shape, "backend": backend,
        "siso": siso, "nii": nii, "window": window, "io_dtype": io_dtype,
        "ext_dtype": ext_dtype, "seq_groups": seq_groups,
        "seq_groups_effective": effective_seq_groups(cfg, B_local),
        "boundary_xch": boundary_xch, "early_term": early_term,
        "processes": world, "devices": world,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "ebn0_db": ebn0_db, "bit_errs": bit, "frame_errs": frame,
        "ber": bit / (B * K), "fer": frame / B,
        "mean_iters": float(iters.float().mean()),
        "max_iters": int(iters.max()),
        "wall_s": wall, "timed_reps": n_timed, "timer": timer,
        "mbit_per_s": B * K / wall / 1e6,
    }
    if verbose and (backend == "local" or torch.distributed.get_rank() == 0):
        print(rec)
    return rec
