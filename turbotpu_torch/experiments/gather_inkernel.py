"""Is the extrinsic interleave gather worth folding into the SISO kernel?

Counterpart of experiments/gather_inkernel.py of the JAX package.  The fold
(`DecoderConfig.fold_gather`) makes each SISO read its a-priori row t from
row idx[t] of the other SISO's raw output.  `row_gather` is that read alone:
`out[t, :] = src[idx[t], :]` on a time-major `(T, B)` stream, a hand-written
kernel (csrc/row_gather.cu) in place of the reference's per-row-DMA Pallas
kernel `row_gather_pallas`.  `main` is the comparison the reference's `main`
is: the kernel against the library's gather (`torch.index_select`) on the
decoder's stream shapes, beside what one trellis row of the SISO kernel
itself costs there, which is the budget a folded read has to fit.

    python -m turbotpu_torch.experiments.gather_inkernel [--out FILE]

On a CUDA tensor `row_gather` launches its kernel or raises; it takes the
plain version only for a tensor on the CPU.  `LAUNCHES` counts launches.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .. import _build
from .._device import launch_on, resolve_device

LAUNCHES = {"row_gather": 0}
TARGET: _build.Target = ("row_gather", ())
_ELEMENT_SIZES = (1, 2, 4)
# the kernel's C entry takes one pointer to six int64 arguments
_ENTRY = _build.PackedEntry(TARGET, "turbotpu_row_gather_launch", 6)


def row_gather_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of `row_gather`: fancy indexing along the rows."""
    return src[idx.to(torch.long)]


def row_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[t, :] = src[idx[t], :].

    src: contiguous (T, B) of a 1-, 2- or 4-byte type; idx: contiguous (T,)
    int32 with values in [0, T), on the same device."""
    shape = src.shape
    if len(shape) != 2 or src.element_size() not in _ELEMENT_SIZES:
        raise ValueError("src must be a (T, B) tensor of 1-, 2- or 4-byte "
                         f"elements, got {src.dtype} {tuple(shape)}")
    T, B = shape
    if idx.dtype != torch.int32 or idx.shape != (T,):
        raise ValueError(f"idx must be int32 of shape {(T,)}, got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    dev = src.device
    if idx.device != dev:
        raise ValueError("src and idx must lie on one device")
    if not (src.is_contiguous() and idx.is_contiguous()):
        raise ValueError("src and idx must be contiguous")
    if dev.type != "cuda":
        if dev.type == "cpu":
            return row_gather_plain(src, idx)
        raise ValueError(f"unsupported device {dev}")
    out = torch.empty_like(src)
    if T == 0 or B == 0:
        return out
    rc = launch_on(dev.index, _ENTRY, src.data_ptr(), idx.data_ptr(),
                   out.data_ptr(), T, B * src.element_size())
    if rc != 0:
        raise RuntimeError(f"row_gather launch failed: cudaError {rc} "
                           f"(T={T}, B={B}, {src.dtype})")
    LAUNCHES["row_gather"] += 1
    return out


def graph_ms(fn, n: int, n_replays: int = 5, counts: dict | None = None
             ) -> float:
    """Device time of one call of `fn`: n calls captured in a CUDA graph,
    replayed `n_replays` times between two CUDA events, per call.  The host
    enqueues one graph per replay, so the time is the device's alone.  The
    calls made while the graph is captured launch nothing, so they are taken
    out of the wrapper's launch counts again (`counts`, this module's
    `LAUNCHES` by default); the replays do not pass through the wrapper and
    are not counted either."""
    counts = LAUNCHES if counts is None else counts
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):        # warm-up outside the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    counted = dict(counts)
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    counts.update(counted)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (n * n_replays)


def siso_ns_per_row(T: int, B: int, K: int, W: int, dev, n: int = 5) -> float:
    """Measured time of one max-log NII SISO launch (bf16 channel + int8
    extrinsic streams) per trellis row, in ns: the budget of a folded read.
    The kernel's time does not depend on the data, so the streams are random."""
    from ..harness.bench import event_ms
    from ..siso.cuda_kernel import siso_cells
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    ls, lp = (torch.randn((T, B), generator=g, device=dev).mul_(4)
              .to(torch.bfloat16) for _ in range(2))
    la = torch.randint(-40, 40, (T, B), generator=g, device=dev,
                       dtype=torch.int8)
    ck = torch.zeros((T // W, 8, B), dtype=torch.float32, device=dev)
    ms = event_ms(lambda: siso_cells(ls, lp, la, K, "maxlog", 0.75,
                                      nii_ckpt=ck, window=W, ext_qscale=0.25),
                   n)
    return ms * 1e6 / T


def main(argv=None, device="cuda", batches=(1024, 16384), n_timed: int = 20
         ) -> dict:
    """Time `row_gather` against `torch.index_select` on the decoder's
    extrinsic stream shapes ((6400, B): K=6144 padded to the window of 256)
    for int8 and bfloat16, through a random permutation and through the
    K=6144 interleaver table, and set them beside the SISO kernel's time per
    trellis row.  Each pair is timed two ways, in turns within the call:
    `n_timed` calls back to back between two CUDA events (what a caller
    waits, the host's enqueue included) and as a CUDA graph of the same calls
    (the device's time alone).  Returns (and with --out writes) the
    record."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the record here")
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("gather_inkernel times with CUDA events and needs "
                           "a card; a CPU timing is not a device metric")
    from ..harness.bench import card_info, event_ms
    from ..spec.qpp import qpp_perm
    K, W, T = 6144, 256, 6400
    rng = np.random.default_rng(0)
    tables = {
        "random": rng.permutation(T).astype(np.int32),
        "qpp6144": np.concatenate([qpp_perm(K), np.arange(K, T)]
                                  ).astype(np.int32),
    }
    out = {"T": T, "K": K, "W": W, "card": card_info(),
           "device": torch.cuda.get_device_name(dev), "rows": []}
    cases = [(B, dt, name) for B in batches
             for dt in (torch.int8, torch.bfloat16) for name in tables]
    k1 = {}
    for B, dt, name in cases:
        if B not in k1:
            k1[B] = siso_ns_per_row(T, B, K, W, dev)
        src = (torch.randn((T, B), device=dev) * 20).to(dt)
        idx = torch.from_numpy(tables[name]).to(dev)
        idx64 = idx.to(torch.long)
        got = row_gather(src, idx)
        if not torch.equal(got, row_gather_plain(src, idx)):
            raise AssertionError(f"row_gather differs from its plain version "
                                 f"at B={B} {dt} {name}")
        kern = lambda: row_gather(src, idx)
        lib = lambda: src.index_select(0, idx64)
        # in turns: kernel, library, library, kernel, each way
        b2b = {"k": [], "l": []}
        dev_t = {"k": [], "l": []}
        for key, f in (("k", kern), ("l", lib), ("l", lib), ("k", kern)):
            b2b[key].append(event_ms(f, n_timed))
        for key, f in (("k", kern), ("l", lib), ("l", lib), ("k", kern)):
            dev_t[key].append(graph_ms(f, n_timed))
        mean = lambda v: sum(v) / len(v)
        ker, lib_ms = mean(b2b["k"]), mean(b2b["l"])
        ker_dev, lib_dev = mean(dev_t["k"]), mean(dev_t["l"])
        out["rows"].append({
            "B": B, "dtype": str(dt).split(".")[1], "index": name,
            "row_bytes": B * src.element_size(),
            "kernel_ms": ker, "index_select_ms": lib_ms,
            "kernel_device_ms": ker_dev, "index_select_device_ms": lib_dev,
            "kernel_ms_turns": b2b["k"], "index_select_ms_turns": b2b["l"],
            "kernel_device_ms_turns": dev_t["k"],
            "index_select_device_ms_turns": dev_t["l"],
            "kernel_ns_per_row": ker * 1e6 / T,
            "index_select_ns_per_row": lib_ms * 1e6 / T,
            "kernel_over_index_select": ker / lib_ms,
            "kernel_over_index_select_device": ker_dev / lib_dev,
            "siso_nii_ns_per_row": k1[B],
            # the most a folded read can save of one half-iteration: the
            # materialised gather's share of kernel + gather
            "index_select_share_of_half_iteration":
                lib_ms * 1e6 / T / (k1[B] + lib_ms * 1e6 / T),
        })
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    print(json.dumps(main()))
