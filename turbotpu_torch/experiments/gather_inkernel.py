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
import ctypes
import json

import numpy as np
import torch

from .. import _build
from .._device import resolve_device

LAUNCHES = {"row_gather": 0}
TARGET: _build.Target = ("row_gather", ())


def row_gather_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of `row_gather`: fancy indexing along the rows."""
    return src[idx.to(torch.long)]


def _lib() -> ctypes.CDLL:
    lib = _build.load(*TARGET)
    fn = lib.turbotpu_row_gather_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int64, p]
        fn.restype = ctypes.c_int
    return lib


def row_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[t, :] = src[idx[t], :].

    src: contiguous (T, B) of a 1-, 2- or 4-byte type; idx: contiguous (T,)
    int32 with values in [0, T), on the same device."""
    if src.dim() != 2 or src.element_size() not in (1, 2, 4):
        raise ValueError("src must be a (T, B) tensor of 1-, 2- or 4-byte "
                         f"elements, got {src.dtype} {tuple(src.shape)}")
    T, B = src.shape
    if idx.shape != (T,) or idx.dtype != torch.int32:
        raise ValueError(f"idx must be int32 of shape {(T,)}, got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if idx.device != src.device:
        raise ValueError("src and idx must lie on one device")
    if not (src.is_contiguous() and idx.is_contiguous()):
        raise ValueError("src and idx must be contiguous")
    if src.device.type == "cpu":
        return row_gather_plain(src, idx)
    if src.device.type != "cuda":
        raise ValueError(f"unsupported device {src.device}")
    out = torch.empty_like(src)
    if T == 0 or B == 0:
        return out
    fn = _lib().turbotpu_row_gather_launch
    with torch.cuda.device(src.device):
        LAUNCHES["row_gather"] += 1
        rc = fn(src.data_ptr(), idx.data_ptr(), out.data_ptr(), T,
                B * src.element_size(),
                torch.cuda.current_stream(src.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"row_gather launch failed: cudaError {rc} "
                           f"(T={T}, B={B}, {src.dtype})")
    return out


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
    trellis row.  Returns (and with --out writes) the record."""
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
    for B in batches:
        k1 = siso_ns_per_row(T, B, K, W, dev)
        for dt in (torch.int8, torch.bfloat16):
            src = (torch.randn((T, B), device=dev) * 20).to(dt)
            for name, tab in tables.items():
                idx = torch.from_numpy(tab).to(dev)
                idx64 = idx.to(torch.long)
                got = row_gather(src, idx)
                if not torch.equal(got, row_gather_plain(src, idx)):
                    raise AssertionError(
                        f"row_gather differs from its plain version at "
                        f"B={B} {dt} {name}")
                ker = event_ms(lambda: row_gather(src, idx), n_timed)
                lib = event_ms(lambda: src.index_select(0, idx64), n_timed)
                out["rows"].append({
                    "B": B, "dtype": str(dt).split(".")[1], "index": name,
                    "row_bytes": B * src.element_size(),
                    "kernel_ms": ker, "index_select_ms": lib,
                    "kernel_ns_per_row": ker * 1e6 / T,
                    "index_select_ns_per_row": lib * 1e6 / T,
                    "kernel_over_index_select": ker / lib,
                    "siso_nii_ns_per_row": k1,
                    # the most a folded read can save of one half-iteration:
                    # the materialised gather's share of kernel + gather
                    "index_select_share_of_half_iteration":
                        lib * 1e6 / T / (k1 + lib * 1e6 / T),
                })
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    print(json.dumps(main()))
