"""Which SISO implementation wins at which (K, B): one half-iteration of
each variant the port has, timed on the card over a grid of shapes.

Counterpart of experiments/siso_shapes.py of the JAX package, whose
variants are scan, ascan and the Pallas kernel; here:

* scan   -- the sequential recursion in torch operations (siso/scan.py);
* ascan  -- the log-depth prefix product of 8x8 matrices (siso/ascan.py);
* window -- the windowed recursion, W=128, Q=32 (siso/windowed.py);
* cuda   -- the exact-contract kernel (`siso_decode_cuda`, K2).

Every variant runs at every shape: nothing is skipped and a failure
raises.  Each time is CUDA-event timed over enough calls for about
`--target-ms` of work (at least one), after one untimed call.

    python -m turbotpu_torch.experiments.siso_shapes [--ks ...] [--bs ...]
        [--variants ...] [--mode maxlog] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from .._device import resolve_device
from ..decoder.turbo import DecoderConfig, get_siso
from .common import need_card, out_path, run_meta, write_record

VARIANTS = ("scan", "ascan", "window", "cuda")


def bench_one(siso_name: str, K: int, B: int, mode: str = "maxlog",
              device="cuda", target_ms: float = 200.0) -> tuple[float, int]:
    """(ms per half-iteration, calls timed) of one SISO variant on random
    fp32 streams (numpy seed 0)."""
    from ..harness.bench import event_ms
    dev = resolve_device(device)
    need_card(dev, "siso_shapes")
    siso = get_siso(DecoderConfig(K=K, siso=siso_name))
    rng = np.random.default_rng(0)
    f32 = lambda *s: torch.from_numpy(
        rng.normal(size=s).astype(np.float32)).to(dev)
    ls, lp, la = f32(B, K + 3), f32(B, K + 3), f32(B, K)
    call = lambda: siso(ls, lp, la, mode=mode)
    once = event_ms(call, 1)            # the untimed call builds and warms
    n = max(1, min(64, math.ceil(target_ms / max(once, 1e-3))))
    return event_ms(call, n, n_warmup=0), n


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ks", type=int, nargs="+", default=[104, 512, 2048, 6144])
    ap.add_argument("--bs", type=int, nargs="+", default=[8, 64, 1024])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=VARIANTS)
    ap.add_argument("--mode", default="maxlog",
                    choices=["maxlog", "logmap", "linlog"])
    ap.add_argument("--target-ms", type=float, default=200.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    rows = []
    for K in args.ks:
        for B in args.bs:
            row = {"K": K, "B": B}
            for v in args.variants:
                ms, n = bench_one(v, K, B, args.mode, dev, args.target_ms)
                row[f"{v}_ms"] = ms
                row[f"{v}_calls"] = n
                row[f"{v}_mbit_s"] = B * K / ms / 1e3
            row["winner"] = min(args.variants, key=lambda v: row[f"{v}_ms"])
            rows.append(row)
            print(json.dumps(row), flush=True)
    rec = {**run_meta(argv, dev), "mode": args.mode,
           "variants": args.variants, "window_variant": {"W": 128, "Q": 32},
           "rows": rows}
    write_record(rec, out_path(args.out, "siso_shapes"))
    return rec


if __name__ == "__main__":
    main()
