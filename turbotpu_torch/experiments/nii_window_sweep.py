"""NII window sweep on the card: speed and FER against the exact contract
at the K=6144 waterfall.

Counterpart of experiments/nii_window_sweep.py of the JAX package.  For the
exact kernel and the NII kernel at each window W:

* fixed-iteration throughput (`harness.bench.bench_decode`, CUDA events) at
  K=6144, B=1024, 6 iterations, max-log, bf16 channel and extrinsic streams;
* frame and bit errors at the waterfall points, on the same frames for
  every row (`fer_run` on `harness.bench.make_decode_inputs`: the
  reference's numpy generation, so one seed gives the JAX program's
  frames), and the penalty in dB against the exact row from the exact
  curve's slope between the first two points (`common.penalties`).

    python -m turbotpu_torch.experiments.nii_window_sweep [--windows 128 256]
        [--ebn0 0.7 0.8] [--n-batches 12] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import warnings

import torch

from .._device import resolve_device
from ..decoder.turbo import DecoderConfig, turbo_decode
from ..harness.bench import bench_decode, make_decode_inputs
from .common import (need_card, one_frame_db, out_path, penalties, run_meta,
                     write_record)


def fer_run(cfg: DecoderConfig, K: int, B: int, ebn0_db: float,
            n_batches: int, seed0: int, device="cuda",
            cache: dict | None = None) -> tuple[int, int]:
    """(bit errors, frame errors) over n_batches batches of B frames, batch
    b drawn at seed seed0 + b.  `cache` (a dict) keeps each batch on the
    device for the next configuration run on the same frames."""
    dev = resolve_device(device)
    bit_t = frame_t = 0
    for b in range(n_batches):
        key = (K, B, float(ebn0_db), seed0 + b)
        if cache is not None and key in cache:
            inputs, bits = cache[key]
        else:
            inputs, bits = make_decode_inputs(K, B, seed0 + b, ebn0_db,
                                              return_bits=True)
            inputs = tuple(x.to(dev) for x in inputs)
            bits = torch.from_numpy(bits).to(dev)
            if cache is not None:
                cache[key] = (inputs, bits)
        hard = turbo_decode(*inputs, cfg, device=dev)[0]
        errs = hard != bits
        bit_t += int(errs.sum())
        frame_t += int(errs.any(dim=1).sum())
    return bit_t, frame_t


def fer_points(cfg, K, B, ebn0s, n_batches, dev, cache, seed0=777) -> dict:
    """{str(ebn0): {frames, frame_errs, bit_errs, fer}} of one configuration
    on the shared frames."""
    fer = {}
    for e in ebn0s:
        bit, frame = fer_run(cfg, K, B, e, n_batches, seed0, dev, cache)
        fer[str(e)] = {"frames": n_batches * B, "frame_errs": frame,
                       "bit_errs": bit, "fer": frame / (n_batches * B)}
    return fer


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, nargs="+",
                    default=[128, 160, 192, 224, 256])
    ap.add_argument("--k", type=int, default=6144)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--ebn0", type=float, nargs="+", default=[0.7, 0.8])
    ap.add_argument("--n-batches", type=int, default=12,
                    help="FER batches per point (B frames each)")
    ap.add_argument("--timed", type=int, default=16)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    need_card(dev, "nii_window_sweep")
    K, B = args.k, args.batch
    rec = {**run_meta(argv, dev), "K": K, "B": B, "iters": args.iters,
           "ebn0_db": args.ebn0, "n_batches": args.n_batches,
           "io_dtype": "bfloat16", "ext_dtype": "bfloat16", "rows": []}
    variants = [("exact", {})] + [(f"nii_w{w}", dict(nii=True, window=w))
                                  for w in args.windows]
    cache = {}
    fers = {}
    for name, kw in variants:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # the warning for small W
            cfg = DecoderConfig(K=K, n_iters=args.iters, mode="maxlog",
                                ext_scale=0.75, siso="cuda",
                                io_dtype="bfloat16", **kw)
        speed = bench_decode(cfg, B, n_timed=args.timed, device=dev)
        row = {"name": name, "nii": cfg.nii, "window": cfg.window,
               "ms_per_batch": speed["wall_s_per_batch"] * 1e3,
               "mbit_per_s": speed["mbit_per_s"],
               "fer": fer_points(cfg, K, B, args.ebn0, args.n_batches, dev,
                                 cache)}
        fers[name] = row["fer"]
        rec["rows"].append(row)
        print(json.dumps(row), flush=True)
    if len(args.ebn0) >= 2:
        lo, hi = args.ebn0[0], args.ebn0[1]
        slope, pen = penalties(fers, "exact", (lo, hi), lo, hi)
        rec["exact_slope_decades_per_db"] = slope
        rec["one_frame_db"] = one_frame_db(fers["exact"], (lo, hi), slope)
        for row in rec["rows"][1:]:
            row["db_penalty_vs_exact"] = pen[row["name"]]
    write_record(rec, out_path(args.out, "nii_window_sweep"))
    return rec


if __name__ == "__main__":
    main()
