"""Flagship tuning on the card: the extrinsic type, the spread of repeated
runs, the batch, and the MAP variants' speed.

Counterpart of experiments/flagship_tuning.py of the JAX package, four
parts, each through `harness.bench.bench_decode` (CUDA events, fixed
6 iterations, K=6144, max-log, NII window 256, bf16 channel streams):

1. extrinsic type A/B at B=1024: bfloat16, int8, float8_e4m3fn, measured
   in turns (each round runs the types forward, then backward) for
   `--ab-rounds` rounds on one batch, with each type's readings, median and
   spread.  A type is the configuration of the parts below only where it
   is separated: its slowest reading beats every other type's fastest.
   Otherwise the flagship's own type (`harness.bench.flagship_config`,
   int8) stays;
2. `--runs` repeated measurements of it: min, median, max, spread;
3. the batch sweep: 512, 1024, 2048, 4096 and 16384;
4. log-MAP and linlog (scale 1.0) at B=1024 beside max-log's median.

    python -m turbotpu_torch.experiments.flagship_tuning [--batches ...]
        [--ab-rounds 3] [--runs 5] [--timed 16] [--out FILE]
"""

from __future__ import annotations

import argparse
import json

from .._device import resolve_device
from ..decoder.turbo import DecoderConfig
from .common import need_card, out_path, run_meta, write_record

FLAG = dict(K=6144, n_iters=6, mode="maxlog", ext_scale=0.75, siso="cuda",
            io_dtype="bfloat16", nii=True, window=256)
EXT_TYPES = ("bfloat16", "int8", "float8_e4m3fn")


def spread(readings) -> dict:
    """min, median, max and (max - min) / median in % of some readings."""
    r = sorted(readings)
    med = r[len(r) // 2]
    return {"min": r[0], "median": med, "max": r[-1],
            "spread_pct": 100 * (r[-1] - r[0]) / med}


def separated(ab: dict) -> str | None:
    """The type whose slowest reading beats every other type's fastest, if
    one does."""
    for t, r in ab.items():
        if all(r["min"] > o["max"] for u, o in ab.items() if u != t):
            return t
    return None


def main(argv=None, device="cuda") -> dict:
    from ..harness.bench import (bench_decode, flagship_config,
                                 make_decode_inputs)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+",
                    default=[512, 1024, 2048, 4096, 16384])
    ap.add_argument("--ab-rounds", type=int, default=3)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--timed", type=int, default=16)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    need_card(dev, "flagship_tuning")
    mbit = lambda cfg, B, inputs=None: bench_decode(
        cfg, B, n_timed=args.timed, device=dev, inputs=inputs)["mbit_per_s"]
    ext_arg = lambda t: "" if t == "bfloat16" else t
    rec = run_meta(argv, dev)
    inputs = make_decode_inputs(FLAG["K"], 1024)
    readings = {t: [] for t in EXT_TYPES}
    for _ in range(args.ab_rounds):
        for t in EXT_TYPES + EXT_TYPES[::-1]:
            cfg = DecoderConfig(**FLAG, ext_dtype=ext_arg(t))
            readings[t].append(mbit(cfg, 1024, inputs))
    ab = {t: {"readings_mbit_per_s": r, **spread(r)}
          for t, r in readings.items()}
    print("ext", json.dumps({t: r["median"] for t, r in ab.items()}),
          flush=True)
    sep = separated(ab)
    best = sep or flagship_config().ext_dtype
    rec["ext_dtype_ab"] = {
        "order": "rounds of " + ", ".join(EXT_TYPES + EXT_TYPES[::-1]),
        "rounds": args.ab_rounds, "types": ab, "separated": sep,
        "chosen": best,
        "rule": "a type is chosen only where its slowest reading beats "
                "every other type's fastest; else flagship_config's"}
    best_arg = ext_arg(best)
    cfg = DecoderConfig(**FLAG, ext_dtype=best_arg)
    runs = sorted(mbit(cfg, 1024) for _ in range(args.runs))
    rec["variance"] = {"config": {**FLAG, "ext_dtype": best, "B": 1024},
                       "runs_mbit_per_s": runs, **spread(runs)}
    med = rec["variance"]["median"]
    print("variance", json.dumps(rec["variance"]), flush=True)
    rec["batch_sweep"] = {}
    for B in args.batches:
        r = bench_decode(cfg, B, n_timed=args.timed, device=dev)
        rec["batch_sweep"][str(B)] = {"mbit_per_s": r["mbit_per_s"],
                                      "ms_per_batch":
                                          r["wall_s_per_batch"] * 1e3}
        print("B", B, json.dumps(rec["batch_sweep"][str(B)]), flush=True)
    modes = {}
    for mode in ("logmap", "linlog"):
        modes[mode] = mbit(DecoderConfig(**{**FLAG, "mode": mode,
                                            "ext_scale": 1.0},
                                         ext_dtype=best_arg), 1024)
        print("mode", mode, modes[mode], flush=True)
    rec["map_variants"] = {"maxlog": med, **modes}
    write_record(rec, out_path(args.out, "flagship_tuning"))
    return rec


if __name__ == "__main__":
    main()
