"""MAP variants at the K=6144 waterfall: log-MAP, linlog and max-log, FER on
the same frames and the penalty in dB against log-MAP, beside each
variant's decode speed on the card.

Counterpart of experiments/map_variant_ber.py of the JAX package.  The
speed column is read from this port's own record of flagship_tuning
(`records/flagship_tuning.json`, its `map_variants` rows), which must
exist: run `python -m turbotpu_torch.experiments.flagship_tuning` first.
The penalty is from the log-MAP curve's slope between the two points; the
bar it is read against is 0.05 dB.

    python -m turbotpu_torch.experiments.map_variant_ber [--ebn0 0.6 0.7]
        [--n-batches 12] [--tuning FILE] [--out FILE]
"""

from __future__ import annotations

import argparse
import json

from .._device import resolve_device
from ..decoder.turbo import DecoderConfig
from .common import (RECORDS, one_frame_db, out_path, penalties, run_meta,
                     write_record)
from .nii_window_sweep import fer_points

VARIANTS = {
    "logmap": dict(mode="logmap", ext_scale=1.0),
    "linlog": dict(mode="linlog", ext_scale=1.0),
    "maxlog": dict(mode="maxlog", ext_scale=0.75),
}


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--ebn0", type=float, nargs="+", default=[0.6, 0.7])
    ap.add_argument("--n-batches", type=int, default=12)
    ap.add_argument("--tuning", default=str(RECORDS / "flagship_tuning.json"),
                    help="flagship_tuning's record (the speed column)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    with open(args.tuning) as f:
        tuning = json.load(f)
    dev = resolve_device(device)
    K, B = 6144, args.batch
    rows, cache = {}, {}
    for name, kw in VARIANTS.items():
        cfg = DecoderConfig(K=K, n_iters=6, siso="cuda", io_dtype="bfloat16",
                            nii=True, window=256, **kw)
        rows[name] = fer_points(cfg, K, B, args.ebn0, args.n_batches, dev,
                                cache)
        print(name, json.dumps(rows[name]), flush=True)
    speeds = tuning["map_variants"]
    rec = {**run_meta(argv, dev), "K": K, "B": B, "n_batches": args.n_batches,
           "ebn0_db": args.ebn0, "bar_db": 0.05, "rows": rows,
           "throughput_mbit_s": {
               **{m: speeds[m] for m in VARIANTS},
               "source": "flagship_tuning record", "card": tuning["card"],
               "commit": tuning["commit"],
               "ext_dtype": tuning["variance"]["config"]["ext_dtype"]}}
    if len(args.ebn0) >= 2:
        slope, pen = penalties(rows, "logmap", args.ebn0, args.ebn0[0],
                               args.ebn0[-1])
        rec["logmap_slope_decades_per_db"] = slope
        rec["one_frame_db"] = one_frame_db(rows["logmap"], args.ebn0, slope)
        rec["penalty_db_vs_logmap"] = pen
        print("penalties vs logmap (dB):", pen, flush=True)
    write_record(rec, out_path(args.out, "map_variant_ber"))
    return rec


if __name__ == "__main__":
    main()
