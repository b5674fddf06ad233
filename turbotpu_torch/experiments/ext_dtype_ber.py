"""Quantised extrinsic streams at the K=6144 waterfall: int8 and fp8
against bf16, FER on the same frames and the penalty in dB of each.

Counterpart of experiments/ext_dtype_ber.py of the JAX package (and of its
fp8 record): the flagship decoder (max-log, scale 0.75, 6 iterations, NII
window 256, bf16 channel streams) with bf16, int8 (step 0.25, +-31.75) and
float8_e4m3fn extrinsics, frame errors through `nii_window_sweep.fer_run`
(the reference's frames), the penalty from the bf16 curve's slope between
the first and the last point.  The bar it is read against is 0.05 dB.

    python -m turbotpu_torch.experiments.ext_dtype_ber [--ext int8 float8_e4m3fn]
        [--ebn0 0.6 0.7 0.8] [--n-batches 12] [--out FILE]
"""

from __future__ import annotations

import argparse
import json

from .._device import resolve_device
from ..decoder.turbo import DecoderConfig
from .common import one_frame_db, out_path, penalties, run_meta, write_record
from .nii_window_sweep import fer_points


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ext", nargs="+", default=["int8", "float8_e4m3fn"],
                    help="quantised extrinsic types set against bfloat16")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--ebn0", type=float, nargs="+", default=[0.6, 0.7, 0.8])
    ap.add_argument("--n-batches", type=int, default=12)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    K, B = 6144, args.batch
    rows, cache = {}, {}
    for ext in ("", *args.ext):
        cfg = DecoderConfig(K=K, n_iters=6, mode="maxlog", ext_scale=0.75,
                            siso="cuda", io_dtype="bfloat16", nii=True,
                            window=256, ext_dtype=ext)
        rows[ext or "bfloat16"] = fer_points(cfg, K, B, args.ebn0,
                                             args.n_batches, dev, cache)
        print(ext or "bfloat16", json.dumps(rows[ext or "bfloat16"]),
              flush=True)
    rec = {**run_meta(argv, dev), "K": K, "B": B, "n_batches": args.n_batches,
           "ebn0_db": args.ebn0, "bar_db": 0.05, "rows": rows}
    if len(args.ebn0) >= 2:
        slope, pen = penalties(rows, "bfloat16", args.ebn0, args.ebn0[0],
                               args.ebn0[-1])
        rec["bfloat16_slope_decades_per_db"] = slope
        rec["one_frame_db"] = one_frame_db(rows["bfloat16"], args.ebn0, slope)
        for ext in args.ext:
            rec[f"{ext}_penalty_db"] = pen[ext]
            print(f"{ext} penalty (dB):", pen[ext], flush=True)
    write_record(rec, out_path(args.out, "ext_dtype_ber"))
    return rec


if __name__ == "__main__":
    main()
