"""linlog against log-MAP on the C3 path: the UMTS mixed-K batch, CRC early
termination, 8 iterations, through the sweep's own step
(`harness.ber.simulate_point`), both variants on the same frames.

Counterpart of experiments/map_variant_umts.py of the JAX package.  Both
arms use C3's seed and a fixed frame count (the frame-error stop pinned
out of reach), so every payload and noise draw is the same in both; the
penalty is from the log-MAP curve's slope between the two points, read
against the 0.05 dB bar.

    python -m turbotpu_torch.experiments.map_variant_umts [--ebn0 0.5 1.0]
        [--frames 12288] [--out FILE]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from .._device import resolve_device
from .common import one_frame_db, out_path, penalties, run_meta, write_record


def main(argv=None, device="cuda") -> dict:
    from ..configs.acceptance import C3
    from ..harness.ber import make_step, simulate_point
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ebn0", type=float, nargs="+", default=[0.5, 1.0])
    ap.add_argument("--frames", type=int, default=12_288)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    rows = {}
    for mode in ("logmap", "linlog"):
        sc = dataclasses.replace(
            C3, name=f"c3_{mode}_paired",
            decoder=dataclasses.replace(C3.decoder, mode=mode),
            ebn0_db_grid=tuple(args.ebn0), min_frame_errors=1 << 30,
            max_frames=args.frames)
        step = make_step(sc, dev)
        fer = {}
        for e in args.ebn0:
            r = simulate_point(sc, e, step)
            fer[str(e)] = {k: r[k] for k in ("frames", "frame_errs",
                                             "bit_errs", "fer", "avg_iters",
                                             "wall_s")}
            print(mode, e, json.dumps(fer[str(e)]), flush=True)
        rows[mode] = fer
    rec = {**run_meta(argv, dev),
           "config": "C3 (umts mixed-K, crc early-term, 8 iters)",
           "K_mix": list(C3.K_mix), "B": C3.B, "n_frames": args.frames,
           "ebn0_db": args.ebn0, "bar_db": 0.05, "rows": rows}
    if len(args.ebn0) >= 2:
        slope, pen = penalties(rows, "logmap", args.ebn0, args.ebn0[0],
                               args.ebn0[-1])
        rec["logmap_slope_decades_per_db"] = slope
        rec["one_frame_db"] = one_frame_db(rows["logmap"], args.ebn0, slope)
        rec["linlog_penalty_db_vs_logmap"] = pen["linlog"]
        print("linlog penalty vs logmap (dB):", pen["linlog"], flush=True)
    write_record(rec, out_path(args.out, "map_variant_umts"))
    return rec


if __name__ == "__main__":
    main()
