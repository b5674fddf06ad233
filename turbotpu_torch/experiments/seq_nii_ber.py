"""The NII sequence decoder's accuracy at the K=6144 waterfall: the
seq-sharded decode against the monolithic one on the same frames.

Counterpart of experiments/seq_nii_ber.py of the JAX package, which, with
one chip, emulates the n_seq=8 sharded decode on one device.  Here the real
`dist.seq_parallel.decode_seq_sharded` runs on a local mesh of the one card
(every shard on it, the collectives tensor operations), so nothing is
emulated: the same chunk kernel (K4, NII contract), chunk sizes, masks and
edge staleness as across cards.  Both decoders: max-log, scale 0.75, 6
fixed iterations, NII window 256, bf16 streams.  Frames come from
`harness.c5.make_batch` at the reference's seeds, batch after batch until
both decoders have `--min-frame-errors` frame errors or `--max-frames`
frames; the penalty in dB is 0.1 x log10 of the FER ratio (the reference's
convention of one decade per 0.1 dB at K=6144).

    python -m turbotpu_torch.experiments.seq_nii_ber [--n-seq 8]
        [--ebn0 0.6 0.7 0.8] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from .._device import resolve_device
from ..decoder.turbo import DecoderConfig, turbo_decode
from .common import one_frame_db, out_path, run_meta, write_record


def main(argv=None, device="cuda") -> dict:
    from ..dist.mesh import make_mesh
    from ..dist.seq_parallel import decode_seq_sharded
    from ..harness.c5 import make_batch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, default=6144)
    ap.add_argument("--n-seq", type=int, default=8)
    ap.add_argument("--b", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--window", type=int, default=256)
    ap.add_argument("--ebn0", type=float, nargs="+", default=[0.6, 0.7, 0.8])
    ap.add_argument("--min-frame-errors", type=int, default=100)
    ap.add_argument("--max-frames", type=int, default=65_536)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    cfg = DecoderConfig(K=args.k, n_iters=args.iters, mode="maxlog",
                        ext_scale=0.75, siso="cuda", io_dtype="bfloat16",
                        nii=True, window=args.window)
    sharded = decode_seq_sharded(make_mesh(1, args.n_seq, device=dev), cfg)
    rows = []
    for ebn0 in args.ebn0:
        stats = {"sharded": [0, 0], "monolithic": [0, 0]}
        frames = seed = agree = 0
        while (min(stats["sharded"][0], stats["monolithic"][0])
               < args.min_frame_errors and frames < args.max_frames):
            bits, noisy = make_batch(args.k, args.b, ebn0,
                                     seed + int(ebn0 * 1000), n_unique=64)
            noisy = [torch.from_numpy(x).to(dev) for x in noisy]
            bits = torch.from_numpy(bits).to(dev)
            h_s = sharded(*noisy)[0]
            h_m = turbo_decode(*noisy, cfg, device=dev)[0]
            agree += int((h_s == h_m).sum())
            for name, h in (("sharded", h_s), ("monolithic", h_m)):
                err = h != bits
                stats[name][0] += int(err.any(dim=1).sum())
                stats[name][1] += int(err.sum())
            frames += args.b
            seed += 1
        fer_s = stats["sharded"][0] / frames
        fer_m = stats["monolithic"][0] / frames
        row = {"ebn0_db": ebn0, "frames": frames,
               "frame_errs_sharded": stats["sharded"][0],
               "frame_errs_monolithic": stats["monolithic"][0],
               "fer_sharded": fer_s, "fer_monolithic": fer_m,
               "ber_sharded": stats["sharded"][1] / (frames * args.k),
               "ber_monolithic": stats["monolithic"][1] / (frames * args.k),
               "hard_bit_agreement": agree / (frames * args.k),
               "delta_db_slope": (0.1 * math.log10(fer_s / fer_m)
                                  if fer_s > 0 and fer_m > 0 else None),
               "one_frame_db": one_frame_db(
                   {str(ebn0): {"frame_errs": stats["monolithic"][0]}},
                   [ebn0], 10.0).get(str(ebn0))}
        rows.append(row)
        print(json.dumps(row), flush=True)
    rec = {**run_meta(argv, dev), "K": args.k, "n_seq": args.n_seq,
           "B": args.b, "iters": args.iters, "window": args.window,
           "mesh": "local: every shard on the one card", "rows": rows}
    write_record(rec, out_path(args.out, "seq_nii_ber"))
    return rec


if __name__ == "__main__":
    main()
