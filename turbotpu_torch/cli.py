"""Command-line entry point of the port: the Monte-Carlo BER/FER sweep.

Counterpart of the `ber` subcommand of turbotpu/cli.py, with --device in
place of --platform.

Examples:
  python -m turbotpu_torch.cli ber --config c4
  python -m turbotpu_torch.cli ber --k 512 --iters 6 --mode maxlog --ebn0 0.5 1.0 1.5
  python -m turbotpu_torch.cli ber --k 40 --batch 8 --device cpu
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="turbotpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ber = sub.add_parser("ber", help="Monte-Carlo BER/FER sweep")
    ber.add_argument("--device", default="cuda",
                     help="cuda (default; fails without a card) or cpu "
                          "(plain PyTorch versions of the kernels)")
    ber.add_argument("--config", choices=["c1", "c2", "c3", "c3rm", "c4"])
    ber.add_argument("--k", type=int, default=1024)
    ber.add_argument("--batch", type=int, default=32)
    ber.add_argument("--iters", type=int, default=8)
    ber.add_argument("--mode", choices=["logmap", "maxlog", "linlog"],
                     default="logmap")
    ber.add_argument("--interleaver", choices=["lte", "umts"], default="lte")
    ber.add_argument("--early-term", choices=["none", "crc", "sign"],
                     default="none")
    ber.add_argument("--siso", default="scan", choices=["scan", "cuda"])
    ber.add_argument("--window", type=int, default=0)
    ber.add_argument("--io-dtype", default="float32",
                     choices=["float32", "bfloat16"],
                     help="channel-LLR stream type on the kernel path")
    ber.add_argument("--ext-dtype", default="",
                     choices=["", "float32", "bfloat16", "int8"],
                     help="extrinsic stream type (default: io-dtype)")
    ber.add_argument("--nii", action="store_true",
                     help="kernel path: windowed next-iteration "
                          "initialisation of alpha")
    ber.add_argument("--ebn0", type=float, nargs="+", default=[0.0, 0.5, 1.0])
    ber.add_argument("--E", type=int, default=0, help="rate-matched length")
    ber.add_argument("--rv", type=int, default=0)
    ber.add_argument("--rv-seq", type=int, nargs="+", default=None,
                     help="HARQ IR redundancy-version sequence, e.g. "
                          "--rv-seq 0 2 3 1 (requires --E)")
    ber.add_argument("--modulation",
                     choices=["bpsk", "qpsk", "qam16", "qam64"],
                     default="bpsk")
    ber.add_argument("--channel", choices=["awgn", "rayleigh"],
                     default="awgn",
                     help="rayleigh = flat per-symbol fading, perfect CSI")
    ber.add_argument("--k-mix", type=int, nargs="+", default=None,
                     help="TRUE mixed block sizes cycled over the batch, "
                          "each with its own interleaver/length, decoded "
                          "in one call at the --k bucket (e.g. "
                          "--k 5114 --k-mix 320 1280 5114)")
    ber.add_argument("--e-mix", type=int, nargs="+", default=None,
                     help="per --k-mix rate-matched lengths (with --k-mix "
                          "but no --e-mix, --E is split proportionally)")
    ber.add_argument("--min-frame-errors", type=int, default=50)
    ber.add_argument("--max-frames", type=int, default=200_000)
    ber.add_argument("--seed", type=int, default=0)
    ber.add_argument("--results", default="results/ber_torch.jsonl")
    ber.add_argument("--no-resume", action="store_true")
    ber.add_argument("--compact", type=int, default=0, metavar="S1_ITERS",
                     help="sweep-level convergence compaction (not ported "
                          "yet: any value but 0 is refused)")
    ber.add_argument("--compact-flush", type=int, default=0, metavar="R")

    args = ap.parse_args(argv)

    from .decoder.turbo import DecoderConfig
    from .harness.ber import SimConfig, simulate_ber
    if args.config:
        from .configs.acceptance import ALL
        cfgs = ALL[args.config]
        if not isinstance(cfgs, tuple):
            cfgs = (cfgs,)
    else:
        dec = DecoderConfig(K=args.k, n_iters=args.iters, mode=args.mode,
                            io_dtype=args.io_dtype, nii=args.nii,
                            ext_dtype=args.ext_dtype,
                            interleaver=args.interleaver,
                            early_term=args.early_term,
                            siso=args.siso, window=args.window)
        cfgs = (SimConfig(name=f"cli_k{args.k}_{args.mode}", K=args.k,
                          B=args.batch, ebn0_db_grid=tuple(args.ebn0),
                          decoder=dec, E=args.E, rv=args.rv,
                          rv_sequence=tuple(args.rv_seq or ()),
                          K_mix=tuple(args.k_mix or ()),
                          E_mix=tuple(args.e_mix or ()),
                          modulation=args.modulation,
                          channel=args.channel,
                          use_crc=args.early_term == "crc",
                          min_frame_errors=args.min_frame_errors,
                          max_frames=args.max_frames, seed=args.seed),)
    for cfg in cfgs:
        simulate_ber(cfg, results_path=args.results,
                     resume=not args.no_resume,
                     compact_stage1=args.compact,
                     compact_flush=args.compact_flush, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
