"""Command-line entry point of the port: the Monte-Carlo BER/FER sweep, the
decode throughput benchmark (and its profile), the transport-block sweep,
the C5 sharded decode, the scaling benchmark and the failure-recovery
supervisor.

Counterpart of the subcommands of turbotpu/cli.py (`ber`, `bench`, `tb`,
`c5`, `scaling`, `supervise`), with --device in place of --platform
(`bench` and `scaling` time with CUDA events and take the card only; `bench
--profile DIR` writes a torch.profiler trace to DIR), and `c5 --backend
local|process` for the mesh.

Examples:
  python -m turbotpu_torch.cli ber --config c4
  python -m turbotpu_torch.cli ber --k 512 --iters 6 --mode maxlog --ebn0 0.5 1.0 1.5
  python -m turbotpu_torch.cli ber --k 40 --batch 8 --device cpu
  python -m turbotpu_torch.cli ber --config c2 --compact 3 --compact-flush 4
  python -m turbotpu_torch.cli bench --k 6144 --batch 1024 --siso cuda --nii \
      --window 256 --io-dtype bfloat16 --ext-dtype int8 --early-term crc --compact 3
  python -m turbotpu_torch.cli tb --config c6
  python -m turbotpu_torch.cli bench --k 6144 --batch 1024 --siso cuda --nii \
      --window 256 --io-dtype bfloat16 --ext-dtype float8_e4m3fn \
      --early-term crc --profile /tmp/trace
  python -m turbotpu_torch.cli c5 --seq 2 --nii --window 256
  python -m turbotpu_torch.cli scaling --devices 1
  python -m turbotpu_torch.cli supervise --results results/ber_torch.jsonl \
      -- ber --config c1
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(prog="turbotpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    ber = sub.add_parser("ber", help="Monte-Carlo BER/FER sweep")
    ber.add_argument("--device", default="cuda",
                     help="cuda (default; fails without a card) or cpu "
                          "(plain PyTorch versions of the kernels)")
    ber.add_argument("--config",
                     choices=["c1", "c2", "c3", "c3rm", "c4", "c5"])
    ber.add_argument("--k", type=int, default=1024)
    ber.add_argument("--batch", type=int, default=32)
    ber.add_argument("--iters", type=int, default=8)
    ber.add_argument("--mode", choices=["logmap", "maxlog", "linlog"],
                     default="logmap")
    ber.add_argument("--interleaver", choices=["lte", "umts"], default="lte")
    ber.add_argument("--early-term", choices=["none", "crc", "sign"],
                     default="none")
    ber.add_argument("--siso", default="scan",
                     choices=["scan", "cuda", "ascan", "window"])
    ber.add_argument("--window", type=int, default=0)
    ber.add_argument("--io-dtype", default="float32",
                     choices=["float32", "bfloat16"],
                     help="channel-LLR stream type on the kernel path")
    ber.add_argument("--ext-dtype", default="",
                     choices=["", "float32", "bfloat16", "float8_e4m3fn",
                              "int8"],
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
    ber.add_argument("--max-frames", type=int, default=None,
                     help="frame cap per grid point (default 200000; with "
                          "--config it replaces the configuration's)")
    ber.add_argument("--seed", type=int, default=0)
    ber.add_argument("--results", default="results/ber_torch.jsonl")
    ber.add_argument("--no-resume", action="store_true")
    ber.add_argument("--compact", type=int, default=0, metavar="S1_ITERS",
                     help="sweep-level convergence compaction: stage-1 "
                          "decode each super-batch at this iteration cap, "
                          "re-batch CRC failures host-side, finish at the "
                          "full cap (bit-identical counts; needs "
                          "--early-term crc, homogeneous K)")
    ber.add_argument("--compact-flush", type=int, default=0, metavar="R",
                     help="with --compact: accumulate failures across "
                          "check groups (up to R retained super-batches) "
                          "and flush only when a dense full batch is "
                          "ready -- more device work saved; stopping rule "
                          "becomes conservative between flushes")

    bench = sub.add_parser("bench", help="decode throughput benchmark "
                                         "(on the card)")
    bench.add_argument("--k", type=int, default=6144)
    bench.add_argument("--batch", type=int, default=64)
    bench.add_argument("--iters", type=int, default=6)
    bench.add_argument("--mode", choices=["logmap", "maxlog", "linlog"],
                       default="maxlog")
    bench.add_argument("--siso", default="scan",
                       choices=["scan", "cuda", "ascan", "window"])
    bench.add_argument("--window", type=int, default=0)
    bench.add_argument("--io-dtype", default="float32",
                       choices=["float32", "bfloat16"],
                       help="channel-LLR stream type on the kernel path")
    bench.add_argument("--ext-dtype", default="",
                       choices=["", "float32", "bfloat16", "float8_e4m3fn",
                              "int8"],
                       help="extrinsic stream type (default: io-dtype)")
    bench.add_argument("--nii", action="store_true",
                       help="kernel path: windowed next-iteration "
                            "initialisation of alpha")
    bench.add_argument("--early-term", choices=["none", "crc", "sign"],
                       default="none",
                       help="measure EFFECTIVE throughput with early exit")
    bench.add_argument("--ebn0", type=float, default=1.0,
                       help="operating Eb/N0 for early-term benchmarks")
    bench.add_argument("--reps", type=int, default=10)
    bench.add_argument("--compact", type=int, default=0, metavar="S1_ITERS",
                       help="sweep-level convergence compaction: decode "
                            "super-batches at this stage-1 iteration cap, "
                            "re-batch CRC failures densely, finish at the "
                            "full cap (requires --early-term crc; "
                            "harness/compact.py)")
    bench.add_argument("--n-super", type=int, default=8,
                       help="super-batches per compaction pass")
    bench.add_argument("--profile", default=None, metavar="DIR",
                       help="write a torch.profiler trace (CPU and CUDA "
                            "activity) of two timed decodes to DIR/trace.json "
                            "after one warm-up")

    sc = sub.add_parser("scaling", help="data-parallel scaling efficiency "
                                        "(on the card)")
    sc.add_argument("--k", type=int, default=6144)
    sc.add_argument("--per-device-batch", type=int, default=1024)
    sc.add_argument("--iters", type=int, default=6)
    sc.add_argument("--siso", default="cuda",
                    choices=["scan", "cuda", "ascan", "window"])
    sc.add_argument("--devices", type=int, nargs="+", default=None,
                    help="data-axis sizes of the local meshes (default: 1 "
                         "and the card count); on one card only 1 is a "
                         "measurement, larger meshes check the structure")
    sc.add_argument("--reps", type=int, default=8)
    sc.add_argument("--json-out", default=None,
                    help="also write the records to this JSON file")

    sup = sub.add_parser(
        "supervise",
        help="run a turbotpu_torch command under the failure-recovery "
             "supervisor: relaunch on crash or results-file stall, resuming "
             "from the JSONL checkpoint")
    sup.add_argument("--max-restarts", type=int, default=3)
    sup.add_argument("--stall-timeout", type=float, default=None,
                     help="seconds without results-file growth before the "
                          "run is declared hung and relaunched")
    sup.add_argument("--results", default="results/ber_torch.jsonl",
                     help="results file watched for progress (must match "
                          "the wrapped command's --results)")
    sup.add_argument("rest", nargs=argparse.REMAINDER,
                     help="the turbotpu_torch command to supervise, e.g. "
                          "supervise -- ber --config c4")

    tb = sub.add_parser("tb", help="transport-block Monte-Carlo: TB > 6144 "
                        "bits through segmentation, per-block rate "
                        "matching, one mixed-K device decode, CRC-24A/B")
    tb.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu "
                         "(plain PyTorch versions of the kernels)")
    tb.add_argument("--config", choices=["c6"],
                    help="run the named acceptance config instead of "
                         "the ad-hoc flags")
    tb.add_argument("--a", type=int, default=12000, help="info bits per TB")
    tb.add_argument("--n-tb", type=int, default=8)
    tb.add_argument("--ebn0", type=float, nargs="+", default=[0.6, 0.8, 1.0])
    tb.add_argument("--G", type=int, default=0,
                    help="rate-matched channel bits per TB per transmission "
                         "(0 = mother rate)")
    tb.add_argument("--rv-seq", type=int, nargs="+", default=None)
    tb.add_argument("--iters", type=int, default=6)
    tb.add_argument("--mode", choices=["logmap", "maxlog", "linlog"],
                    default="maxlog")
    tb.add_argument("--siso", default="cuda", choices=["scan", "cuda"])
    tb.add_argument("--io-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    tb.add_argument("--nii", action="store_true")
    tb.add_argument("--window", type=int, default=0)
    tb.add_argument("--min-tb-errors", type=int, default=20)
    tb.add_argument("--max-tbs", type=int, default=20_000)
    tb.add_argument("--seed", type=int, default=0)
    tb.add_argument("--results", default="results/tb_torch.jsonl")
    tb.add_argument("--no-resume", action="store_true")

    c5 = sub.add_parser("c5", help="C5 acceptance: sharded batch decode "
                        "with windowed BCJR + boundary exchanges")
    c5.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu "
                         "(plain PyTorch versions; tiny shapes only)")
    c5.add_argument("--backend", default="local", choices=["local", "process"],
                    help="local: every (data, seq) shard in this process on "
                         "one device; process: one shard per rank of "
                         "torch.distributed (TURBOTPU_COORDINATOR, "
                         "TURBOTPU_NUM_PROCS, TURBOTPU_PROC_ID)")
    c5.add_argument("--k", type=int, default=6144)
    c5.add_argument("--batch", type=int, default=4096)
    c5.add_argument("--ebn0", type=float, default=0.8)
    c5.add_argument("--iters", type=int, default=6)
    c5.add_argument("--data", type=int, default=None)
    c5.add_argument("--seq", type=int, default=2)
    c5.add_argument("--siso", default="cuda", choices=["cuda", "scan"],
                    help="chunk SISO: cuda (the boundary kernels) or scan")
    c5.add_argument("--io-dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    c5.add_argument("--nii", action="store_true",
                    help="NII inside the chunk kernel too (window-start "
                         "alphas inherited across half-iterations)")
    c5.add_argument("--window", type=int, default=0)
    c5.add_argument("--ext-dtype", default="",
                    choices=["", "float32", "bfloat16", "float8_e4m3fn",
                              "int8"],
                    help="extrinsic/exchange stream type (default: io-dtype)")
    c5.add_argument("--groups", type=int, default=1,
                    help="seq_groups: independent batch splits of whole "
                         "1024-codeword cells (not with --xch dma; the "
                         "record's seq_groups_effective shows what ran)")
    c5.add_argument("--xch", default="ppermute", choices=["ppermute", "dma"],
                    help="boundary exchange: the ring shift of the mesh, or "
                         "one K6 kernel launch per iteration")
    c5.add_argument("--early-term", choices=["none", "crc", "sign"],
                    default="crc",
                    help="none = fixed-iteration lean loop")
    c5.add_argument("--reps", type=int, default=4,
                    help="timed decodes after the untimed first one")
    c5.add_argument("--seed", type=int, default=0)

    args = ap.parse_args(argv)

    from .decoder.turbo import DecoderConfig

    if args.cmd == "bench":
        from .harness.bench import bench_decode, card_info
        cfg = DecoderConfig(K=args.k, n_iters=args.iters, mode=args.mode,
                            siso=args.siso, window=args.window,
                            io_dtype=args.io_dtype, nii=args.nii,
                            ext_dtype=args.ext_dtype,
                            early_term=args.early_term)
        if args.compact:
            from .harness.compact import bench_compaction
            rec = bench_compaction(cfg, args.batch, args.ebn0,
                                   n_super=args.n_super,
                                   stage1_iters=args.compact)
        elif args.profile:
            from .harness.profiling import TRACE_FILE, trace
            bench_decode(cfg, args.batch, n_timed=1, ebn0_db=args.ebn0)
            with trace(args.profile):
                rec = bench_decode(cfg, args.batch, n_timed=2, n_warmup=0,
                                   ebn0_db=args.ebn0)
            rec["trace"] = str(Path(args.profile) / TRACE_FILE)
            print(f"profile written to {rec['trace']}", file=sys.stderr)
        else:
            rec = bench_decode(cfg, args.batch, n_timed=args.reps,
                               ebn0_db=args.ebn0)
        print(json.dumps({**rec, "card": card_info()}))
        return 0

    if args.cmd == "scaling":
        from .harness.bench import card_info
        from .harness.scaling import bench_scaling
        cfg = DecoderConfig(K=args.k, n_iters=args.iters, mode="maxlog",
                            siso=args.siso)
        recs = bench_scaling(cfg, args.per_device_batch, args.devices,
                             n_timed=args.reps)
        card = card_info()
        for rec in recs:
            print(json.dumps({**rec, "card": card}))
        if args.json_out:
            Path(args.json_out).write_text(json.dumps(recs, indent=1))
        return 0

    if args.cmd == "supervise":
        from .harness.supervisor import supervise
        rest = [a for a in args.rest if a != "--"]
        if not rest:
            ap.error("supervise needs a command after --")
        argv_child = [sys.executable, "-m", "turbotpu_torch.cli"] + rest
        restarts = supervise([argv_child], max_restarts=args.max_restarts,
                             stall_timeout_s=args.stall_timeout,
                             results_path=args.results)
        print(json.dumps({"restarts": restarts, "ok": True}))
        return 0

    if args.cmd == "c5":
        from .harness.c5 import run_c5
        rec = run_c5(K=args.k, B=args.batch, ebn0_db=args.ebn0,
                     n_iters=args.iters, data=args.data, seq=args.seq,
                     siso=args.siso, io_dtype=args.io_dtype, nii=args.nii,
                     window=args.window, boundary_xch=args.xch,
                     early_term=args.early_term, n_timed=args.reps,
                     ext_dtype=args.ext_dtype, seq_groups=args.groups,
                     seed=args.seed, backend=args.backend, device=args.device,
                     verbose=False)
        if args.device != "cpu":
            from .harness.bench import card_info
            rec["card"] = card_info()
        print(json.dumps(rec))
        return 0

    if args.cmd == "tb":
        from .harness.tb import TBConfig, simulate_tbler
        if args.config:
            from .configs.acceptance import ALL
            cfg = ALL[args.config]
        else:
            cfg = TBConfig(name=f"cli_tb_a{args.a}", A=args.a, n_tb=args.n_tb,
                           ebn0_db_grid=tuple(args.ebn0), G=args.G,
                           rv_sequence=tuple(args.rv_seq or (0,)),
                           n_iters=args.iters, mode=args.mode, siso=args.siso,
                           io_dtype=args.io_dtype, nii=args.nii,
                           window=args.window,
                           min_tb_errors=args.min_tb_errors,
                           max_tbs=args.max_tbs, seed=args.seed)
        simulate_tbler(cfg, results_path=args.results,
                       resume=not args.no_resume, device=args.device)
        return 0

    from .harness.ber import SimConfig, simulate_ber
    if args.config:
        from .configs.acceptance import ALL
        cfgs = ALL[args.config]
        if not isinstance(cfgs, tuple):
            cfgs = (cfgs,)
        if args.max_frames is not None:
            cfgs = tuple(dataclasses.replace(c, max_frames=args.max_frames)
                         for c in cfgs)
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
                          max_frames=args.max_frames or 200_000,
                          seed=args.seed),)
    for cfg in cfgs:
        simulate_ber(cfg, results_path=args.results,
                     resume=not args.no_resume,
                     compact_stage1=args.compact,
                     compact_flush=args.compact_flush, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
