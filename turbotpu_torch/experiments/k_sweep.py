"""Throughput against the block size, and what a mixed-K batch costs.

Counterpart of experiments/k_sweep.py of the JAX package, two parts:

1. the K sweep: `harness.bench.bench_decode` (CUDA events) of the lean
   max-log NII decode, 6 iterations, bf16 channel and extrinsic streams, at
   K in {512, 1024, 2048, 4096, 6144} and B=1024; window 256 where K is a
   multiple of it and at least 2048, else the kernel's own (`window_len`);
2. the mixed-K cost at C3's bucket (UMTS, K=5114, exact contract):
   `bench_embedded` decodes random LLRs homogeneously (the shared table),
   as a true mixed batch of K in {320, 1280, 5114} through the grouped
   tables (`decoder.bucketing.grouped_perm_tables`) and through the
   per-codeword tables (`embedded_perm_tables`), at B=1024, and grouped at
   C3's own B=128.  With early termination off the iteration count, and so
   the time, does not depend on the values.

    python -m turbotpu_torch.experiments.k_sweep [--ks ...]
        [--mixed-batches 1024 128] [--out FILE]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .._device import resolve_device
from ..decoder.bucketing import embedded_perm_tables, grouped_perm_tables
from ..decoder.turbo import DecoderConfig, turbo_decode
from .common import need_card, out_path, run_meta, write_record

C3_MIX = (320, 1280, 5114)


def mixed_tables(K: int, B: int, k_mix, grouped: bool,
                 interleaver: str = "umts", device="cuda") -> dict:
    """turbo_decode's table arguments for B codewords of sizes k_mix[i %
    len(k_mix)] in a K bucket, as tensors on `device`: group_tables, or
    perm_b and inv_b."""
    dev = resolve_device(device)
    Ks = [k_mix[i % len(k_mix)] for i in range(B)]
    put = lambda *xs: tuple(torch.from_numpy(x).to(dev) for x in xs)
    if grouped:
        return {"group_tables": put(*grouped_perm_tables(Ks, K, interleaver))}
    pb, ib = put(*embedded_perm_tables(Ks, K, interleaver))
    return {"perm_b": pb, "inv_b": ib}


def bench_embedded(K: int, B: int, k_mix, n_iters: int = 6,
                   interleaver: str = "umts", grouped: bool = False,
                   device="cuda", n_timed: int = 16) -> dict:
    """ms per decode of random LLRs (numpy seed 0, as the reference) with
    or without mixed-K embedded tables."""
    from ..harness.bench import event_ms
    dev = resolve_device(device)
    need_card(dev, "bench_embedded")
    cfg = DecoderConfig(K=K, n_iters=n_iters, mode="maxlog", ext_scale=0.75,
                        siso="cuda", io_dtype="bfloat16",
                        interleaver=interleaver)
    rng = np.random.default_rng(0)
    mk = lambda n: torch.from_numpy(
        (rng.normal(size=(B, n)) * 4).astype(np.float32)).to(dev)
    inputs = (mk(K), mk(K), mk(K), mk(6), mk(6))
    tables = {}
    true_bits = B * K
    if k_mix:
        tables = mixed_tables(K, B, k_mix, grouped, interleaver, dev)
        true_bits = int(sum(k_mix[i % len(k_mix)] for i in range(B)))
    ms = event_ms(lambda: turbo_decode(*inputs, cfg, device=dev, **tables),
                  n_timed)
    return {"K": K, "B": B, "k_mix": list(k_mix) if k_mix else None,
            "grouped": grouped if k_mix else None, "ms_per_batch": ms,
            "timed_reps": n_timed,
            "bucket_mbit_per_s": B * K / ms / 1e3,
            "true_mbit_per_s": true_bits / ms / 1e3}


def main(argv=None, device="cuda") -> dict:
    from ..harness.bench import bench_decode
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ks", type=int, nargs="+",
                    default=[512, 1024, 2048, 4096, 6144])
    ap.add_argument("--mixed-batches", type=int, nargs="+",
                    default=[1024, 128],
                    help="batches of the mixed-K rows: the first gets all "
                         "four rows, the others the grouped row")
    ap.add_argument("--timed", type=int, default=16)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    need_card(dev, "k_sweep")
    rec = run_meta(argv, dev)
    ks = {}
    for K in args.ks:
        W = 256 if K % 256 == 0 and K >= 2048 else 0
        cfg = DecoderConfig(K=K, n_iters=6, mode="maxlog", ext_scale=0.75,
                            siso="cuda", io_dtype="bfloat16", nii=True,
                            window=W)
        r = bench_decode(cfg, 1024, n_timed=args.timed, device=dev)
        ks[str(K)] = {"window": W or "auto", "B": 1024,
                      "ms_per_batch": r["wall_s_per_batch"] * 1e3,
                      "mbit_per_s": r["mbit_per_s"]}
        print("K", K, json.dumps(ks[str(K)]), flush=True)
    rec["k_sweep"] = ks
    K, B0 = C3_MIX[-1], args.mixed_batches[0]
    bench = lambda B, mix, grouped=False: bench_embedded(
        K, B, mix, grouped=grouped, device=dev, n_timed=args.timed)
    mixed = {"homogeneous_5114": bench(B0, None),
             "mixed_grouped": bench(B0, C3_MIX, True),
             "mixed_per_codeword": bench(B0, C3_MIX)}
    mixed["grouped_overhead_pct"] = 100 * (
        mixed["mixed_grouped"]["ms_per_batch"]
        / mixed["homogeneous_5114"]["ms_per_batch"] - 1)
    mixed["per_codeword_vs_grouped_x"] = (
        mixed["mixed_per_codeword"]["ms_per_batch"]
        / mixed["mixed_grouped"]["ms_per_batch"])
    for B in args.mixed_batches[1:]:
        mixed[f"mixed_grouped_b{B}"] = bench(B, C3_MIX, True)
    for k, v in mixed.items():
        print(k, json.dumps(v), flush=True)
    rec["mixed_k"] = mixed
    write_record(rec, out_path(args.out, "k_sweep"))
    return rec


if __name__ == "__main__":
    main()
