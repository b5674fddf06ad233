"""Decode latency against the batch on the card: what one batch waits.

Counterpart of experiments/latency.py of the JAX package.  The lean
flagship decode (`harness.bench.flagship_config`: K=6144, max-log, 6
iterations, NII window 256, bf16 channel streams, int8 extrinsics) and the
same with CRC early termination at 1.0 dB, at B = 1, 64 and 1024, each
read two ways on the same batch:

* chained: `bench_decode`'s ms per batch between CUDA events over decodes
  issued back to back.  The host enqueues the next decode while the card
  runs the last, so this is a pipelined time per batch;
* one-shot: a lone batch's time from its submission to its result, on the
  host's clock: synchronize, start the clock, decode, synchronize; the
  median, min and max over `--oneshot` repeats after one warm-up.  The
  host's work of the call that the chained time hides counts here.

Where this port's `records/comm_model.json` exists, its modelled latency
gain of each seq ring is recorded beside them, labelled as a model.

    python -m turbotpu_torch.experiments.latency [--batches 1 64 1024]
        [--timed 16] [--oneshot 32] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .._device import resolve_device
from ..decoder.turbo import DecoderConfig, turbo_decode
from ..harness.bench import bench_decode, flagship_config, make_decode_inputs
from .common import RECORDS, need_card, out_path, run_meta, write_record


def oneshot_ms(cfg: DecoderConfig, B: int, reps: int, device="cuda") -> dict:
    """Host-clock ms from submitting one decode to an idle card to its
    result: median, min and max over `reps` after one warm-up, on
    bench_decode's batch (seed 0, 1.0 dB, CRC frames with early
    termination)."""
    dev = resolve_device(device)
    need_card(dev, "oneshot_ms")
    inputs = tuple(x.to(dev) for x in make_decode_inputs(
        cfg.K, B, 0, 1.0, with_crc=cfg.early_term == "crc"))
    turbo_decode(*inputs, cfg, device=dev)
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        turbo_decode(*inputs, cfg, device=dev)
        torch.cuda.synchronize(dev)
        ts.append((time.perf_counter() - t0) * 1e3)
    ts.sort()
    return {"median": ts[len(ts) // 2], "min": ts[0], "max": ts[-1],
            "reps": reps}


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 64, 1024])
    ap.add_argument("--timed", type=int, default=16)
    ap.add_argument("--oneshot", type=int, default=32)
    ap.add_argument("--comm-model", default=str(RECORDS / "comm_model.json"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    need_card(dev, "latency")
    rec = {**run_meta(argv, dev),
           "config": "flagship_config(): K=6144, 6 iters, maxlog, NII W=256, "
                     "bf16 channel, int8 extrinsics", "rows": []}
    for B in args.batches:
        for early in ("none", "crc"):
            cfg = flagship_config(early_term=early)
            r = bench_decode(cfg, B, n_timed=args.timed, device=dev)
            row = {"B": B, "early_term": early,
                   "chained_ms": r["wall_s_per_batch"] * 1e3,
                   "mbit_per_s": r["mbit_per_s"], "timed_reps": args.timed,
                   "oneshot_ms": oneshot_ms(cfg, B, args.oneshot, dev),
                   **({"ebn0_db": r["ebn0_db"], "mean_iters": r["mean_iters"],
                       "max_iters": r["max_iters"]} if early != "none"
                      else {})}
            rec["rows"].append(row)
            print(json.dumps(row), flush=True)
    try:
        with open(args.comm_model) as f:
            cm = json.load(f)
    except FileNotFoundError:
        cm = None
    if cm is not None:
        rec["seq_modeled_latency_speedup"] = {
            str(r["n_seq"]): r["latency_speedup_vs_1chip"]
            for r in cm["seq_sharded"]}
        rec["seq_modeled_note"] = (
            "a model (comm_model record: measured glue, datasheet link "
            "rate), not a measurement across cards")
    write_record(rec, out_path(args.out, "latency"))
    return rec


if __name__ == "__main__":
    main()
