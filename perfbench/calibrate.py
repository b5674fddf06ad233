"""Readings the benchmark's limits and operating points are set from, on the
card.  Not part of a run.

    python3 perfbench/calibrate.py readings --workload NAME --seeds S ...
        per seed, the compared numbers of the program's outputs of the
        cell's sample (the pool decoded once in a window's order, after
        the warm-up, outside a window) against
        the reference, and of the control (the reference with 4-bit
        extrinsic codes in the program's place) against the same reference:
        the lower and upper readings of each limit;
    python3 perfbench/calibrate.py sweep --workload NAME --ebn0 DB ...
        [--batches N] [--seed S]
        a transport-block cell's TBLER (CRC-24A verdicts) and code-block
        error rate against Eb/N0, through the program's timed path.

One JSON line per reading on standard output.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell, seeds, dev):
    import torch

    from perfbench.harness import compare
    from perfbench.reference import turbo_ref
    fn, _ = cell.timed_path(dev)
    for seed in seeds:
        t0 = time.perf_counter()
        pool = cell.make_pool(seed, dev)
        batches, units = cell.sample(seed)
        # in a window's order: the warm-up, then the pool once through
        for b in cell.warmup(pool):
            fn(b)
        kept = {}
        for p, b in enumerate(pool):
            out = fn(b)
            if p in batches:
                kept[p] = out
        prog = cell.select(kept, batches, units)
        inputs = {b: pool[b] for b in cell.needs(batches)}
        del pool, kept, out
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        ref = cell.reference_outputs(inputs, batches, units, turbo_ref.INT8)
        t2 = time.perf_counter()
        ctl = cell.reference_outputs(inputs, batches, units, turbo_ref.INT4)
        print(json.dumps({
            "workload": cell.name, "seed": seed,
            "program": compare.numbers(prog, ref),
            "control": compare.numbers(ctl, ref),
            "program_units_wrong": compare.units_wrong(prog, ref),
            "units": len(units) * len(batches),
            "mean_iters_ref": float(ref["iters"].float().mean()),
            "reference_s": t2 - t1, "seconds": time.perf_counter() - t0}),
            flush=True)


def sweep(cell, points, n_batches, seed, dev):
    import torch

    from perfbench.harness import gen
    fn, _ = cell.timed_path(dev)
    c = cell.config
    n = cell.units
    for ebn0 in points:
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        tb_err = tb_fail = blk_cap = tbs = undetected = 0
        iters_sum = 0
        for _ in range(n_batches):
            runs, tx = gen.transport_blocks(g, n, c["A"], c["G"], c["Qm"],
                                            ebn0)
            out = fn(runs)
            wrong = (out["hard"] != tx).any(dim=1)
            tb_err += int(wrong.sum())
            tb_fail += int((~out["ok"]).sum())
            undetected += int((wrong & out["ok"]).sum())
            blk_cap += int((out["iters"] == c["decoder"]["n_iters"]).sum())
            iters_sum += int(out["iters"].sum())
            tbs += n
        blocks = tbs * cell.layout()[0].C
        print(json.dumps({
            "workload": cell.name, "ebn0_db": ebn0, "tbs": tbs,
            "tbler": tb_fail / tbs, "tb_errors": tb_err,
            "crc24a_fails": tb_fail, "undetected": undetected,
            "blocks_at_cap": blk_cap / blocks,
            "mean_iters": iters_sum / blocks}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("readings", "sweep"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[1])
    ap.add_argument("--ebn0", type=float, nargs="*", default=[])
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    import torch

    from perfbench.harness.cell import Cell
    if not torch.cuda.is_available():
        print("needs a card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cell = Cell.load(args.workload)
    if args.what == "readings":
        readings(cell, args.seeds, dev)
    else:
        sweep(cell, args.ebn0, args.batches, args.seed, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
