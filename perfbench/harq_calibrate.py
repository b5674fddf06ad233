"""Readings of the HARQ cells (kind "harq_transport_block") on the card,
beside perfbench/calibrate.py's.  Not part of a run.

    python3 perfbench/harq_calibrate.py controls --workload NAME --seeds S ...
        per seed, as `calibrate.py readings` does, the compared numbers of
        the program's outputs of the cell's sample against the reference,
        and of two controls against the same reference: the reference with
        4-bit extrinsic codes (`int4`) and the reference whose soft buffer
        is stored in bfloat16, rounded at every transmission (`bf16_buffer`);
    python3 perfbench/harq_calibrate.py sweep --workload NAME --ebn0 DB ...
        [--batches N] [--seed S]
        the TBLER (CRC-24A verdicts) after 1, 2, ... transmissions at the
        cell's redundancy versions, through the program's timed path at
        the cell's own E split: every transport block of a batch sent at
        every redundancy version in turn, each with fresh noise, into one
        HARQ process, and decoded after each.

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


def controls(cell, seeds, dev):
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
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        ref = cell.reference_outputs(inputs, batches, units, turbo_ref.INT8)
        ctl = {"int4": cell.reference_outputs(inputs, batches, units,
                                              turbo_ref.INT4),
               "bf16_buffer": cell.reference_outputs(
                   inputs, batches, units, turbo_ref.INT8,
                   buffer=torch.bfloat16)}
        print(json.dumps({
            "workload": cell.name, "seed": seed,
            "program": compare.numbers(prog, ref),
            **{k: compare.numbers(v, ref) for k, v in ctl.items()},
            "units_wrong": {k: compare.units_wrong(v, ref)
                            for k, v in (("program", prog), *ctl.items())},
            "units": len(units) * len(batches),
            "seconds": time.perf_counter() - t0}), flush=True)


def sweep(cell, points, n_batches, seed, dev):
    import torch

    from perfbench.harness import harq_gen
    fn, _ = cell.timed_path(dev)
    c = cell.config
    n, C = cell.units, cell.layout()[0].C
    layout = cell.layout()[1]
    slots = torch.arange(n, device=dev)
    order = cell.rv_order
    for ebn0 in points:
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        es = harq_gen.esn0_db(ebn0, c["A"], c["G"])
        fails = [0] * len(order)
        errors, undetected, iters = list(fails), list(fails), list(fails)
        for _ in range(n_batches):
            tb, blocks = harq_gen.encode(g, n, c["A"], c["G"], c["Qm"])
            for i, v in enumerate(order):
                rv = torch.full((n,), v, dtype=torch.int64, device=dev)
                out = fn({"proc": 0, "rv": rv,
                          "new": torch.full((n,), i == 0, device=dev),
                          "runs": harq_gen.transmit(g, blocks, layout, slots,
                                                    rv, es)})
                wrong = (out["hard"] != tb).any(dim=1)
                fails[i] += int((~out["ok"]).sum())
                errors[i] += int(wrong.sum())
                undetected[i] += int((wrong & out["ok"]).sum())
                iters[i] += int(out["iters"].sum())
        tbs = n * n_batches
        print(json.dumps({
            "workload": cell.name, "ebn0_db": ebn0, "tbs": tbs,
            "rv_order": list(order),
            "tbler_after": [f / tbs for f in fails],
            "crc24a_fails": fails, "tb_errors": errors,
            "undetected": undetected,
            "mean_iters": [x / (tbs * C) for x in iters],
            "layout": [list(x) for x in layout]}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("controls", "sweep"))
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
    if not hasattr(cell, "rv_order"):
        print(f"{args.workload} is not a HARQ cell", file=sys.stderr)
        return 2
    if args.what == "controls":
        controls(cell, args.seeds, dev)
    else:
        sweep(cell, args.ebn0, args.batches, args.seed, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
