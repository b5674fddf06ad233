"""Helpers of the benchmark's CPU tests: a checkout in a temporary
directory holding tiny cells of both kinds of configuration, run through
perfbench/run.py on the CPU (the program's plain PyTorch path)."""

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


# tiny cells: each takes the committed limits of the real cell named, or,
# for the early-terminated one-shot mixes that no committed cell runs, the
# limits set from their readings on the card (PERF.md)
TINY = {
    "cb.lean": ("cb", "lean", "cb6144-b16384-lean"),
    "cb.one": ("cb", "one", "cb6144-b64-lean-oneshot"),
    "cb.crc": ("cb", "crc", {"bits_differ": 0.009, "iters_differ": 0.5,
                             "verdicts_differ": 0.4, "llr_gap": 0.4}),
    "tb.one": ("tb", "tb1", {"bits_differ": 8e-07, "iters_differ": 0.2,
                             "verdicts_differ": 0.01, "llr_gap": 0.5}),
    "tb.chain": ("tb", "tb2", "tb75376-n512-crc"),
}
TRAFFIC = {
    "one": {"units_per_batch": 4, "loop": "oneshot", "early_term": "none",
            "ebn0_db": 0.7, "pool_batches": 3, "check": {"batches": 2},
            "trace_batches": 2},
    "lean": {"units_per_batch": 4, "loop": "chained", "early_term": "none",
             "ebn0_db": 1.0, "pool_batches": 3,
             "check": {"batches": 2, "units": 3}, "trace_batches": 2},
    "crc": {"units_per_batch": 8, "loop": "oneshot", "early_term": "crc",
            "ebn0_db": 1.0, "pool_batches": 3, "check": {"batches": 2},
            "trace_batches": 2},
    "tb1": {"units_per_batch": 2, "loop": "oneshot", "early_term": "crc",
            "ebn0_db": "operating_point", "pool_batches": 3,
            "check": {"batches": 2}, "trace_batches": 2},
    "tb2": {"units_per_batch": 3, "loop": "chained", "early_term": "crc",
            "ebn0_db": "operating_point", "pool_batches": 2,
            "check": {"batches": 2, "units": 2}, "trace_batches": 2},
}


def write_tiny_checkout(root: Path) -> Path:
    """BENCHMARK.json and perfbench/ data files of the tiny cells, and a
    copy of the metric readers, under `root`."""
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    pb = root / "perfbench"
    for sub in ("configs", "workloads", "limits"):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(REPO / "perfbench" / "metrics", pb / "metrics",
                    dirs_exist_ok=True)
    cb = json.loads((REPO / "perfbench/configs/lte-cb6144-maxlog.json")
                    .read_text())
    cb["K"] = 256
    cb["decoder"]["window"] = 64
    tb = json.loads((REPO / "perfbench/configs/lte-tb75376-pusch.json")
                    .read_text())
    # one block of K=280 with 6 filler bits, rate-matched to 600 bits
    tb.update(A=250, G=600, Qm=2, operating_point_ebn0_db=2.0)
    tb["decoder"]["window"] = 64
    for name, cfg in (("cb", cb), ("tb", tb)):
        (pb / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, t in TRAFFIC.items():
        (pb / "workloads" / f"{name}.json").write_text(json.dumps(t))
    cells = []
    for name, (cfg, traffic, like) in TINY.items():
        cells.append({"name": name, "config": cfg, "traffic": traffic,
                      "chips": 1, "why": "test"})
        if isinstance(like, dict):
            (pb / "limits" / f"{name}.json").write_text(json.dumps(like))
        else:
            shutil.copy(REPO / "perfbench" / "limits" / f"{like}.json",
                        pb / "limits" / f"{name}.json")
    # every metric of the real benchmark, over the tiny cells of its kind
    chained = [n for n, (_, t, _) in TINY.items()
               if TRAFFIC[t]["loop"] == "chained"]
    oneshot = [n for n in TINY if n not in chained]

    def cells_of(m):
        if m["name"] == "setup_s":
            return m
        kind = m.get("moves", m["name"])
        return {**m, "workloads": chained if kind == "mbit_per_s" else oneshot}
    bench = {**real,
             "configs": [{"name": n, "source": "test", "reduced": [],
                          "file": f"perfbench/configs/{n}.json", "why": "t"}
                         for n in ("cb", "tb")],
             "workloads": cells,
             "end_to_end": [cells_of(m) for m in real["end_to_end"]],
             "per_layer": [cells_of(m) for m in real["per_layer"]]}
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_cell(root, name, seed=3000000001, trace=0, breaker=None,
             capsys=None):
    """main() of perfbench/run.py on the CPU; returns (exit code, the
    result line as a dict or None)."""
    from perfbench import run
    rc = run.main(["--workload", name, "--seed", str(seed), "--seconds",
                   "0.5", "--trace", str(trace)], device="cpu", root=root,
                  breaker=breaker)
    out = capsys.readouterr().out.strip().splitlines() if capsys else []
    return rc, (json.loads(out[-1]) if out else None)
