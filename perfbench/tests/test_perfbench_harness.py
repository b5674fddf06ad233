"""perfbench/run.py driven end to end on the CPU at tiny sizes: the result
line, the data-driven lookup of cells and metrics, the faults that have to
make `correct` false, the control, and what the benchmark imports."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from pbtestlib import REPO, TINY, run_cell

FORBIDDEN = {"jax", "jaxlib", "flax", "turbotpu"}


@pytest.mark.parametrize("name", sorted(TINY))
def test_a_cell_runs_and_is_correct(tiny, capsys, name):
    rc, res = run_cell(tiny, name, capsys=capsys)
    assert rc == 0 and res["correct"] and res["failed"] == 0
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "compared"
    assert "setup_s" in res["metrics"]
    e2e = "mbit_per_s" if name in ("cb.lean", "tb.chain") \
        else "latency_ms_p50"
    assert res["metrics"][e2e]["value"] > 0
    for v in res["compared"].values():
        assert v["value"] <= v["limit"]


def test_trace_run_reports_per_layer_metrics(tiny, capsys):
    rc, res = run_cell(tiny, "tb.chain", trace=1, capsys=capsys)
    assert rc == 0 and res["correct"]
    # the CPU trace has no device operations: only the output count reads
    assert set(res["metrics"]) == {"iters_useful_pct.tput"}
    assert 0 < res["metrics"]["iters_useful_pct.tput"]["value"] <= 100
    assert res["device"]["busy_s"] == 0.0 and "breakdown" in res


def test_a_cell_and_a_metric_are_added_as_files_alone(tiny, capsys):
    """A later change adds a traffic mix, a cell, its limits and a metric
    by adding files and entries, and edits no file."""
    pb = tiny / "perfbench"
    (pb / "workloads" / "burst.json").write_text(json.dumps(
        {"units_per_batch": 2, "loop": "oneshot", "early_term": "none",
         "ebn0_db": 0.8, "pool_batches": 2, "check": {"batches": 1},
         "trace_batches": 2}))
    (pb / "limits" / "cb.burst.json").write_text(
        (pb / "limits" / "cb.lean.json").read_text())
    (pb / "metrics" / "batches_seen.py").write_text(
        "def read(run):\n    return float(run.batches)\n")
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "cb.burst", "config": "cb",
                               "traffic": "burst", "chips": 1, "why": "t"})
    bench["end_to_end"].append({"name": "batches_seen", "unit": "count",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["cb.burst"]})
    (tiny / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, res = run_cell(tiny, "cb.burst", capsys=capsys)
    assert rc == 0 and res["correct"]
    assert res["metrics"]["batches_seen"]["value"] == res["attempted"]
    assert "mbit_per_s" not in res["metrics"]


def _alter_an_answer(fn):
    """Each batch's first answer (a code block, or a transport block with
    its first code block's LLRs) comes out inverted."""
    def broken(batch):
        out = dict(fn(batch))
        out["hard"], out["L"] = out["hard"].clone(), out["L"].clone()
        out["hard"][0] ^= 1
        out["L"][0] = -out["L"][0]
        return out
    return broken


def _half_the_batch(fn):
    """Decodes the first half of the batch and hands its answers out for
    the rest too."""
    def broken(batch):
        if isinstance(batch, tuple):          # code blocks: rows are units
            half = tuple(x[:x.shape[0] // 2] for x in batch)
            out = fn(half)
            rep = lambda x: None if x is None else torch.cat(
                [x, x])[:batch[0].shape[0]]
            return {k: rep(v) for k, v in out.items()}
        return fn([x.flip(0) for x in batch])
    return broken


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch",
                                   "altered_answer"])
@pytest.mark.parametrize("name", ["cb.lean", "cb.one", "tb.one"])
def test_a_planted_fault_is_not_correct(tiny, capsys, monkeypatch, fault,
                                        name):
    """Each fault the cells can have (one card: no exchange between
    chips) turns `correct` false."""
    breaker = None
    if fault == "unchanged_state":
        import turbotpu_torch.decoder.turbo_cells as tc
        real = tc.siso_cells

        def stale(ls, lp, la, *a, nii_ckpt=None, **k):
            real(ls, lp, la, *a, nii_ckpt=nii_ckpt, **k)
            return la.clone() if nii_ckpt is None else (la.clone(), nii_ckpt)
        monkeypatch.setattr(tc, "siso_cells", stale)
    else:
        breaker = {"half_batch": _half_the_batch,
                   "altered_answer": _alter_an_answer}[fault]
    rc, res = run_cell(tiny, name, breaker=breaker, capsys=capsys)
    assert rc == 0 and res["correct"] is False and res["failed"] > 0


@pytest.mark.parametrize("name", sorted(TINY))
def test_the_control_is_not_correct(tiny, name):
    """The reference with 4-bit extrinsic codes in the program's place
    fails the committed limits of the cell it stands for."""
    from perfbench.harness import compare
    from perfbench.harness.cell import Cell
    from perfbench.reference import turbo_ref
    cell = Cell.load(name, tiny)
    fails = 0
    for seed in (1, 2, 3):
        pool = cell.make_pool(seed, torch.device("cpu"))
        batches, units = cell.sample(seed)
        inputs = {b: pool[b] for b in batches}
        ref = cell.reference_outputs(inputs, batches, units, turbo_ref.INT8)
        ctl = cell.reference_outputs(inputs, batches, units, turbo_ref.INT4)
        fails += not compare.judge(compare.numbers(ctl, ref), cell.limits)[0]
    assert fails == 3


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_of_the_benchmark_imports_jax():
    for path in (REPO / "perfbench").rglob("*.py"):
        assert not _imports(path) & FORBIDDEN, path
    for path in (REPO / "perfbench" / "reference").rglob("*.py"):
        assert "turbotpu_torch" not in _imports(path), path


def test_what_a_run_loads_has_no_jax(tiny):
    """Every module a run of each kind loads, the program's included, has
    a top-level name other than jax, jaxlib, flax and turbotpu."""
    code = (
        "import sys, pathlib, io, contextlib\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from perfbench import run\n"
        "for w in ('cb.crc', 'tb.chain'):\n"
        "    with contextlib.redirect_stdout(io.StringIO()), "
        "contextlib.redirect_stderr(io.StringIO()):\n"
        "        assert run.main(['--workload', w, '--seed', '1', "
        "'--seconds', '0.2'], device='cpu', "
        f"root=pathlib.Path({str(tiny)!r})) == 0\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "import perfbench.reference.rx_ref\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]
                            .replace("'", '"')))
    assert "turbotpu_torch" in loaded and not loaded & FORBIDDEN
    ref = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {str(REPO)!r}); "
         "import perfbench.reference.rx_ref; "
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        capture_output=True, text=True, timeout=300)
    mods = set(json.loads(ref.stdout.strip().replace("'", '"')))
    assert not mods & (FORBIDDEN | {"turbotpu_torch"})


def test_a_run_refuses_without_a_card(monkeypatch, capsys):
    from perfbench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "cb6144-b64-lean-oneshot", "--seed", "1",
                     "--seconds", "1"]) == 3
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "cb6144-b64-lean-oneshot", "--seed", "5", "--seconds", "2",
         "--trace", "1"], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["busy_s"] > 0
    assert "siso_ms.lat" in res["metrics"]
