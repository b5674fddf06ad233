"""The HARQ kind (perfbench/kinds/harq_transport_block.py) end to end on the
CPU at a tiny size: a cell of it runs through perfbench/run.py and is
correct, makes and reads what was recorded, and each fault a receiver with
soft buffers can have turns `correct` false, as does the control; the
committed cell's schedule, sample and byte count."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pbtestlib import REPO, digest, run_cell

CELL = "tb75376-harq8-n512"
RECORDED = json.loads((Path(__file__).parent / "recorded_harq.json")
                      .read_text())
# one block of K=280 with 6 fillers punctured to 600 bits, 2 processes of
# 6 slots, 4 rounds each
TRAFFIC = {"units_per_batch": 6, "loop": "chained", "early_term": "crc",
           "ebn0_db": 1.0, "pool_batches": 8,
           "tx_shares": [0.39, 0.57, 0.03, 0.01],
           "check": {"batches": 2, "units": 4}, "trace_batches": 2}


def add_harq(root: Path) -> str:
    """A tiny cell "harq" of the HARQ kind in the tiny checkout at `root`,
    with the committed cell's limits; returns its name."""
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "tb.json").read_text())
    real = json.loads((REPO / "perfbench" / "configs" /
                       "lte-tb75376-pusch-harq.json").read_text())
    cfg.update(kind="harq_transport_block",
               harq={**real["harq"], "processes": 2})
    (pb / "configs" / "harq.json").write_text(json.dumps(cfg))
    (pb / "workloads" / "harq.json").write_text(json.dumps(TRAFFIC))
    shutil.copy(REPO / "perfbench" / "limits" / f"{CELL}.json",
                pb / "limits" / "harq.json")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "harq", "source": "test", "reduced": [],
                             "file": "perfbench/configs/harq.json",
                             "why": "t"})
    bench["workloads"].append({"name": "harq", "config": "harq",
                               "traffic": "harq", "chips": 1, "why": "t"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "tb.chain" in m.get("workloads", ()):
            m["workloads"].append("harq")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return "harq"


def test_the_harq_cell_runs_and_is_correct(tiny, capsys):
    name = add_harq(tiny)
    rc, res = run_cell(tiny, name, capsys=capsys)
    assert rc == 0 and res["correct"] and res["failed"] == 0
    assert res["metrics"]["mbit_per_s"]["value"] > 0
    assert all(v["value"] == 0 for v in res["compared"].values())
    rc, res = run_cell(tiny, name, trace=1, capsys=capsys)
    # the CPU trace has no device operations: only the output count reads
    assert rc == 0 and res["correct"]
    assert set(res["metrics"]) == {"iters_useful_pct.tput"}


def test_the_harq_kind_makes_and_reads_what_was_recorded(tiny, capsys):
    """The tiny cell's pool, sample, reference and compared numbers at one
    seed, and what its kind says of itself."""
    from perfbench.harness.cell import Cell
    from perfbench.reference import turbo_ref
    seed = 3000000001
    cell = Cell.load(add_harq(tiny), tiny)
    pool = cell.make_pool(seed, torch.device("cpu"))
    got = [[b["proc"], digest(b["rv"]), digest(b["new"])]
           + [digest(x) for x in b["runs"]] for b in pool]
    assert got == RECORDED["pool"]
    batches, units = cell.sample(seed)
    assert [batches, units] == RECORDED["sample"]
    assert cell.needs(batches) == RECORDED["needs"]
    ref = cell.reference_outputs({b: pool[b] for b in cell.needs(batches)},
                                 batches, units, turbo_ref.INT8)
    assert {k: digest(v) for k, v in ref.items()} == RECORDED["reference"]
    assert (cell.K, cell.rows, cell.info_bits, cell.crc, cell.processes,
            cell.rounds, list(cell.rv_order)) == tuple(RECORDED["kind"])
    assert cell.warmup(pool) == pool
    rc, res = run_cell(tiny, "harq", seed=seed, capsys=capsys)
    assert {k: v["value"] for k, v in res["compared"].items()} == \
        RECORDED["compared"]


def _never_reset(fn):
    """New data is added to the buffer instead of replacing it."""
    return lambda b: fn({**b, "new": torch.zeros_like(b["new"])})


def _at_rv0(fn):
    """Retransmissions are combined at redundancy version 0's positions."""
    return lambda b: fn({**b, "rv": torch.where(b["new"], b["rv"], 0)})


def _alone(fn):
    """Every transmission is decoded without the earlier ones."""
    return lambda b: fn({**b, "new": torch.ones_like(b["new"])})


def _neighbour(fn):
    """Process 0's TTIs go into its neighbour's buffers, process 1's, which
    also takes its own (every process shifted alike would be the same
    receiver under other names)."""
    return lambda b: fn({**b, "proc": max(b["proc"], 1)})


@pytest.mark.parametrize("fault", [_never_reset, _at_rv0, _alone,
                                   _neighbour],
                         ids=lambda f: f.__name__.strip("_"))
def test_a_planted_receiver_fault_is_not_correct(tiny, capsys, fault):
    name = add_harq(tiny)
    rc, res = run_cell(tiny, name, breaker=fault, capsys=capsys)
    assert rc == 0 and res["correct"] is False and res["failed"] > 0


def test_the_control_is_not_correct_on_the_harq_cell(tiny):
    """The reference with 4-bit extrinsic codes in the program's place
    fails the committed cell's limits."""
    from perfbench.harness import compare
    from perfbench.harness.cell import Cell
    from perfbench.reference import turbo_ref
    cell = Cell.load(add_harq(tiny), tiny)
    fails = 0
    for seed in (1, 2, 3):
        pool = cell.make_pool(seed, torch.device("cpu"))
        batches, units = cell.sample(seed)
        inputs = {b: pool[b] for b in cell.needs(batches)}
        ref = cell.reference_outputs(inputs, batches, units, turbo_ref.INT8)
        ctl = cell.reference_outputs(inputs, batches, units, turbo_ref.INT4)
        fails += not compare.judge(compare.numbers(ctl, ref), cell.limits)[0]
    assert fails == 3


@pytest.mark.parametrize("seed", [1, 3811000101, 2 ** 31 + 17])
def test_the_committed_cells_shares_are_the_stated_ones(seed):
    """The schedule of the committed cell (8 processes, 512 slots, 4
    rounds): each slot's rounds filled exactly by its transport blocks,
    transmission indices in order, and the realized shares within 0.02 of
    the stated ones."""
    from perfbench.harness import harq_gen
    from perfbench.harness.cell import Cell
    cell = Cell.load(CELL)
    sch = harq_gen.schedule(seed, 8, 4, 512, cell.traffic["tx_shares"])
    k, tb = sch["k"].reshape(4, 8, 512), sch["tb"].reshape(4, 8, 512)
    for r in range(4):
        nxt = (r + 1) % 4
        # the next round continues the block or starts a new one
        cont = k[nxt] == k[r] + 1
        assert ((k[nxt] == 0) | cont).all()
        assert (tb[nxt][cont] == tb[r][cont]).all()
    got = harq_gen.realized_shares(sch)
    want = {"tx_index": [0.602, 0.367, 0.024, 0.006],
            "transmissions": cell.traffic["tx_shares"]}
    for key in want:
        assert np.abs(np.array(got[key]) - want[key]).max() < 0.02


def test_the_committed_cell_checks_every_transmission_index():
    from perfbench.harness.cell import Cell
    cell = Cell.load(CELL)
    assert (cell.K, cell.rows, cell.info_bits, cell.processes, cell.rounds) \
        == (5824, 13 * 512, 512 * 75376, 8, 4)
    base = Cell.load("tb75376-n512-crc")
    assert cell.decoder_settings() == base.decoder_settings()
    for seed in (5, 3811000101):
        batches, units = cell.sample(seed)
        assert len(batches) == 4 and len(units) >= 32
        k = cell.schedule(seed)["k"]
        for b in batches:
            assert set(k[b]) == set(k[b, units])
        assert cell.needs(batches) == sorted(
            {b % 8 + 8 * r for b in batches for r in range(4)})


def test_the_combines_bytes_counted_by_hand():
    import importlib.util
    path = REPO / "perfbench" / "metrics" / "harq_combine_roofline.py"
    spec_ = importlib.util.spec_from_file_location("roof", path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    # K=40: 3 x 44 = 132 positions; E=100 selects 100 distinct ones
    layout = [(40, 100, 0), (40, 100, 0)]
    got = mod.combine_bytes(layout, [0, 2, 1], [True, False, False])
    per_block = 3 * 4 * 100 + 4 * (3 * 40 + 12) + 2 * 8 * 100
    assert got == 2 * per_block
    # E=300 wraps: every one of the 132 positions is selected
    assert mod.combine_bytes([(40, 300, 0)], [3], [False]) == \
        4 * 300 + 8 * 132


def test_what_a_harq_run_loads_has_no_jax(tiny):
    add_harq(tiny)
    code = (
        "import sys, pathlib, io, contextlib\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from perfbench import run\n"
        "with contextlib.redirect_stdout(io.StringIO()), "
        "contextlib.redirect_stderr(io.StringIO()):\n"
        "    assert run.main(['--workload', 'harq', '--seed', '1', "
        "'--seconds', '0.2'], device='cpu', "
        f"root=pathlib.Path({str(tiny)!r})) == 0\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]
                            .replace("'", '"')))
    assert "turbotpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "turbotpu"}


def _harq_calibrate():
    import importlib.util
    path = REPO / "perfbench" / "harq_calibrate.py"
    spec_ = importlib.util.spec_from_file_location("harq_calibrate", path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def test_the_sweep_counts_each_transmission_at_the_cells_split(tiny,
                                                                capsys):
    """harq_calibrate.py sweep on the tiny cell: one line a point, the
    TBLER after each of the four transmissions, each transport block sent
    at every redundancy version into one process."""
    from perfbench.harness.cell import Cell
    cell = Cell.load(add_harq(tiny), tiny)
    capsys.readouterr()
    _harq_calibrate().sweep(cell, [0.0, 6.0], 2, 5, torch.device("cpu"))
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["ebn0_db"] for x in lines] == [0.0, 6.0]
    for x in lines:
        assert x["tbs"] == 12 and x["rv_order"] == [0, 2, 3, 1]
        assert x["layout"] == [list(b) for b in cell.layout()[1]]
        assert len(x["tbler_after"]) == 4 and x["undetected"] == [0] * 4
        assert x["tbler_after"] == [f / 12 for f in x["crc24a_fails"]]
    # combining recovers what one transmission loses
    low = lines[0]["tbler_after"]
    assert low[0] > 0.5 and low[-1] < low[0]
    assert lines[1]["tbler_after"] == [0.0] * 4


def test_the_bf16_buffer_control_is_not_correct_on_the_harq_cell(tiny):
    """The reference whose soft buffer is rounded to bfloat16 at every
    transmission fails the committed cell's limits, by llr_gap alone: a
    first transmission alone is the reference's (the decoder rounds to
    bfloat16 as it reads), a sum of two is not."""
    from perfbench.harness import compare
    from perfbench.harness.cell import Cell
    from perfbench.reference import turbo_ref
    cell = Cell.load(add_harq(tiny), tiny)
    C = cell.layout()[0].C
    for seed in (1, 2, 3):
        pool = cell.make_pool(seed, torch.device("cpu"))
        batches, units = cell.sample(seed)
        inputs = {b: pool[b] for b in cell.needs(batches)}
        ref = cell.reference_outputs(inputs, batches, units, turbo_ref.INT8)
        ctl = cell.reference_outputs(inputs, batches, units, turbo_ref.INT8,
                                     buffer=torch.bfloat16)
        k = cell.schedule(seed)["k"]
        first = torch.from_numpy(np.array([k[b, units] == 0
                                           for b in batches]).reshape(-1))
        rows = first.repeat(C)
        assert torch.equal(ctl["L"][rows], ref["L"][rows])
        assert not torch.equal(ctl["L"][~rows], ref["L"][~rows])
        ok, shown = compare.judge(compare.numbers(ctl, ref), cell.limits)
        assert not ok
        assert [k for k, v in shown.items() if v["value"] > v["limit"]] \
            == ["llr_gap"]
