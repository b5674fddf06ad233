"""The port's harness modules of the last slice on the CPU: debug
(`checked`, `assert_finite`), profiling (`trace`, `compile_count_guard`,
the ptxas report parser), the supervisor (a sweep child that dies once,
relaunched and resumed from its JSONL checkpoint) and the scaling
benchmark's structure on a local mesh.  The decode loop's early exit is held
to the JAX package's on the same inputs.

Where the JAX package has the same function (the decode), inputs are made
from a seed with numpy and handed to both sides.
"""

import dataclasses
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from turbotpu.decoder.turbo import DecoderConfig as JaxConfig
from turbotpu.decoder.turbo import turbo_decode as jax_decode
from turbotpu_torch import DecoderConfig, _build, convert, turbo_decode
from turbotpu_torch import cli
from turbotpu_torch.harness import debug, profiling, scaling
from turbotpu_torch.harness.bench import make_decode_inputs
from turbotpu_torch.harness.supervisor import supervise

REPO = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# debug
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
def test_assert_finite_walks_trees(bad):
    ok = {"a": torch.ones(3), "b": [torch.zeros(2), (torch.arange(3),)]}
    debug.assert_finite(ok)
    tree = {"a": torch.ones(3), "b": [torch.zeros(2),
                                      (torch.tensor([1.0, bad]),)]}
    with pytest.raises(ValueError, match=r"value\['b'\]\[1\]\[0\] is not finite"):
        debug.assert_finite(tree)
    # integer tensors are not floating and are not checked
    debug.assert_finite(torch.tensor([1, 2], dtype=torch.int64))


def _tiny():
    return make_decode_inputs(40, 2, seed=0), DecoderConfig(K=40, n_iters=2)


def test_checked_passes_a_good_decode_through():
    inputs, cfg = _tiny()
    got = debug.checked(turbo_decode)(*inputs, cfg, device="cpu")
    want = turbo_decode(*inputs, cfg, device="cpu")
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_checked_raises_on_a_non_finite_output(bad):
    inputs, cfg = _tiny()
    ls = inputs[0].clone()
    ls[0, 3] = bad
    with pytest.raises(ValueError, match="decode output"):
        debug.checked(turbo_decode)(ls, *inputs[1:], cfg, device="cpu")


@pytest.mark.parametrize("which,value", [("perm_b", 40), ("inv_b", -1),
                                         ("group", 40), ("gid", 1)])
def test_checked_raises_on_an_out_of_range_table(which, value):
    """An index table outside its range raises before the decode (on a card
    the gather would read out of bounds, not raise)."""
    inputs, cfg = _tiny()
    perm = torch.from_numpy(np.stack([cfg.perm()] * 2))
    inv = torch.from_numpy(np.stack([cfg.inv()] * 2))
    calls = []

    def decode(*args, **kwargs):
        calls.append(1)
        return turbo_decode(*args, **kwargs)

    f = debug.checked(decode)
    if which in ("perm_b", "inv_b"):
        tab = {"perm_b": perm, "inv_b": inv}
        tab[which] = tab[which].clone()
        tab[which][1, 5] = value
        with pytest.raises(ValueError, match=which):
            f(*inputs, cfg, device="cpu", **tab)
    else:
        gid = torch.tensor([0, 0])
        perm_g = perm[:1].clone()
        if which == "group":
            perm_g[0, 0] = value
        else:
            gid[1] = value
        with pytest.raises(ValueError, match="group_tables"):
            f(*inputs, cfg, device="cpu",
              group_tables=(perm_g, inv[:1], gid))
    assert not calls
    # the same tables in range decode
    f(*inputs, cfg, device="cpu", perm_b=perm, inv_b=inv)
    assert calls


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_trace_writes_a_trace_with_the_decoder_ranges(tmp_path):
    """On the CPU the trace has the host's activity: the decoder's named
    ranges and their operations."""
    cfg = DecoderConfig(K=40, n_iters=2, siso="cuda", mode="maxlog",
                        early_term="crc", window=16, nii=True)
    inputs = make_decode_inputs(40, 2, seed=1, with_crc=True)
    with profiling.trace(tmp_path / "p", device="cpu") as prof:
        turbo_decode(*inputs, cfg, device="cpu")
    path = tmp_path / "p" / profiling.TRACE_FILE
    assert path.exists()
    names = {a[0] for a in profiling.annotations(path, "turbo.")}
    assert {"turbo.siso1", "turbo.gather_perm", "turbo.siso2",
            "turbo.gather_inv", "turbo.early_exit"} <= names
    assert any(e.key.startswith("aten::") for e in prof.key_averages())
    assert profiling.device_ops(path) == []      # no card, no device work


def test_idle_gaps():
    ops = [("a", 0.0, 10.0), ("b", 12.0, 3.0), ("c", 13.0, 10.0),
           ("d", 30.0, 1.0)]
    assert profiling.idle_gaps(ops) == [(10.0, 2.0), (23.0, 7.0)]
    assert profiling.idle_gaps(ops, min_us=5.0) == [(23.0, 7.0)]
    assert profiling.idle_gaps(ops, t0=-4.0, t1=40.0, min_us=3.0) == [
        (-4.0, 4.0), (23.0, 7.0), (31.0, 9.0)]


def test_read_gaps():
    """The gap after each device-to-host copy: an early-exit read."""
    ops = [("k", 0.0, 10.0), ("Memcpy DtoH (Device -> Pageable)", 10.0, 1.0),
           ("k", 40.0, 5.0), ("Memcpy DtoH (Device -> Pageable)", 45.0, 1.0),
           ("k", 46.0, 5.0), ("Memcpy HtoD", 60.0, 1.0), ("k", 90.0, 1.0)]
    assert profiling.read_gaps(ops) == [(11.0, 29.0)]
    with pytest.raises(ValueError, match="card alone"):
        with profiling.trace("unused", device="cpu", host=False):
            pass


def test_compile_count_guard(monkeypatch, tmp_path):
    """The guard counts nvcc processes started by _build.build; a build of a
    library that exists already starts none."""
    started = []

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kw):
            started.append(cmd)
            self.out = Path(cmd[cmd.index("-o") + 1])

        def communicate(self):
            self.out.write_bytes(b"lib")
            return "ptxas info    : Used 8 registers", None

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", FakeProc)
    target = ("siso", ("-DSISO_MODE=0", "-DSISO_CHAN=1", "-DSISO_EXT=3"))
    with pytest.raises(AssertionError, match="unexpected kernel builds"):
        with profiling.compile_count_guard(max_new=0):
            _build.build((target,))
    with profiling.compile_count_guard(max_new=0):
        lib = _build.build((target,))[target]
    assert len(started) == 1 and lib.exists()
    assert lib.with_suffix(".log").read_text().startswith("ptxas info")
    with profiling.compile_count_guard(max_new=1):
        _build.build((("siso", ("-DSISO_MODE=1",)),))


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111exact_pass1ILi0ELb1E13__nv_bfloat16aEEvPKT1_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_111exact_pass1ILi0ELb1E13__nv_bfloat16aEEvPKT1_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 80 registers, used 1 barriers, 8704 bytes smem, 452 bytes cmem[0]
ptxas info    : Compiling entry function 'ring_xch' for 'sm_90a'
ptxas info    : Function properties for ring_xch
    16 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 48 registers, 400 bytes cmem[0]
"""


def test_parse_ptxas():
    got = profiling.parse_ptxas(PTXAS_LOG)
    assert [(r["function"], r["registers"], r["smem"], r["spill_stores"],
             r["spill_loads"], r["stack"]) for r in got] == [
        ("exact_pass1", 80, 8704, 0, 0, 0), ("ring_xch", 48, 0, 4, 8, 16)]


# ---------------------------------------------------------------------------
# supervisor
# ---------------------------------------------------------------------------

_WORKER = r"""
import os, pathlib, signal, sys
from turbotpu_torch.decoder.turbo import DecoderConfig
from turbotpu_torch.harness.ber import SimConfig, simulate_ber
results, marker = sys.argv[1], pathlib.Path(sys.argv[2])
cfg = SimConfig(name="sup", K=40, B=8, ebn0_db_grid=(8.0, 9.0, 10.0),
                decoder=DecoderConfig(K=40, n_iters=2), use_crc=False,
                min_frame_errors=1, max_frames=16, seed=3)
first = SimConfig(**{**cfg.__dict__, "ebn0_db_grid": (8.0,)})
simulate_ber(first, results_path=results, verbose=False, device="cpu")
if not marker.exists():
    marker.write_text("died once")
    os.kill(os.getpid(), signal.SIGKILL)      # exact own PID
simulate_ber(cfg, results_path=results, verbose=False, device="cpu")
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_supervise_relaunches_and_resumes(tmp_path):
    """A sweep child that kills itself after its first grid point: the
    supervisor relaunches it once, and the relaunch resumes from the JSONL
    checkpoint (the first point is not recomputed)."""
    worker = tmp_path / "sweep.py"
    worker.write_text(_WORKER)
    results, marker = tmp_path / "r.jsonl", tmp_path / "fault_injected"
    restarts = supervise([[sys.executable, str(worker), str(results),
                           str(marker)]], max_restarts=2, env=_env(),
                         results_path=str(results), verbose=False)
    assert restarts == 1 and marker.exists()
    recs = [json.loads(line) for line in results.read_text().splitlines()]
    assert sorted(r["ebn0_db"] for r in recs) == [8.0, 9.0, 10.0]


def test_supervise_gives_up_after_max_restarts(tmp_path):
    with pytest.raises(RuntimeError, match="max_restarts=1"):
        supervise([[sys.executable, "-c", "import sys; sys.exit(3)"]],
                  max_restarts=1, verbose=False)


def test_cli_supervise_runs_a_port_command(tmp_path, capsys):
    """`cli supervise -- ber ...` runs `python -m turbotpu_torch.cli ber`
    as its child (here on the CPU at a tiny size)."""
    results = tmp_path / "b.jsonl"
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        rc = cli.main(["supervise", "--results", str(results), "--",
                       "ber", "--device", "cpu", "--k", "40", "--batch", "8",
                       "--iters", "2", "--ebn0", "8.0",
                       "--min-frame-errors", "1", "--max-frames", "8",
                       "--results", str(results)])
    finally:
        os.chdir(cwd)
    assert rc == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "restarts": 0, "ok": True}
    assert len(results.read_text().splitlines()) == 1


# ---------------------------------------------------------------------------
# scaling
# ---------------------------------------------------------------------------

def test_bench_scaling_structure_on_a_local_mesh():
    """data 1 and 2 on a local mesh of the CPU: each mesh's hard bits equal
    the one-row decode of the same codewords; nothing is timed here."""
    cfg = DecoderConfig(K=40, n_iters=2, siso="cuda", mode="maxlog")
    recs = scaling.bench_scaling(cfg, 3, [1, 2], device="cpu")
    assert [(r["devices"], r["B"], r["physical_devices"]) for r in recs] == [
        (1, 3, 1), (2, 6, 1)]
    assert all(r["rows_equal_one_device"] for r in recs)
    assert all(r["mbit_per_s"] is None and r["efficiency"] is None
               for r in recs)


def test_bench_scaling_needs_a_card_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scaling.bench_scaling(DecoderConfig(K=40), 2, [1])


# ---------------------------------------------------------------------------
# the decode loop's early exit (F3)
# ---------------------------------------------------------------------------

EXIT_CASES = {
    "crc-nii-int8": dict(K=168, n_iters=6, mode="maxlog", ext_scale=0.75,
                         siso="pallas", nii=True, window=32,
                         io_dtype="bfloat16", ext_dtype="int8",
                         early_term="crc"),
    "sign-exact-f32": dict(K=168, n_iters=6, mode="maxlog", ext_scale=0.75,
                           siso="pallas", window=32, early_term="sign"),
}


@pytest.mark.parametrize("case", list(EXIT_CASES))
def test_early_exit_loop_matches_jax(case):
    """Codewords converge at different iterations (iteration counts spread)
    and the batch exits before n_iters: hard bits, per-codeword iteration
    counts equal to the JAX package's lax.while_loop, L within 1e-4."""
    jcfg = JaxConfig(**EXIT_CASES[case])
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    arrays = [x.numpy() for x in make_decode_inputs(
        168, 6, seed=14 if jcfg.early_term == "crc" else 12, ebn0_db=1.6,
        with_crc=jcfg.early_term == "crc")]
    hj, ij, Lj = jax_decode(*[jnp.asarray(a) for a in arrays], jcfg)
    ht, it, Lt = turbo_decode(*arrays, tcfg, device="cpu")
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), atol=1e-4, rtol=0)
    assert len(set(it.tolist())) > 1 and it.max() < jcfg.n_iters

