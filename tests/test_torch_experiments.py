"""The evidence layer (turbotpu_torch/experiments/) against the JAX
package's experiments/ programs, on the CPU.

The JAX programs are scripts, loaded from their files.  Inputs are made
from a seed with numpy on both sides; where a JAX program reaches its
Pallas kernel it runs in interpret mode, and the port's decoders take their
kernels' plain versions because the tensors lie on the CPU.  The card runs
are chip_smoke.py's phase `experiments`.
"""

import dataclasses
import importlib.util
import math
import sys
from pathlib import Path

import numpy as np
import pytest

from turbotpu.decoder import bucketing as jbucket
from turbotpu.decoder.turbo import DecoderConfig as JaxConfig
from turbotpu_torch import convert
from turbotpu_torch.experiments import (common, flagship_tuning, k_sweep,
                                        nii_window_sweep)
from turbotpu_torch.experiments.run_acceptance import (compare, errors_of,
                                                       fer_band, point_key)
from turbotpu_torch.harness.bench import make_decode_inputs

REPO = Path(__file__).resolve().parents[1]


def _jax_experiment(name):
    """A module of the JAX package's experiments/ directory (scripts, not a
    package), loaded from its file; its siblings import each other by name,
    so the directory goes on the path."""
    if str(REPO / "experiments") not in sys.path:
        sys.path.insert(0, str(REPO / "experiments"))
    spec = importlib.util.spec_from_file_location(
        f"jax_experiments_{name}", REPO / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


FER_CASES = {
    # (JAX DecoderConfig fields, Eb/N0): the flagship's options at small K
    "k40-nii-bf16": (dict(K=40, n_iters=6, mode="maxlog", ext_scale=0.75,
                          siso="pallas", io_dtype="bfloat16", nii=True), 0.5),
    "k168-nii-w32-bf16-int8": (dict(K=168, n_iters=6, mode="maxlog",
                                    ext_scale=0.75, siso="pallas",
                                    io_dtype="bfloat16", nii=True, window=32,
                                    ext_dtype="int8"), 0.5),
}


@pytest.mark.parametrize("case", list(FER_CASES))
def test_fer_run_counts_equal_jax(case):
    """fer_run: the same frames (the reference's numpy generation at the
    same seeds) give identical bit and frame error counts, B=8, two
    batches; tolerance 0."""
    fields, ebn0 = FER_CASES[case]
    jcfg = JaxConfig(**fields)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    assert tcfg.siso == "cuda"
    jax_nws = _jax_experiment("nii_window_sweep")
    want = jax_nws.fer_run(jcfg, jcfg.K, 8, ebn0, 2, seed0=777)
    got = nii_window_sweep.fer_run(tcfg, tcfg.K, 8, ebn0, 2, seed0=777,
                                   device="cpu")
    assert got == want
    assert got[0] > 0                   # the point has errors to count


def test_fer_batch_is_the_reference_frames():
    """fer_run's batches (harness.bench.make_decode_inputs) are the
    reference's bits and noise: at a high Eb/N0 the signs of the systematic
    stream are the transmitted bits, and the rows repeat every 64."""
    (ls, *_), bits = make_decode_inputs(40, 130, 5, 20.0, return_bits=True)
    assert bits.shape == (130, 40) and ls.shape == (130, 40)
    np.testing.assert_array_equal((ls.numpy() < 0).astype(np.int8), bits)
    np.testing.assert_array_equal(bits[:64], bits[64:128])
    rng = np.random.default_rng(5)
    np.testing.assert_array_equal(bits[0],
                                  rng.integers(0, 2, 40).astype(np.int8))


def test_fer_run_reuses_cached_frames():
    cfg = convert.config_from_dict(dataclasses.asdict(JaxConfig(
        K=40, n_iters=2, mode="maxlog", siso="pallas")))
    cache = {}
    a = nii_window_sweep.fer_run(cfg, 40, 4, 0.5, 2, 3, "cpu", cache)
    assert len(cache) == 2
    assert nii_window_sweep.fer_run(cfg, 40, 4, 0.5, 2, 3, "cpu", cache) == a


def _curve(counts, frames=1000):
    return {str(e): {"fer": fe / frames} for e, fe in counts.items()}


def test_penalties_on_hand_made_counts():
    """The slope of the reference curve between two points and each row's
    penalty at every point, exact to 1e-12 against the arithmetic done by
    hand; a zero count gives no entry."""
    ref = _curve({0.6: 100, 0.7: 10, 0.8: 1})
    rows = {"ref": ref, "a": _curve({0.6: 200, 0.7: 10, 0.8: 0}),
            "b": _curve({0.6: 50, 0.7: 20, 0.8: 4})}
    slope, pen = common.penalties(rows, "ref", (0.6, 0.7, 0.8), 0.6, 0.8)
    assert slope == pytest.approx(10.0, abs=1e-12)   # 2 decades / 0.2 dB
    assert pen["a"] == pytest.approx({"0.6": math.log10(2) / 10,
                                      "0.7": 0.0}, abs=1e-12)
    assert pen["b"] == pytest.approx({"0.6": -math.log10(2) / 10,
                                      "0.7": math.log10(2) / 10,
                                      "0.8": math.log10(4) / 10}, abs=1e-12)
    assert common.fer_slope(_curve({0.6: 0, 0.7: 1}), 0.6, 0.7) is None
    assert common.db_penalty(rows["a"], ref, (0.6,), None) == {}


def test_one_frame_resolution_on_hand_made_counts():
    """one_frame_db: log10((n + 1) / n) over the slope for the reference's
    n frame errors at each point, exact to 1e-12; no entry at n = 0 or
    without a slope."""
    ref = {"0.6": {"frame_errs": 100}, "0.7": {"frame_errs": 9},
           "0.8": {"frame_errs": 0}}
    got = common.one_frame_db(ref, (0.6, 0.7, 0.8), 10.0)
    assert got == pytest.approx({"0.6": math.log10(1.01) / 10,
                                 "0.7": math.log10(10 / 9) / 10}, abs=1e-12)
    assert common.one_frame_db(ref, (0.6,), None) == {}


def test_flagship_ab_chooses_only_a_separated_type():
    """flagship_tuning's A/B: spread's median and range of hand-made
    readings, and a type chosen only where its slowest reading beats every
    other type's fastest."""
    s = flagship_tuning.spread([3.0, 1.0, 2.0, 4.0, 5.0])
    assert s == {"min": 1.0, "median": 3.0, "max": 5.0,
                 "spread_pct": pytest.approx(400 / 3, abs=1e-12)}
    ab = {t: flagship_tuning.spread(r) for t, r in
          {"bfloat16": [9.0, 10.0], "int8": [10.5, 11.0],
           "float8_e4m3fn": [11.5, 12.0]}.items()}
    assert flagship_tuning.separated(ab) == "float8_e4m3fn"
    ab["int8"] = flagship_tuning.spread([10.5, 11.6])
    assert flagship_tuning.separated(ab) is None


def test_penalties_equal_the_reference_arithmetic():
    """The shared helper computes what experiments/ext_dtype_ber.py computes
    inline: slope from the first and last point, log10 ratio over it."""
    rng = np.random.default_rng(1)
    pts = (0.6, 0.7, 0.8)
    bf = _curve(dict(zip(pts, rng.integers(5, 500, 3))))
    q = _curve(dict(zip(pts, rng.integers(5, 500, 3))))
    f0, f1 = bf["0.6"]["fer"], bf["0.8"]["fer"]
    slope = (np.log10(f0) - np.log10(f1)) / (0.8 - 0.6)
    want = {str(e): (np.log10(q[str(e)]["fer"]) - np.log10(bf[str(e)]["fer"]))
            / slope for e in pts}
    _, pen = common.penalties({"bfloat16": bf, "int8": q}, "bfloat16", pts,
                              0.6, 0.8)
    assert pen["int8"] == pytest.approx(want, rel=1e-12)


def test_fer_band_on_hand_made_counts():
    """|rate difference| and 4 sigma of the pooled binomial, to 1e-15."""
    diff, band = fer_band(30, 1000, 10, 1000)
    p = 40 / 2000
    assert diff == pytest.approx(0.02, abs=1e-15)
    assert band == pytest.approx(4 * math.sqrt(p * (1 - p) * 2 / 1000),
                                 abs=1e-15)
    assert fer_band(0, 4096, 0, 4096) == (0.0, 0.0)
    diff, band = fer_band(1, 4096, 0, 4096)
    assert 0 < diff < band
    # a 10-sigma excess is outside
    d, b = fer_band(200, 1000, 100, 1000)
    assert d > b


def test_acceptance_points_compare_to_the_reference_file():
    """Every kind of record of the acceptance run finds its point in
    results/tpu_accept.jsonl; the reference against itself lies inside."""
    import json
    ref = [json.loads(ln) for ln in
           (REPO / "results" / "tpu_accept.jsonl").read_text().splitlines()]
    rows = compare(ref, ref)
    assert len(rows) == len(ref) == 26
    assert all(r["inside"] and r["rate_diff"] == 0 for r in rows)
    c5 = next(r for r in ref if "mesh" in r)
    c6 = next(r for r in ref if "tbs" in r)
    assert point_key(c5) == ("c5", 0.8) and errors_of(c5) == (4, 4096)
    assert errors_of(c6) == (21, 416)
    far = dict(c5, frame_errs=400)
    assert not compare([far], ref)[0]["inside"]
    with pytest.raises(KeyError):
        compare([dict(c6, ebn0_db=9.0)], ref)


@pytest.mark.parametrize("grouped", [True, False])
def test_k_sweep_mixed_tables_equal_jax(grouped):
    """k_sweep's mixed-K tables at C3's bucket equal the JAX package's
    tables (decoder/bucketing) exactly, at B=1024 and C3's 128."""
    for B in (1024, 128):
        Ks = [k_sweep.C3_MIX[i % 3] for i in range(B)]
        got = k_sweep.mixed_tables(5114, B, k_sweep.C3_MIX, grouped,
                                   device="cpu")
        if grouped:
            want = jbucket.grouped_perm_tables(Ks, 5114, "umts")
            for g, w in zip(got["group_tables"], want):
                np.testing.assert_array_equal(g, np.asarray(w))
        else:
            want = jbucket.embedded_perm_tables(Ks, 5114, "umts")
            np.testing.assert_array_equal(got["perm_b"], np.asarray(want[0]))
            np.testing.assert_array_equal(got["inv_b"], np.asarray(want[1]))


def test_programs_write_to_their_records_directory():
    """No program's default output lies in experiments/ or results/, where
    the TPU records are."""
    p = common.out_path(None, "k_sweep")
    assert p == REPO / "turbotpu_torch" / "experiments" / "records" / \
        "k_sweep.json"
    assert common.out_path("x.json", "k_sweep") == Path("x.json")
