"""The port's own copies of the framework-free modules (spec tables, CRC,
encoder, scalar BCJR) against the JAX package's, bit for bit; and the
port's import hygiene: no module of turbotpu_torch, and not chip_smoke.py,
imports jax or the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import turbotpu.golden.numpy_ref as jref
import turbotpu.spec as jspec
import turbotpu_torch.golden.numpy_ref as tref
import turbotpu_torch.spec as tspec


@pytest.mark.parametrize("table", ["next_state", "parity", "prev_state",
                                   "prev_parity", "tail_bit"])
def test_trellis_tables_equal(table):
    a, b = getattr(jspec.TRELLIS, table), getattr(tspec.TRELLIS, table)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_qpp_tables_equal_for_every_legal_k():
    assert tspec.LEGAL_K == jspec.LEGAL_K
    assert tspec.QPP_PARAMS == jspec.QPP_PARAMS
    for K in jspec.LEGAL_K:
        np.testing.assert_array_equal(tspec.qpp_perm(K), jspec.qpp_perm(K))
        np.testing.assert_array_equal(tspec.qpp_inv(K), jspec.qpp_inv(K))
    assert tspec.nearest_legal_k(1000) == jspec.nearest_legal_k(1000)


@pytest.mark.parametrize("poly", ["CRC24A_POLY", "CRC24B_POLY"])
def test_crc_equal(poly):
    pj, pt = getattr(jspec, poly), getattr(tspec, poly)
    assert pj == pt
    for K in (16, 144, 6120):
        np.testing.assert_array_equal(tspec.crc_matrix(K, pt),
                                      jspec.crc_matrix(K, pj))
    bits = np.random.default_rng(0).integers(0, 2, 144).astype(np.int8)
    framed = tspec.crc_attach(bits, pt)
    np.testing.assert_array_equal(framed, jspec.crc_attach(bits, pj))
    assert tspec.crc_check(framed, pt) and jspec.crc_check(framed, pj)
    framed[3] ^= 1
    assert not tspec.crc_check(framed, pt)


@pytest.mark.parametrize("K", [40, 168, 6144])
def test_turbo_encode_equal(K):
    bits = np.random.default_rng(K).integers(0, 2, K).astype(np.int8)
    got = tref.turbo_encode(bits, tspec.qpp_perm(K))
    want = jref.turbo_encode(bits, jspec.qpp_perm(K))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", ["logmap", "maxlog"])
def test_scalar_bcjr_equal(mode):
    rng = np.random.default_rng(5)
    K = 40
    ls, lp, la = rng.normal(size=K + 3), rng.normal(size=K + 3), rng.normal(size=K)
    for g, w in zip(tref.bcjr_siso(ls, lp, la, mode),
                    jref.bcjr_siso(ls, lp, la, mode)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("K", [40, 41, 320, 1280, 2281, 5114])
def test_umts_tables_equal(K):
    perm = tspec.umts_perm(K)
    assert perm.dtype == jspec.umts_perm(K).dtype
    np.testing.assert_array_equal(perm, jspec.umts_perm(K))
    np.testing.assert_array_equal(tspec.umts_inv(K), jspec.umts_inv(K))
    assert sorted(perm) == list(range(K))
    np.testing.assert_array_equal(perm[tspec.umts_inv(K)], np.arange(K))


def test_umts_illegal_k_raises():
    for K in (39, 5115):
        with pytest.raises(ValueError):
            tspec.umts_perm(K)
        with pytest.raises(ValueError):
            jspec.umts_perm(K)


@pytest.mark.parametrize("K", [40, 168, 1024, 6144])
def test_rate_match_maps_equal(K):
    import turbotpu.spec.rate_match  # noqa: F401  (the package shadows the
    import turbotpu_torch.spec.rate_match  # noqa: F401  module with a function)
    import sys
    jrm = sys.modules["turbotpu.spec.rate_match"]
    trm = sys.modules["turbotpu_torch.spec.rate_match"]
    for g, w in zip(trm.sub_block_maps(K + 4), jrm.sub_block_maps(K + 4)):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(trm.circular_buffer_map(K), jrm.circular_buffer_map(K)):
        np.testing.assert_array_equal(g, w)
    for E, rv, n_cb, F in ((2 * K, 0, None, 0), (4 * K, 2, None, 0),
                           (K + 50, 3, 2 * K, 0), (3 * K, 1, None, 8)):
        got = trm.select_indices(K, E, rv, n_cb, F)
        want = jrm.select_indices(K, E, rv, n_cb, F)
        assert got.dtype == want.dtype and len(got) == E
        np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(K)
    d = [rng.integers(0, 2, K + 4).astype(np.int8) for _ in range(3)]
    np.testing.assert_array_equal(trm.rate_match(*d, 2 * K, 1),
                                  jrm.rate_match(*d, 2 * K, 1))
    llr = rng.normal(size=4 * K)
    for g, w in zip(trm.de_rate_match(llr, K, 2), jrm.de_rate_match(llr, K, 2)):
        np.testing.assert_array_equal(g, w)


def test_public_names_equal_the_reference():
    """Every name the JAX package exports is exported by the port, and is
    the port's own (no JAX object behind it)."""
    import turbotpu
    import turbotpu_torch
    assert turbotpu_torch.__all__ == turbotpu.__all__
    ns = {}
    exec("from turbotpu_torch import *", ns)
    for name in turbotpu.__all__:
        obj = getattr(turbotpu_torch, name)
        assert ns[name] is obj
        if name != "__version__":
            assert obj.__module__.startswith("turbotpu_torch."), name
    with pytest.raises(AttributeError):
        turbotpu_torch.no_such_name


REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(str(p.relative_to(REPO)) for p in
                    (REPO / "turbotpu_torch").rglob("*.py")) + ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "turbotpu")


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_source_imports_no_jax(path):
    """Every import statement of every module of the port (the harness,
    SISO variants, golden and oracle modules of the last slice included)
    names neither jax nor the JAX package; relative imports stay inside the
    port."""
    tree = ast.parse((REPO / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if n.split(".")[0] in FORBIDDEN]
        assert not bad, f"{path} imports {bad}"


def test_every_port_module_imports_without_jax():
    """Importing every module of the port in a fresh interpreter loads
    neither jax nor the JAX package."""
    modules = [p[:-3].replace("/", ".").removesuffix(".__init__")
               for p in PORT_FILES if p.startswith("turbotpu_torch/")]
    code = ("import sys\n"
            f"for m in {modules!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=300)
