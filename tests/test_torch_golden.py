"""The port's golden and oracle layer against the JAX package's, on the CPU:
golden/numpy_ref.py, golden/cpp_ref.py (with its byte copy of golden.cc),
spec/rate_match_ref.py and spec/umts_ref.py.

Inputs are made from a seed with numpy and handed to both sides.  These
modules are numpy (and C++) on both sides: results are held equal, the
decoders' L to 1e-9 between the numpy and the C++ model (as
tests/golden/test_golden_equiv.py holds the reference's).
"""

import itertools
from pathlib import Path

import numpy as np
import pytest

from turbotpu.golden import cpp_ref as j_cpp
from turbotpu.golden import numpy_ref as j_npr
from turbotpu.spec.rate_match_ref import rate_match_ref as j_rm_ref
from turbotpu.spec.umts_ref import umts_perm_ref as j_umts_ref
from turbotpu_torch.golden import cpp_ref, numpy_ref
from turbotpu_torch.spec.crc import CRC24A_POLY, crc_attach
from turbotpu_torch.spec.qpp import qpp_inv, qpp_perm
from turbotpu_torch.spec.rate_match import select_indices
from turbotpu_torch.spec.rate_match_ref import rate_match_ref
from turbotpu_torch.spec.umts import umts_inv, umts_perm
from turbotpu_torch.spec.umts_ref import umts_perm_ref

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", ["golden.cc", "Makefile"])
def test_cpp_sources_are_byte_copies(name):
    assert ((REPO / "turbotpu_torch/golden/cpp" / name).read_bytes()
            == (REPO / "turbotpu/golden/cpp" / name).read_bytes())


def _noisy_llrs(K, seed, ebn0_db=1.0, umts=False, with_crc=False):
    rng = np.random.default_rng(seed)
    if with_crc:
        bits = crc_attach(rng.integers(0, 2, K - 24).astype(np.int8),
                          CRC24A_POLY)
    else:
        bits = rng.integers(0, 2, K).astype(np.int8)
    perm, inv = (umts_perm(K), umts_inv(K)) if umts else (qpp_perm(K),
                                                         qpp_inv(K))
    parts = numpy_ref.turbo_encode(bits, perm)
    enc = np.concatenate(parts).astype(np.float64)
    sigma = np.sqrt(1 / (2 * 10 ** (ebn0_db / 10) / 3))
    y = (1 - 2 * enc) + sigma * rng.normal(size=enc.shape)
    llr = 2 * y / sigma ** 2
    ofs = np.cumsum([0, K, K, K, 6, 6])
    return bits, perm, inv, [llr[ofs[i]:ofs[i + 1]] for i in range(5)]


@pytest.mark.parametrize("K,umts", [(40, False), (512, False), (40, True),
                                    (160, True)])
def test_numpy_encode_and_muxes_equal_reference(K, umts):
    bits, perm, _, llrs = _noisy_llrs(K, seed=K, umts=umts)
    enc = numpy_ref.turbo_encode(bits, perm)
    for x, y in zip(enc, j_npr.turbo_encode(bits, perm)):
        np.testing.assert_array_equal(x, y)
    for parts in (enc, llrs):
        wire = numpy_ref.umts_mux(*parts)
        np.testing.assert_array_equal(wire, j_npr.umts_mux(*parts))
        assert len(wire) == 3 * K + 12
        for x, y, z in zip(numpy_ref.umts_demux(wire),
                           j_npr.umts_demux(wire), parts):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)
        for x, y in zip(numpy_ref.lte_mux(*parts), j_npr.lte_mux(*parts)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("mode", ["logmap", "maxlog", "linlog"])
@pytest.mark.parametrize("K", [40, 104])
def test_numpy_decode_equals_reference(K, mode):
    """The whole-decoder golden: the same scalar arithmetic, equal
    outputs."""
    _, perm, inv, p = _noisy_llrs(K, seed=3)
    h1, it1, L1 = numpy_ref.turbo_decode(*p, perm, inv, n_iters=3, mode=mode,
                                         ext_scale=0.75)
    h2, it2, L2 = j_npr.turbo_decode(*p, perm, inv, n_iters=3, mode=mode,
                                     ext_scale=0.75)
    np.testing.assert_array_equal(h1, h2)
    np.testing.assert_array_equal(L1, L2)
    assert it1 == it2 == 3


@pytest.mark.parametrize("mode", ["logmap", "maxlog", "linlog"])
@pytest.mark.parametrize("K", [40, 104])
def test_cpp_decode_equals_numpy_and_reference(K, mode):
    """The C++ golden equals the reference's build of the same source, and
    the numpy golden to 1e-9 (max-log, log-MAP: the numpy golden has no
    linlog correction, it takes log-MAP's for every mode but max-log)."""
    _, perm, inv, p = _noisy_llrs(K, seed=4)
    h1, _, L1 = cpp_ref.turbo_decode(*p, perm, inv, n_iters=4, mode=mode)
    h3, _, L3 = j_cpp.turbo_decode(*p, perm, inv, n_iters=4, mode=mode)
    np.testing.assert_array_equal(h1, h3)
    np.testing.assert_array_equal(L1, L3)
    if mode != "linlog":
        h2, _, L2 = numpy_ref.turbo_decode(*p, perm, inv, n_iters=4,
                                           mode=mode)
        np.testing.assert_array_equal(h1, h2)
        np.testing.assert_allclose(L1, L2, atol=1e-9)


def test_cpp_crc_early_termination_matches_numpy():
    K = 104
    bits, perm, inv, p = _noisy_llrs(K, seed=11, ebn0_db=3.0, with_crc=True)
    h1, it1, _ = numpy_ref.turbo_decode(*p, perm, inv, n_iters=8,
                                        crc_poly=CRC24A_POLY)
    h2, it2, _ = cpp_ref.turbo_decode(*p, perm, inv, n_iters=8,
                                      crc_poly=CRC24A_POLY)
    assert (h1 == h2).all() and (h1 == bits).all()
    assert it1 == it2 < 8
    assert cpp_ref.crc_check(bits, CRC24A_POLY)
    bad = bits.copy()
    bad[5] ^= 1
    assert not cpp_ref.crc_check(bad, CRC24A_POLY)


@pytest.mark.parametrize("K,umts", [(40, False), (64, False), (512, False),
                                    (40, True), (160, True)])
def test_cpp_encoder_and_muxes_equal_numpy(K, umts):
    bits, perm, _, llrs = _noisy_llrs(K, seed=K + 1, umts=umts)
    for x, y, z in zip(cpp_ref.turbo_encode(bits, perm),
                       numpy_ref.turbo_encode(bits, perm),
                       j_cpp.turbo_encode(bits, perm)):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
    wire = cpp_ref.umts_mux(*llrs)
    np.testing.assert_array_equal(wire, numpy_ref.umts_mux(*llrs))
    for x, y in zip(cpp_ref.umts_demux(wire), numpy_ref.umts_demux(wire)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("mode", ["logmap", "maxlog"])
def test_cpp_siso_equals_numpy(mode):
    rng = np.random.default_rng(8)
    ls, lp, la = rng.normal(size=43) * 3, rng.normal(size=43) * 3, \
        rng.normal(size=40) * 3
    L1, Le1 = cpp_ref.bcjr_siso(ls, lp, la, mode)
    L2, Le2 = numpy_ref.bcjr_siso(ls, lp, la, mode)
    np.testing.assert_allclose(L1, L2, atol=1e-9)
    np.testing.assert_allclose(Le1, Le2, atol=1e-9)


def _d_symbol_streams(K):
    D = K + 4
    return (list(range(D)), list(range(D, 2 * D)), list(range(2 * D, 3 * D)))


@pytest.mark.parametrize("K,F", [(40, 0), (104, 0), (512, 0), (6144, 0),
                                 (40, 4), (512, 28), (6144, 63)])
def test_rate_match_oracle_equals_reference_and_index_maps(K, F):
    """The literal TS 36.212 while-loop oracle: equal to the reference's
    copy, and the port's index-map rate matching equal to it."""
    d0, d1, d2 = _d_symbol_streams(K)
    for E, rv in itertools.product((17, K, 3 * K + 12, 4 * K), range(4)):
        got = rate_match_ref(d0, d1, d2, E, rv, F=F)
        assert got == j_rm_ref(d0, d1, d2, E, rv, F=F), (K, E, rv, F)
        assert select_indices(K, E, rv, F=F).tolist() == got, (K, E, rv, F)


# Every (R, C-vs-p) regime and the inter-row-pattern switch points of
# TS 25.212 (the reference's tests/unit/test_umts.py grid), with the range
# ends.
UMTS_KS = (list(range(40, 202)) + [240, 320, 480, 481, 500, 529, 530, 531,
           1000, 1528, 2280, 2281, 2400, 2480, 2481, 3160, 3161, 3210, 3211,
           4000, 5000, 5113, 5114])


@pytest.mark.parametrize("K", UMTS_KS)
def test_umts_oracle_equals_reference_and_production(K):
    ref = umts_perm_ref(K)
    assert ref == j_umts_ref(K)
    assert list(umts_perm(K)) == ref


def test_umts_oracle_refuses_illegal_sizes():
    for K in (39, 5115):
        with pytest.raises(ValueError):
            umts_perm_ref(K)
