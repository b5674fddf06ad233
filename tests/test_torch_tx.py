"""The port's transmit chain, rate matching and QAM against the JAX package's,
on the CPU.

Deterministic stages get the same numpy inputs on both sides and must agree
bit for bit (LLRs out of a demapper within 1e-5 relative: the two frameworks
evaluate 10 ** (dB / 10) in different precisions).  The random stages draw
PyTorch's numbers, not JAX's, and are held to closed forms.
"""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import turbotpu.spec as jspec
from turbotpu.tx import chain as jchain
from turbotpu.tx import qam as jqam
from turbotpu.tx import rate_match_jax as jrm
import turbotpu_torch.spec as tspec
from turbotpu_torch.spec.rate_match import de_rate_match as np_de_rate_match
from turbotpu_torch.spec.rate_match import select_indices
from turbotpu_torch.tx import chain, qam
from turbotpu_torch.tx import rate_match as trm

T = torch.from_numpy


def _gen(seed=0):
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return g


def _bits(shape, seed):
    return np.random.default_rng(seed).integers(0, 2, shape).astype(np.int8)


@pytest.mark.parametrize("poly", ["CRC24A_POLY", "CRC24B_POLY"])
@pytest.mark.parametrize("n", [16, 1000])
def test_crc_attach_batch_equal(n, poly):
    bits = _bits((5, n), n)
    got = chain.crc_attach_batch(T(bits), getattr(tspec, poly))
    want = jchain.crc_attach_batch(jnp.asarray(bits), getattr(jspec, poly))
    assert got.dtype == torch.int8 and got.shape == (5, n + 24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for row in got.numpy():
        assert tspec.crc_check(row, getattr(tspec, poly))


@pytest.mark.parametrize("K,B,interleaver", [
    (40, 7, "lte"), (168, 5, "lte"), (1024, 3, "lte"), (320, 4, "umts"),
    (41, 4, "umts"), (6144, 1, "lte")])
def test_turbo_encode_equal(K, B, interleaver):
    """The matrix-product encoder against the JAX package's scan encoder,
    tail bits included; K=6144 covers the widest feedback matrix."""
    perm = (tspec.qpp_perm if interleaver == "lte" else tspec.umts_perm)(K)
    bits = _bits((B, K), K)
    bits[0, :] = 0
    bits[0, K // 2] = 1          # one impulse: the register's free response
    got = chain.turbo_encode(T(bits), perm)
    want = jchain.turbo_encode(jnp.asarray(bits), perm)
    assert [tuple(g.shape) for g in got] == [(B, K)] * 3 + [(B, 6)] * 2
    for g, w in zip(got, want):
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_gf2_products_refuse_tf32_only_on_a_card():
    chain.require_exact_matmul(torch.zeros(2))       # a CPU tensor: no-op
    assert chain.gen_payload(_gen(), 3, 50).shape == (3, 50)
    p = chain.gen_payload(_gen(1), 64, 512)
    assert p.dtype == torch.int8 and set(p.unique().tolist()) == {0, 1}
    assert abs(float(p.float().mean()) - 0.5) < 0.02


@pytest.mark.parametrize("wire", ["lte", "umts"])
def test_mux_demux_equal(wire):
    K, B = 40, 3
    parts = [_bits((B, K), i) for i in range(3)] + [_bits((B, 6), 7),
                                                    _bits((B, 6), 8)]
    mux, demux = getattr(trm, f"{wire}_mux"), getattr(trm, f"{wire}_demux")
    jmux, jdemux = (getattr(jrm, f"{wire}_mux_jax"),
                    getattr(jrm, f"{wire}_demux_jax"))
    flat = mux(*map(T, parts))
    np.testing.assert_array_equal(
        flat.numpy(), np.asarray(jmux(*map(jnp.asarray, parts))))
    llr = np.random.default_rng(3).normal(size=flat.shape).astype(np.float32)
    for g, w in zip(demux(T(llr)), jdemux(jnp.asarray(llr))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, p in zip(demux(flat), parts):
        np.testing.assert_array_equal(g.numpy(), p)


RM_CASES = [  # K, E, n_cb, F
    (40, 66, None, 0),          # punctured
    (40, 132, None, 0),         # exactly the mother rate
    (40, 200, None, 0),         # repeated, under two wraps
    (40, 700, None, 0),         # heavy repetition: up to six LLRs a position
    (168, 336, None, 0),
    (40, 150, 96, 0),           # limited circular buffer
    (104, 400, None, 16),       # filler bits skipped
]


@pytest.mark.parametrize("K,E,n_cb,F", RM_CASES)
@pytest.mark.parametrize("rv", [0, 1, 2, 3])
def test_rate_match_and_de_rate_match_equal(K, E, n_cb, F, rv):
    """rate_match is a gather; de_rate_match sums repeats wrap after wrap, in
    the order a sequential scatter-add meets them: bit-identical to np.add.at
    in fp32, to the numpy original in its float64, and to the JAX package's
    scatter-add on the CPU."""
    rng = np.random.default_rng(K + E + rv)
    d = rng.normal(size=(3, 3 * (K + 4))).astype(np.float32)
    tx = trm.rate_match(T(d), E, rv, n_cb, F)
    np.testing.assert_array_equal(
        tx.numpy(), np.asarray(jrm.rate_match_jax(jnp.asarray(d), E, rv, n_cb, F)))
    llr = rng.normal(size=(3, E)).astype(np.float32)
    got = trm.de_rate_match(T(llr), K, rv, n_cb, F).numpy()
    got64 = trm.de_rate_match(T(llr.astype(np.float64)), K, rv, n_cb, F).numpy()
    idx = select_indices(K, E, rv, n_cb, F)
    for b in range(3):
        seq = np.zeros(3 * (K + 4), np.float32)
        np.add.at(seq, idx, llr[b])               # sequential fp32 scatter-add
        np.testing.assert_array_equal(got[b], seq)
        # the numpy original accumulates in float64
        np.testing.assert_array_equal(
            got64[b], np.concatenate(np_de_rate_match(llr[b], K, rv, n_cb, F)))
    np.testing.assert_array_equal(
        got, np.asarray(jrm.de_rate_match_jax(jnp.asarray(llr), K, rv, n_cb, F)))


@pytest.mark.parametrize("E", [66, 700])
def test_harq_combining_equal(E):
    K, rvs = 40, (0, 2, 3, 1)
    rng = np.random.default_rng(E)
    txs = [rng.normal(size=(2, E)).astype(np.float32) for _ in rvs]
    got = trm.de_rate_match_harq([T(x) for x in txs], K, rvs)
    want = jrm.de_rate_match_harq_jax([jnp.asarray(x) for x in txs], K, rvs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="one redundancy version"):
        trm.de_rate_match_harq([T(txs[0])], K, rvs)


@pytest.mark.parametrize("m", [2, 4, 6])
def test_qam_equal_on_the_same_symbols(m):
    pts_t, bits_t = qam.constellation(m)
    pts_j, bits_j = jqam.constellation(m)
    np.testing.assert_array_equal(pts_t, pts_j)
    np.testing.assert_array_equal(bits_t, bits_j)
    bits = _bits((3, 8 * m), m)
    x = qam.modulate_qam(T(bits), m)
    assert x.dtype == torch.complex64
    np.testing.assert_array_equal(
        x.numpy(), np.asarray(jqam.modulate_qam(jnp.asarray(bits), m)))
    rng = np.random.default_rng(m)
    y = (x.numpy() + 0.3 * (rng.normal(size=x.shape)
                            + 1j * rng.normal(size=x.shape))).astype(np.complex64)
    amp = rng.rayleigh(scale=math.sqrt(0.5), size=x.shape).astype(np.float32)
    for a_t, a_j in ((None, None), (T(amp), jnp.asarray(amp))):
        got = qam.demap_qam(T(y), 4.0, m, amp=a_t)
        want = jqam.demap_qam(jnp.asarray(y), 4.0, m, amp=a_j)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    # noiseless symbols demap to the transmitted bits
    llr0 = qam.demap_qam(x, 10.0, m)
    np.testing.assert_array_equal((llr0 < 0).numpy(), bits == 1)
    with pytest.raises(ValueError, match="not a multiple"):
        qam.modulate_qam(T(bits[:, :m + 1]), m)


def test_bpsk_qpsk_modulate_and_demap_equal():
    bits = _bits((3, 24), 1)
    np.testing.assert_array_equal(
        chain.modulate_bpsk(T(bits)).numpy(),
        np.asarray(jchain.modulate_bpsk(jnp.asarray(bits))))
    xq = chain.modulate_qpsk(T(bits))
    np.testing.assert_array_equal(
        xq.numpy(), np.asarray(jchain.modulate_qpsk(jnp.asarray(bits))))
    rng = np.random.default_rng(2)
    y = rng.normal(size=(3, 24)).astype(np.float32)
    yc = (rng.normal(size=(3, 12)) + 1j * rng.normal(size=(3, 12))
          ).astype(np.complex64)
    a = rng.rayleigh(scale=math.sqrt(0.5), size=(3, 24)).astype(np.float32)
    ac = a[:, :12]
    close = lambda g, w: np.testing.assert_allclose(
        g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)
    close(chain.demap_bpsk(T(y), 1.5), jchain.demap_bpsk(jnp.asarray(y), 1.5))
    close(chain.demap_qpsk(T(yc), 1.5), jchain.demap_qpsk(jnp.asarray(yc), 1.5))
    close(chain.demap_bpsk_csi(T(y), T(a), 1.5),
          jchain.demap_bpsk_csi(jnp.asarray(y), jnp.asarray(a), 1.5))
    close(chain.demap_qpsk_csi(T(yc), T(ac), 1.5),
          jchain.demap_qpsk_csi(jnp.asarray(yc), jnp.asarray(ac), 1.5))
    # QPSK rails agree with the generic max-log demapper
    close(chain.demap_qpsk(T(yc), 1.5), qam.demap_qam(T(yc), 1.5, 2).numpy())


def _q(x):
    return 0.5 * math.erfc(x / math.sqrt(2.0))


@pytest.mark.parametrize("modulation", ["bpsk", "qpsk"])
def test_uncoded_awgn_ber_matches_q_function(modulation):
    """Uncoded BER from the port's own generator: BPSK Q(sqrt(2 Es/N0)),
    QPSK Q(sqrt(Es/N0)) per rail, within four standard deviations."""
    esn0_db, n = 4.0, 400_000
    g = 10 ** (esn0_db / 10)
    gen = _gen(5)
    bits = chain.gen_payload(gen, 4, n // 4)
    if modulation == "bpsk":
        llr = chain.demap_bpsk(chain.awgn(gen, chain.modulate_bpsk(bits),
                                          esn0_db), esn0_db)
        expected = _q(math.sqrt(2 * g))
    else:
        y = chain.awgn_complex(gen, chain.modulate_qpsk(bits), esn0_db)
        llr = chain.demap_qpsk(y, esn0_db)
        expected = _q(math.sqrt(g))
    ber = float(((llr < 0) != (bits == 1)).float().mean())
    assert abs(ber - expected) < 4 * math.sqrt(expected * (1 - expected) / n)


def test_noise_and_fading_statistics():
    gen = _gen(6)
    x = torch.zeros((4, 50_000), dtype=torch.complex64)
    n = chain.awgn_complex(gen, x, 3.0)
    var = 1.0 / (2.0 * 10 ** 0.3)            # per real dimension
    assert abs(float(n.real.var()) - var) < 0.02 * var
    assert abs(float(n.imag.var()) - var) < 0.02 * var
    z, a = chain.rayleigh_fading(gen, torch.ones((4, 50_000)), 60.0)
    assert z.dtype == torch.float32 and not a.is_complex()
    assert abs(float((a ** 2).mean()) - 1.0) < 0.02
    assert abs(float(a.mean()) - math.sqrt(math.pi) / 2) < 0.01
    # nearly noiseless: the rotated observation is a * x
    np.testing.assert_allclose(z.numpy(), a.numpy(), atol=1e-2)
    zc, ac = chain.rayleigh_fading(
        gen, chain.modulate_qpsk(chain.gen_payload(gen, 2, 64)), 60.0)
    assert zc.is_complex() and ac.shape == (2, 32)


def test_uncoded_bpsk_rayleigh_matches_closed_form():
    """Pb = (1 - sqrt(g / (1 + g))) / 2 at average Es/N0 g."""
    esn0_db, n = 7.0, 400_000
    g = 10 ** (esn0_db / 10)
    expected = 0.5 * (1.0 - math.sqrt(g / (1.0 + g)))
    gen = _gen(7)
    bits = chain.gen_payload(gen, 4, n // 4)
    z, a = chain.rayleigh_fading(gen, chain.modulate_bpsk(bits), esn0_db)
    llr = chain.demap_bpsk_csi(z, a, esn0_db)
    ber = float(((llr < 0) != (bits == 1)).float().mean())
    assert abs(ber - expected) < 4 * math.sqrt(expected * (1 - expected) / n)
