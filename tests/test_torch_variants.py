"""The windowed (overlap-save) and associative-scan SISOs of the port
against the JAX package's, on the CPU, alone and inside the decoder.

Inputs are made from a seed with numpy and handed to both sides.  Both
variants are tensor code on both sides (no kernel): Le within 1e-4, hard
bits and iteration counts equal.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from turbotpu.decoder.turbo import DecoderConfig as JaxConfig
from turbotpu.decoder.turbo import turbo_decode as jax_decode
from turbotpu.siso.ascan import siso_decode_ascan as j_ascan
from turbotpu.siso.windowed import make_windowed_siso as j_windowed
from turbotpu_torch import convert, turbo_decode
from turbotpu_torch.decoder.turbo import get_siso
from turbotpu_torch.harness.bench import make_decode_inputs
from turbotpu_torch.siso import ascan, windowed
from turbotpu_torch.siso.scan import siso_decode_scan as t_scan


def _inputs(K, B, seed, scale=4.0):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.normal(size=s) * scale).astype(np.float32)
    return f(B, K + 3), f(B, K + 3), f(B, K)


def _both(fn_t, fn_j, args, mode):
    Lt, Let = fn_t(*map(torch.from_numpy, args), mode=mode)
    Lj, Lej = fn_j(*map(jnp.asarray, args), mode=mode)
    return (Lt.numpy(), Let.numpy()), (np.asarray(Lj), np.asarray(Lej))


@pytest.mark.parametrize("mode", ["maxlog", "logmap", "linlog"])
@pytest.mark.parametrize("K", [40, 300])
def test_ascan_matches_jax(K, mode):
    """The log-depth prefix product against jax.lax.associative_scan's: the
    products are combined in another order, so Le and L within 1e-4."""
    (Lt, Let), (Lj, Lej) = _both(ascan.siso_decode_ascan, j_ascan,
                                 _inputs(K, 3, seed=K), mode)
    np.testing.assert_allclose(Let, Lej, atol=1e-4, rtol=0)
    np.testing.assert_allclose(Lt, Lj, atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode", ["maxlog", "logmap"])
def test_ascan_matches_scan(mode):
    """As the reference holds its own (tests/unit/test_siso_variants.py)."""
    args = tuple(map(torch.from_numpy, _inputs(104, 3, seed=0)))
    _, Le1 = t_scan(*args, mode=mode)
    _, Le2 = ascan.siso_decode_ascan(*args, mode=mode)
    np.testing.assert_allclose(Le2.numpy(), Le1.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["maxlog", "logmap", "linlog"])
@pytest.mark.parametrize("K,W,Q", [(300, 64, 16), (1000, 128, 32)])
def test_windowed_matches_jax(K, W, Q, mode):
    """Overlap-save windows, warm-up Q, against the reference's: the same
    scan over the same windows, Le and L within 1e-4."""
    (Lt, Let), (Lj, Lej) = _both(windowed.make_windowed_siso(W, Q),
                                 j_windowed(W, Q), _inputs(K, 2, seed=W),
                                 mode)
    np.testing.assert_allclose(Let, Lej, atol=1e-4, rtol=0)
    np.testing.assert_allclose(Lt, Lj, atol=1e-4, rtol=0)


def test_windowed_short_block_is_exact():
    """A block shorter than W + 2Q is decoded by the exact full-block scan
    (tests/unit/test_siso_variants.py:72)."""
    args = tuple(map(torch.from_numpy, _inputs(40, 2, seed=7)))
    _, Le1 = t_scan(*args, mode="maxlog")
    _, Le2 = windowed.make_windowed_siso(256, 32)(*args, mode="maxlog")
    np.testing.assert_allclose(Le2.numpy(), Le1.numpy(), rtol=1e-4, atol=1e-4)


def test_windowed_close_to_exact_on_codewords():
    """Approximate but close on real codewords: sign agreement on confident
    extrinsics near-total (the reference's own bar)."""
    ls, lp1, _, t1, _ = make_decode_inputs(512, 2, seed=0, ebn0_db=0.8)
    ls1 = torch.cat([ls, t1[:, 0::2]], 1)
    lp = torch.cat([lp1, t1[:, 1::2]], 1)
    la = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 512)
                                                          ).astype(np.float32))
    a = t_scan(ls1, lp, la, mode="maxlog")[1].numpy()
    b = windowed.make_windowed_siso(128, 32)(ls1, lp, la, mode="maxlog")[1]
    confident = np.abs(a) > 2.0
    assert ((a < 0) == (b.numpy() < 0))[confident].mean() > 0.995
    assert np.abs(a - b.numpy()).mean() < 0.2


def test_get_siso_resolves_both():
    assert get_siso(convert.config_from_dict(
        dict(K=40, siso="ascan"))) is ascan.siso_decode_ascan
    fn = get_siso(convert.config_from_dict(dict(K=40, siso="window")))
    assert fn.__name__ == "siso_decode_windowed"


@pytest.mark.parametrize("siso,cfg_kw", [
    ("ascan", dict(mode="logmap", early_term="crc")),
    ("window", dict(mode="maxlog", window=64, early_term="sign")),
    ("window", dict(mode="linlog"))])
def test_decode_matches_jax(siso, cfg_kw):
    """The whole decode through each variant, K=300, 3 codewords: hard bits
    and iteration counts equal, L within 1e-4."""
    jcfg = JaxConfig(K=304, n_iters=4, siso=siso, **cfg_kw)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    arrays = [x.numpy() for x in make_decode_inputs(
        304, 3, seed=2, ebn0_db=1.2, with_crc=jcfg.early_term == "crc")]
    hj, ij, Lj = jax_decode(*[jnp.asarray(a) for a in arrays], jcfg)
    ht, it, Lt = turbo_decode(*arrays, tcfg, device="cpu")
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), atol=1e-4, rtol=0)
