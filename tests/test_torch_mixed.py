"""Mixed-K batches: the port's embedded interleaver tables and its one-call
mixed decode against the JAX package's, on the CPU.

Frames are made from a seed with numpy (each codeword encoded at its own size
with its own interleaver, embedded in the bucket behind known-zero fillers)
and handed to both sides.  On the kernel path the JAX side runs its Pallas
kernel in interpret mode and the port its kernels' plain versions.
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import turbotpu.decoder.bucketing as jbucket
from turbotpu.decoder.turbo import DecoderConfig as JaxConfig
from turbotpu.decoder.turbo import turbo_decode as jax_decode
import turbotpu_torch.decoder.bucketing as tbucket
import turbotpu_torch.golden.numpy_ref as tref
from turbotpu_torch import turbo_decode
from turbotpu_torch.convert import config_from_dict, tables_to_torch
from turbotpu_torch.decoder.turbo_cells import time_major_index
from turbotpu_torch.spec.crc import CRC24A_POLY, crc_attach

BUCKET, SIZES, B = 320, (40, 168, 320), 12
KS = [SIZES[i % 3] for i in range(B)]


def mixed_frames(interleaver, seed, ebn0_db):
    """B true-K codewords (sizes cycling over SIZES, CRC-24A inside) at their
    own mother rate over BPSK/AWGN, embedded in the bucket: systematic
    fillers +1e9, parity fillers 0.  Returns the five LLR streams and the
    embedded transmitted bits, numpy."""
    rng = np.random.default_rng(seed)
    cfg = JaxConfig(K=BUCKET, interleaver=interleaver)
    cols = [[] for _ in range(6)]
    for K in KS:
        bits = crc_attach(rng.integers(0, 2, K - 24).astype(np.int8),
                          CRC24A_POLY)
        enc = tref.turbo_encode(bits, dataclasses.replace(cfg, K=K).perm())
        sigma = np.sqrt(1 / (2 * 10 ** (ebn0_db / 10) * K / (3 * K + 12)))
        llr = [(2 * ((1 - 2 * x.astype(np.float64))
                     + sigma * rng.normal(size=x.shape)) / sigma ** 2
                ).astype(np.float32) for x in enc]
        F = BUCKET - K
        for col, x in zip(cols, (
                np.concatenate([np.full(F, 1e9, np.float32), llr[0]]),
                np.concatenate([np.zeros(F, np.float32), llr[1]]),
                np.concatenate([np.zeros(F, np.float32), llr[2]]),
                llr[3], llr[4], np.concatenate([np.zeros(F, np.int8), bits]))):
            col.append(x)
    *streams, bits = (np.stack(c) for c in cols)
    return streams, bits


@pytest.mark.parametrize("interleaver", ["lte", "umts"])
@pytest.mark.parametrize("form", ["embedded", "grouped"])
def test_perm_tables_equal_reference(form, interleaver):
    Ks = [40, 320, 168, 40, 320, 320, 168]
    name = f"{form}_perm_tables"
    got = getattr(tbucket, name)(Ks, BUCKET, interleaver)
    want = getattr(jbucket, name)(Ks, BUCKET, interleaver)
    assert len(got) == len(want) == (2 if form == "embedded" else 3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    # each row is a bijection that keeps the fillers in place
    for row, K in zip(got[0] if form == "embedded" else got[0][got[2]], Ks):
        assert sorted(row) == list(range(BUCKET))
        np.testing.assert_array_equal(row[:BUCKET - K], np.arange(BUCKET - K))


def test_bucket_ceilings_and_errors():
    legal = (40, 168, 320)
    assert (tbucket.bucket_ceilings([40, 41, 168, 300], legal)
            == jbucket.bucket_ceilings([40, 41, 168, 300], legal)
            == {40: 40, 41: 168, 168: 168, 300: 320})
    with pytest.raises(ValueError, match="no bucket ceiling"):
        tbucket.bucket_ceilings([321], legal)
    with pytest.raises(ValueError, match="exceeds bucket"):
        tbucket.embedded_perm_tables([328], BUCKET)


def test_time_major_index_extends_with_identity():
    pb, _ = tbucket.embedded_perm_tables(KS, BUCKET, "umts")
    idx = time_major_index(torch.from_numpy(pb), 336)
    assert idx.shape == (336, B) and idx.dtype == torch.int64
    np.testing.assert_array_equal(idx[:BUCKET].numpy(), pb.T)
    np.testing.assert_array_equal(
        idx[BUCKET:].numpy(), np.arange(BUCKET, 336)[:, None].repeat(B, 1))


CASES = {
    "scan-umts-linlog-crc": (dict(n_iters=4, mode="linlog", early_term="crc",
                                  interleaver="umts"), 2.0),
    "kernel-umts-linlog-crc": (dict(n_iters=4, mode="linlog", siso="pallas",
                                    early_term="crc", interleaver="umts"), 2.0),
    "kernel-lte-maxlog-lean": (dict(n_iters=3, mode="maxlog", siso="pallas",
                                    ext_scale=0.75), 2.5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_mixed_decode_matches_reference(case):
    """Hard bits and iteration counts equal to the JAX package's grouped
    decode, L within 1e-4 (real positions; filler positions carry the 1e9
    systematic LLR, compared relatively); the port's grouped and
    per-codeword call forms are bit-identical to each other."""
    cfg_kw, ebn0 = CASES[case]
    jcfg = JaxConfig(K=BUCKET, **cfg_kw)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    streams, bits = mixed_frames(jcfg.interleaver, seed=len(case), ebn0_db=ebn0)
    tables = jbucket.grouped_perm_tables(KS, BUCKET, jcfg.interleaver)
    hj, ij, Lj = jax_decode(*[jnp.asarray(a) for a in streams], jcfg,
                            group_tables=tuple(jnp.asarray(t) for t in tables))
    ht, it, Lt = turbo_decode(*streams, tcfg, group_tables=tables,
                              device="cpu")
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), atol=1e-4,
                               rtol=1e-6)
    real = np.arange(BUCKET)[None, :] >= (BUCKET - np.asarray(KS))[:, None]
    # the decode is a real one: most frames come out right, fillers are zero
    assert ((ht.numpy() != bits) & real).any(axis=1).mean() < 0.5
    assert not ht.numpy()[~real].any()
    if jcfg.early_term == "crc":
        assert it.numpy().min() < jcfg.n_iters

    pg, ig, gid = tables_to_torch(tbucket.grouped_perm_tables(
        KS, BUCKET, jcfg.interleaver))
    hb, ib, Lb = turbo_decode(*streams, tcfg, perm_b=pg[gid], inv_b=ig[gid],
                              device="cpu")
    assert torch.equal(hb, ht) and torch.equal(ib, it) and torch.equal(Lb, Lt)


def test_mixed_table_arguments_are_checked():
    streams, _ = mixed_frames("lte", seed=0, ebn0_db=3.0)
    cfg = config_from_dict(dict(K=BUCKET, n_iters=1))
    pb, ib = tbucket.embedded_perm_tables(KS, BUCKET)
    tables = tbucket.grouped_perm_tables(KS, BUCKET)
    with pytest.raises(ValueError, match="pair"):
        turbo_decode(*streams, cfg, perm_b=pb, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        turbo_decode(*streams, cfg, perm_b=pb, inv_b=ib, group_tables=tables,
                     device="cpu")
    with pytest.raises(ValueError, match="per-codeword tables"):
        turbo_decode(*streams, cfg, perm_b=pb[:3], inv_b=ib[:3], device="cpu")


def test_decode_mixed_buckets_match_reference():
    """decode_mixed: per-K buckets, results back in input order."""
    rng = np.random.default_rng(8)
    cws = []
    for K in (40, 168, 40, 104):
        bits = rng.integers(0, 2, K).astype(np.int8)
        enc = tref.turbo_encode(bits, JaxConfig(K=K).perm())
        keys = ("ls", "lp1", "lp2", "tail1", "tail2")
        cws.append({k: (3.0 * (1 - 2 * x.astype(np.float32))
                        + rng.normal(size=x.shape).astype(np.float32))
                    for k, x in zip(keys, enc)})
    want = jbucket.decode_mixed(cws, JaxConfig(K=40, n_iters=2, mode="maxlog"))
    got = tbucket.decode_mixed(
        cws, config_from_dict(dict(K=40, n_iters=2, mode="maxlog")),
        device="cpu")
    np.testing.assert_array_equal(got.iters, np.asarray(want.iters))
    for g, w, gl, wl in zip(got.hard, want.hard, got.L, want.L):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_allclose(gl, np.asarray(wl), atol=1e-4, rtol=0)
