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
from turbotpu_torch.decoder import turbo_cells
from turbotpu_torch.decoder.turbo import DecoderConfig
from turbotpu_torch.decoder.turbo_cells import time_major_index
from turbotpu_torch.spec.crc import CRC24A_POLY, crc_attach

BUCKET, SIZES, B = 320, (40, 168, 320), 12
KS = [SIZES[i % 3] for i in range(B)]


def mixed_frames(interleaver, seed, ebn0_db, Ks=KS):
    """len(Ks) true-K codewords (sizes Ks, by default cycling over SIZES,
    CRC-24A inside) at their own mother rate over BPSK/AWGN, embedded in the
    bucket: systematic fillers +1e9, parity fillers 0.  Returns the five LLR
    streams and the embedded transmitted bits, numpy."""
    rng = np.random.default_rng(seed)
    cfg = JaxConfig(K=BUCKET, interleaver=interleaver)
    cols = [[] for _ in range(6)]
    for K in Ks:
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


# one size a batch: the bucket itself (F = 0) or a smaller block behind F
# fillers
SINGLE = {"bucket": BUCKET, "smaller": 168}

# every case on the mixed batch (G = 3), and on a batch of each single size
# (G = 1), which the port decodes through one shared table
MIXED_OR_SINGLE = (
    [pytest.param(case, KS, id=case) for case in CASES]
    + [pytest.param(case, [K] * B, id=f"{case}-{size}")
       for case in CASES for size, K in SINGLE.items()])


@pytest.mark.parametrize("case, Ks", MIXED_OR_SINGLE)
def test_mixed_decode_matches_reference(case, Ks):
    """Hard bits and iteration counts equal to the JAX package's grouped
    decode, L within 1e-4 (real positions; filler positions carry the 1e9
    systematic LLR, compared relatively); the port's grouped and
    per-codeword call forms are bit-identical to each other.  On the kernel
    path the grouped decode gathers per codeword for the mixed batch and
    through one shared table for a single size."""
    cfg_kw, ebn0 = CASES[case]
    jcfg = JaxConfig(K=BUCKET, **cfg_kw)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    streams, bits = mixed_frames(jcfg.interleaver, seed=len(case),
                                 ebn0_db=ebn0, Ks=Ks)
    tables = jbucket.grouped_perm_tables(Ks, BUCKET, jcfg.interleaver)
    hj, ij, Lj = jax_decode(*[jnp.asarray(a) for a in streams], jcfg,
                            group_tables=tuple(jnp.asarray(t) for t in tables))
    forms = dict(turbo_cells.TABLE_FORMS)
    ht, it, Lt = turbo_decode(*streams, tcfg, group_tables=tables,
                              device="cpu")
    if tcfg.siso == "cuda":
        ran = "shared" if len(set(Ks)) == 1 else "per_codeword"
        assert turbo_cells.TABLE_FORMS == {
            k: v + (k == ran) for k, v in forms.items()}
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), atol=1e-4,
                               rtol=1e-6)
    real = np.arange(BUCKET)[None, :] >= (BUCKET - np.asarray(Ks))[:, None]
    # the decode is a real one: most frames come out right, fillers are zero
    assert ((ht.numpy() != bits) & real).any(axis=1).mean() < 0.5
    assert not ht.numpy()[~real].any()
    if jcfg.early_term == "crc":
        assert it.numpy().min() < jcfg.n_iters

    pg, ig, gid = tables_to_torch(tbucket.grouped_perm_tables(
        Ks, BUCKET, jcfg.interleaver))
    hb, ib, Lb = turbo_decode(*streams, tcfg, perm_b=pg[gid], inv_b=ig[gid],
                              device="cpu")
    assert torch.equal(hb, ht) and torch.equal(ib, it) and torch.equal(Lb, Lt)


def _single_size_config(interleaver, early_term, **kw):
    """The benchmark cells' decoder on the port's kernel path at the
    bucket."""
    return DecoderConfig(
        K=BUCKET, n_iters=4, mode="maxlog", ext_scale=0.75, siso="cuda",
        io_dtype="bfloat16", ext_dtype="int8", ext_qscale=0.25, nii=True,
        window=64, interleaver=interleaver, early_term=early_term, **kw)


def _decode_counted(streams, cfg, **tables):
    """turbo_decode on the CPU, and the table form its gathers ran."""
    forms = dict(turbo_cells.TABLE_FORMS)
    out = turbo_decode(*streams, cfg, device="cpu", **tables)
    ran = [k for k, v in turbo_cells.TABLE_FORMS.items() if v != forms[k]]
    assert len(ran) == 1 and turbo_cells.TABLE_FORMS[ran[0]] == forms[ran[0]] + 1
    return out, ran[0]


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("early_term", ["none", "crc"])
@pytest.mark.parametrize("interleaver", ["lte", "umts"])
@pytest.mark.parametrize("size", sorted(SINGLE))
def test_single_size_grouped_batch_gathers_through_one_shared_table(
        size, interleaver, early_term):
    """A grouped batch of one block size (G = 1) decodes through the
    group's own row as one shared table: hard bits, iterations and L equal
    to the per-codeword form of the same tables, and at F = 0 to the
    table-less decode."""
    K = SINGLE[size]
    Ks = [K] * B
    streams, bits = mixed_frames(interleaver, seed=K + len(early_term),
                                 ebn0_db=2.0, Ks=Ks)
    cfg = _single_size_config(interleaver, early_term)
    tables = tbucket.grouped_perm_tables(Ks, BUCKET, interleaver)
    assert len(tables[0]) == 1
    got, form = _decode_counted(streams, cfg, group_tables=tables)
    assert form == "shared"
    pg, ig, gid = tables_to_torch(tables)
    want, form = _decode_counted(streams, cfg, perm_b=pg[gid], inv_b=ig[gid])
    assert form == "per_codeword"
    _equal(got, want)
    if K == BUCKET:
        plain, form = _decode_counted(streams, cfg)
        assert form == "shared"
        _equal(got, plain)
    else:
        # the group's row is not the configuration's table
        assert not np.array_equal(tables[0][0], cfg.perm())
    hard, iters, _ = got
    real = np.arange(BUCKET) >= BUCKET - K
    assert ((hard.numpy() != bits)[:, real]).any(axis=1).mean() < 0.5
    assert not hard.numpy()[:, ~real].any()
    if early_term == "crc":
        assert int(iters.min()) < cfg.n_iters


@pytest.mark.parametrize("interleaver", ["lte", "umts"])
def test_single_size_grouped_batch_on_the_generic_loop(interleaver):
    """The generic loop (siso="scan") takes the same shared row: a grouped
    batch of blocks smaller than the bucket equals its per-codeword form."""
    Ks = [SINGLE["smaller"]] * 4
    streams, _ = mixed_frames(interleaver, seed=3, ebn0_db=2.0, Ks=Ks)
    cfg = DecoderConfig(K=BUCKET, n_iters=3, mode="maxlog",
                        interleaver=interleaver, early_term="crc")
    tables = tbucket.grouped_perm_tables(Ks, BUCKET, interleaver)
    pg, ig, gid = tables_to_torch(tables)
    _equal(turbo_decode(*streams, cfg, group_tables=tables, device="cpu"),
           turbo_decode(*streams, cfg, perm_b=pg[gid], inv_b=ig[gid],
                        device="cpu"))


@pytest.mark.parametrize("early_term", ["none", "crc"])
def test_single_size_grouped_batch_folds(early_term, monkeypatch):
    """fold_gather applies to a G = 1 grouped batch (its tables are
    shared): every SISO call reads its a-priori through a table, and the
    outputs are the unfolded decode's."""
    Ks = [SINGLE["smaller"]] * B
    streams, _ = mixed_frames("lte", seed=5, ebn0_db=2.0, Ks=Ks)
    tables = tbucket.grouped_perm_tables(Ks, BUCKET, "lte")
    folds = []

    def siso_cells(*args, gather_idx=None, **kw):
        folds.append(gather_idx is not None)
        return siso_cells_of_the_loop(*args, gather_idx=gather_idx, **kw)

    siso_cells_of_the_loop = turbo_cells.siso_cells
    monkeypatch.setattr(turbo_cells, "siso_cells", siso_cells)
    folded, form = _decode_counted(
        streams, _single_size_config("lte", early_term, fold_gather=True),
        group_tables=tables)
    assert form == "shared" and folds and all(folds)
    folds.clear()
    unfolded, _ = _decode_counted(streams,
                                  _single_size_config("lte", early_term),
                                  group_tables=tables)
    assert folds and not any(folds)
    _equal(folded, unfolded)


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
    pg, ig, gid = tbucket.grouped_perm_tables([BUCKET] * B, BUCKET)
    for one in ((pg, ig, gid[:3]), (pg[:, :40], ig, gid)):
        with pytest.raises(ValueError, match="one group's tables"):
            turbo_decode(*streams, cfg, group_tables=one, device="cpu")


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
