"""The HARQ receiver (turbotpu_torch/harq.py, csrc/harq.cu) against the
benchmark's plain reference (perfbench/reference/harq_ref.py), on the CPU.

The combine is held to the reference's sums bit for bit (punctured,
repeated and segmented blocks with fillers, rows of every redundancy
version and both flags in one call), the receiver over sequences of TTIs
on several processes to the reference's decode (hard bits, iterations and
verdicts equal, L within 1e-4), and each process's buffers to their own
TTIs.  The tests marked `cuda` hold the kernel to its plain version on the
card, byte for byte.  This file imports no JAX, so it runs on a machine
without it (`python -m pytest --noconftest tests/test_torch_harq.py -m
cuda`).
"""

import dataclasses

import numpy as np
import pytest
import torch

from perfbench.harness import gen, harq_gen
from perfbench.reference import harq_ref, turbo_ref
from turbotpu_torch import _device, harq
from turbotpu_torch.decoder import turbo_cells
from turbotpu_torch.decoder.turbo import DecoderConfig, turbo_decode
from turbotpu_torch.harness import tb as ttb
from turbotpu_torch.spec.crc import CRC24A_POLY, CRC24B_POLY
from turbotpu_torch.spec.rate_match import select_indices
from turbotpu_torch.spec.segmentation import segment_params
from turbotpu_torch.tx import chain
from turbotpu_torch.tx.rate_match import (de_rate_match, inverse_map,
                                          lte_demux, rate_match)

RV = harq_gen.RV_ORDER
# (A, G, Qm): one block of K=280 with 6 fillers punctured to 600 bits, the
# same repeated to 2400 (2.9 wraps), and two blocks of K 3072 and 3136
# with 8 fillers, E 6200 each
SHAPES = {"punctured": (250, 600, 2), "repeated": (250, 2400, 2),
          "two-sizes": (6128, 12400, 2)}


def _decoder(A, W=64):
    seg = segment_params(A + 24)
    return DecoderConfig(
        K=max(seg.sizes), n_iters=6, mode="maxlog", ext_scale=0.75,
        siso="cuda", io_dtype="bfloat16", ext_dtype="int8", ext_qscale=0.25,
        nii=True, window=W, early_term="crc",
        crc_poly=CRC24B_POLY if seg.C > 1 else CRC24A_POLY)


def _ttis(n_tti, procs, slots, seed):
    """(process, transmission index per slot) of each TTI: slot 0 runs to
    the fourth transmission and starts again, the others draw new data
    with probability 0.4."""
    rng = np.random.default_rng(seed)
    k = -np.ones((procs, slots), dtype=np.int64)
    out = []
    for i in range(n_tti):
        q = i % procs
        new = (k[q] < 0) | (k[q] >= 3) | (rng.random(slots) < 0.4)
        new[0] = k[q, 0] < 0 or k[q, 0] >= 3
        k[q] = np.where(new, 0, k[q] + 1)
        out.append((q, k[q].copy()))
    return out


def _rows(n, r0, r1, slots):
    """Block-major rows of `slots` in a run [r0, r1) of n slots."""
    s = torch.as_tensor(slots, dtype=torch.int64)
    return (torch.arange(r1 - r0)[:, None] * n + s[None, :]).reshape(-1)


def _history(ttis, q, upto, n):
    """harq_ref's txs of process q's buffers after TTI `upto`: each slot's
    transmissions since its last new data, TTI by TTI, grouped by
    redundancy version."""
    mine = [(i, k) for i, (p, k) in enumerate(ttis[:upto + 1]) if p == q]
    start = np.zeros(n, dtype=np.int64)
    for i, k in mine:
        start[k == 0] = i
    out = []
    for i, k in mine:
        for rv in sorted({RV[x] for x in k}):
            which = [t for t in range(n) if start[t] <= i and RV[k[t]] == rv]
            if which:
                out.append((i, rv, which))
    return out


def _txs(history, llrs, layout, n):
    """_history's entries with each TTI's received LLR runs cut to their
    slots."""
    runs = gen.runs(layout)
    return [([llrs[i][j].index_select(0, _rows(n, r0, r1, which))
              for j, (r0, r1) in enumerate(runs)], rv, which)
            for i, rv, which in history]


def _random_llrs(ttis, layout, n, seed):
    g = torch.Generator().manual_seed(seed)
    return [[torch.randn((r1 - r0) * n, layout[r0][1], generator=g) * 4
             for r0, r1 in gen.runs(layout)] for _ in ttis]


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_combine_equals_the_reference_sums(shape):
    """TTI after TTI on two processes, rows at every redundancy version,
    new data and retransmissions mixed in each call: every buffer equals
    the reference's 0 + d_0 + d_1 + ... demultiplexed, bit for bit."""
    A, G, Qm = SHAPES[shape]
    n, procs = 5, 2
    _, layout = gen.block_layout(A, G, Qm)
    ttis = _ttis(12, procs, n, seed=len(shape))
    assert {RV[x] for _, k in ttis for x in k} == set(RV)
    rx = harq.HarqReceiver(A, G, Qm, n, _decoder(A), processes=procs,
                           device="cpu")
    llrs = _random_llrs(ttis, layout, n, seed=3)
    for i, (q, k) in enumerate(ttis):
        rv = torch.tensor([RV[x] for x in k])
        n_tx = rx.combine_tti(q, llrs[i], rv, torch.from_numpy(k == 0))
        assert n_tx.tolist() == (k + 1).tolist()
        want, _ = harq_ref.decoder_streams(
            harq_ref.soft_buffers(_txs(_history(ttis, q, i, n), llrs,
                                       layout, n), n, A, G, Qm), A, G, Qm)
        for got, ref in zip(rx.buffers[q], want):
            assert torch.equal(got, ref)


@pytest.mark.parametrize("shape", ["punctured", "repeated"])
def test_receiver_decodes_as_the_reference(shape):
    """Encoded transport blocks sent TTI after TTI on three processes at
    their redundancy versions: the receiver's outputs after each TTI are
    the reference's rebuilt from the transmissions alone."""
    A, G, Qm = SHAPES[shape]
    n, procs = 4, 3
    _, layout = gen.block_layout(A, G, Qm)
    ttis = _ttis(15, procs, n, seed=7)
    g = torch.Generator().manual_seed(11)
    tb_of = np.zeros((procs, n), dtype=np.int64)
    n_tb = 0
    ids = []
    for q, k in ttis:
        for t in np.flatnonzero(k == 0):
            tb_of[q, t] = n_tb
            n_tb += 1
        ids.append(tb_of[q].copy())
    sent, blocks = harq_gen.encode(g, n_tb, A, G, Qm)
    es = harq_gen.esn0_db(1.0 if shape == "punctured" else -2.0, A, G)
    llrs = [harq_gen.transmit(g, blocks, layout, torch.from_numpy(t),
                              torch.tensor([RV[x] for x in k]), es)
            for t, (_, k) in zip(ids, ttis)]
    rx = harq.HarqReceiver(A, G, Qm, n, _decoder(A), processes=procs,
                           device="cpu")
    dec = turbo_ref.Decoder(K=max(segment_params(A + 24).sizes),
                            window=64)
    oks = []
    for i, (q, k) in enumerate(ttis):
        out = rx.receive(q, llrs[i], torch.tensor([RV[x] for x in k]),
                         torch.from_numpy(k == 0))
        tb, ok, iters, L = harq_ref.receive(
            _txs(_history(ttis, q, i, n), llrs, layout, n), n, A, G, Qm,
            dec)
        assert torch.equal(out["hard"], tb) and torch.equal(out["ok"], ok)
        assert torch.equal(out["iters"], iters)
        assert float((out["L"] - L).abs().max()) <= 1e-4
        assert torch.equal(ok, (tb == sent[torch.from_numpy(ids[i])])
                           .all(dim=1))
        oks.append(ok)
    oks = torch.stack(oks)
    # the channel leaves first transmissions in doubt and combining
    # recovers them
    assert not oks.all() and oks[-procs:].float().mean() > oks[:procs].float(
    ).mean()


def test_a_tti_touches_its_own_process_alone():
    """A TTI on process q leaves every other process's buffers byte for
    byte as they were, and its counts say what it combined."""
    A, G, Qm = SHAPES["punctured"]
    n, procs = 3, 3
    _, layout = gen.block_layout(A, G, Qm)
    rx = harq.HarqReceiver(A, G, Qm, n, _decoder(A), processes=procs,
                           device="cpu")
    llrs = _random_llrs(range(4), layout, n, seed=5)
    for q in range(procs):
        rx.combine_tti(q, llrs[q], torch.tensor([0, 0, 0]),
                       torch.ones(n, dtype=torch.bool))
    before = [[b.clone() for b in bufs] for bufs in rx.buffers]
    rx.combine_tti(1, llrs[3], torch.tensor([2, 0, 3]),
                   torch.tensor([False, True, False]))
    for q in (0, 2):
        assert all(torch.equal(a, b) for a, b in zip(rx.buffers[q],
                                                     before[q]))
    assert not torch.equal(rx.buffers[1][0], before[1][0])
    assert rx.n_tx.tolist() == [[1, 1, 1], [2, 1, 2], [1, 1, 1]]
    assert rx.counts() == {"new": {0: 10, 1: 0, 2: 0, 3: 0},
                           "retx": {0: 0, 1: 0, 2: 1, 3: 1}}


def test_new_data_forgets_the_old_contents():
    """A slot that gets new data after retransmissions holds that one
    transmission alone, as a fresh receiver would."""
    A, G, Qm = SHAPES["repeated"]
    n = 2
    _, layout = gen.block_layout(A, G, Qm)
    llrs = _random_llrs(range(4), layout, n, seed=9)
    rx = harq.HarqReceiver(A, G, Qm, n, _decoder(A), processes=1,
                           device="cpu")
    new = torch.ones(n, dtype=torch.bool)
    for i, rv in enumerate((0, 2, 3)):
        rx.combine_tti(0, llrs[i], torch.tensor([rv, rv]),
                       torch.full((n,), i == 0))
    rx.combine_tti(0, llrs[3], torch.tensor([1, 0]), new)
    fresh = harq.HarqReceiver(A, G, Qm, n, _decoder(A), processes=1,
                              device="cpu")
    fresh.combine_tti(0, llrs[3], torch.tensor([1, 0]), new)
    for a, b in zip(rx.buffers[0], fresh.buffers[0]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("K,E,rv,F", [(40, 100, 0, 0), (280, 600, 2, 6),
                                      (280, 2400, 3, 6), (3072, 6200, 1, 8)])
def test_the_inverse_map_reads_the_selection_back(K, E, rv, F):
    sel = select_indices(K, E, rv, None, F)
    inv, period = inverse_map(K, E, rv, F, torch.device("cpu"))
    assert period == len(np.unique(sel)) == min(E, period)
    hit = inv >= 0
    assert int(hit.sum()) == period
    assert torch.equal(inv[torch.from_numpy(sel[:period]).long()],
                       torch.arange(period))
    # every later bit lands where the one a whole number of periods before
    # it did
    assert (sel[period:] == sel[:E - period]).all()


def test_the_table_lays_the_streams_out_as_the_receive_chain_does():
    """Each table row, read as a new-data combine of the received LLRs,
    gives the port's de_rate_match, demux, filler pin and bucket embedding
    of them."""
    K, E, F, bucket = 280, 600, 6, 296
    table, period = harq.combine_table(K, E, F, bucket,
                                       torch.device("cpu"))
    assert tuple(table.shape) == (4, 3 * bucket + 12)
    llr = torch.randn(3, E, generator=torch.Generator().manual_seed(1))
    for rv in range(4):
        streams = tuple(torch.empty(3, w) for w in (bucket,) * 3 + (6, 6))
        harq.combine(streams, llr, table, period, torch.tensor([rv]),
                     torch.tensor([True]))
        ls, lp1, lp2, t1, t2 = lte_demux(de_rate_match(llr, K, rv, F=F))
        pad = torch.nn.functional.pad
        ls = ls.clone()
        ls[:, :F] = harq.BIG_LLR
        want = (pad(ls, (bucket - K, 0), value=harq.BIG_LLR),
                pad(lp1, (bucket - K, 0)), pad(lp2, (bucket - K, 0)), t1, t2)
        for a, b in zip(streams, want):
            assert torch.equal(a, b)
        assert int((table[rv] >= 0).sum()) == period
        assert int((table[rv] == harq.PINNED).sum()) == bucket - K + F


def test_combine_refuses_what_it_cannot_take():
    K, E, bucket = 40, 100, 40
    table, period = harq.combine_table(K, E, 0, bucket,
                                       torch.device("cpu"))
    good = dict(streams=tuple(torch.zeros(4, w)
                              for w in (bucket,) * 3 + (6, 6)),
                llr=torch.zeros(4, E), table=table, period=period,
                rv=torch.zeros(2, dtype=torch.int64),
                new=torch.ones(2, dtype=torch.bool))
    harq.combine(**good)
    for bad in (dict(rv=torch.zeros(3, dtype=torch.int64),
                     new=torch.ones(3, dtype=torch.bool)),
                dict(rv=torch.zeros(2, dtype=torch.int32)),
                dict(llr=torch.zeros(4, E, dtype=torch.float64)),
                dict(streams=good["streams"][:4] + (torch.zeros(4, 5),)),
                dict(table=table[:, :-1])):
        with pytest.raises(ValueError):
            harq.combine(**{**good, **bad})
    with pytest.raises(ValueError, match="bucket"):
        harq.HarqReceiver(250, 600, 2, 2, dataclasses.replace(
            _decoder(250), K=256), device="cpu")


def _old_gen_batch(cfg, gen_, esn0_db):
    """make_tb_step's streams as de_rate_match and sums built them before
    the receiver's combine: 0 + d_0 + d_1 + ..., demultiplexed, fillers
    pinned, embedded at the bucket."""
    seg = cfg.seg()
    bucket = max(seg.sizes)
    Es = ttb.per_block_e(cfg.G, seg.C)
    payload = chain.gen_payload(gen_, cfg.n_tb, cfg.A)
    tb = chain.crc_attach_batch(payload, CRC24A_POLY)
    pad = torch.nn.functional.pad
    parts = [[] for _ in range(5)]
    for r, ((_, d), K) in enumerate(zip(ttb.tb_encode_blocks(tb, seg),
                                        seg.sizes)):
        F = seg.F if r == 0 else 0
        llr_d = torch.zeros_like(d)
        for v in cfg.rv_sequence:
            x = chain.modulate_bpsk(rate_match(d, Es[r], v, F=F)
                                    .to(torch.int8))
            y = chain.demap_bpsk(chain.awgn(gen_, x, esn0_db), esn0_db)
            llr_d = llr_d + de_rate_match(y, K, v, F=F)
        ls, lp1, lp2, t1, t2 = lte_demux(llr_d)
        if F:
            ls = ls.clone()
            ls[:, :F] = harq.BIG_LLR
        Fe = bucket - K
        for lst, x in zip(parts, (pad(ls, (Fe, 0), value=harq.BIG_LLR),
                                  pad(lp1, (Fe, 0)), pad(lp2, (Fe, 0)),
                                  t1, t2)):
            lst.append(x)
    return tuple(torch.cat(p) for p in parts), tb


@pytest.mark.parametrize("A,G,rvs", [(6128, 9000, (0, 2)),
                                     (6128, 30000, (0, 2, 3, 1)),
                                     (200, 1500, (3, 1))])
def test_the_tb_sweep_streams_are_unchanged(A, G, rvs):
    """make_tb_step's rate-matched path, now through the receiver's
    combine, makes the streams the de_rate_match sums made, bit for bit
    (punctured and repeated, one and two block sizes)."""
    cfg = ttb.TBConfig(A=A, n_tb=3, G=G, rv_sequence=rvs, siso="scan")
    step = ttb.make_tb_step(cfg, "cpu")
    got, tb = step.gen(torch.Generator().manual_seed(4), 1.5)
    want, tb0 = _old_gen_batch(cfg, torch.Generator().manual_seed(4), 1.5)
    assert torch.equal(tb, tb0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_the_receiver_builds_nothing_until_its_first_card_call():
    """Constructing receivers and combining on the CPU loads no library."""
    from turbotpu_torch import _build
    A, G, Qm = SHAPES["punctured"]
    harq.HarqReceiver(A, G, Qm, 2, _decoder(A), processes=2, device="cpu")
    assert harq.TARGET not in _build._loaded
    assert harq._COMBINE._fn is None


# ---- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(SHAPES) + ["heavy"])
def test_the_kernel_equals_its_plain_version(card, shape):
    """Every shape, and one whose rows (E=26000, over 9 wraps) are too long
    to stage in shared memory."""
    A, G, Qm = SHAPES.get(shape, (250, 26000, 2))
    n = 37
    _, layout = gen.block_layout(A, G, Qm)
    seg = segment_params(A + 24)
    bucket = max(seg.sizes)
    g = torch.Generator().manual_seed(2)
    for (r0, r1) in gen.runs(layout):
        K, E, F = layout[r0]
        rows = (r1 - r0) * n
        rv = torch.randint(0, 4, (n,), generator=g)
        new = torch.rand(n, generator=g) < 0.5
        llr = torch.randn(rows, E, generator=g) * 4
        start = tuple(torch.randn(rows, w, generator=g)
                      for w in (bucket,) * 3 + (6, 6))
        cpu = tuple(x.clone() for x in start)
        dev = tuple(x.to(card) for x in start)
        table, period = harq.combine_table(K, E, F, bucket,
                                           torch.device("cpu"))
        harq.combine(cpu, llr, table, period, rv, new)
        before = _device.LAUNCHES["combine_kernel"]
        harq.combine(dev, llr.to(card), table.to(card), period, rv.to(card),
                     new.to(card))
        torch.cuda.synchronize()
        assert _device.LAUNCHES["combine_kernel"] == before + 1
        for a, b in zip(cpu, dev):
            assert torch.equal(a.view(torch.int32), b.cpu().view(torch.int32))


@pytest.mark.cuda
def test_a_single_size_batch_decodes_as_its_per_codeword_form(card):
    """The cells' transport block at a reduced batch: 13 blocks of K=5824 x
    16 transport blocks, bf16 + int8, crc.  Its one group's shared-table
    decode gives the bytes of the per-codeword form of the same tables, and
    `receive` (a first transmission, then rv 2) gives the per-codeword
    decode of its buffers."""
    A, G, Qm, n = 75376, 86400, 6, 16
    cfg = _decoder(A, W=256)
    _, layout = gen.block_layout(A, G, Qm)
    g = torch.Generator(device=card).manual_seed(5)
    _, blocks = harq_gen.encode(g, n, A, G, Qm)
    rx = harq.HarqReceiver(A, G, Qm, n, cfg, processes=1, device=card)
    pg, ig, gid = rx.group_tables
    assert pg.shape == (1, 5824) and len(gid) == 13 * n
    slots = torch.arange(n, device=card)
    es = harq_gen.esn0_db(3.8, A, G)
    for i, v in enumerate((0, 2)):
        rv = torch.full((n,), v, dtype=torch.int64, device=card)
        llrs = harq_gen.transmit(g, blocks, layout, slots, rv, es)
        forms = dict(turbo_cells.TABLE_FORMS)
        out = rx.receive(0, llrs, rv, torch.full((n,), i == 0, device=card))
        grouped = turbo_decode(*rx.buffers[0], cfg,
                               group_tables=rx.group_tables, device=card)
        assert turbo_cells.TABLE_FORMS["shared"] == forms["shared"] + 2
        hard, iters, L = turbo_decode(*rx.buffers[0], cfg, perm_b=pg[gid],
                                      inv_b=ig[gid], device=card)
        assert (turbo_cells.TABLE_FORMS["per_codeword"]
                == forms["per_codeword"] + 1)
        assert torch.equal(grouped[0], hard) and torch.equal(grouped[1],
                                                             iters)
        assert torch.equal(grouped[2].view(torch.int32), L.view(torch.int32))
        tb = torch.cat([hard[a:b, lo:lo + take]
                        for a, b, lo, take in rx.cuts], dim=1)
        assert torch.equal(out["hard"], tb)
        assert torch.equal(out["iters"], iters)
        assert torch.equal(out["L"].view(torch.int32), L.view(torch.int32))
        if i == 0:
            assert int(iters.min()) < cfg.n_iters
