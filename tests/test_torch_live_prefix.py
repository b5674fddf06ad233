"""The `crc` loop's live prefix (decoder/turbo_cells.py; decoder/layout.py::
live_syndromes, retire_outputs, live_compact; csrc/layout.cu: exit_kernel
and unpack_kernel with a live prefix, live_close_kernel, compact_kernel;
the SISO kernels' live count).

A `crc` decode with one shared interleaver table keeps its codewords not
yet done in the first n columns of its working set and runs both SISO calls
over those columns alone; the per-codeword form keeps the loop that runs
every codeword and freezes the done ones.  On the CPU the two loops, run on
the same tables in both forms, give the same bits, iteration counts and L
byte for byte, and so does the JAX package's decode; the moves stay within
the codewords done in each iteration, and `siso_columns` counts the
columns each SISO call's grid spanned.  The tests marked `cuda` hold the
kernels to the plain versions on the card.  The JAX package is imported
inside the one test that needs it, so the file runs on a machine without
it (`python -m pytest --noconftest tests/test_torch_live_prefix.py -m
cuda`).
"""

import dataclasses

import numpy as np
import pytest
import torch

from turbotpu_torch import DecoderConfig, _device, turbo_decode
from turbotpu_torch.decoder import layout, turbo_cells
from turbotpu_torch.harness.bench import flagship_config, make_decode_inputs
from turbotpu_torch.siso.cuda_kernel import FP8, siso_cells
from turbotpu_torch.spec.crc import CRC24A_POLY, CRC24B_POLY, crc_matrix

K = 104
N_ITERS = 5
# Eb/N0 of each regime at K=104 and five iterations: every codeword done
# after the first iteration, none done by the cap, some retiring in every
# iteration
REGIMES = {"all_first": 6.0, "none": -2.0, "every": 0.5}
NII = dict(nii=True, window=32)
CASES = {
    "nii-bf16-int8-every-B19": (dict(NII, io_dtype="bfloat16",
                                     ext_dtype="int8"), 19, "every"),
    "nii-bf16-int8-fold-every-B19": (dict(NII, io_dtype="bfloat16",
                                          ext_dtype="int8",
                                          fold_gather=True), 19, "every"),
    "exact-f32-bf16-every-B16": (dict(io_dtype="float32",
                                      ext_dtype="bfloat16"), 16, "every",
                                 10),
    "nii-bf16-fp8-every-B19": (dict(NII, io_dtype="bfloat16",
                                    ext_dtype="float8_e4m3fn"), 19, "every"),
    "nii-bf16-fp8-fold-all-first-B16": (dict(NII, io_dtype="bfloat16",
                                             ext_dtype="float8_e4m3fn",
                                             fold_gather=True), 16,
                                        "all_first"),
    "exact-bf16-int8-none-B19": (dict(io_dtype="bfloat16", ext_dtype="int8"),
                                 19, "none"),
    "nii-f32-bf16-fold-none-B16": (dict(NII, io_dtype="float32",
                                        ext_dtype="bfloat16",
                                        fold_gather=True), 16, "none"),
    "nii-bf16-int8-all-first-B19": (dict(NII, io_dtype="bfloat16",
                                         ext_dtype="int8"), 19, "all_first"),
}
# (configuration, B, regime[, seed]): seed 7 unless given, each in its regime


def _config(cfg_kw, **over):
    return DecoderConfig(**{**dict(K=K, n_iters=N_ITERS, mode="maxlog",
                                   siso="cuda", early_term="crc",
                                   ext_scale=0.75, **cfg_kw), **over})


def _per_codeword(cfg, B):
    """The configuration's tables as (B, K) per-codeword tables: the
    freezing loop's form."""
    perm, inv = (torch.from_numpy(t.astype(np.int64)).expand(B, -1)
                 for t in (cfg.perm(), cfg.inv()))
    return dict(perm_b=perm, inv_b=inv)


def _in_regime(iters, regime):
    it = sorted(set(iters.tolist()))
    return {"all_first": it == [1], "none": it == [N_ITERS],
            "every": it == list(range(1, N_ITERS + 1))}[regime]


@pytest.mark.parametrize("case", list(CASES))
def test_prefix_loop_equals_freezing_loop_and_jax(case):
    """hard, iters and L of the live prefix equal, byte for byte, the
    freezing loop's on the same tables in per-codeword form and the JAX
    package's decode (its Pallas kernel in interpret mode)."""
    import jax.numpy as jnp

    from turbotpu.decoder.turbo import DecoderConfig as JaxConfig
    from turbotpu.decoder.turbo import turbo_decode as jax_decode

    cfg_kw, B, regime, *seed = CASES[case]
    cfg = _config(cfg_kw)
    inputs = make_decode_inputs(K, B, seed=seed[0] if seed else 7,
                                ebn0_db=REGIMES[regime], with_crc=True)
    forms = dict(turbo_cells.TABLE_FORMS)
    got = turbo_decode(*inputs, cfg, device="cpu")
    assert turbo_cells.TABLE_FORMS["shared"] == forms["shared"] + 1
    assert _in_regime(got[1], regime), sorted(got[1].tolist())
    want = turbo_decode(*inputs, cfg, device="cpu", **_per_codeword(cfg, B))
    assert turbo_cells.TABLE_FORMS["per_codeword"] == \
        forms["per_codeword"] + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    jcfg = JaxConfig(**{**dataclasses.asdict(cfg), "siso": "pallas"})
    hj, ij, Lj = jax_decode(*[jnp.asarray(x.numpy()) for x in inputs], jcfg)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(hj))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ij))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(Lj))


@pytest.mark.parametrize("B,regime", [(19, "every"), (16, "every"),
                                      (19, "all_first"), (19, "none")])
def test_moves_are_at_most_the_codewords_done_now(B, regime, monkeypatch):
    """After each iteration's close the prefix holds exactly the codewords
    not retired, each in one column; the k-th hole below n' takes the k-th
    staying column from n' up, and the moves are at most the codewords
    done in that iteration (the cap retires the rest without a move)."""
    cfg = _config(dict(NII, io_dtype="bfloat16", ext_dtype="int8"))
    inputs = make_decode_inputs(K, B, seed=7, ebn0_db=REGIMES[regime],
                                with_crc=True)
    seen = []
    compact = layout.live_compact

    def spy(done, iters, live, moved, last):
        n = int(live.state[0])
        live_cols = live.col[:n].clone()
        retired = set(live_cols[(live.synd[:n] == 0) | last].tolist())
        before = done.clone()
        out = compact(done, iters, live, moved, last)
        stay, n_ret, n_mv = live.state.tolist()
        newly = int((done & ~before).sum())
        src, hole = live.lists
        assert stay == n - n_ret and n_ret == len(retired)
        assert n_mv <= newly <= n_ret and (last or newly == n_ret)
        assert (hole[:n_mv] < stay).all() and (src[:n_mv] >= stay).all()
        assert torch.equal(hole[:n_mv], hole[:n_mv].sort().values)
        assert torch.equal(src[:n_mv], src[:n_mv].sort().values)
        left = set(live_cols.tolist()) - retired
        assert sorted(live.col[:stay].tolist()) == sorted(left)
        assert not done[live.col[:stay].long()].any()
        assert not live.synd.any()
        seen.append((n, stay, n_ret, n_mv, newly))
        return out

    monkeypatch.setattr(turbo_cells, "live_compact", spy)
    hard, iters, L = turbo_decode(*inputs, cfg, device="cpu")
    assert _in_regime(iters, regime)
    assert len(seen) == int(iters.max())
    assert seen[0][0] == B and seen[-1][1] == 0
    for (_, stay, *_), (n, *_) in zip(seen, seen[1:]):
        assert n == stay


def _expected_columns(iters, B):
    """The columns a decode's SISO calls span.  n_i codewords are live at
    the start of iteration i (n_0 = B); both calls of iteration i >= 1 are
    launched before the read that gives n_i, on the host's bound n_(i-1),
    and two more before the read that ends the loop ahead of the cap."""
    it = iters.numpy()
    n = [int((it > i).sum()) for i in range(int(it.max()))]
    widths = [B] + n[:-1] + ([n[-1]] if len(n) < N_ITERS else [])
    return 2 * sum(widths), 2 * len(widths) * B


@pytest.mark.parametrize("regime", list(REGIMES))
@pytest.mark.parametrize("fold", [False, True])
def test_siso_columns_count_what_ran(regime, fold):
    """`siso_columns.run` adds the columns each SISO call's grid spans,
    `siso_columns.full` the B that the freezing loop runs a call: equal in
    the freezing loop, the run's share below 1 where codewords retire
    before the last iteration run."""
    B = 19
    cfg = _config(dict(NII, io_dtype="bfloat16", ext_dtype="int8",
                       fold_gather=fold))
    inputs = make_decode_inputs(K, B, seed=7, ebn0_db=REGIMES[regime],
                                with_crc=True)
    before = _device.LAUNCHES.copy()
    _, iters, _ = turbo_decode(*inputs, cfg, device="cpu")
    cols = {k: _device.LAUNCHES[k] - before[k]
            for k in ("siso_columns.run", "siso_columns.full")}
    run, full = _expected_columns(iters, B)
    assert cols == {"siso_columns.run": run, "siso_columns.full": full}
    # all done after one iteration: the calls launched ahead span B, and
    # nothing is saved
    assert (run < full) == (regime == "every")
    before = _device.LAUNCHES.copy()
    turbo_decode(*inputs, cfg, device="cpu", **_per_codeword(cfg, B))
    frozen = [_device.LAUNCHES[k] - before[k]
              for k in ("siso_columns.run", "siso_columns.full")]
    assert frozen[0] == frozen[1] == B * (2 * int(iters.max())
                                          + int(iters.max() < N_ITERS))


def test_siso_live_refuses_what_it_does_not_take():
    T, B = 64, 6
    ls = torch.zeros((T, B))
    one = torch.tensor([3], dtype=torch.int32)
    with pytest.raises(ValueError, match="bound"):
        siso_cells(ls, ls, ls, 40, "maxlog", window=32, live=(one, B + 1))
    with pytest.raises(ValueError, match="bound"):
        siso_cells(ls, ls, ls, 40, "maxlog", window=32, live=(one, 0))
    with pytest.raises(ValueError, match="int32"):
        siso_cells(ls, ls, ls, 40, "maxlog", window=32,
                   live=(one.long(), B))
    e0 = torch.zeros((8, B))
    with pytest.raises(ValueError, match="boundary"):
        siso_cells(ls, ls, ls, 40, "maxlog", window=32, boundaries=(e0, e0),
                   live=(one, B))


# ---------------------------------------------------------------- the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _bits(x: torch.Tensor) -> torch.Tensor:
    """A tensor's elements as integers of their width, on the CPU."""
    width = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[x.element_size()]
    return x.contiguous().view(width).cpu()


def _streams(g, shape, dtype, dev):
    """Random (KTp, B) streams of `dtype`, as the loop carries them
    (float8 as its bytes, no NaN codes)."""
    if dtype == torch.int8:
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)
    if dtype == FP8:
        x = torch.randint(0, 256, shape, generator=g, device=dev,
                          dtype=torch.uint8)
        return torch.where((x & 0x7F) == 0x7F, 0x38, x).to(torch.uint8)
    return (torch.randn(shape, generator=g, device=dev) * 30).to(dtype)


def live_case(B, K_, chan, ext, nii, fold, share, n0, seed, dev):
    """One iteration's operands of the live prefix's kernels at (B, K): a
    prefix of n0 columns holding a random choice of codewords, of which
    about `share` have channel LLRs that outweigh the extrinsics and form a
    valid CRC-24B word (they pass); done/iters per codeword; the working
    set's channel streams, carry and window tables; the outputs."""
    g = torch.Generator(device=dev).manual_seed(seed)
    KTp = -(-(K_ + 3) // 32) * 32
    ls1 = torch.randn((KTp, B), generator=g, device=dev) * 5
    rng = np.random.default_rng(seed)
    passing = np.flatnonzero(rng.random(n0) < share)
    words = rng.integers(0, 2, (len(passing), K_ - 24), dtype=np.int64)
    valid = np.concatenate(
        [words, words @ crc_matrix(K_ - 24, CRC24B_POLY) % 2], 1)
    ls1[:K_, passing] = torch.from_numpy(
        np.where(valid.T == 1, -4096.0, 4096.0).astype(np.float32)).to(dev)
    ls1 = ls1.to(chan)
    e = lambda: _streams(g, (KTp, B), ext, dev)
    le1, le2 = e(), e()
    le21_nat = e() if fold else le2
    moved = (ls1, *(_streams(g, (KTp, B), chan, dev) for _ in range(3)),
             le2)
    cks = ((torch.randn((KTp // 32, 8, B), generator=g, device=dev),
            torch.randn((KTp // 32, 8, B), generator=g, device=dev))
           if nii else (None, None))
    live = layout.live_prefix(B, dev)
    cw = torch.from_numpy(rng.permutation(B).astype(np.int32)).to(dev)
    live.col.copy_(cw)
    live.state[0] = n0
    done = torch.ones((B,), dtype=torch.bool, device=dev)
    done[cw[:n0].long()] = False
    iters = torch.from_numpy(rng.integers(0, 6, B, dtype=np.int32)).to(dev)
    outs = (torch.zeros((B, K_), dtype=torch.int8, device=dev),
            torch.zeros((B, K_), device=dev))
    return dict(ls1=ls1, le1=le1, le21_nat=le21_nat, moved=moved + cks,
                live=live, done=done, iters=iters, outs=outs)


def _clone(case, dev):
    """The case's tensors on `dev`, copies; the working ls1 and the natural
    carry stay one tensor with the moved arrays."""
    c = {k: (v.to(dev, copy=True) if isinstance(v, torch.Tensor) else v)
         for k, v in case.items() if k not in ("moved", "live", "outs")}
    moved = tuple(None if x is None else x.to(dev, copy=True)
                  for x in case["moved"])
    c["ls1"] = moved[0]
    if case["le21_nat"] is case["moved"][4]:
        c["le21_nat"] = moved[4]
    c["moved"] = moved
    c["live"] = layout.LivePrefix(*(x.to(dev, copy=True)
                                    for x in case["live"]))
    c["outs"] = tuple(x.to(dev, copy=True) for x in case["outs"])
    return c


def _run_live(c, K_, ext, last):
    deq = 0.1875 if ext == torch.int8 else 0.75
    n = int(c["live"].state[0])
    layout.live_syndromes(c["ls1"], c["le1"], c["le21_nat"], K_, deq, ext,
                          CRC24B_POLY, c["live"], max(n, 1))
    synd = c["live"].synd.clone()
    layout.retire_outputs(*c["outs"], c["ls1"], c["le1"], c["le21_nat"], K_,
                          deq, ext, c["live"], max(n, 1), last)
    layout.live_compact(c["done"], c["iters"], c["live"], c["moved"], last)
    return synd


@pytest.mark.cuda
@pytest.mark.parametrize("B,K_", [(13, 40), (64, 5824), (1000, 40),
                                  (6656, 5824)])
@pytest.mark.parametrize("ext,chan", [(torch.int8, torch.bfloat16),
                                      (torch.bfloat16, torch.float32),
                                      (torch.float32, torch.bfloat16),
                                      (FP8, torch.float32)])
@pytest.mark.parametrize("share,last", [(0.0, False), (0.33, False),
                                        (0.9, False), (0.33, True)])
def test_live_kernels_match_plain_on_card(B, K_, ext, chan, share, last):
    """`live_syndromes`, `retire_outputs` and `live_compact` on the card
    equal their plain versions byte for byte: the syndromes, the retired
    codewords' rows of hard and L, done, iters, col, the state, the moves
    and the moved columns of every working array; the launches are one
    exit_kernel, one unpack_kernel, one live_close_kernel and one
    compact_kernel."""
    dev = _card()
    nii = ext != torch.float32
    fold = ext in (torch.bfloat16, FP8)
    n0 = B - B // 7
    case = live_case(B, K_, chan, ext, nii, fold, share, n0, seed=B + K_,
                     dev=dev)
    want = _clone(case, torch.device("cpu"))
    got = _clone(case, dev)
    synd_w = _run_live(want, K_, ext, last)
    before = dict(_device.LAUNCHES)
    synd_g = _run_live(got, K_, ext, last)
    torch.cuda.synchronize()
    assert {k: _device.LAUNCHES[k] - before.get(k, 0)
            for k in layout.KERNELS} == {
        "pack_kernel": 0, "unpack_kernel": 1, "exit_kernel": 1,
        "exit_close_kernel": 0, "live_close_kernel": 1, "compact_kernel": 1}
    assert torch.equal(synd_g[:n0].cpu(), synd_w[:n0])
    assert (synd_w[:n0] == 0).float().mean() >= share * 0.5
    stay, n_ret, n_mv = want["live"].state.tolist()
    assert got["live"].state.tolist() == [stay, n_ret, n_mv]
    assert n_ret == (n0 if last else int((synd_w[:n0] == 0).sum()))
    for name in ("done", "iters"):
        assert torch.equal(got[name].cpu(), want[name])
    assert torch.equal(got["live"].col[:stay].cpu(), want["live"].col[:stay])
    assert not got["live"].synd.any()
    assert torch.equal(got["live"].lists[:, :n_mv].cpu(),
                       want["live"].lists[:, :n_mv])
    rows = case["live"].col[:n0][(synd_w[:n0] == 0) | last].long().cpu()
    assert len(rows) == n_ret
    for g, w in zip(got["outs"], want["outs"]):
        assert torch.equal(_bits(g)[rows], _bits(w)[rows])
        assert torch.equal(_bits(g), _bits(w))    # the others: untouched
    for g, w in zip(got["moved"], want["moved"]):
        if w is not None:
            assert torch.equal(_bits(g[..., :stay]), _bits(w[..., :stay]))


CELL = dict(B=6656, K=5824)     # tb75376-n512-crc: 13 blocks x 512 TBs


@pytest.mark.cuda
@pytest.mark.parametrize("nii", [True, False])
@pytest.mark.parametrize("count,N", [(6656, 6656), (3001, 3001),
                                     (3001, 4000), (17, 6656), (1, 1)])
def test_live_siso_equals_narrowed_columns_on_card(nii, count, N):
    """At the transport-block cells' shape (B=6656, K=5824, KTp=5888, bf16
    channel, int8 extrinsics, NII W=256) a SISO call with a live count of
    n on a grid of N >= n gives the n leading columns of le (and of the
    window table) of the same call on the narrowed operands, byte for
    byte."""
    dev = _card()
    B, K_ = CELL["B"], CELL["K"]
    KTp, W = 5888, 256
    g = torch.Generator(device=dev).manual_seed(count + N)
    ls, lp = ((torch.randn((KTp, B), generator=g, device=dev) * 3)
              .to(torch.bfloat16) for _ in range(2))
    la = torch.randint(-127, 128, (KTp, B), generator=g, device=dev,
                       dtype=torch.int8)
    ain = (torch.randn((KTp // W, 8, B), generator=g, device=dev)
           if nii else None)
    kw = dict(window=W, ext_qscale=0.25, nii_ckpt=ain)
    cnt = torch.tensor([count], dtype=torch.int32, device=dev)
    got = siso_cells(ls, lp, la, K_, "maxlog", 0.75, live=(cnt, N), **kw)
    narrow = lambda x: None if x is None else x[..., :count].contiguous()
    want = siso_cells(narrow(ls), narrow(lp), narrow(la), K_, "maxlog", 0.75,
                      **dict(kw, nii_ckpt=narrow(ain)))
    got, want = (x if nii else (x, None) for x in (got, want))
    assert torch.equal(got[0][:, :count], want[0])
    if nii:
        assert torch.equal(got[1][1:, :, :count], want[1][1:])


def _mixed_inputs(B, K_, share, seed):
    """(B, K) decoder inputs of which a random `share` of the codewords
    come from a clean channel (done after an iteration or two) and the rest
    from a channel too noisy to pass by the cap."""
    hi = make_decode_inputs(K_, B, seed=seed, ebn0_db=4.0, with_crc=True)
    lo = make_decode_inputs(K_, B, seed=seed + 1, ebn0_db=-1.5,
                            with_crc=True)
    clean = torch.from_numpy(np.random.default_rng(seed).random(B) < share)
    return tuple(torch.where(clean[:, None], h, lo_) for h, lo_ in
                 zip(hi, lo)), clean


@pytest.mark.cuda
@pytest.mark.parametrize("share", [0.0, 0.33, 0.9])
def test_crc_decode_at_the_cell_shape_equals_freezing_loop(share):
    """A `crc` decode at the transport-block cells' shape (6656 codewords
    of K=5824, the flagship decoder) through the live prefix equals the
    freezing loop on the same tables in per-codeword form, byte for byte,
    with 0, 33 and 90% of the codewords done early."""
    dev = _card()
    B, K_ = CELL["B"], CELL["K"]
    cfg = flagship_config(K=K_, early_term="crc")
    inputs, clean = _mixed_inputs(B, K_, share, seed=25)
    inputs = tuple(x.to(dev) for x in inputs)
    before = dict(_device.LAUNCHES)
    got = turbo_decode(*inputs, cfg)
    n = int(got[1].max())
    assert _device.LAUNCHES["live_close_kernel"] - before.get(
        "live_close_kernel", 0) == n
    cols = _device.LAUNCHES["siso_columns.run"] - before.get(
        "siso_columns.run", 0)
    assert (cols < 2 * n * B) == (share > 0)
    want = turbo_decode(*inputs, cfg,
                        **{k: v.to(dev) for k, v in
                           _per_codeword(cfg, B).items()})
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    early = got[1].cpu() < cfg.n_iters
    assert abs(float(early.float().mean()) - share) < 0.05
