"""The `crc` loop's early exit (decoder/layout.py::crc_exit, csrc/layout.cu:
exit_kernel and exit_close_kernel).

On the CPU the plain version is held to the pass written out by hand with
numpy: L in fp32 rounded step by step in `full_llr`'s order, the syndrome
as the XOR of each 1 bit's packed check mask, the carry frozen on the
columns of codewords done before the call, iters and done updated after
it.  A decode in `crc` mode gives each codeword the lean decode's outputs
at the iterations it counts.  The tests marked `cuda` hold the kernels to
the plain version on the card, byte for byte, and count their launches in
a decode.  This file imports no JAX, so it runs on a machine without it
(`python -m pytest --noconftest tests/test_torch_early_exit.py -m cuda`).
"""

import numpy as np
import pytest
import torch

from turbotpu_torch import DecoderConfig, _device, turbo_decode
from turbotpu_torch.decoder import layout
from turbotpu_torch.decoder.early_term import make_crc_matrix
from turbotpu_torch.harness.bench import make_decode_inputs
from turbotpu_torch.siso.cuda_kernel import FP8
from turbotpu_torch.spec.crc import (CRC24A_POLY, CRC24B_POLY, crc_attach,
                                     crc_matrix)
from turbotpu_torch.spec.qpp import qpp_inv

CHAN = (torch.float32, torch.bfloat16)
EXT = (torch.float32, torch.bfloat16, torch.int8, FP8)
POLYS = {"crc24a": CRC24A_POLY, "crc24b": CRC24B_POLY}


def _ktp(K):
    """The decoder's padded length at the default window."""
    W = 128 if K + 3 >= 256 else -(-(K + 3) // 8) * 8
    return -(-(K + 3) // W) * W


def _bits(x: torch.Tensor) -> np.ndarray:
    """A tensor's elements as integers of their width."""
    width = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[x.element_size()]
    return x.contiguous().view(width).numpy()


def _ext_stream(rng, KTp, B, ext):
    """A (KTp, B) extrinsic stream as the loop carries it (float8 as its
    bytes, no NaN codes), with a row of zeros at row 2."""
    if ext == torch.int8:
        x = torch.from_numpy(rng.integers(-127, 128, (KTp, B), dtype=np.int8))
    elif ext == FP8:
        codes = rng.integers(0, 256, (KTp, B), dtype=np.uint8)
        codes[(codes & 0x7F) == 0x7F] = 0x38
        x = torch.from_numpy(codes)
    else:
        x = torch.from_numpy((rng.standard_normal((KTp, B)) * 30).astype(
            np.float32)).to(ext)
    x[2] = 0
    return x


def _values(x, ext) -> np.ndarray:
    """An extrinsic stream's fp32 values."""
    return x.view(ext).to(torch.float32).numpy()


def exit_case(B, K, chan, ext, poly, carry="natural", table="shared",
              seed=0, dev="cpu"):
    """One iteration's inputs to `crc_exit` at (B, K), as the loop hands
    them over: (ls1, le1, le21, le1_new, le21_nat, le21_new, done, iters),
    and deq.  About a third of the codewords were done before the call; of
    the others, every third has hard bits that form a valid codeword (its
    channel LLR outweighs the extrinsics), one has L = 0 throughout (the
    all-zero word, which passes), the rest random bits.  carry "fold":
    le21_new is le2 in interleaved order and le21_nat its de-interleave;
    "natural": le21_new is the de-interleave itself.  table: a shared QPP
    inverse (`index_select`) or a per-codeword one (`torch.gather`)."""
    rng = np.random.default_rng(seed)
    KTp = _ktp(K)
    ls = rng.standard_normal((KTp, B)).astype(np.float32) * 5
    ls[0] = 0.0
    words = rng.integers(0, 2, (B, K - 24), dtype=np.int64)
    valid = np.concatenate([words, words @ crc_matrix(K - 24, poly) % 2], 1)
    ls[:K, ::3] = np.where(valid[::3].T == 1, -4096.0, 4096.0)
    le1, le21, le1_new, le2 = (_ext_stream(rng, KTp, B, ext)
                               for _ in range(4))
    zero = min(B - 1, 1)
    ls[:, zero] = 0.0
    for x in (le1_new, le2):
        x[:, zero] = 0
    inv = np.concatenate([qpp_inv(K), np.arange(K, KTp)]).astype(np.int64)
    if table == "shared":
        g_inv = lambda x: x.index_select(0, torch.from_numpy(inv))
    else:
        idx = np.stack([inv if b % 2 else np.concatenate(
            [rng.permutation(K), np.arange(K, KTp)]) for b in range(B)], 1)
        g_inv = lambda x: torch.gather(x, 0, torch.from_numpy(idx))
    le21_new = le2 if carry == "fold" else g_inv(le2)
    le21_nat = g_inv(le2) if carry == "fold" else le21_new
    done = torch.from_numpy(rng.random(B) < 0.35)
    done[zero] = False
    iters = torch.from_numpy(rng.integers(0, 6, B, dtype=np.int32))
    streams = (torch.from_numpy(ls).to(chan), le1, le21, le1_new, le21_nat,
               le21_new)
    out = tuple(x.to(dev) for x in streams + (done, iters))
    if carry == "natural":      # the same tensor, as in the loop
        out = out[:4] + (out[5], out[5]) + out[6:]
    deq = 0.75 * 0.25 if ext == torch.int8 else 0.75
    return out, deq


def exit_by_hand(ls1, le1, le21, le1_new, le21_nat, le21_new, done, iters,
                 K, deq, ext, poly):
    """The pass in numpy: (le1, le21, done, iters, all_done) as bytes and
    values."""
    f = np.float32
    ls_f = ls1.to(torch.float32).numpy()[:K]
    L = (ls_f + f(deq) * (_values(le1_new, ext)[:K]
                          + _values(le21_nat, ext)[:K])).astype(f)
    masks = layout.crc_masks_np(K, poly).astype(np.uint32)
    synd = np.bitwise_xor.reduce(np.where(L < 0, masks[:, None], 0), axis=0)
    d = done.numpy()
    keep = d[None, :]
    le1_out = np.where(keep, _bits(le1), _bits(le1_new))
    le21_out = np.where(keep, _bits(le21), _bits(le21_new))
    iters_out = iters.numpy() + (~d).astype(np.int32)
    done_out = d | (synd == 0)
    return le1_out, le21_out, done_out, iters_out, bool(done_out.all())


@pytest.mark.parametrize("K", [40, 5824, 6144])
@pytest.mark.parametrize("poly", list(POLYS))
def test_packed_masks_give_the_matmul_syndrome(K, poly):
    """The XOR of the packed check masks over a word's 1 bits equals
    (bits @ H) mod 2, bit j of the mask for column j, on random words and
    on valid codewords (syndrome 0)."""
    rng = np.random.default_rng(K)
    p = POLYS[poly]
    bits = rng.integers(0, 2, (37, K), dtype=np.uint8)
    bits[::4] = np.stack([crc_attach(w, p) for w in bits[::4, :K - 24]])
    bits[1] = 0
    masks = layout.crc_masks_np(K, p)
    assert masks.dtype == np.int32 and masks.shape == (K,)
    assert 0 <= masks.min() and masks.max() < 1 << 24
    got = np.bitwise_xor.reduce(np.where(bits == 1, masks[None, :], 0), axis=1)
    H = make_crc_matrix(K, p).numpy().astype(np.int64)
    want = (bits.astype(np.int64) @ H) % 2
    np.testing.assert_array_equal(
        got, (want << np.arange(24)).sum(axis=1))
    assert (got[::4] == 0).all() and got[1] == 0
    assert (got[2::4] != 0).all()


@pytest.mark.parametrize("B,K", [(13, 40), (37, 40), (6, 5824), (37, 6144)])
@pytest.mark.parametrize("poly", list(POLYS))
@pytest.mark.parametrize("carry,table", [("natural", "shared"),
                                         ("fold", "shared"),
                                         ("natural", "per_codeword")])
@pytest.mark.parametrize("ext", EXT)
@pytest.mark.parametrize("chan", CHAN)
def test_plain_exit_matches_by_hand(B, K, poly, carry, table, ext, chan):
    """The plain version (a CPU call of `crc_exit`) gives the by-hand pass's
    frozen carries byte for byte, done, iters and the all-done flag, and
    launches nothing."""
    p = POLYS[poly]
    args, deq = exit_case(B, K, chan, ext, p, carry, table, seed=B * K)
    want = exit_by_hand(*args, K, deq, ext, p)
    before = dict(_device.LAUNCHES)
    le1, le21, done, iters, all_done = layout.crc_exit(*args, K, deq, ext, p)
    assert _device.LAUNCHES == before
    np.testing.assert_array_equal(_bits(le1), want[0])
    np.testing.assert_array_equal(_bits(le21), want[1])
    np.testing.assert_array_equal(done.numpy(), want[2])
    np.testing.assert_array_equal(iters.numpy(), want[3])
    assert all_done.dim() == 0 and bool(all_done) == want[4]
    assert done.dtype == torch.bool and iters.dtype == torch.int32
    assert le1.dtype == args[3].dtype and le21.dtype == args[5].dtype
    # the case has both verdicts among the codewords that were live
    live = ~args[6].numpy()
    assert want[2][live].any() and not want[2][live].all()


def test_all_done_flag_once_every_codeword_passes():
    B, K = 5, 40
    args, deq = exit_case(B, K, torch.float32, torch.int8, CRC24A_POLY)
    args = args[:6] + (torch.tensor([True, False, True, True, True]),
                       args[7])
    ls1 = args[0].clone()
    ls1[:, 1] = 0.0                   # L = deq * (le1 + le21) on codeword 1
    le1_new, le21_new = args[3].clone(), args[5].clone()
    le1_new[:, 1] = 0
    le21_new[:, 1] = 0                # ... = 0: the all-zero word
    args = (ls1,) + args[1:3] + (le1_new, le21_new, le21_new) + args[6:]
    _, _, done, iters, all_done = layout.crc_exit(*args, K, deq, torch.int8,
                                                  CRC24A_POLY)
    assert bool(all_done) and done.all()
    assert torch.equal(iters, args[7] + torch.tensor([0, 1, 0, 0, 0],
                                                     dtype=torch.int32))


def test_exit_refuses_what_the_kernel_does_not_take():
    args, deq = exit_case(4, 40, torch.bfloat16, torch.int8, CRC24A_POLY)
    with pytest.raises(ValueError, match="tail"):
        layout.crc_exit(*args, 46, deq, torch.int8, CRC24A_POLY)
    with pytest.raises(ValueError, match="le1_new"):
        layout.crc_exit(*args[:3], args[3].float(), *args[4:], 40, deq,
                        torch.int8, CRC24A_POLY)
    with pytest.raises(ValueError, match="done"):
        layout.crc_exit(*args[:6], args[6].to(torch.uint8), args[7], 40, deq,
                        torch.int8, CRC24A_POLY)
    with pytest.raises(ValueError, match="iters"):
        layout.crc_exit(*args[:7], args[7].long(), 40, deq, torch.int8,
                        CRC24A_POLY)
    with pytest.raises(ValueError, match="extrinsic type"):
        layout.crc_exit(*args, 40, deq, torch.uint8, CRC24A_POLY)


@pytest.mark.parametrize("cfg_kw", [
    dict(io_dtype="bfloat16", ext_dtype="int8", nii=True, window=32),
    dict(io_dtype="bfloat16", ext_dtype="int8", nii=True, window=32,
         fold_gather=True),
    dict(io_dtype="float32", ext_dtype="float8_e4m3fn"),
])
def test_crc_decode_stops_each_codeword_where_it_passes(cfg_kw):
    """Each codeword of a `crc` decode carries the outputs of the lean
    decode run for as many iterations as it counts: its carry froze at the
    iteration its hard bits passed the CRC (or at the cap) in the freezing
    loop (per-codeword tables, `crc_exit`), and it retired then from the
    live prefix (the configuration's shared table, `live_syndromes`).
    Either loop runs its exit once an iteration."""
    import turbotpu_torch.decoder.turbo_cells as tc

    K, B, n = 104, 19, 5
    inputs = make_decode_inputs(K, B, seed=7, ebn0_db=0.5, with_crc=True)
    cfg = dict(K=K, n_iters=n, mode="maxlog", siso="cuda", **cfg_kw)
    c = DecoderConfig(early_term="crc", **cfg)
    per_codeword = dict(perm_b=np.tile(c.perm(), (B, 1)),
                        inv_b=np.tile(c.inv(), (B, 1)))
    outs = []
    for exit_name, tables in (("live_syndromes", {}),
                              ("crc_exit", per_codeword)):
        calls = []
        exit_fn = getattr(tc, exit_name)

        def counted(*a, **k):
            calls.append(1)
            return exit_fn(*a, **k)

        setattr(tc, exit_name, counted)
        try:
            outs.append(turbo_decode(*inputs, c, device="cpu", **tables))
        finally:
            setattr(tc, exit_name, exit_fn)
        it = outs[-1][1].numpy()
        assert len(calls) == it.max() and 1 <= it.min() and it.max() <= n
    for got, want in zip(*outs):
        assert torch.equal(got, want)
    hard, iters, L = outs[0]
    it = iters.numpy()
    assert len(set(it.tolist())) > 1          # codewords stop apart
    for k in sorted(set(it.tolist())):
        h, _, l = turbo_decode(*inputs, DecoderConfig(
            early_term="none", **dict(cfg, n_iters=k)), device="cpu")
        cols = np.flatnonzero(it == k)
        assert torch.equal(hard[cols], h[cols])
        assert torch.equal(L[cols], l[cols])


# ---------------------------------------------------------------- the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _kernel_vs_plain(B, K, chan, ext, poly, carry, table, seed):
    dev = _card()
    args, deq = exit_case(B, K, chan, ext, poly, carry, table, seed, dev)
    want = layout.crc_exit_plain(*args, K, deq, ext, poly)
    got_args = tuple(x.clone() for x in args)
    if carry == "natural":
        got_args = got_args[:4] + (got_args[5], got_args[5]) + got_args[6:]
    scratch = layout.crc_exit_scratch(B, dev)
    before = dict(_device.LAUNCHES)
    got = layout.crc_exit(*got_args, K, deq, ext, poly, scratch)
    assert {k: _device.LAUNCHES[k] - before.get(k, 0)
            for k in layout.KERNELS} == {
        "pack_kernel": 0, "unpack_kernel": 0, "exit_kernel": 1,
        "exit_close_kernel": 1, "live_close_kernel": 0, "compact_kernel": 0}
    torch.cuda.synchronize()
    # written in place, as the loop carries them on
    assert got[0] is got_args[3] and got[1] is got_args[5]
    assert got[2] is got_args[6] and got[3] is got_args[7]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(_bits(g.cpu()), _bits(w.cpu()))
    assert not scratch[0].any()            # the syndrome left zero


@pytest.mark.cuda
@pytest.mark.parametrize("B,K", [(13, 5824), (64, 5824), (13, 40),
                                 (64, 6144), (1000, 40)])
@pytest.mark.parametrize("poly", list(POLYS))
@pytest.mark.parametrize("carry,table", [("natural", "shared"),
                                         ("fold", "shared"),
                                         ("natural", "per_codeword")])
@pytest.mark.parametrize("ext", EXT)
@pytest.mark.parametrize("chan", CHAN)
def test_exit_kernel_matches_plain_on_card(B, K, poly, carry, table, ext,
                                           chan):
    _kernel_vs_plain(B, K, chan, ext, POLYS[poly], carry, table, seed=B + K)


@pytest.mark.cuda
@pytest.mark.parametrize("carry,table", [("natural", "per_codeword"),
                                         ("natural", "shared"),
                                         ("fold", "shared")])
def test_exit_kernel_matches_plain_at_the_transport_block_cell(carry, table):
    """`tb75376-n512-crc`'s shape: 6656 codewords of K=5824 (KTp 5888),
    bf16 channel, int8 extrinsics, CRC-24B."""
    _kernel_vs_plain(6656, 5824, torch.bfloat16, torch.int8, CRC24B_POLY,
                     carry, table, seed=3)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg_kw", [
    dict(io_dtype="bfloat16", ext_dtype="int8", nii=True, window=32),
    dict(io_dtype="bfloat16", ext_dtype="int8", nii=True, window=32,
         fold_gather=True),
    dict(io_dtype="float32", ext_dtype="float8_e4m3fn", interleaver="umts"),
])
def test_crc_decode_launches_the_exit_each_iteration(cfg_kw):
    """A `crc` decode on the card (a shared table: the live prefix)
    launches the syndromes' kernel, the retired codewords' unpack, the
    close and the column moves once an iteration run, and gives the CPU's
    bits, iteration counts and L; a lean decode launches none of them and
    one unpack."""
    _card()
    K, B = 168, 37
    inputs = make_decode_inputs(K, B, seed=4, ebn0_db=1.0, with_crc=True)
    for term in ("crc", "none"):
        cfg = DecoderConfig(K=K, n_iters=5, mode="maxlog", siso="cuda",
                            early_term=term, **cfg_kw)
        before = dict(_device.LAUNCHES)
        got = turbo_decode(*inputs, cfg)
        torch.cuda.synchronize()
        n = int(got[1].max()) if term == "crc" else 0
        assert {k: _device.LAUNCHES[k] - before.get(k, 0)
                for k in layout.KERNELS} == {
            "pack_kernel": 1, "unpack_kernel": n or 1, "exit_kernel": n,
            "exit_close_kernel": 0, "live_close_kernel": n,
            "compact_kernel": n}
        want = turbo_decode(*inputs, cfg, device="cpu")
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
