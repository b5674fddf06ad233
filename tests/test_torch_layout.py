"""The decoder's two layout crossings (decoder/layout.py, csrc/layout.cu).

On the CPU the plain versions are held to streams and outputs built by hand
with numpy: bodies transposed, tail rows, pad values, bf16 rounded to
nearest even on the bits, float8 codes decoded from their bytes.  The tests
marked `cuda` hold each kernel to its plain version on the card, bit for
bit, and a decode to the CPU's.  This file imports no JAX, so it runs on a
machine without it (`python -m pytest --noconftest tests/test_torch_layout.py
-m cuda`).
"""

import itertools

import numpy as np
import pytest
import torch

from turbotpu_torch import DecoderConfig, _device, turbo_decode
from turbotpu_torch.decoder import layout
from turbotpu_torch.harness.bench import make_decode_inputs
from turbotpu_torch.siso.cuda_kernel import BIG, FP8
from turbotpu_torch.spec.qpp import qpp_inv, qpp_perm

CHAN = (torch.float32, torch.bfloat16)
EXT = (torch.float32, torch.bfloat16, torch.int8, FP8)


def _ktp(K, W):
    """The decoder's padded length: K + 3 rounded up to the window."""
    W = W or (128 if K + 3 >= 256 else -(-(K + 3) // 8) * 8)
    return -(-(K + 3) // W) * W


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """fp32 -> the bits of bf16, rounded to nearest even (no NaN here)."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    u = u.astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _fp8_value(code: np.ndarray) -> np.ndarray:
    """float8_e4m3fn bytes -> their fp32 values (no NaN among them)."""
    s = np.where(code >> 7, -1.0, 1.0)
    e, m = (code >> 3) & 15, code & 7
    v = np.where(e == 0, m * 2.0 ** -9,
                 (1 + m / 8) * 2.0 ** (e.astype(int) - 7))
    return (s * v).astype(np.float32)


def _bits(x: torch.Tensor) -> np.ndarray:
    """A tensor's elements as unsigned integers of their width."""
    width = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[x.element_size()]
    return x.contiguous().view(width).numpy()


def _inputs(B, K, seed):
    g = torch.Generator().manual_seed(seed)
    ls, lp1, lp2 = (torch.randn(B, K, generator=g) * 5 for _ in range(3))
    tail1, tail2 = (torch.randn(B, 6, generator=g) * 5 for _ in range(2))
    return ls, lp1, lp2, tail1, tail2


def _tables(B, K, seed):
    """A shared (K,) table and a time-major (K, B) per-codeword one."""
    g = torch.Generator().manual_seed(seed)
    shared = torch.from_numpy(qpp_perm(K).astype(np.int64))
    per_cw = torch.stack([torch.randperm(K, generator=g) for _ in range(B)])
    return {"shared": shared, "per_codeword": per_cw.T.contiguous()}


def _streams_np(ls, lp1, lp2, tail1, tail2, KTp, perm):
    """The four fp32 (KTp, B) streams, by hand."""
    ls, lp1, lp2, tail1, tail2, perm = (x.numpy() for x in
                                        (ls, lp1, lp2, tail1, tail2, perm))
    B, K = ls.shape
    if perm.ndim == 1:
        sys2 = ls[:, perm]
    else:
        sys2 = ls[np.arange(B)[None, :], perm].T

    def one(body, tail, pad):
        out = np.full((KTp, B), pad, dtype=np.float32)
        out[:K] = body.T
        out[K:K + 3] = tail.T
        return out

    return (one(ls, tail1[:, 0::2], BIG), one(lp1, tail1[:, 1::2], 0.0),
            one(sys2, tail2[:, 0::2], BIG), one(lp2, tail2[:, 1::2], 0.0))


@pytest.mark.parametrize("B,K,W", [(1, 40, 0), (5, 40, 16), (7, 104, 0),
                                   (3, 512, 256)])
@pytest.mark.parametrize("table", ["shared", "per_codeword"])
@pytest.mark.parametrize("dtype", CHAN)
def test_pack_plain_matches_numpy(B, K, W, table, dtype):
    """Bodies transposed (ls2 in the interleaver's order), tail rows from
    tail[:, off::2], pad BIG on the systematic streams and 0 on the parity
    streams; bf16 rounded to nearest even."""
    KTp = _ktp(K, W)
    inputs = _inputs(B, K, seed=K + B)
    perm = _tables(B, K, seed=B)[table]
    launches = dict(_device.LAUNCHES)
    got = layout.pack_streams(*inputs, KTp, dtype, perm)    # CPU: plain
    assert _device.LAUNCHES == launches
    want = _streams_np(*inputs, KTp, perm)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == (KTp, B)
        w_bits = (_bf16_bits(w) if dtype == torch.bfloat16
                  else w.view(np.int32))
        np.testing.assert_array_equal(_bits(g).view(w_bits.dtype), w_bits)
    for s, pad in zip(got, (BIG, 0.0, BIG, 0.0)):
        assert (s[K + 3:] == torch.tensor(pad).to(dtype)).all()


def _extrinsics(KTp, B, ext, seed):
    """Two (KTp, B) extrinsic streams as the loop carries them (float8 as
    bytes), and their fp32 values by hand."""
    rng = np.random.default_rng(seed)
    if ext == torch.int8:
        codes = rng.integers(-127, 128, (2, KTp, B), dtype=np.int8)
        return [torch.from_numpy(c) for c in codes], codes.astype(np.float32)
    if ext == FP8:
        codes = rng.integers(0, 256, (2, KTp, B), dtype=np.uint8)
        codes[(codes & 0x7F) == 0x7F] = 0x38        # no NaN codes: 1.0
        return [torch.from_numpy(c) for c in codes], _fp8_value(codes)
    vals = (rng.standard_normal((2, KTp, B)) * 30).astype(np.float32)
    if ext == torch.bfloat16:
        vals = (_bf16_bits(vals).astype(np.uint32) << 16).view(np.float32)
    return [torch.from_numpy(v).to(ext) for v in vals], vals


@pytest.mark.parametrize("B,K,W", [(1, 40, 0), (6, 40, 16), (3, 168, 0)])
@pytest.mark.parametrize("ext", EXT)
@pytest.mark.parametrize("chan", CHAN)
def test_assemble_plain_matches_numpy(B, K, W, ext, chan):
    """L = ls + deq * (le1 + le21) in fp32, rounded step by step in that
    order, transposed to (B, K); hard = L < 0 (a zero L, and -0, is 0)."""
    KTp = _ktp(K, W)
    rng = np.random.default_rng(K * B)
    ls_np = (rng.standard_normal((KTp, B)) * 5).astype(np.float32)
    ls_np[:4] = 0.0                               # L = deq * (le1 + le21)
    ls1 = torch.from_numpy(ls_np).to(chan)
    ls_f = ls1.to(torch.float32).numpy()
    (le1, le21), vals = _extrinsics(KTp, B, ext, seed=B)
    for x in (le1, le21, vals[0], vals[1]):       # ... and a row of zeros
        x[1] = 0
    deq = 0.75 * 0.25 if ext == torch.int8 else 0.7
    hard, L = layout.assemble_outputs(ls1, le1, le21, K, deq, ext)
    f = np.float32
    want = (ls_f[:K] + f(deq) * (vals[0, :K] + vals[1, :K])).astype(f)
    assert L.dtype == torch.float32 and L.shape == (B, K)
    np.testing.assert_array_equal(L.numpy().view(np.int32),
                                  np.ascontiguousarray(want.T).view(np.int32))
    np.testing.assert_array_equal(hard.numpy(), (want.T < 0).astype(np.int8))
    assert hard.dtype == torch.int8 and not hard[:, 1].any()


def test_assemble_plain_under_fold():
    """Under fold_gather the loop carries le2 in interleaved order: the
    outputs take it de-interleaved by the inverse table (rows from K the
    identity), as le21."""
    K, B, W = 40, 3, 0
    KTp = _ktp(K, W)
    inv_e = torch.from_numpy(np.concatenate(
        [qpp_inv(K), np.arange(K, KTp)]).astype(np.int64))
    (le1, le2_raw), vals = _extrinsics(KTp, B, torch.int8, seed=5)
    ls1 = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (KTp, B)).astype(np.float32)).to(torch.bfloat16)
    hard, L = layout.assemble_outputs(
        ls1, le1, le2_raw.index_select(0, inv_e), K, 0.1875, torch.int8)
    le21 = vals[1][qpp_inv(K)]                    # natural order, by hand
    want = (ls1.float().numpy()[:K]
            + np.float32(0.1875) * (vals[0][:K] + le21)).astype(np.float32)
    np.testing.assert_array_equal(L.numpy(), want.T)
    np.testing.assert_array_equal(hard.numpy(), (want.T < 0).astype(np.int8))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    ls, lp1, lp2, t1, t2 = _inputs(4, 40, seed=0)
    perm = torch.arange(40)
    with pytest.raises(ValueError, match="tail"):
        layout.pack_streams(ls, lp1, lp2, t1, t2, 42, torch.bfloat16, perm)
    with pytest.raises(ValueError, match="lp1"):
        layout.pack_streams(ls, lp1.double(), lp2, t1, t2, 48,
                            torch.bfloat16, perm)
    with pytest.raises(ValueError, match="stream type"):
        layout.pack_streams(ls, lp1, lp2, t1, t2, 48, torch.int8, perm)
    with pytest.raises(ValueError, match="time-major"):
        layout.pack_streams(ls, lp1, lp2, t1, t2, 48, torch.bfloat16,
                            torch.zeros((4, 40), dtype=torch.long))
    ls1 = torch.zeros((48, 4), dtype=torch.bfloat16)
    le = torch.zeros((48, 4), dtype=torch.int8)
    with pytest.raises(ValueError, match="tail"):
        layout.assemble_outputs(ls1, le, le, 46, 1.0, torch.int8)
    with pytest.raises(ValueError, match="le21"):
        layout.assemble_outputs(ls1, le, le.float(), 40, 1.0, torch.int8)
    with pytest.raises(ValueError, match="extrinsic type"):
        layout.assemble_outputs(ls1, le, le, 40, 1.0, torch.uint8)


# ---------------------------------------------------------------- the card

SHAPES = list(itertools.product((1, 33, 1000), (40, 5824, 6144), (256, 0)))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,W", SHAPES)
@pytest.mark.parametrize("table", ["shared", "per_codeword"])
@pytest.mark.parametrize("dtype", CHAN)
def test_pack_kernel_matches_plain_on_card(B, K, W, table, dtype):
    dev = _card()
    KTp = _ktp(K, W)
    inputs = [x.to(dev) for x in _inputs(B, K, seed=K + B)]
    perm = _tables(B, K, seed=B)[table].to(dev)
    before = _device.LAUNCHES["pack_kernel"]
    got = layout.pack_streams(*inputs, KTp, dtype, perm)
    assert _device.LAUNCHES["pack_kernel"] == before + 1
    want = layout.pack_streams_plain(*inputs, KTp, dtype, perm)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(_bits(g.cpu()), _bits(w.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("B,K,W", SHAPES)
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("ext", EXT)
@pytest.mark.parametrize("chan", CHAN)
def test_assemble_kernel_matches_plain_on_card(B, K, W, fold, ext, chan):
    dev = _card()
    KTp = _ktp(K, W)
    ls1 = layout.pack_streams_plain(
        *_inputs(B, K, seed=K), KTp, chan,
        torch.arange(K))[0].to(dev)
    (le1, le21), _ = _extrinsics(KTp, B, ext, seed=B + K)
    le1, le21 = le1.to(dev), le21.to(dev)
    if fold:        # the loop's carry in interleaved order, de-interleaved
        inv_e = torch.from_numpy(np.concatenate(
            [qpp_inv(K), np.arange(K, KTp)]).astype(np.int64)).to(dev)
        le21 = le21.index_select(0, inv_e)
    deq = 0.75 * 0.25 if ext == torch.int8 else 0.75
    before = _device.LAUNCHES["unpack_kernel"]
    hard, L = layout.assemble_outputs(ls1, le1, le21, K, deq, ext)
    assert _device.LAUNCHES["unpack_kernel"] == before + 1
    want_hard, want_L = layout.assemble_outputs_plain(ls1, le1, le21, K, deq,
                                                      ext)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(_bits(L.cpu()), _bits(want_L.cpu()))
    assert torch.equal(hard.cpu(), want_hard.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("cfg_kw", [
    dict(io_dtype="bfloat16", ext_dtype="int8", nii=True, window=32),
    dict(io_dtype="bfloat16", ext_dtype="int8", nii=True, window=32,
         fold_gather=True, early_term="crc"),
    dict(io_dtype="float32", ext_dtype="float8_e4m3fn", early_term="sign"),
    dict(io_dtype="bfloat16", ext_dtype="bfloat16", interleaver="umts"),
])
def test_decode_runs_both_kernels_and_matches_cpu(cfg_kw):
    """A decode on the card launches each kernel once (in `crc` mode the
    live prefix's syndromes, unpack of the codewords that retire, close and
    moves once an iteration) and gives the CPU's bits, iteration counts and
    L."""
    _card()
    K, B = 168, 33
    inputs = make_decode_inputs(K, B, seed=4, ebn0_db=1.0, with_crc=True)
    cfg = DecoderConfig(K=K, n_iters=4, mode="maxlog", siso="cuda", **cfg_kw)
    before = dict(_device.LAUNCHES)
    got = turbo_decode(*inputs, cfg)
    n_exit = int(got[1].max()) if cfg.early_term == "crc" else 0
    assert {k: _device.LAUNCHES[k] - before.get(k, 0)
            for k in layout.KERNELS} == {
        "pack_kernel": 1, "unpack_kernel": n_exit or 1,
        "exit_kernel": n_exit, "exit_close_kernel": 0,
        "live_close_kernel": n_exit, "compact_kernel": n_exit}
    want = turbo_decode(*inputs, cfg, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
