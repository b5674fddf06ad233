"""The port's SISO modules against the JAX package's, on the CPU.

Inputs are made from a seed with numpy and handed to both sides.  The fused
kernel itself cannot run here: the JAX side runs its Pallas kernel in
interpret mode, the port's wrapper takes its kernel's plain PyTorch version
(it does so because the tensors lie on the CPU), and layouts cross through
turbotpu_torch.convert.  The kernel is held against the same plain version on
a card by the test marked `cuda` and by chip_smoke.py.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from turbotpu.siso import pallas_kernel as jk
from turbotpu.siso.scan import siso_decode_scan as j_scan
from turbotpu_torch import _device, convert
from turbotpu_torch.golden.numpy_ref import bcjr_siso
from turbotpu_torch.harness.bench import make_decode_inputs
from turbotpu_torch.siso import cuda_kernel as ck
from turbotpu_torch.siso.scan import siso_decode_scan as t_scan

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "int8": torch.int8}


def _siso_inputs(K, B, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: (2.0 * rng.normal(size=s)).astype(np.float32)
    return f(B, K + 3), f(B, K + 3), f(B, K)


@pytest.mark.parametrize("mode", ["logmap", "maxlog", "linlog"])
def test_scan_matches_jax(mode):
    """(b) siso_decode_scan, port vs JAX, K=40.  atol 1e-4: both run fp32
    but reduce max* (logsumexp, the running max) in another order."""
    ls, lp, la = _siso_inputs(40, 4, seed=1)
    Lj, lej = j_scan(jnp.asarray(ls), jnp.asarray(lp), jnp.asarray(la), mode=mode)
    Lt, let = t_scan(*map(torch.from_numpy, (ls, lp, la)), mode=mode)
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), atol=1e-4, rtol=0)
    np.testing.assert_allclose(let.numpy(), np.asarray(lej), atol=1e-4, rtol=0)


@pytest.mark.parametrize("mode", ["logmap", "maxlog"])
def test_scan_matches_scalar_golden(mode):
    ls, lp, la = _siso_inputs(40, 2, seed=2)
    Lt, let = t_scan(*(torch.from_numpy(x).double() for x in (ls, lp, la)),
                     mode=mode)
    for b in range(2):
        L, le = bcjr_siso(ls[b].astype(np.float64), lp[b].astype(np.float64),
                          la[b].astype(np.float64), mode)
        np.testing.assert_allclose(Lt[b].numpy(), L, atol=1e-9)
        np.testing.assert_allclose(let[b].numpy(), le, atol=1e-9)


def test_exact_kernel_plain_matches_scan():
    """The exact contract is the unwindowed max-log BCJR: its plain version,
    through the drop-in entry, against the scan SISO (which renormalises at
    every step, hence 1e-4 and not 0)."""
    ls, lp, la = map(torch.from_numpy, _siso_inputs(168, 3, seed=3))
    Ls, les = t_scan(ls, lp, la, mode="maxlog")
    Lk, lek = ck.siso_decode_cuda(ls, lp, la, mode="maxlog")
    np.testing.assert_allclose(Lk.numpy(), Ls.numpy(), atol=1e-4, rtol=0)
    np.testing.assert_allclose(lek.numpy(), les.numpy(), atol=1e-4, rtol=0)


def _streams(K, B, W, seed):
    """fp32 (KTp, B) numpy streams of one SISO, padded as the decoder pads."""
    ls, lp1, _, t1, _ = (x.numpy() for x in
                         make_decode_inputs(K, B, seed=seed, ebn0_db=1.0))
    KTp = -(-(K + 3) // W) * W
    pad = lambda body, tail, v: np.ascontiguousarray(np.pad(
        np.concatenate([body, tail], 1), ((0, 0), (0, KTp - K - 3)),
        constant_values=v).T.astype(np.float32))
    return pad(ls, t1[:, 0::2], jk.BIG), pad(lp1, t1[:, 1::2], 0.0)


def _to_jax(x_tb, dtype):
    """(T, B) numpy (fp32 values or int8 codes) -> JAX cell layout."""
    return jnp.asarray(convert.tb_to_cells(x_tb)).astype(dtype)


def _le_np(le_t):
    return le_t.to(torch.float32).numpy()


@pytest.mark.parametrize("nii,chan,ext,scale", [
    (True, "float32", "float32", 0.75), (False, "float32", "float32", 0.75),
    (True, "bfloat16", "bfloat16", 0.75), (False, "bfloat16", "bfloat16", 0.75),
    (True, "bfloat16", "int8", 0.75), (False, "bfloat16", "int8", 0.75),
    (True, "float32", "float32", 0.5)])
def test_one_siso_call_matches_pallas_interpret(nii, chan, ext, scale):
    """(c) One SISO call, K=168, W=32, B=8: the JAX package's Pallas kernel
    in interpret mode against the port's plain versions.  NII is fed a
    non-zero a-priori stream and non-zero window starts taken from a previous
    call.  Tolerance 0 for int8 codes, bf16 extrinsics and checkpoints.  With
    fp32 extrinsics and scale 0.75 the a-priori product scale*la is not exact
    in fp32, and XLA:CPU contracts la*scale + ls into one FMA where the port
    (like its kernel) rounds the product first: the last bit of a branch
    metric may differ, so le and aout are held to 1e-4 there.  With scale 0.5
    the product is exact and fp32 extrinsics are held to 0 as well."""
    K, W, B = 168, 32, 8
    qs = 0.25 if ext == "int8" else 0.0
    exact_inputs = ext != "float32" or scale == 0.5
    ls_np, lp_np = _streams(K, B, W, seed=7)
    T = ls_np.shape[0]
    n_win = T // W
    dt, dte = TORCH_DT[chan], TORCH_DT[ext]
    ls_t, lp_t = (torch.from_numpy(x).to(dt) for x in (ls_np, lp_np))
    ls_j, lp_j = _to_jax(ls_np, chan), _to_jax(lp_np, chan)

    def check(le_t, le_j, ck_t=None, ck_j=None):
        got = _le_np(le_t)
        want = convert.cells_to_tb(np.asarray(le_j.astype(jnp.float32)), B)
        if exact_inputs:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        if ck_t is not None:
            want_ck = convert.ckpt_cells_to_port(np.asarray(ck_j), B)
            np.testing.assert_allclose(ck_t.numpy()[1:], want_ck[1:],
                                       atol=0 if exact_inputs else 1e-4, rtol=0)

    # first call, cold: la = 0, window starts = 0 (the port's alone; the
    # comparison below uses its outputs as inputs of both sides)
    la0 = torch.zeros((T, B), dtype=dte)
    le1_t, ck1_t = ck.siso_cells(ls_t, lp_t, la0, K, "maxlog", scale,
                                 nii_ckpt=torch.zeros((n_win, 8, B)),
                                 window=W, ext_qscale=qs)
    assert ck1_t[1:].abs().max() > 0 and le1_t.to(torch.float32).abs().max() > 0
    la_j = _to_jax(_le_np(le1_t) if ext != "int8" else le1_t.numpy(), ext)
    if nii:
        le_t, ck_t = ck.siso_cells(ls_t, lp_t, le1_t, K, "maxlog", scale,
                                   nii_ckpt=ck1_t, window=W, ext_qscale=qs)
        le_j, ck_j = jk.siso_cells(
            ls_j, lp_j, la_j, K, "maxlog", scale, interpret=True,
            nii_ckpt=jnp.asarray(convert.ckpt_port_to_cells(ck1_t.numpy())),
            window=W, ext_qscale=qs)
        check(le_t, le_j, ck_t, ck_j)
    else:
        le_t = ck.siso_cells(ls_t, lp_t, le1_t, K, "maxlog", scale,
                             window=W, ext_qscale=qs)
        le_j = jk.siso_cells(ls_j, lp_j, la_j, K, "maxlog", scale,
                             interpret=True, window=W, ext_qscale=qs)
        check(le_t, le_j)


def test_plain_nii_equals_exact_on_one_window():
    """With a single window NII starts from e0 like the exact contract."""
    K, W, B = 40, 48, 5
    ls_np, lp_np = _streams(K, B, W, seed=9)
    ls, lp = torch.from_numpy(ls_np), torch.from_numpy(lp_np)
    la = torch.from_numpy(np.random.default_rng(9).normal(
        size=ls_np.shape).astype(np.float32))
    le_n, _ = ck.siso_nii_plain(ls, lp, la, torch.zeros((1, 8, B)), K, W, 0.75)
    le_x = ck.siso_exact_plain(ls, lp, la, K, W, 0.75)
    assert torch.equal(le_n, le_x)


def test_layout_round_trips():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(24, 1030)).astype(np.float32)
    cells = convert.tb_to_cells(x)
    assert cells.shape == (2, 24, 8, 128)
    np.testing.assert_array_equal(convert.cells_to_tb(cells, 1030), x)
    # the JAX package's own packing of a (B, T) batch gives the same cells
    xb = np.zeros((2048, 24), np.float32)
    xb[:1030] = x.T
    np.testing.assert_array_equal(np.asarray(jk.to_cells(jnp.asarray(xb))), cells)
    c = rng.normal(size=(3, 8, 1030)).astype(np.float32)
    cc = convert.ckpt_port_to_cells(c)
    assert cc.shape == (2, 3, 8, 8, 128)
    np.testing.assert_array_equal(convert.ckpt_cells_to_port(cc, 1030), c)
    # state s of codeword b = cell*1024 + sub*128 + lane sits at [cell, w, s, sub, lane]
    assert cc[1, 2, 5, 0, 3] == c[2, 5, 1024 + 3]


def test_window_len_and_quantize_match_jax():
    for KT in (43, 171, 255, 256, 6147):
        assert ck.window_len(KT) == jk.window_len(KT)
    x = np.concatenate([np.arange(-40, 40, 0.125), [0.374, 0.376, 1e3, -1e3]]
                       ).astype(np.float32)
    for name, dt in (("int8", jnp.int8), ("bfloat16", jnp.bfloat16)):
        got = ck._quantize_le(torch.from_numpy(x), TORCH_DT[name], 0.25)
        want = jk._quantize_le(jnp.asarray(x), dt, 0.25)
        np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                      np.asarray(want.astype(jnp.float32)))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    T, B, K = 64, 4, 40
    z = lambda dt=torch.float32: torch.zeros((T, B), dtype=dt)
    with pytest.raises(ValueError, match="unknown max"):
        ck.siso_cells(z(), z(), z(), K, "constlog")
    for mode in ("logmap", "linlog"):        # all three modes are taken
        assert ck.siso_cells(z(), z(), z(), K, mode).shape == (T, B)
    with pytest.raises(ValueError, match="contiguous"):
        ck.siso_cells(torch.zeros((B, T)).T, z(), z(), K, "maxlog")
    with pytest.raises(TypeError):
        ck.siso_cells(z(torch.float64), z(torch.float64), z(), K, "maxlog")
    with pytest.raises(ValueError, match="ext_qscale"):
        ck.siso_cells(z(), z(), z(torch.int8), K, "maxlog")
    with pytest.raises(ValueError, match="multiple"):
        ck.siso_cells(z(), z(), z(), K, "maxlog", window=48)
    with pytest.raises(ValueError, match="nii_ckpt"):
        ck.siso_cells(z(), z(), z(), K, "maxlog", window=32,
                      nii_ckpt=torch.zeros((3, 8, B)))
    # float8_e4m3fn extrinsics are taken: on the same a-priori values the
    # fp8 call's le is the fp32 call's, saturated and rounded to fp8
    rng = np.random.default_rng(2)
    r = lambda: torch.from_numpy((rng.normal(size=(T, B)) * 4).astype(
        np.float32))
    ls, lp, la = r(), r(), r().to(torch.float8_e4m3fn)
    le8 = ck.siso_cells(ls, lp, la, K, "maxlog", 0.75)
    le32 = ck.siso_cells(ls, lp, la.to(torch.float32), K, "maxlog", 0.75)
    assert le8.dtype == torch.float8_e4m3fn
    assert torch.equal(le8.view(torch.uint8), ck._quantize_le(
        le32, torch.float8_e4m3fn, 0.0).view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("chan,ext", [("bfloat16", "int8"),
                                      ("float32", "float32")])
def test_kernels_match_plain_on_card(chan, ext):
    """Needs a card: the CUDA kernels against their plain versions, equal
    (le and the NII window starts)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    K, W, B, scale = 168, 32, 70, 0.75
    qs = 0.25 if ext == "int8" else 0.0
    dev = torch.device("cuda")
    ls_np, lp_np = _streams(K, B, W, seed=11)
    ls, lp = (torch.from_numpy(x).to(dev, TORCH_DT[chan]) for x in (ls_np, lp_np))
    T = ls.shape[0]
    before = _device.LAUNCHES.copy()
    la, ain = ck.siso_cells(ls, lp, torch.zeros((T, B), dtype=TORCH_DT[ext], device=dev),
                            K, "maxlog", scale, window=W, ext_qscale=qs,
                            nii_ckpt=torch.zeros((T // W, 8, B), device=dev))
    le, aout = ck.siso_cells(ls, lp, la, K, "maxlog", scale, window=W,
                             ext_qscale=qs, nii_ckpt=ain)
    le_x = ck.siso_cells(ls, lp, la, K, "maxlog", scale, window=W, ext_qscale=qs)
    assert _device.LAUNCHES["siso_nii"] == before["siso_nii"] + 2
    assert _device.LAUNCHES["siso_exact"] == before["siso_exact"] + 1
    le_p, aout_p = ck.siso_nii_plain(ls, lp, la, ain, K, W, scale, qs)
    assert torch.equal(le, le_p) and torch.equal(aout[1:], aout_p[1:])
    assert torch.equal(le_x, ck.siso_exact_plain(ls, lp, la, K, W, scale, qs))
    # the window-parallel exact and NII kernels, every mode: B = 70 is not
    # a multiple of their 4-codeword warps (pass 1) or 32-codeword blocks;
    # K=40 in one window (of 48: three segments; of 64: one segment, no
    # first pass); K_real = 150 masks rows of the K=168 trellis
    for mode in ("maxlog", "linlog", "logmap"):
        for K_, W_, K_real in ((168, 32, 168), (40, 48, 40), (40, 64, 40),
                               (168, 32, 150)):
            s_np, p_np = _streams(K_, B, W_, seed=12)
            ls_, lp_ = (torch.from_numpy(x).to(dev, TORCH_DT[chan])
                        for x in (s_np, p_np))
            T_ = ls_.shape[0]
            la_, ain_ = ck.siso_cells(ls_, lp_, torch.zeros(
                ls_.shape, dtype=TORCH_DT[ext], device=dev), K_real, mode,
                scale, window=W_, ext_qscale=qs,
                nii_ckpt=torch.zeros((T_ // W_, 8, B), device=dev))
            name = ck.kernel_name(False, mode)
            n = _device.LAUNCHES[name]
            got = ck.siso_cells(ls_, lp_, la_, K_real, mode, scale,
                                window=W_, ext_qscale=qs)
            assert _device.LAUNCHES[name] == n + 1
            assert torch.equal(got, ck.siso_exact_plain(
                ls_, lp_, la_, K_real, W_, scale, qs, mode)), (mode, K_, W_)
            name = ck.kernel_name(True, mode)
            n = _device.LAUNCHES[name]
            got, aout_ = ck.siso_cells(ls_, lp_, la_, K_real, mode, scale,
                                       window=W_, ext_qscale=qs,
                                       nii_ckpt=ain_)
            assert _device.LAUNCHES[name] == n + 1
            want, aout_p = ck.siso_nii_plain(ls_, lp_, la_, ain_, K_real, W_,
                                             scale, qs, mode)
            assert torch.equal(got, want), (mode, K_, W_)
            assert torch.equal(aout_[1:], aout_p[1:]), (mode, K_, W_)
