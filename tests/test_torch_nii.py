"""The window-parallel schedule of the NII SISO kernel, on the CPU.

csrc/siso.cu runs the NII contract (K1, and K3's NII rows) on the exact
contract's two passes.  Pass 1 walks beta backward from e0 at the padded end
over the whole trellis (beta is exact in the NII contract too) and leaves
beta at each segment end; beside it, alpha walks over every window from the
start the previous half-iteration left (`ain`; e0 for window 0) and leaves
alpha at each segment start inside the window and the window's end alpha
(`aout`).  Pass 2 decodes every (segment, codeword) pair alone from its two
checkpoints.  Segments divide the window, so every segment edge is an 8-step
renorm edge of the window's walk.  The kernel cannot run here.
`_nii_window_parallel` below is a plain rendering of that schedule with the
same step functions, and it must equal `siso_nii_plain` (the serial schedule,
which the Pallas kernel is held to in tests/test_torch_siso.py and the CUDA
kernel on the card) bit for bit in le and aout[1:], in every mode and stream
type, and with the folded read of K5 (`gather_idx`) to
`siso_nii_plain(..., gather_idx=)`.  On one shape the Pallas kernel in
interpret mode is held to the rendering directly.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from turbotpu.siso import pallas_kernel as jk
from turbotpu_torch import convert
from turbotpu_torch.harness.bench import make_decode_inputs
from turbotpu_torch.siso import cuda_kernel as ck
from turbotpu_torch.spec.qpp import qpp_perm

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "int8": torch.int8}
U = ck.UNROLL


def _nii_window_parallel(ls, lp, la, ain, K_real, W, seg, scale, qs, mode,
                         gather_idx=None):
    """The NII contract in the kernel's window-parallel schedule, segments
    of `seg` steps (a multiple of 8 that divides W).  With gather_idx (K5,
    the folded read) the a-priori row of step t is row gather_idx[t] of la.
    Returns (le, aout); aout[0] is zero, as the kernel leaves it unwritten.
    Every recursion runs on (8, B) tensors, as in the serial plain version,
    so the elementwise functions see the same shapes."""
    T, B = ls.shape
    n_win, n_seg, nsub = T // W, T // seg, seg // U
    assert W % seg == 0 and seg % U == 0
    tb = ck._Tables(ls.device)
    f32 = torch.float32
    eff = scale * (qs if qs else 1.0)
    sm = torch.where(torch.arange(T) < K_real, torch.tensor(eff, dtype=f32),
                     torch.zeros((), dtype=f32))[:, None]
    rows = la if gather_idx is None else la[gather_idx.long()]
    A = -(rows.to(f32) * sm + ls.to(f32))
    P = -lp.to(f32)
    G = torch.stack([torch.zeros_like(P), P, A, A + P], dim=1)
    e0 = ck._e0(B, ls.device)

    # pass 1, beta: from e0 at the padded end down to row seg, renormalised
    # after every block, a checkpoint at each segment end
    bck, beta = [None] * (n_seg - 1) + [e0], e0
    for t in range(T - 1, seg - 1, -1):
        beta = ck._beta_step(beta, G[t], tb, mode)
        if t % U == 0:
            beta = ck._renorm(beta)
        if t % seg == 0:
            bck[t // seg - 1] = beta

    # pass 1, alpha (independent of beta and of each other): every window
    # from its inherited start, renormalised after every block of the
    # window, a checkpoint at each segment start, the window's end to aout
    ack = [None] * n_seg
    aout = torch.zeros((n_win, 8, B), dtype=f32)
    for w in range(n_win):
        alpha = e0 if w == 0 else ain[w]
        for tw in range(W):
            t = w * W + tw
            if tw % seg == 0:
                ack[t // seg] = alpha
            alpha = ck._alpha_step(alpha, G[t], tb, mode)
            if (tw + 1) % U == 0:
                alpha = ck._renorm(alpha)
        if w + 1 < n_win:
            aout[w + 1] = alpha

    # pass 2: each segment alone, from its two checkpoints
    le = torch.empty((T, B), dtype=la.dtype)
    for j in reversed(range(n_seg)):      # any order: segments are independent
        base = j * seg
        sub, alpha = [], ack[j]
        for i in range(nsub):
            sub.append(alpha)
            if i + 1 < nsub:
                for t in range(base + i * U, base + (i + 1) * U):
                    alpha = ck._alpha_step(alpha, G[t], tb, mode)
                alpha = ck._renorm(alpha)
        beta = bck[j]
        for i in reversed(range(nsub)):
            t0 = base + i * U
            at = [sub[i]]
            for k in range(U - 1):
                at.append(ck._alpha_step(at[-1], G[t0 + k], tb, mode))
            for k in reversed(range(U)):
                le[t0 + k] = ck._quantize_le(
                    ck._extrinsic(at[k], beta, P[t0 + k], tb, mode),
                    la.dtype, qs)
                beta = ck._beta_step(beta, G[t0 + k], tb, mode)
            beta = ck._renorm(beta)
    return le, aout


def _case(K, W, B, chan, ext, seed, mode, K_real=None):
    """A decoder-padded stream pair of one SISO, a real a-priori stream and
    real window starts (both from a cold NII call)."""
    ls, lp1, _, t1, _ = (x.numpy() for x in
                         make_decode_inputs(K, B, seed=seed, ebn0_db=1.0))
    KTp = -(-(K + 3) // W) * W
    pad = lambda body, tail, v: torch.from_numpy(np.ascontiguousarray(np.pad(
        np.concatenate([body, tail], 1), ((0, 0), (0, KTp - K - 3)),
        constant_values=v).T.astype(np.float32))).to(TORCH_DT[chan])
    ls_t, lp_t = pad(ls, t1[:, 0::2], ck.BIG), pad(lp1, t1[:, 1::2], 0.0)
    qs = 0.25 if ext == "int8" else 0.0
    scale = 0.75 if mode == "maxlog" else 1.0
    K_real = K_real or K
    la, ain = ck.siso_cells(ls_t, lp_t, torch.zeros((KTp, B),
                                                    dtype=TORCH_DT[ext]),
                            K_real, mode, scale, window=W, ext_qscale=qs,
                            nii_ckpt=torch.zeros((KTp // W, 8, B)))
    assert la.to(torch.float32).abs().max() > 0
    assert KTp == W or ain[1:].abs().max() > 0
    return ls_t, lp_t, la, ain, K_real, scale, qs


def _assert_schedule_equal(ls, lp, la, ain, K_real, W, segs, scale, qs, mode):
    le_p, aout_p = ck.siso_nii_plain(ls, lp, la, ain, K_real, W, scale, qs,
                                     mode)
    assert ck.exact_segment(W) in segs
    for seg in segs:
        le, aout = _nii_window_parallel(ls, lp, la, ain, K_real, W, seg,
                                        scale, qs, mode)
        assert torch.equal(le, le_p), seg
        assert torch.equal(aout[1:], aout_p[1:]), seg


@pytest.mark.parametrize("mode", ["maxlog", "linlog", "logmap"])
@pytest.mark.parametrize("chan,ext,B,W,segs", [
    ("bfloat16", "int8", 8, 32, (8, 32)),      # six windows
    ("bfloat16", "bfloat16", 6, 64, (16, 64)),  # three windows
    ("float32", "float32", 4, 32, (16, 32)),
])
def test_window_parallel_schedule_equals_the_serial_plain_version(
        mode, chan, ext, B, W, segs):
    """K=168 (T=192): the schedule gives le and aout[1:] equal bit for bit
    on segments of 8 to 64 steps, the kernel's own (the largest power of two
    up to 64 that divides W) among them."""
    ls, lp, la, ain, K, scale, qs = _case(168, W, B, chan, ext, 31, mode)
    _assert_schedule_equal(ls, lp, la, ain, K, W, segs, scale, qs, mode)


@pytest.mark.parametrize("mode", ["maxlog", "linlog", "logmap"])
@pytest.mark.parametrize("K,W,K_real,B,chan,ext,segs", [
    (40, 48, None, 5, "bfloat16", "int8", (16,)),     # one window, 3 segments
    (168, 64, 150, 7, "float32", "float32", (32, 64)),  # masked rows
    (168, 32, None, 3, "bfloat16", "bfloat16", (8, 32)),
])
def test_window_parallel_schedule_edge_shapes(mode, K, W, K_real, B, chan,
                                              ext, segs):
    """One window only (K=40: no window table is written, beta and alpha
    still cross three segments), K_real below K (masked a-priori rows), and
    batches that are not a multiple of the kernel's 4-codeword warps."""
    ls, lp, la, ain, K_real, scale, qs = _case(K, W, B, chan, ext, 32, mode,
                                               K_real)
    assert (ls.shape[0] == W) == (K == 40)
    _assert_schedule_equal(ls, lp, la, ain, K_real, W, segs, scale, qs, mode)


@pytest.mark.parametrize("mode", ["maxlog", "linlog", "logmap"])
@pytest.mark.parametrize("table", ["qpp", "random"])
def test_window_parallel_schedule_folded_read(mode, table):
    """K5: the folded read (la row t from row idx[t]) in the same schedule
    equals `siso_nii_plain(..., gather_idx=)` bit for bit in le and
    aout[1:], through the QPP table extended over the tail and pad rows and
    through a random permutation of all rows, K=168 in windows of 32, B=6
    (not a multiple of 4), bf16 channel and int8 extrinsic streams."""
    W, B = 32, 6
    ls, lp, la, ain, K, scale, qs = _case(168, W, B, "bfloat16", "int8", 34,
                                          mode)
    T = ls.shape[0]
    idx = (np.concatenate([qpp_perm(K), np.arange(K, T)]) if table == "qpp"
           else np.random.default_rng(35).permutation(T))
    idx = torch.from_numpy(idx.astype(np.int32))
    le_p, aout_p = ck.siso_nii_plain(ls, lp, la, ain, K, W, scale, qs, mode,
                                     gather_idx=idx)
    for seg in (8, ck.exact_segment(W)):
        le, aout = _nii_window_parallel(ls, lp, la, ain, K, W, seg, scale, qs,
                                        mode, gather_idx=idx)
        assert torch.equal(le, le_p), seg
        assert torch.equal(aout[1:], aout_p[1:]), seg
    # the read is really folded: in order, the rows give another result
    assert not torch.equal(le_p, ck.siso_nii_plain(ls, lp, la, ain, K, W,
                                                   scale, qs, mode)[0])


def test_pallas_interpret_equals_the_window_parallel_schedule():
    """The reference itself: the JAX package's Pallas kernel (NII contract,
    interpret mode) gives the rendering's le and window starts bit for bit
    at K=104 (four windows of 32), B=8, bf16 channel and int8 extrinsic
    streams."""
    K, W, B, mode = 104, 32, 8, "maxlog"
    ls, lp, la, ain, K, scale, qs = _case(K, W, B, "bfloat16", "int8", 33,
                                          mode)
    le, aout = _nii_window_parallel(ls, lp, la, ain, K, W,
                                    ck.exact_segment(W), scale, qs, mode)
    to_j = lambda x, dt: jnp.asarray(convert.tb_to_cells(x)).astype(dt)
    le_j, aout_j = jk.siso_cells(
        to_j(ls.float().numpy(), "bfloat16"), to_j(lp.float().numpy(),
                                                   "bfloat16"),
        to_j(la.numpy(), "int8"), K, mode, scale, interpret=True,
        nii_ckpt=jnp.asarray(convert.ckpt_port_to_cells(ain.numpy())),
        window=W, ext_qscale=qs)
    np.testing.assert_array_equal(
        le.numpy(), convert.cells_to_tb(np.asarray(le_j), B))
    np.testing.assert_array_equal(
        aout.numpy()[1:], convert.ckpt_cells_to_port(np.asarray(aout_j), B)[1:])
