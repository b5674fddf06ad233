"""The window-parallel schedule of the exact SISO kernel, on the CPU.

csrc/siso.cu runs the exact contract (K2, and K3's exact rows) in two
passes: a forward alpha walk and a backward beta walk over the whole
trellis, run at once, that leave one checkpoint per window boundary; then
every (window, codeword) pair decoded alone from its two checkpoints, the
window's alphas kept as one sub-checkpoint per 8-step block and recomputed
block by block.  The windows the kernel decodes are segments of
`exact_segment(T)` steps: the exact contract does not depend on the window,
because every checkpoint sits on an 8-step renorm edge.  The kernel cannot
run here.  `_window_parallel` below is a plain rendering of that schedule
with the same step functions, and it must equal `siso_exact_plain` (the
serial schedule, which the Pallas kernel is held to in
tests/test_torch_siso.py and the CUDA kernel on the card) bit for bit, in
every mode and stream type: int8 codes and bf16/fp32 values equal.
"""

import numpy as np
import pytest
import torch

from turbotpu_torch.harness.bench import make_decode_inputs
from turbotpu_torch.siso import cuda_kernel as ck

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "int8": torch.int8}
U = ck.UNROLL


def _window_parallel(ls, lp, la, K_real, W, scale, qs, mode):
    """The exact contract in the kernel's window-parallel schedule.  Every
    recursion runs on (8, B) tensors, as in the serial plain version, so the
    elementwise functions see the same shapes."""
    T, B = ls.shape
    n_win, nsub = T // W, W // U
    tb = ck._Tables(ls.device)
    f32 = torch.float32
    eff = scale * (qs if qs else 1.0)
    sm = torch.where(torch.arange(T) < K_real, torch.tensor(eff, dtype=f32),
                     torch.zeros((), dtype=f32))[:, None]
    A = -(la.to(f32) * sm + ls.to(f32))
    P = -lp.to(f32)
    G = torch.stack([torch.zeros_like(P), P, A, A + P], dim=1)
    e0 = ck._e0(B, ls.device)

    # pass 1, forward: alpha over windows 0..n_win-2, renormalised after
    # every block, a checkpoint at each window start
    ack, alpha = [e0], e0
    for t in range((n_win - 1) * W):
        alpha = ck._alpha_step(alpha, G[t], tb, mode)
        if (t + 1) % U == 0:
            alpha = ck._renorm(alpha)
        if (t + 1) % W == 0:
            ack.append(alpha)
    # pass 1, backward (independent of the forward walk): beta from e0 at
    # the padded end down to row W, a checkpoint at each window end
    bck, beta = [None] * (n_win - 1) + [e0], e0
    for t in range(T - 1, W - 1, -1):
        beta = ck._beta_step(beta, G[t], tb, mode)
        if t % U == 0:
            beta = ck._renorm(beta)
        if t % W == 0:
            bck[t // W - 1] = beta

    # pass 2: each window alone, from its two checkpoints
    le = torch.empty((T, B), dtype=la.dtype)
    for w in reversed(range(n_win)):      # any order: windows are independent
        base = w * W
        sub, alpha = [], ack[w]
        for i in range(nsub):
            sub.append(alpha)
            if i + 1 < nsub:
                for t in range(base + i * U, base + (i + 1) * U):
                    alpha = ck._alpha_step(alpha, G[t], tb, mode)
                alpha = ck._renorm(alpha)
        beta = bck[w]
        for i in reversed(range(nsub)):
            t0 = base + i * U
            at = [sub[i]]
            for j in range(U - 1):
                at.append(ck._alpha_step(at[-1], G[t0 + j], tb, mode))
            for j in reversed(range(U)):
                le[t0 + j] = ck._quantize_le(
                    ck._extrinsic(at[j], beta, P[t0 + j], tb, mode),
                    la.dtype, qs)
                beta = ck._beta_step(beta, G[t0 + j], tb, mode)
            beta = ck._renorm(beta)
    return le


def _case(K, W, B, chan, ext, seed, mode, K_real=None):
    """A decoder-padded stream pair and a real a-priori stream (from a cold
    NII call) of one SISO."""
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
    la, _ = ck.siso_cells(ls_t, lp_t, torch.zeros((KTp, B),
                                                  dtype=TORCH_DT[ext]),
                          K_real, mode, scale, window=W, ext_qscale=qs,
                          nii_ckpt=torch.zeros((KTp // W, 8, B)))
    assert la.to(torch.float32).abs().max() > 0
    return ls_t, lp_t, la, K_real, scale, qs


@pytest.mark.parametrize("mode", ["maxlog", "linlog", "logmap"])
@pytest.mark.parametrize("chan,ext,B", [("bfloat16", "int8", 8),
                                        ("bfloat16", "bfloat16", 37),
                                        ("float32", "float32", 64)])
def test_window_parallel_schedule_equals_the_serial_plain_version(
        mode, chan, ext, B):
    """K=168, W=32 (six windows), B of 8-64 codewords, not all a multiple
    of a warp: the window-parallel schedule gives le equal bit for bit, on
    the decoder's windows and on the kernel's segments (three of 64)."""
    ls, lp, la, K, scale, qs = _case(168, 32, B, chan, ext, 21, mode)
    want = ck.siso_exact_plain(ls, lp, la, K, 32, scale, qs, mode)
    assert ck.exact_segment(ls.shape[0]) == 64
    for unit in (32, 64):
        got = _window_parallel(ls, lp, la, K, unit, scale, qs, mode)
        assert torch.equal(got, want), unit


@pytest.mark.parametrize("mode", ["maxlog", "linlog", "logmap"])
@pytest.mark.parametrize("K,W,K_real,chan,ext", [
    (40, 48, None, "bfloat16", "int8"),      # n_win = 1; segments of 16
    (40, 64, None, "bfloat16", "bfloat16"),  # one segment: no first pass
    (168, 32, 150, "float32", "float32"),    # K_real < K: masked rows
])
def test_window_parallel_schedule_edge_shapes(mode, K, W, K_real, chan, ext):
    ls, lp, la, K_real, scale, qs = _case(K, W, 5, chan, ext, 22, mode,
                                          K_real)
    T = ls.shape[0]
    assert (T // W == 1) == (K == 40)
    want = ck.siso_exact_plain(ls, lp, la, K_real, W, scale, qs, mode)
    for unit in (W, ck.exact_segment(T)):
        got = _window_parallel(ls, lp, la, K_real, unit, scale, qs, mode)
        assert torch.equal(got, want), unit
