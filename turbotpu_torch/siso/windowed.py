"""Sliding-window SISO with acquisition warm-up (overlap-save).

Counterpart of turbotpu/siso/windowed.py.  The trellis is cut into n_win
windows of W steps; every window is decoded on its own with Q extra warm-up
steps of real neighbouring data on each side: alpha warms up from a uniform
prior Q steps left of the window, beta from Q steps right.  The windows
become extra batch, so the sequential span drops from K+3 to W+2Q steps.

Exactness: approximate, converging to the exact BCJR as Q grows (Q = 32,
about 10 constraint lengths, is the literature's near-lossless setting).
Block edges keep the exact terminated boundaries (alpha_0 = beta_end = e_0)
through known-zero-bit padding, which only takes u=0 edges: state 0 is a
fixed point, so the padded recursion is exact at real positions.

This is tensor code around siso/scan.py's `siso_scan_boundary`, as the
reference runs it outside any kernel.
"""

from __future__ import annotations

import torch

from ..spec.trellis import N_STATES
from .maxstar import LOGMAP
from .scan import NEG, siso_scan_boundary

BIG = 1e9


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def make_windowed_siso(W: int = 256, Q: int = 32):
    """Returns siso(ls, lp, la, mode) with the standard SISO signature
    (batch-major (B, K+3), (B, K+3), (B, K); returns (L, Le))."""

    def siso_decode_windowed(ls: torch.Tensor, lp: torch.Tensor,
                             la: torch.Tensor, mode: str = LOGMAP):
        B, KT = ls.shape
        K = la.shape[1]
        if KT <= W + 2 * Q:
            # Too short to be worth windowing: the exact full-block scan.
            L, Le, _, _ = siso_scan_boundary(ls, lp, la, None, None, mode)
            return L, Le

        KTp = _round_up(KT, W)
        n_win = KTp // W
        pad = torch.nn.functional.pad
        # Pad: right to KTp with known-0 steps, plus Q on both sides.
        ls_e = pad(ls, (Q, KTp - KT + Q), value=BIG)
        lp_e = pad(lp, (Q, KTp - KT + Q))
        la_e = pad(la, (Q, KTp - K + Q))

        # Extended windows: window w covers [w*W - Q, w*W + W + Q) in
        # unpadded coordinates = [w*W, w*W + W + 2Q) in padded ones.
        WE = W + 2 * Q
        idx = (torch.arange(n_win, device=ls.device)[:, None] * W
               + torch.arange(WE, device=ls.device)[None, :])
        win = lambda x: x[:, idx].reshape(B * n_win, WE)
        ls_w, lp_w, la_w = win(ls_e), win(lp_e), win(la_e)

        # Boundary metrics: uniform at warm-up edges, exact e_0 at the
        # outermost block edges (window 0 left, window n-1 right -- both in
        # the known-0 pad region, where e_0 propagates exactly).
        uni = torch.zeros((B, n_win, N_STATES), dtype=ls.dtype,
                          device=ls.device)
        e0 = torch.full((N_STATES,), NEG, dtype=ls.dtype, device=ls.device)
        e0[0] = 0.0
        alpha0, betaT = uni.clone(), uni.clone()
        alpha0[:, 0] = e0
        betaT[:, n_win - 1] = e0

        _, Le_w, _, _ = siso_scan_boundary(
            ls_w, lp_w, la_w, alpha0.reshape(B * n_win, N_STATES),
            betaT.reshape(B * n_win, N_STATES), mode)
        Le = Le_w.reshape(B, n_win, WE)[:, :, Q:Q + W].reshape(B, KTp)[:, :K]
        L = Le + la + ls[:, :K]
        return L, Le

    return siso_decode_windowed
