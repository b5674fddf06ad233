"""SISO BCJR as a log-depth prefix product over the (max*, +) semiring.

Counterpart of turbotpu/siso/ascan.py, which runs `jax.lax.associative_scan`:
each trellis step is an 8x8 transition matrix over the tropical semiring
(max-log) or the log-semiring ("sum" = logsumexp, for log-MAP and, as in
the reference, linlog, whose correction enters only in the final LLR
stage), and the alpha prefixes and beta suffixes are all-prefix
products, computed here by a Hillis-Steele scan of torch operations
(log2(KT) rounds, each combining every element with the one 2^r before it).

Cost: 8x8x8 work per combine against 8x2 for the sequential form, for log
depth instead of KT sequential steps.  It is a test oracle for the
sequential SISOs, as in the reference.

Per-combine normalisation (subtracting the per-matrix max) keeps metrics
bounded over 6k steps; it shifts every entry of a prefix product by a
constant, which cancels in the final LLR difference.
"""

from __future__ import annotations

import torch

from ..spec.trellis import TRELLIS, N_STATES
from .maxstar import MODES, LOGMAP, MAXLOG
from .scan import NEG, llr_stage


def _edge_masks(device, dtype):
    """Constant (8, 8) masks: valid[s2, s1], u[s2, s1], par[s2, s1]."""
    valid = torch.zeros((N_STATES, N_STATES), dtype=torch.bool)
    u_mask = torch.zeros((N_STATES, N_STATES), dtype=dtype)
    p_mask = torch.zeros((N_STATES, N_STATES), dtype=dtype)
    for s1 in range(N_STATES):
        for u in (0, 1):
            s2 = int(TRELLIS.next_state[s1, u])
            valid[s2, s1] = True
            u_mask[s2, s1] = float(u)
            p_mask[s2, s1] = float(TRELLIS.parity[s1, u])
    return valid.to(device), u_mask.to(device), p_mask.to(device)


def _combine(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """Compose b after a: out[i, j] = max*_s b[i, s] + a[s, j], then
    subtract the per-matrix max."""
    s = b[..., :, :, None] + a[..., None, :, :]
    out = s.amax(dim=-2) if mode == MAXLOG else torch.logsumexp(s, dim=-2)
    return out - out.amax(dim=(-2, -1), keepdim=True)


def _scan(M: torch.Tensor, mode: str, reverse: bool = False) -> torch.Tensor:
    """Inclusive Hillis-Steele scan of `_combine` along dim 0: element k
    becomes M_k o ... o M_0 (reverse: M_k o M_{k+1} o ... o M_{n-1}, the
    composition of the suffix, matching associative_scan(reverse=True))."""
    n = M.shape[0]
    x = M
    d = 1
    while d < n:
        if reverse:
            # x[k] = x[k] o x[k + d]: the later suffix applied first
            head = _combine(x[d:], x[:-d], mode)
            x = torch.cat([head, x[n - d:]], dim=0)
        else:
            # x[k] = x[k] o x[k - d]: the earlier prefix applied first
            tail = _combine(x[:-d], x[d:], mode)
            x = torch.cat([x[:d], tail], dim=0)
        d *= 2
    return x


def siso_decode_ascan(ls: torch.Tensor, lp: torch.Tensor, la: torch.Tensor,
                      mode: str = LOGMAP) -> tuple[torch.Tensor, torch.Tensor]:
    """Drop-in replacement for siso_decode_scan (same shapes/semantics)."""
    if mode not in MODES:
        raise ValueError(f"unknown max* mode {mode!r}")
    B, KT = ls.shape
    K = la.shape[1]
    valid, u_mask, p_mask = _edge_masks(ls.device, ls.dtype)

    laf = torch.nn.functional.pad(la, (0, KT - K))
    A = -(laf + ls)            # (B, KT)
    P = -lp

    # M[k, b, s2, s1] = gamma_k(u, par) on valid edges, NEG elsewhere.
    gam = (A.T[:, :, None, None] * u_mask + P.T[:, :, None, None] * p_mask)
    M = torch.where(valid, gam, torch.full((), NEG, dtype=ls.dtype,
                                           device=ls.device))  # (KT, B, 8, 8)

    # alpha prefixes: P_k = M_k o ... o M_0; alpha AFTER step k = P_k[:, :, 0]
    # (the encoder starts in state 0).  Emit alpha BEFORE each step.
    pref = _scan(M, mode)
    a0 = torch.full((1, B, N_STATES), NEG, dtype=ls.dtype, device=ls.device)
    a0[:, :, 0] = 0.0
    alphas = torch.cat([a0, pref[:-1, :, :, 0]], dim=0)      # (KT, B, 8)

    # beta suffixes over N_k = M_k^T: R_k = N_k o N_{k+1} o ... o N_{KT-1};
    # beta AFTER step k is R_{k+1}[:, :, 0] (the trellis ends in state 0).
    N = M.transpose(-1, -2)
    suf = _scan(N, mode, reverse=True)
    bT = torch.full((1, B, N_STATES), NEG, dtype=ls.dtype, device=ls.device)
    bT[:, :, 0] = 0.0
    betas = torch.cat([suf[1:, :, :, 0], bT], dim=0)         # (KT, B, 8)

    return llr_stage(alphas, betas, A, P, ls, la, mode)
