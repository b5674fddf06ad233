"""Plain max-log-MAP turbo decoder: the benchmark's reference.

Written from the algorithm the configurations state, in plain PyTorch, and
independent of the program under test (it imports nothing of it):

* the 8-state RSC of TS 36.212 section 5.1.3.2.1, branch metrics
  gamma(u, p) = u*A + p*P with A = -(scale * step * la + ls) on the K
  information steps (A = -ls on the tail) and P = -lp, in float32;
* max-log forward (alpha) and backward (beta) recursions, renormalised to
  their largest state every 8 steps;
* next-iteration initialisation (NII) of width W: the padded trellis
  (K + 3 steps, then known-zero steps with ls = BIG up to a multiple of W) is
  cut into windows of W steps; window 0 starts from the zero state, window
  w > 0 from the alpha the same constituent decoder reached at that point in
  the previous half-iteration (zero metrics before the first); beta walks the
  whole trellis back from the zero state;
* channel streams rounded to the stated type (bfloat16); extrinsics stored
  as signed integer codes of a stated step and width (int8: step 0.25,
  +-127), scaled by `scale` on the way in;
* LTE turbo iterations, the full LLR L = ls + scale * step * (le1 + le21)
  and hard bits L < 0; with CRC early termination a codeword's extrinsics
  freeze at the first iteration whose hard bits pass its CRC, and its
  iteration count is that iteration.

The recursions are the serial loops of the definition, vectorised over
codewords (and, for alpha, over windows).  A codeword's result does not
depend on the others in its batch, so any subset of a batch may be checked.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..harness import spec

BIG = 1e9
RENORM = 8          # steps between renormalisations


def _trellis():
    """next state and parity of each (state, u); state = a1 a2 a3 of the
    feedback register (a1 the newest)."""
    nxt = np.zeros((8, 2), dtype=np.int64)
    par = np.zeros((8, 2), dtype=np.int64)
    for s in range(8):
        a1, a2, a3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        for u in (0, 1):
            a = u ^ a2 ^ a3
            par[s, u] = a ^ a1 ^ a3
            nxt[s, u] = (a << 2) | (a1 << 1) | a2
    prv = np.zeros((8, 2), dtype=np.int64)
    prv_par = np.zeros((8, 2), dtype=np.int64)
    for s in range(8):
        for u in (0, 1):
            prv[nxt[s, u], u] = s
            prv_par[nxt[s, u], u] = par[s, u]
    return nxt, par, prv, prv_par


NEXT, PARITY, PREV, PREV_PARITY = _trellis()


@dataclasses.dataclass(frozen=True)
class Precision:
    """How the streams are stored: the channel LLRs' float type, and the
    extrinsics as integer codes of `step` saturated at +-`code_max`."""
    chan: torch.dtype = torch.bfloat16
    step: float = 0.25
    code_max: int = 127


INT8 = Precision()
# the control: the same range in 4-bit codes
INT4 = Precision(step=127 * 0.25 / 7, code_max=7)


@dataclasses.dataclass(frozen=True)
class Decoder:
    K: int                       # trellis length (a bucket, for mixed sizes)
    n_iters: int = 6
    scale: float = 0.75
    window: int = 256
    crc_poly: int = 0            # 0: fixed iterations; else CRC early exit
    precision: Precision = INT8


class _Siso:
    """One constituent decoder's tables on a device."""

    def __init__(self, device):
        t = lambda a: torch.as_tensor(a, dtype=torch.long, device=device)
        # alpha: state s from PREV[s, u] over the edge of row u*2 + parity
        self.a_src = t(np.concatenate([PREV[:, 0], PREV[:, 1]]))
        self.a_row = t(np.concatenate([PREV_PARITY[:, 0],
                                       2 + PREV_PARITY[:, 1]]))
        # beta: state s from NEXT[s, u] over the edge of row u*2 + parity
        self.b_src = t(np.concatenate([NEXT[:, 0], NEXT[:, 1]]))
        self.b_row = t(np.concatenate([PARITY[:, 0], 2 + PARITY[:, 1]]))
        self.nxt = (t(NEXT[:, 0]), t(NEXT[:, 1]))
        self.p0 = tuple(t(np.nonzero(PARITY[:, u] == 0)[0]) for u in (0, 1))
        self.p1 = tuple(t(np.nonzero(PARITY[:, u] == 1)[0]) for u in (0, 1))


def _zero_state(shape, device):
    m = torch.full((*shape[:-2], 8, shape[-1]), -BIG, dtype=torch.float32,
                   device=device)
    m[..., 0, :] = 0.0
    return m


def _renorm(m):
    return m - m.amax(dim=-2, keepdim=True)


def siso(tab: _Siso, ls, lp, la, ain, K: int, W: int, eff: float,
         prec: Precision, t_chunk: int = 512):
    """One max-log SISO with NII on time-major (Tp, B) float32 streams; la
    holds extrinsic codes (float32).  Returns (le codes (Tp, B) float32,
    the next window table (n_win, 8, B))."""
    Tp, B = ls.shape
    dev = ls.device
    n_win = Tp // W
    sm = torch.zeros((Tp, 1), dtype=torch.float32, device=dev)
    sm[:K] = eff
    A = -(la * sm + ls)
    P = -lp
    G = torch.stack([torch.zeros_like(P), P, A, A + P], dim=1)  # (Tp, 4, B)
    GA = G.index_select(1, tab.a_row).view(n_win, W, 16, B)
    GB = G.index_select(1, tab.b_row)                           # (Tp, 16, B)
    del G

    # alpha: every window at once, from its inherited start
    alpha = ain.clone()
    alpha[0] = _zero_state((8, B), dev)
    aw = []
    for j in range(W):
        aw.append(alpha)
        x = alpha.index_select(1, tab.a_src) + GA[:, j]
        alpha = x.view(n_win, 2, 8, B).amax(dim=1)
        if (j + 1) % RENORM == 0:
            alpha = _renorm(alpha)
    aout = torch.zeros_like(ain)
    aout[1:] = alpha[:-1]
    alphas = torch.stack(aw, dim=1).view(Tp, 8, B)
    del aw, GA

    # beta: one walk back over the whole trellis
    beta = _zero_state((8, B), dev)
    bin_ = [None] * Tp
    for t in range(Tp - 1, -1, -1):
        bin_[t] = beta
        x = beta.index_select(0, tab.b_src) + GB[t]
        beta = x.view(2, 8, B).amax(dim=0)
        if t % RENORM == 0:
            beta = _renorm(beta)
    del GB

    le = torch.empty((Tp, B), dtype=torch.float32, device=dev)
    for t0 in range(0, Tp, t_chunk):
        t1 = min(Tp, t0 + t_chunk)
        a = alphas[t0:t1]
        b = torch.stack(bin_[t0:t1])
        p = P[t0:t1]
        side = []
        for u in (0, 1):
            x = a + b.index_select(1, tab.nxt[u])
            side.append(torch.maximum(
                x.index_select(1, tab.p0[u]).amax(dim=1),
                x.index_select(1, tab.p1[u]).amax(dim=1) + p))
        le[t0:t1] = torch.clamp(torch.round((side[0] - side[1])
                                            * (1.0 / prec.step)),
                                -prec.code_max, prec.code_max)
    return le, aout


def _stream(body, tail, pad_val, Tp, chan):
    full = torch.cat([body, tail], dim=1)
    full = torch.nn.functional.pad(full, (0, Tp - full.shape[1]),
                                   value=pad_val)
    return full.to(chan).to(torch.float32).T.contiguous()


def crc_pass(hard: torch.Tensor, poly: int) -> torch.Tensor:
    """(B, K) 0/1 -> (B,) bool: the last 24 bits are the CRC of the rest
    (float64 products: exact)."""
    K = hard.shape[1]
    M = torch.from_numpy(spec.crc_parity_matrix(K - 24, poly)).to(
        hard.device, torch.float64)
    par = (hard[:, :K - 24].to(torch.float64) @ M) % 2
    return (par == hard[:, K - 24:].to(torch.float64)).all(dim=1)


def decode(ls, lp1, lp2, tail1, tail2, dec: Decoder, perm=None):
    """Decode (B, K) float32 LLR streams and (B, 6) tails.  perm: the
    interleaver, one (K,) table or per-codeword (B, K) tables (default:
    the QPP table of K).  Returns (hard (B, K) int8, iterations (B,) int32,
    L (B, K) float32)."""
    dev = ls.device
    B, K = ls.shape
    T = K + 3
    W = dec.window
    Tp = -(-T // W) * W
    prec = dec.precision
    eff = dec.scale * prec.step
    if perm is None:
        perm = torch.from_numpy(spec.qpp_perm(K)).to(dev)
    perm = perm.to(dev, torch.long)
    if perm.dim() == 1:
        perm = perm.expand(B, K)
    inv = torch.empty_like(perm)
    inv.scatter_(1, perm, torch.arange(K, device=dev).expand(B, K))
    pad_rows = torch.arange(K, Tp, device=dev)[:, None].expand(Tp - K, B)
    perm_t = torch.cat([perm.T, pad_rows])          # (Tp, B) along time
    inv_t = torch.cat([inv.T, pad_rows])

    ls1 = _stream(ls, tail1[:, 0::2], BIG, Tp, prec.chan)
    lp1s = _stream(lp1, tail1[:, 1::2], 0.0, Tp, prec.chan)
    ls2 = _stream(torch.gather(ls, 1, perm), tail2[:, 0::2], BIG, Tp,
                  prec.chan)
    lp2s = _stream(lp2, tail2[:, 1::2], 0.0, Tp, prec.chan)
    tab = _Siso(dev)
    n_win = Tp // W
    le21 = torch.zeros((Tp, B), dtype=torch.float32, device=dev)
    le1 = le21
    ck1 = torch.zeros((n_win, 8, B), dtype=torch.float32, device=dev)
    ck2 = ck1
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    full_llr = lambda a, b: ls1[:K] + eff * (a[:K] + b[:K])
    for _ in range(dec.n_iters):
        le1_new, ck1 = siso(tab, ls1, lp1s, le21, ck1, K, W, eff, prec)
        la2 = torch.gather(le1_new, 0, perm_t)
        le2, ck2 = siso(tab, ls2, lp2s, la2, ck2, K, W, eff, prec)
        le21_new = torch.gather(le2, 0, inv_t)
        keep = done[None, :]
        le21 = torch.where(keep, le21, le21_new)
        le1 = torch.where(keep, le1, le1_new)
        iters += (~done).to(torch.int32)
        if dec.crc_poly:
            hard = (full_llr(le1_new, le21_new) < 0).T.to(torch.int8)
            done = done | crc_pass(hard, dec.crc_poly)
            if bool(done.all()):
                break
    L = full_llr(le1, le21).T.contiguous()
    return (L < 0).to(torch.int8), iters, L
