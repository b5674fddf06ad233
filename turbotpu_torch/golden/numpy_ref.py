"""Scalar numpy golden model: bit-exact turbo encoder and log-MAP decoder.

The port's own copy of turbotpu/golden/numpy_ref.py (numpy only): the
readable, unvectorised ground truth the torch decoders are tested against.
The equivalent C++ model lives in cpp/golden.cc (cpp_ref.py binds it); both
follow TS 36.212 section 5.1.3 / TS 25.212 section 4.2.3 exactly.

Canonical codeword format used throughout the framework
-------------------------------------------------------
A turbo codeword for block size K is the tuple of streams

    sys[K], par1[K], par2[K], tail1[6], tail2[6]

where tail1 = (x_K, z_K, x_K+1, z_K+1, x_K+2, z_K+2) from terminating
encoder 1 and tail2 likewise from encoder 2.  The LTE d-stream mux
(TS 36.212 section 5.1.3.2.2, d^(i) of length K+4) and the UMTS wire order
(TS 25.212 section 4.2.3.1) are thin re-orderings of this canonical form,
provided in lte_mux/lte_demux and umts_mux/umts_demux below.
"""

from __future__ import annotations

import numpy as np

from ..spec.trellis import TRELLIS, N_STATES


def rsc_encode(bits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Run one RSC constituent encoder over bits and terminate.

    Returns (parity[K], tail[6]) with tail = (x_K, z_K, ..., x_K+2, z_K+2).
    """
    ns, par, tb = TRELLIS.next_state, TRELLIS.parity, TRELLIS.tail_bit
    s = 0
    parity = np.empty(len(bits), dtype=np.int8)
    for k, u in enumerate(np.asarray(bits, dtype=np.int64)):
        parity[k] = par[s, u]
        s = ns[s, u]
    tail = np.empty(6, dtype=np.int8)
    for t in range(3):
        u = tb[s]
        tail[2 * t] = u
        tail[2 * t + 1] = par[s, u]
        s = ns[s, u]
    assert s == 0, "termination must reach state 0"
    return parity, tail


def turbo_encode(bits: np.ndarray, perm: np.ndarray):
    """Canonical-format turbo encoder.

    Returns (sys, par1, par2, tail1, tail2); total 3K + 12 bits.
    """
    bits = np.asarray(bits, dtype=np.int8)
    par1, tail1 = rsc_encode(bits)
    par2, tail2 = rsc_encode(bits[perm])
    return bits.copy(), par1, par2, tail1, tail2


def lte_mux(sys, par1, par2, tail1, tail2):
    """Canonical -> LTE d-streams (d0, d1, d2), each length K + 4.

    TS 36.212 section 5.1.3.2.2 tail multiplexing:
      d0[K..K+3] = x_K,   z_K+1,  x'_K,   z'_K+1
      d1[K..K+3] = z_K,   x_K+2,  z'_K,   x'_K+2
      d2[K..K+3] = x_K+1, z_K+2,  x'_K+1, z'_K+2
    """
    d0 = np.concatenate([sys, [tail1[0], tail1[3], tail2[0], tail2[3]]])
    d1 = np.concatenate([par1, [tail1[1], tail1[4], tail2[1], tail2[4]]])
    d2 = np.concatenate([par2, [tail1[2], tail1[5], tail2[2], tail2[5]]])
    return d0.astype(sys.dtype), d1.astype(sys.dtype), d2.astype(sys.dtype)


def lte_demux(d0, d1, d2):
    """LTE d-streams -> canonical (sys, par1, par2, tail1, tail2).

    Works on bits or LLRs (dtype preserved).
    """
    K = len(d0) - 4
    tail1 = np.array([d0[K], d1[K], d2[K], d0[K + 1], d1[K + 1], d2[K + 1]])
    tail2 = np.array([d0[K + 2], d1[K + 2], d2[K + 2], d0[K + 3], d1[K + 3], d2[K + 3]])
    return d0[:K], d1[:K], d2[:K], tail1, tail2


def umts_mux(sys, par1, par2, tail1, tail2):
    """Canonical -> UMTS wire order (TS 25.212 section 4.2.3.1):
    x1 z1 z'1 x2 z2 z'2 ... xK zK z'K then the 12 tail bits
    x_K+1 z_K+1 x_K+2 z_K+2 x_K+3 z_K+3 x'_K+1 z'_K+1 ... z'_K+3."""
    K = len(sys)
    body = np.empty(3 * K, dtype=sys.dtype)
    body[0::3], body[1::3], body[2::3] = sys, par1, par2
    return np.concatenate([body, tail1, tail2])


def umts_demux(wire):
    K = (len(wire) - 12) // 3
    body, tail = wire[:3 * K], wire[3 * K:]
    return body[0::3], body[1::3], body[2::3], tail[:6], tail[6:]


# ----------------------------------------------------------------------
# log-MAP / max-log-MAP BCJR SISO
# ----------------------------------------------------------------------

NEG_INF = -1e30


def _maxstar(a: float, b: float, mode: str) -> float:
    m = max(a, b)
    if mode == "maxlog" or m <= NEG_INF / 2:
        return m
    return m + np.log1p(np.exp(-abs(a - b)))


def bcjr_siso(ls: np.ndarray, lp: np.ndarray, la: np.ndarray,
              mode: str = "logmap") -> tuple[np.ndarray, np.ndarray]:
    """One SISO half-iteration over a terminated K+3-step trellis.

    ls, lp: systematic / parity channel LLRs of length K+3 (info + tail).
    la:     a-priori LLRs of length K (tail positions have none).
    Returns (L[K], Le[K]): a-posteriori and extrinsic LLRs for info bits.

    LLR convention: positive favors bit 0 -- L = log P(u=0) / P(u=1).
    Branch metric for (u, c): gamma = -0.5*u*(la + ls) - 0.5*c*lp with
    u, c in {0, 1} mapped through (1 - 2b) bipolarization folded in.
    """
    KT = len(ls)
    K = len(la)
    assert KT == K + 3
    ns, par = TRELLIS.next_state, TRELLIS.parity
    laf = np.concatenate([np.asarray(la, dtype=np.float64), np.zeros(3)])

    # gamma[k, u, c] for the 4 (input, parity) combos; branch picks its pair.
    # With positive-LLR-favors-0: contribution of hypothesis bit b to the
    # metric is -b * llr (so b=0 branches get 0, b=1 branches get -llr).
    def gamma(k, u, c):
        return -u * (laf[k] + ls[k]) - c * lp[k]

    alpha = np.full((KT + 1, N_STATES), NEG_INF)
    alpha[0, 0] = 0.0
    for k in range(KT):
        for s in range(N_STATES):
            if alpha[k, s] <= NEG_INF / 2:
                continue
            for u in (0, 1):
                s2 = ns[s, u]
                m = alpha[k, s] + gamma(k, u, par[s, u])
                alpha[k + 1, s2] = _maxstar(alpha[k + 1, s2], m, mode)
        alpha[k + 1] -= alpha[k + 1].max()

    beta = np.full((KT + 1, N_STATES), NEG_INF)
    beta[KT, 0] = 0.0
    for k in range(KT - 1, -1, -1):
        for s in range(N_STATES):
            for u in (0, 1):
                s2 = ns[s, u]
                if beta[k + 1, s2] <= NEG_INF / 2:
                    continue
                m = beta[k + 1, s2] + gamma(k, u, par[s, u])
                beta[k, s] = _maxstar(beta[k, s], m, mode)
        beta[k] -= beta[k].max()

    L = np.empty(K)
    for k in range(K):
        m0 = m1 = NEG_INF
        for s in range(N_STATES):
            for u in (0, 1):
                m = alpha[k, s] + gamma(k, u, par[s, u]) + beta[k + 1, ns[s, u]]
                if u == 0:
                    m0 = _maxstar(m0, m, mode)
                else:
                    m1 = _maxstar(m1, m, mode)
        L[k] = m0 - m1
    Le = L - la - ls[:K]
    return L, Le


def turbo_decode(ls, lp1, lp2, tail1, tail2, perm, inv,
                 n_iters: int = 8, mode: str = "logmap",
                 ext_scale: float = 1.0,
                 crc_poly: int | None = None):
    """Golden full turbo decode, canonical-format LLR inputs.

    ls, lp1, lp2: length-K channel LLRs; tail1/tail2: length-6 tail LLRs.
    Returns (hard_bits[K], n_iters_run, L[K]).
    """
    from ..spec.crc import crc_check  # local import to avoid cycle

    K = len(ls)
    ls1 = np.concatenate([ls, tail1[0::2]])
    lp1f = np.concatenate([lp1, tail1[1::2]])
    ls2 = np.concatenate([np.asarray(ls)[perm], tail2[0::2]])
    lp2f = np.concatenate([lp2, tail2[1::2]])

    le21 = np.zeros(K)  # extrinsic from SISO2, natural order
    for it in range(1, n_iters + 1):
        _, le1 = bcjr_siso(ls1, lp1f, le21, mode)
        le1 = le1 * ext_scale
        _, le2 = bcjr_siso(ls2, lp2f, le1[perm], mode)
        le2 = le2 * ext_scale
        le21 = le2[inv]
        L = ls + le1 + le21
        hard = (L < 0).astype(np.int8)  # positive LLR favors 0
        if crc_poly is not None and crc_check(hard, crc_poly):
            return hard, it, L
    return hard, n_iters, L
