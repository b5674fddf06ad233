"""LTE rate matching for turbo-coded transport channels (TS 36.212 s5.1.4.1).

Pipeline per code block: three streams d^(0) (systematic), d^(1), d^(2)
(parities), each of length D = K + 4, go through a 32-column sub-block
interleaver, are interlaced into a circular buffer w of length 3*K_Pi, and E
bits are selected starting at the redundancy-version offset k0, skipping
dummy (<NULL>) positions -- E < 3K+12 puncturing, E > 3K+12 repetition.

De-rate-matching is the LLR-domain inverse: scatter-ADD received LLRs into
the circular-buffer positions (repetition combines coherently) and zero-fill
punctured positions.

The port's own copy of turbotpu/spec/rate_match.py (numpy only).  Everything
here precomputes int32 index maps on the host; the device-side op
(tx/rate_match.py) is a pure gather on tx and a fixed-order sum on rx.
"""

from __future__ import annotations

import functools

import numpy as np

# Inter-column permutation pattern, TS 36.212 Table 5.1.4-1.
COL_PERM = np.array(
    [0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
     1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31],
    dtype=np.int64)
C_SUB = 32


@functools.lru_cache(maxsize=None)
def sub_block_maps(D: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Index maps from padded-stream position to v-stream position.

    Returns (perm01, perm2, K_pi): v^(i)[k] = y^(i)[perm01[k]] for streams
    0,1 and v^(2)[k] = y^(2)[perm2[k]], where y is d prepended with
    ND = K_pi - D dummies.  Dummy positions are those with perm < ND.
    """
    R = -(-D // C_SUB)
    K_pi = R * C_SUB
    # Streams 0/1: row-major write, column permute, column-major read.
    mat = np.arange(K_pi, dtype=np.int64).reshape(R, C_SUB)
    perm01 = mat[:, COL_PERM].T.reshape(-1)
    # Stream 2: pi(k) = (P[k div R] + 32*(k mod R) + 1) mod K_pi.
    k = np.arange(K_pi, dtype=np.int64)
    perm2 = (COL_PERM[k // R] + C_SUB * (k % R) + 1) % K_pi
    return perm01, perm2, K_pi


@functools.lru_cache(maxsize=None)
def circular_buffer_map(K: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Map circular-buffer position -> flat d index (stream*D + pos).

    Returns (wmap, valid, K_pi): wmap[j] indexes into the concatenated
    [d0, d1, d2] array of length 3D; valid[j] is False at dummy positions.
    """
    D = K + 4
    perm01, perm2, K_pi = sub_block_maps(D)
    ND = K_pi - D
    # y index -> d index: y[j] = d[j - ND] for j >= ND, dummy otherwise.
    w = np.empty(3 * K_pi, dtype=np.int64)
    w[:K_pi] = perm01 - ND                       # v0
    w[K_pi::2] = perm01 - ND + D                 # v1 interlaced even
    w[K_pi + 1::2] = perm2 - ND + 2 * D          # v2 interlaced odd
    valid = np.concatenate([perm01 >= ND, np.empty(2 * K_pi, dtype=bool)])
    valid[K_pi::2] = perm01 >= ND
    valid[K_pi + 1::2] = perm2 >= ND
    return w, valid, K_pi


@functools.lru_cache(maxsize=None)
def select_indices(K: int, E: int, rv: int = 0, n_cb: int | None = None,
                   F: int = 0) -> np.ndarray:
    """Indices into the flat [d0,d1,d2] array (length 3D) of the E
    transmitted soft bits, in transmission order.

    F > 0 marks the first F positions of d^(0) and d^(1) as <NULL> filler
    bits (TS 36.212 section 5.1.3.2); like interleaver padding dummies,
    the bit selection skips them, so filler bits are never transmitted.
    """
    wmap, valid, K_pi = circular_buffer_map(K)
    if F:
        D = K + 4
        filler = (wmap < F) | ((wmap >= D) & (wmap < D + F))
        valid = valid & ~filler
    if n_cb is None:
        n_cb = 3 * K_pi
    R = K_pi // C_SUB
    k0 = R * (2 * (-(-n_cb // (8 * R))) * rv + 2)
    n_valid = int(valid[:n_cb].sum())
    if n_valid == 0:
        raise ValueError(f"no selectable bits in n_cb={n_cb}")
    # Enough full wraps of the circular buffer to collect E non-dummy bits.
    n_wraps = -(-E // n_valid) + 1
    pos = (k0 + np.arange(n_wraps * n_cb, dtype=np.int64)) % n_cb
    pos = pos[valid[pos]][:E]
    assert len(pos) == E
    return wmap[pos].astype(np.int32)


def rate_match(d0: np.ndarray, d1: np.ndarray, d2: np.ndarray, E: int,
               rv: int = 0, n_cb: int | None = None, F: int = 0) -> np.ndarray:
    """Golden host-side rate matching: 3 streams of length D -> E bits."""
    K = len(d0) - 4
    d = np.concatenate([d0, d1, d2])
    return d[select_indices(K, E, rv, n_cb, F)]


def de_rate_match(llr_e: np.ndarray, K: int, rv: int = 0,
                  n_cb: int | None = None, F: int = 0
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Golden host-side inverse: E LLRs -> (l0, l1, l2) each of length K+4.

    Repetition combines by addition; punctured positions (and, with F > 0,
    never-transmitted filler positions) stay 0.
    """
    D = K + 4
    idx = select_indices(K, len(llr_e), rv, n_cb, F)
    acc = np.zeros(3 * D, dtype=np.float64)
    np.add.at(acc, idx, np.asarray(llr_e, dtype=np.float64))
    return acc[:D], acc[D:2 * D], acc[2 * D:]
