"""Independent second implementation of LTE rate matching.

The port's own copy of turbotpu/spec/rate_match_ref.py: the conformance
oracle for `spec/rate_match.py`.  That module precomputes index maps; THIS
module follows TS 36.212 section 5.1.4.1 literally on symbol arrays with an
explicit <NULL> sentinel -- build the R x 32 matrices, permute columns,
read out, interlace into the circular buffer, then run the spec's
while-loop bit selection skipping <NULL>s.  Oracle only; never imported by
production code.
"""

from __future__ import annotations

NULL = -1  # the spec's <NULL> marker; real soft bits here are >= 0 indices

# TS 36.212 Table 5.1.4-1 inter-column permutation pattern, transcribed
# independently of spec/rate_match.py.
P = [0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
     1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31]


def _sub_block_interleave_01(d: list[int]) -> list[int]:
    """Streams d^(0)/d^(1): write row by row into R x 32, permute columns
    by P, read column by column (TS 36.212 section 5.1.4.1.1)."""
    D = len(d)
    R = -(-D // 32)
    y = [NULL] * (R * 32 - D) + list(d)
    mat = [[y[r * 32 + c] for c in range(32)] for r in range(R)]
    out = []
    for c in range(32):
        for r in range(R):
            out.append(mat[r][P[c]])
    return out


def _sub_block_interleave_2(d: list[int]) -> list[int]:
    """Stream d^(2): v_k = y_{pi(k)}, pi(k) = (P(k div R) + 32(k mod R) + 1)
    mod K_pi."""
    D = len(d)
    R = -(-D // 32)
    K_pi = R * 32
    y = [NULL] * (K_pi - D) + list(d)
    return [y[(P[k // R] + 32 * (k % R) + 1) % K_pi] for k in range(K_pi)]


def rate_match_ref(d0: list[int], d1: list[int], d2: list[int], E: int,
                   rv: int = 0, n_cb: int | None = None,
                   F: int = 0) -> list[int]:
    """Rate-match three length-D streams to E soft-bit values.

    Inputs are SYMBOLS (any ints >= 0, typically flat d indices); filler
    handling per section 5.1.3.2: with F > 0 the first F entries of d0 and
    d1 are <NULL> and are skipped by the bit selection exactly like
    interleaver padding dummies.
    """
    d0 = list(d0)
    d1 = list(d1)
    for k in range(F):
        d0[k] = NULL
        d1[k] = NULL
    v0 = _sub_block_interleave_01(d0)
    v1 = _sub_block_interleave_01(d1)
    v2 = _sub_block_interleave_2(d2)
    K_pi = len(v0)

    # Bit collection (section 5.1.4.1.2): w_k = v0_k; w_{Kpi+2k} = v1_k;
    # w_{Kpi+2k+1} = v2_k.
    w = [NULL] * (3 * K_pi)
    for k in range(K_pi):
        w[k] = v0[k]
        w[K_pi + 2 * k] = v1[k]
        w[K_pi + 2 * k + 1] = v2[k]

    if n_cb is None:
        n_cb = 3 * K_pi
    R = K_pi // 32
    k0 = R * (2 * (-(-n_cb // (8 * R))) * rv + 2)

    # Bit selection: the spec's literal while loop.
    e = []
    j = 0
    while len(e) < E:
        wj = w[(k0 + j) % n_cb]
        if wj != NULL:
            e.append(wj)
        j += 1
        if j > 4 * 3 * K_pi * (E // max(1, 3 * K_pi) + 1):
            raise RuntimeError("selection not terminating")
    return e
