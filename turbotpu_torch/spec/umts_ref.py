"""Independent second implementation of the UMTS turbo interleaver.

The port's own copy of turbotpu/spec/umts_ref.py.  `spec/umts.py` is the
production matrix-gather formulation; THIS file re-derives the permutation
by following the TS 25.212 section 4.2.3.2.3 text literally, step by step,
with explicit scalar loops and a pruning pass -- a genuinely different
construction path, which the port's tests hold `spec/umts.py` to.

Do not import this from production code; it is a conformance oracle only.
"""

from __future__ import annotations

import math

# TS 25.212 Table 2 transcribed independently: prime p -> primitive root v.
TABLE2 = {
    7: 3, 11: 2, 13: 2, 17: 3, 19: 2, 23: 5, 29: 2, 31: 3, 37: 2, 41: 6,
    43: 3, 47: 5, 53: 2, 59: 2, 61: 2, 67: 2, 71: 7, 73: 5, 79: 3, 83: 2,
    89: 3, 97: 5, 101: 2, 103: 5, 107: 2, 109: 6, 113: 3, 127: 3, 131: 2,
    137: 3, 139: 2, 149: 2, 151: 6, 157: 5, 163: 2, 167: 5, 173: 2, 179: 2,
    181: 2, 191: 19, 193: 5, 197: 2, 199: 3, 211: 2, 223: 3, 227: 2, 229: 6,
    233: 3, 239: 7, 241: 7, 251: 6, 257: 3,
}

# TS 25.212 Table 3: inter-row permutation patterns <T(0), ..., T(R-1)>.
PAT1 = [19, 9, 14, 4, 0, 2, 5, 7, 12, 18, 16, 13, 17, 15, 3, 1, 6, 11, 8, 10]
PAT2 = [19, 9, 14, 4, 0, 2, 5, 7, 12, 18, 10, 8, 13, 17, 3, 1, 16, 6, 15, 11]
PAT3 = [9, 8, 7, 6, 5, 4, 3, 2, 1, 0]
PAT4 = [4, 3, 2, 1, 0]


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    return all(n % d for d in range(2, int(math.isqrt(n)) + 1))


def umts_perm_ref(K: int) -> list[int]:
    """TS 25.212 section 4.2.3.2.3, followed literally.

    Returns the permutation as a plain list: output[i] = input[perm[i]].
    """
    if not 40 <= K <= 5114:
        raise ValueError(K)

    # -- 4.2.3.2.3.1: determine R, p, C ---------------------------------
    if 40 <= K <= 159:
        R = 5
    elif 160 <= K <= 200 or 481 <= K <= 530:
        R = 10
    else:
        R = 20

    if 481 <= K <= 530:
        p = 53
        C = p
    else:
        p = min(q for q in TABLE2 if K <= R * (q + 1))
        if K <= R * (p - 1):
            C = p - 1
        elif K <= R * p:
            C = p
        else:
            C = p + 1
    v = TABLE2[p]

    # Write the input bit INDICES into the R x C matrix row by row,
    # padding positions beyond K with a dummy marker (None).
    mat: list[list[int | None]] = []
    n = 0
    for _ in range(R):
        row: list[int | None] = []
        for _ in range(C):
            row.append(n if n < K else None)
            n += 1
        mat.append(row)

    # -- 4.2.3.2.3.2: intra-row permutations ----------------------------
    # (1) base sequence s(j) = (v * s(j-1)) mod p, s(0) = 1.
    s = [1]
    for _ in range(p - 2):
        s.append((v * s[-1]) % p)
    assert len(s) == p - 1

    # (2) q(0) = 1; q(j) = minimum prime with gcd(q(j), p-1) == 1,
    #     q(j) > 6, and q(j) > q(j-1).
    q = [1]
    for _ in range(R - 1):
        cand = q[-1] + 1
        while not (_is_prime(cand) and cand > 6
                   and math.gcd(cand, p - 1) == 1):
            cand += 1
        q.append(cand)

    # (3) inter-row permutation pattern selection (Table 3).
    if R == 5:
        T = PAT4
    elif R == 10:
        T = PAT3
    elif (2281 <= K <= 2480) or (3161 <= K <= 3210):
        T = PAT2
    else:
        T = PAT1

    # (4) permute {q} into {r}: r(T(j)) = q(j).
    r = [0] * R
    for j in range(R):
        r[T[j]] = q[j]

    # (5)/(6) intra-row permutation U_j(i) of row j, by the C cases.
    for j in range(R):
        U = [0] * C
        if C == p:
            for i in range(p - 1):
                U[i] = s[(i * r[j]) % (p - 1)]
            U[p - 1] = 0
        elif C == p + 1:
            for i in range(p - 1):
                U[i] = s[(i * r[j]) % (p - 1)]
            U[p - 1] = 0
            U[p] = p
            if K == R * C and j == R - 1:
                U[p], U[0] = U[0], U[p]
        else:  # C == p - 1
            for i in range(p - 1):
                U[i] = s[(i * r[j]) % (p - 1)] - 1
        mat[j] = [mat[j][U[i]] for i in range(C)]

    # -- 4.2.3.2.3.3: inter-row permutation -----------------------------
    mat = [mat[T[j]] for j in range(R)]

    # Read column by column, pruning dummies.
    out: list[int] = []
    for c in range(C):
        for rr in range(R):
            x = mat[rr][c]
            if x is not None:
                out.append(x)
    assert len(out) == K
    return out
