"""3GPP UMTS turbo code internal interleaver (TS 25.212 section 4.2.3.2.3).

The "prunable" matrix interleaver: K bits (40 <= K <= 5114) are written
row-major into an R x C matrix, intra-row permutations built from primitive
roots mod a prime p are applied, rows are permuted, and the matrix is read
column-major with positions >= K pruned out.

The port's own copy of turbotpu/spec/umts.py (numpy only): the table is
built on the host, the permutation itself is applied on the device with a
gather.
"""

from __future__ import annotations

import functools

import numpy as np

MIN_K = 40
MAX_K = 5114

# TS 25.212 Table 2: primes p with associated primitive root v.
_PRIME_V = (
    (7, 3), (11, 2), (13, 2), (17, 3), (19, 2), (23, 5), (29, 2), (31, 3),
    (37, 2), (41, 6), (43, 3), (47, 5), (53, 2), (59, 2), (61, 2), (67, 2),
    (71, 7), (73, 5), (79, 3), (83, 2), (89, 3), (97, 5), (101, 2), (103, 5),
    (107, 2), (109, 6), (113, 3), (127, 3), (131, 2), (137, 3), (139, 2),
    (149, 2), (151, 6), (157, 5), (163, 2), (167, 5), (173, 2), (179, 2),
    (181, 2), (191, 19), (193, 5), (197, 2), (199, 3), (211, 2), (223, 3),
    (227, 2), (229, 6), (233, 3), (239, 7), (241, 7), (251, 6), (257, 3),
)
_PRIMES = tuple(p for p, _ in _PRIME_V)
_V = {p: v for p, v in _PRIME_V}

# TS 25.212 Table 3: inter-row permutation patterns T (new row i takes old
# row T[i] when reading).
_PAT_A = (19, 9, 14, 4, 0, 2, 5, 7, 12, 18, 16, 13, 17, 15, 3, 1, 6, 11, 8, 10)
_PAT_B = (19, 9, 14, 4, 0, 2, 5, 7, 12, 18, 10, 8, 13, 17, 3, 1, 16, 6, 15, 11)
_PAT_C = (9, 8, 7, 6, 5, 4, 3, 2, 1, 0)
_PAT_D = (4, 3, 2, 1, 0)


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for d in range(2, int(n**0.5) + 1):
        if n % d == 0:
            return False
    return True


def _rcp(K: int) -> tuple[int, int, int]:
    """Rows R, columns C, prime p per TS 25.212 section 4.2.3.2.3.1."""
    if not MIN_K <= K <= MAX_K:
        raise ValueError(f"UMTS interleaver requires 40 <= K <= 5114, got {K}")
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
        p = next(q for q in _PRIMES if K <= R * (q + 1))
        if K <= R * (p - 1):
            C = p - 1
        elif K <= R * p:
            C = p
        else:
            C = p + 1
    return R, C, p


@functools.lru_cache(maxsize=None)
def umts_perm(K: int) -> np.ndarray:
    """Permutation Pi with interleaved[i] = natural[Pi[i]] (len K, int32)."""
    R, C, p = _rcp(K)
    v = _V[p]

    # Base sequence s(j) = v^j mod p for j = 0..p-2.
    s = np.empty(p - 1, dtype=np.int64)
    s[0] = 1
    for j in range(1, p - 1):
        s[j] = (v * s[j - 1]) % p

    # q(0)=1; q(i) = least prime with gcd(q(i), p-1) == 1, q(i) > 6, and
    # q(i) > q(i-1).  The "> 6" floor is part of TS 25.212 section
    # 4.2.3.2.3.2 step (2); dropping it yields a wrong-but-bijective
    # permutation.
    q = [1]
    cand = 2
    while len(q) < R:
        if (_is_prime(cand) and cand > 6 and cand > q[-1]
                and np.gcd(cand, p - 1) == 1):
            q.append(cand)
        cand += 1
    q = np.array(q, dtype=np.int64)

    # Inter-row permutation pattern T.
    if R == 5:
        T = np.array(_PAT_D)
    elif R == 10:
        T = np.array(_PAT_C)
    elif (2281 <= K <= 2480) or (3161 <= K <= 3210):
        T = np.array(_PAT_B)
    else:
        T = np.array(_PAT_A)

    # r(T(i)) = q(i).
    r = np.empty(R, dtype=np.int64)
    r[T] = q

    # Intra-row permutations U[i, j].
    U = np.empty((R, C), dtype=np.int64)
    j = np.arange(p - 1, dtype=np.int64)
    for i in range(R):
        base = s[(j * r[i]) % (p - 1)]
        if C == p:
            U[i, : p - 1] = base
            U[i, p - 1] = 0
        elif C == p + 1:
            U[i, : p - 1] = base
            U[i, p - 1] = 0
            U[i, p] = p
        else:  # C == p - 1
            U[i] = base - 1
    if C == p + 1 and K == R * C:
        # Exchange U[R-1, p] with U[R-1, 0].
        U[R - 1, p], U[R - 1, 0] = U[R - 1, 0], U[R - 1, p]

    # Matrix of input indices, row-major, with dummies = -1 beyond K.
    mat = np.full((R, C), -1, dtype=np.int64)
    flat = np.arange(R * C, dtype=np.int64)
    mat.flat[: R * C] = np.where(flat < K, flat, -1)

    # Apply intra-row permutation: new row i col j takes old col U[i, j].
    rows = np.arange(R)[:, None]
    mat = mat[rows, U]
    # Apply inter-row permutation, then read column-major and prune.
    mat = mat[T, :]
    out = mat.T.reshape(-1)
    out = out[out >= 0]
    assert out.shape == (K,)
    return out.astype(np.int32)


@functools.lru_cache(maxsize=None)
def umts_inv(K: int) -> np.ndarray:
    perm = umts_perm(K)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(K, dtype=np.int32)
    return inv
