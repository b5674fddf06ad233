"""Mixed block-size decoding.

Counterpart of turbotpu/decoder/bucketing.py.  `decode_mixed` groups
codewords into per-K buckets, decodes each bucket in one call and puts the
results back into input order.  `embedded_perm_tables` and
`grouped_perm_tables` build the interleaver tables that let a batch of true
per-K codewords decode in ONE call at a bucket size (turbo_decode's
perm_b/inv_b and group_tables); `bucket_ceilings` maps sizes to a small set
of bucket sizes.  The tables are numpy, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict

import numpy as np

from ..spec.qpp import qpp_perm
from ..spec.umts import umts_perm
from .turbo import DecoderConfig, turbo_decode


@dataclasses.dataclass
class MixedResult:
    hard: list[np.ndarray]     # per-codeword decoded bits (ragged)
    iters: np.ndarray          # (B,)
    L: list[np.ndarray]        # per-codeword LLRs (ragged)


def decode_mixed(codewords: list[dict], base_cfg: DecoderConfig,
                 device="cuda") -> MixedResult:
    """Decode codewords of heterogeneous K in per-K buckets.

    Each codeword dict: {"ls": (K,), "lp1": (K,), "lp2": (K,),
    "tail1": (6,), "tail2": (6,)}.  base_cfg.K is ignored; every other
    field (mode, iters, early termination, interleaver) applies to all.
    """
    buckets: dict[int, list[int]] = defaultdict(list)
    for i, cw in enumerate(codewords):
        buckets[len(cw["ls"])].append(i)

    B = len(codewords)
    hard: list[np.ndarray | None] = [None] * B
    L: list[np.ndarray | None] = [None] * B
    iters = np.zeros(B, np.int32)
    for K, idxs in sorted(buckets.items()):
        cfg = dataclasses.replace(base_cfg, K=K)
        stack = lambda key: np.stack(
            [np.asarray(codewords[i][key], np.float32) for i in idxs])
        h, it, Lb = (x.cpu().numpy() for x in turbo_decode(
            stack("ls"), stack("lp1"), stack("lp2"), stack("tail1"),
            stack("tail2"), cfg, device=device))
        for j, i in enumerate(idxs):
            hard[i] = h[j]
            L[i] = Lb[j]
            iters[i] = it[j]
    return MixedResult(hard=hard, iters=iters, L=L)  # type: ignore[arg-type]


def embedded_perm_tables(Ks: list[int] | tuple[int, ...], K_bucket: int,
                         interleaver: str = "lte"
                         ) -> tuple[np.ndarray, np.ndarray]:
    """Per-codeword EMBEDDED interleaver tables for true mixed-K decoding.

    A true-K codeword -- transmitted at its own 3K+12 bits with its own
    TS 36.212 / TS 25.212 interleaver pi_K -- embeds into a K_bucket
    trellis as F = K_bucket - K leading known-zero filler steps followed
    by the real code: both constituent encoders idle at state 0 through
    the fillers (zero input from state 0 keeps an RSC at state 0), and
    the true tail bits land at the canonical end-of-trellis slots, so a
    heterogeneous batch decodes in one call against one trellis shape.
    The embedded permutation is

        phi(j)     = j               for j <  F   (filler <-> filler)
        phi(F + i) = F + pi_K(i)     for 0 <= i < K

    a bijection on [0, K_bucket).  The receiver marks filler systematic
    LLRs +BIG (known zero) and filler parity LLRs 0 -- the same
    known-zero-bit convention the kernel's tail padding uses.

    Returns (phi (B, K_bucket), phi_inv (B, K_bucket)) int32, one row per
    codeword, ready to pass to turbo_decode(..., perm_b=, inv_b=).
    """
    mk = qpp_perm if interleaver == "lte" else umts_perm
    rows, invs = [], []
    cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    for K in Ks:
        if K > K_bucket:
            raise ValueError(f"K={K} exceeds bucket {K_bucket}")
        if K not in cache:
            F = K_bucket - K
            phi = np.arange(K_bucket, dtype=np.int32)
            phi[F:] = F + np.asarray(mk(K), np.int32)
            inv = np.empty_like(phi)
            inv[phi] = np.arange(K_bucket, dtype=np.int32)
            cache[K] = (phi, inv)
        phi, inv = cache[K]
        rows.append(phi)
        invs.append(inv)
    return np.stack(rows), np.stack(invs)


def grouped_perm_tables(Ks: list[int] | tuple[int, ...], K_bucket: int,
                        interleaver: str = "lte"
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Deduplicated embedded tables: a mixed batch has only a handful of
    distinct block sizes, so G shared tables plus a per-codeword group id
    describe it.

    Returns (perm_g (G, K_bucket), inv_g (G, K_bucket), gid (B,) int32)
    with G = number of DISTINCT sizes in Ks (ascending order), ready to
    pass to turbo_decode(..., group_tables=).
    """
    uniq = sorted(set(Ks))
    pg, ig = embedded_perm_tables(uniq, K_bucket, interleaver)
    idx = {k: i for i, k in enumerate(uniq)}
    gid = np.asarray([idx[k] for k in Ks], np.int32)
    return pg, ig, gid


def bucket_ceilings(Ks: list[int], legal: tuple[int, ...]) -> dict[int, int]:
    """Map each K to the smallest ceiling in `legal` >= K.  Padding up to a
    bucket uses the known-zero-bit trick at the tx side (filler bits), so
    ceilings must be legal block sizes."""
    out = {}
    for K in Ks:
        for c in legal:
            if c >= K:
                out[K] = c
                break
        else:
            raise ValueError(f"no bucket ceiling for K={K}")
    return out
