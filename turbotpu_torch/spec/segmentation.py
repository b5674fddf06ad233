"""LTE code block segmentation (TS 36.212 section 5.1.2).

Transport blocks longer than Z = 6144 are split into C code blocks, each
getting a CRC-24B, with filler bits (<NULL>, decoded-side LLR = +inf toward
0) prepended to the first block so every block size is a legal QPP K.

The port's own copy of turbotpu/spec/segmentation.py (numpy only).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .crc import CRC24B_POLY, CRC_LEN, crc_attach
from .qpp import nearest_legal_k, LEGAL_K

Z = 6144  # maximum code block size


@dataclasses.dataclass(frozen=True)
class Segmentation:
    B: int            # input length (incl. transport-block CRC)
    C: int            # number of code blocks
    K_plus: int       # larger block size
    K_minus: int      # smaller block size (0 if unused)
    C_plus: int       # number of K_plus blocks
    C_minus: int      # number of K_minus blocks
    F: int            # filler bits in block 0
    sizes: tuple[int, ...]


def segment_params(B: int) -> Segmentation:
    if B <= Z:
        L = 0
        C = 1
        B_prime = B
    else:
        L = CRC_LEN
        C = int(np.ceil(B / (Z - L)))
        B_prime = B + C * L
    # First segmentation size: minimum legal K >= B'/C.
    K_plus = nearest_legal_k(int(np.ceil(B_prime / C)))
    if C == 1:
        K_minus, C_plus, C_minus = 0, 1, 0
    else:
        # K_minus: maximum legal K < K_plus.
        K_minus = max(k for k in LEGAL_K if k < K_plus)
        delta = K_plus - K_minus
        C_minus = int(np.floor((C * K_plus - B_prime) / delta))
        C_plus = C - C_minus
    F = C_plus * K_plus + C_minus * K_minus - B_prime
    sizes = (K_minus,) * C_minus + (K_plus,) * C_plus
    return Segmentation(B, C, K_plus, K_minus, C_plus, C_minus, F, sizes)


def segment(bits: np.ndarray) -> list[np.ndarray]:
    """Split bits into code blocks (filler bits set to 0), CRC24B attached
    per block when C > 1. Returns list of length-K_r int8 arrays."""
    bits = np.asarray(bits, dtype=np.int8)
    p = segment_params(len(bits))
    blocks = []
    s = 0
    for r, K in enumerate(p.sizes):
        payload = K - (CRC_LEN if p.C > 1 else 0)
        take = payload - (p.F if r == 0 else 0)
        blk = bits[s:s + take]
        s += take
        if r == 0 and p.F:
            blk = np.concatenate([np.zeros(p.F, dtype=np.int8), blk])
        if p.C > 1:
            blk = crc_attach(blk, CRC24B_POLY)
        assert len(blk) == K
        blocks.append(blk)
    assert s == len(bits)
    return blocks


def desegment(blocks: list[np.ndarray], B: int) -> np.ndarray:
    """Inverse of segment: strip per-block CRCs and filler, reassemble."""
    p = segment_params(B)
    out = []
    for r, blk in enumerate(blocks):
        blk = np.asarray(blk, dtype=np.int8)
        if p.C > 1:
            blk = blk[:-CRC_LEN]
        if r == 0 and p.F:
            blk = blk[p.F:]
        out.append(blk)
    res = np.concatenate(out)
    assert len(res) == B
    return res
