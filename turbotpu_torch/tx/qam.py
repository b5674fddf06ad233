"""Gray-mapped square QAM: modulation + generic max-log LLR demapping.

Counterpart of turbotpu/tx/qam.py.  Constellations follow TS 36.211 (16QAM
Table 7.1.3-1, 64QAM Table 7.1.4-1); QPSK is included so the generic
demapper can be cross-checked against the closed-form rails in
`chain.demap_qpsk`.

Demapping is exact max-log over the constellation:

    LLR_j = esn0 * ( min_{s: bit_j=1} |y - s|^2  -  min_{s: bit_j=0} |y - s|^2 )

with the framework sign convention LLR > 0 => bit 0, and per-real-dimension
noise variance sigma_r^2 = 1/(2*Es/N0) for unit-energy symbols (so the
prefactor 1/(2*sigma_r^2) = esn0).  For BPSK/QPSK this reduces exactly to
the closed forms in `chain`.  The distance tensor is (B, n, M) with M <= 64:
test-signal generation and receive front end only, not a hot path.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def constellation(m: int) -> tuple[np.ndarray, np.ndarray]:
    """Return (points (M,) complex128, bit_table (M, m) int8) for 2^m-QAM.

    m = 2 (QPSK), 4 (16QAM), 6 (64QAM).  bit_table[i] is the TS 36.211 bit
    label (b0..b_{m-1}) of points[i]; unit average symbol energy.
    """
    if m not in (2, 4, 6):
        raise ValueError(f"unsupported bits/symbol: {m}")
    M = 1 << m
    bits = ((np.arange(M)[:, None] >> np.arange(m - 1, -1, -1)) & 1).astype(
        np.int8)  # row i = (b0, ..., b_{m-1}) of integer i, b0 = MSB
    s = 1 - 2 * bits.astype(np.float64)  # bipolar: bit 0 -> +1
    if m == 2:      # QPSK: x = (s0 + j*s1)/sqrt(2)
        i_amp, q_amp, norm = s[:, 0], s[:, 1], np.sqrt(2.0)
    elif m == 4:    # 16QAM: I = s0*(2 - s2), Q = s1*(2 - s3), /sqrt(10)
        i_amp = s[:, 0] * (2.0 - s[:, 2])
        q_amp = s[:, 1] * (2.0 - s[:, 3])
        norm = np.sqrt(10.0)
    else:           # 64QAM: I = s0*(4 - s2*(2 - s4)), mirrored for Q
        i_amp = s[:, 0] * (4.0 - s[:, 2] * (2.0 - s[:, 4]))
        q_amp = s[:, 1] * (4.0 - s[:, 3] * (2.0 - s[:, 5]))
        norm = np.sqrt(42.0)
    points = (i_amp + 1j * q_amp) / norm
    # lru_cache shares these arrays across all callers: freeze them so a
    # mutating caller cannot corrupt the cache.
    points.flags.writeable = False
    bits.flags.writeable = False
    return points, bits


def _points(m: int, device) -> torch.Tensor:
    return torch.from_numpy(constellation(m)[0].astype(np.complex64)).to(device)


def modulate_qam(bits: torch.Tensor, m: int) -> torch.Tensor:
    """Gray-map bits (B, m*n) -> complex64 symbols (B, n), unit energy."""
    B, nb = bits.shape
    if nb % m:
        raise ValueError(f"bit count {nb} not a multiple of {m}")
    w = torch.tensor([1 << k for k in range(m - 1, -1, -1)], dtype=torch.long,
                     device=bits.device)
    idx = (bits.reshape(B, nb // m, m).to(torch.long) * w).sum(dim=-1)
    return _points(m, bits.device)[idx]


def demap_qam(y: torch.Tensor, esn0_db: float, m: int,
              amp: torch.Tensor | None = None) -> torch.Tensor:
    """Exact max-log per-bit LLRs: (B, n) symbols -> (B, m*n) LLRs.

    LLR > 0 favors bit 0 (framework convention).  `amp` (broadcastable to
    y's shape) is the per-symbol CSI amplitude of a fading channel after
    the maximal-ratio rotation (chain.rayleigh_fading): the hypothesis
    distances become |y - amp*s|^2, which is the exact max-log metric for
    y = a*s + n with known a.  amp=None is the unit-gain AWGN case.
    """
    _, bit_table = constellation(m)
    esn0 = 10.0 ** (float(esn0_db) / 10.0)
    pts = _points(m, y.device)
    if amp is not None:
        pts = amp[..., None].to(torch.complex64) * pts
    d2 = (y[..., None] - pts).abs() ** 2                       # (B, n, M)
    big = torch.finfo(torch.float32).max
    llrs = []
    for j in range(m):  # one bit at a time keeps peak memory at (B, n, M)
        is1 = torch.from_numpy(bit_table[:, j] == 1).to(y.device)  # (M,)
        d1 = d2.masked_fill(~is1, big).amin(dim=-1)
        d0 = d2.masked_fill(is1, big).amin(dim=-1)
        llrs.append(esn0 * (d1 - d0))
    B, n = y.shape
    return torch.stack(llrs, dim=-1).reshape(B, n * m)


BITS_PER_SYMBOL = {"bpsk": 1, "qpsk": 2, "qam16": 4, "qam64": 6}
