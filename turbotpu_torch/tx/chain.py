"""Transmit chain on the device: payload -> CRC -> turbo encode ->
modulate -> channel -> LLR demap.

Counterpart of turbotpu/tx/chain.py.  Everything is batched (leading B
axis).  Random draws take an explicit `torch.Generator` that lives on the
tensors' device; the numbers are PyTorch's, not the JAX package's, so the
deterministic stages are held bit-identical to it on the same inputs and the
channels are held to closed forms.

The encoder is not a loop over trellis steps.  The RSC's feedback register
(1 + D^2 + D^3) is linear over GF(2), so the feedback sequence is the input
convolved with the register's impulse response (period 7), which is one
matrix product mod 2 against a K x K upper-triangular 0/1 matrix, built once
per K and device; the parity (1 + D + D^3) and the three tail steps follow
from shifts of that sequence.  The product is fp32 on 0/1 values with sums
up to K < 2^24: exact, provided it really runs in fp32 (TF32 off, as PyTorch
has it by default).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..spec.crc import crc_matrix


def require_exact_matmul(x: torch.Tensor) -> None:
    """The GF(2) products (CRC, encoder) need a true fp32 matmul on the
    card."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "GF(2) matrix products need an exact fp32 matmul: "
            "torch.backends.cuda.matmul.allow_tf32 must be False")


def gen_payload(gen: torch.Generator, B: int, n_bits: int) -> torch.Tensor:
    """(B, n_bits) uniform random information bits, int8, on gen's device."""
    return torch.randint(0, 2, (B, n_bits), generator=gen, device=gen.device,
                         dtype=torch.int8)


@functools.lru_cache(maxsize=None)
def _crc_matrix_on(n: int, poly: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(crc_matrix(n, poly).astype(np.float32)).to(device)


def crc_attach_batch(bits: torch.Tensor, poly: int) -> torch.Tensor:
    """Append CRC-24 to each row: (B, n) -> (B, n + 24)."""
    require_exact_matmul(bits)
    G = _crc_matrix_on(bits.shape[1], poly, bits.device)
    crc = (bits.to(torch.float32) @ G) % 2.0
    return torch.cat([bits, crc.to(torch.int8)], dim=1)


@functools.lru_cache(maxsize=8)
def _feedback_matrix(K: int, device: torch.device) -> torch.Tensor:
    """M (K, K) fp32 with M[j, k] = h[k - j] for k >= j, where h is the
    impulse response of 1 / (1 + D^2 + D^3): feedback = bits @ M mod 2."""
    h = [0, 0, 0, 1]              # a_k = u_k ^ a_k-2 ^ a_k-3, impulse at 0
    for _ in range(9):
        h.append(h[-2] ^ h[-3])
    h = h[3:]
    if h[7:10] != h[0:3]:
        raise AssertionError("the feedback register's period is not 7")
    h7 = torch.tensor(h[:7], dtype=torch.float32, device=device)
    k = torch.arange(K, device=device, dtype=torch.int32)
    d = k[None, :] - k[:, None]
    return torch.where(d >= 0, h7[d.remainder(7).long()],
                       torch.zeros((), dtype=torch.float32, device=device))


def _rsc(bits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched RSC encoder: bits (B, K) int8 -> (parity (B, K), tail (B, 6))."""
    B, K = bits.shape
    a = ((bits.to(torch.float32) @ _feedback_matrix(K, bits.device)) % 2.0
         ).to(torch.int8)
    # a_k-1, a_k-2, a_k-3 with the register starting at zero
    ap = torch.nn.functional.pad(a, (3, 0))
    a1, a3 = ap[:, 2:K + 2], ap[:, 0:K]
    parity = a ^ a1 ^ a3
    # termination: the input that zeroes the feedback, three times
    s1, s2, s3 = ap[:, K + 2], ap[:, K + 1], ap[:, K]
    tail = []
    for _ in range(3):
        tail += [s2 ^ s3, s1 ^ s3]                # u = a2 ^ a3, p = a1 ^ a3
        s1, s2, s3 = torch.zeros_like(s1), s1, s2
    return parity, torch.stack(tail, dim=1)


def turbo_encode(bits: torch.Tensor, perm) -> tuple[torch.Tensor, ...]:
    """Canonical-format batched turbo encode.

    bits: (B, K) int8; perm: the interleaver table (numpy or tensor).
    Returns (sys (B,K), par1, par2, tail1 (B,6), tail2 (B,6)), int8.
    """
    require_exact_matmul(bits)
    perm = torch.as_tensor(perm).to(bits.device, torch.long)
    par1, tail1 = _rsc(bits)
    par2, tail2 = _rsc(bits.index_select(1, perm))
    return bits, par1, par2, tail1, tail2


def _esn0(esn0_db: float) -> float:
    return 10.0 ** (float(esn0_db) / 10.0)


def _randn(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=gen.device,
                       dtype=torch.float32)


def modulate_bpsk(bits: torch.Tensor) -> torch.Tensor:
    """0 -> +1, 1 -> -1 (so positive LLR favors 0)."""
    return (1 - 2 * bits).to(torch.float32)


def awgn(gen: torch.Generator, x: torch.Tensor, esn0_db: float) -> torch.Tensor:
    """Add white Gaussian noise at the given Es/N0 (dB); unit-energy symbols."""
    sigma = math.sqrt(1.0 / (2.0 * _esn0(esn0_db)))
    return x + sigma * _randn(gen, x.shape)


def demap_bpsk(y: torch.Tensor, esn0_db: float) -> torch.Tensor:
    """LLR = 2y / sigma^2 = 4 * (Es/N0) * y (channel reliability scaling)."""
    return (4.0 * _esn0(esn0_db)) * y


def modulate_qpsk(bits: torch.Tensor) -> torch.Tensor:
    """Gray-mapped QPSK as two independent BPSK rails at Es split across
    I/Q: bits (B, 2n) -> complex64 (B, n) with unit symbol energy."""
    i = modulate_bpsk(bits[:, 0::2]) / math.sqrt(2.0)
    q = modulate_bpsk(bits[:, 1::2]) / math.sqrt(2.0)
    return torch.complex(i, q)


def awgn_complex(gen: torch.Generator, x: torch.Tensor,
                 esn0_db: float) -> torch.Tensor:
    """Circularly-symmetric AWGN at Es/N0 for unit-energy complex symbols:
    total noise power N0 = 1/(Es/N0), i.e. variance 1/(2*Es/N0) per real
    dimension -- the convention every demapper in this module assumes."""
    sigma = math.sqrt(1.0 / (2.0 * _esn0(esn0_db)))  # per-real-dimension std
    n = torch.complex(_randn(gen, x.shape), _randn(gen, x.shape))
    return x + sigma * n


def _interleave_rails(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return torch.stack([re, im], dim=2).reshape(re.shape[0], -1)


def demap_qpsk(y: torch.Tensor, esn0_db: float) -> torch.Tensor:
    """Per-rail LLRs, interleaved back to bit order: (B, n) -> (B, 2n)."""
    scale = 4.0 * _esn0(esn0_db) / math.sqrt(2.0)
    return _interleave_rails(scale * y.real, scale * y.imag)


# ---------------------------------------------------------------------------
# Rayleigh flat fading with perfect CSI
# ---------------------------------------------------------------------------

def rayleigh_fading(gen: torch.Generator, x: torch.Tensor, esn0_db: float
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-symbol Rayleigh flat fading + noise; returns (z, a).

    Channel: y = h * x + n with h ~ CN(0, 1) i.i.d. per symbol and
    circularly-symmetric noise at the given Es/N0 (E[|h|^2] = 1, so the
    average Es/N0 label is unchanged).  The receiver has perfect CSI and
    applies the maximal-ratio rotation z = conj(h) * y / |h|, which leaves

        z = a * x + n'        a = |h| (Rayleigh),  n' ~ same law as n

    because the rotation is unitary on circular noise.  Returns the rotated
    observation `z` (real for real `x`, taking Re(.) -- the imaginary rail
    of a real constellation carries no signal) and the CSI amplitudes `a`,
    to be passed to the *_csi demappers / `demap_qam(..., amp=a)`.
    """
    hr = _randn(gen, (2,) + tuple(x.shape)) / math.sqrt(2.0)
    h = torch.complex(hr[0], hr[1])
    a = h.abs()
    rot = h.conj() / a.to(torch.complex64)
    if x.is_complex():
        return rot * awgn_complex(gen, h * x, esn0_db), a
    # Real constellation on a complex channel: after the rotation the
    # in-phase rail is a*x + Re(n'), Re(n') real Gaussian with the same
    # per-dimension variance as the real-channel AWGN model.
    y = awgn_complex(gen, h * x.to(torch.complex64), esn0_db)
    return (rot * y).real, a


def demap_bpsk_csi(z: torch.Tensor, a: torch.Tensor,
                   esn0_db: float) -> torch.Tensor:
    """BPSK LLR with per-symbol CSI amplitude: L = 4 * (Es/N0) * a * z."""
    return (4.0 * _esn0(esn0_db)) * a * z


def demap_qpsk_csi(z: torch.Tensor, a: torch.Tensor,
                   esn0_db: float) -> torch.Tensor:
    """QPSK per-rail LLRs with CSI: each rail is BPSK at amplitude a/sqrt(2)."""
    scale = (4.0 * _esn0(esn0_db) / math.sqrt(2.0)) * a
    return _interleave_rails(scale * z.real, scale * z.imag)
