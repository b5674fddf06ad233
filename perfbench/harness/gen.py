"""The benchmark's input generator: received LLRs made on the device from a
seed, in bulk.

Payload bits, CRC-24A (and, for a segmented transport block, CRC-24B per
code block), the LTE turbo encoder (TS 36.212 section 5.1.3.2), rate
matching to each block's E_r bits (section 5.1.4.1, redundancy version 0)
where the configuration has a G, BPSK over AWGN and the channel LLR
2y / sigma^2.  Everything comes from one `torch.Generator` on the device,
seeded with the run's seed, so the same seed gives the same inputs.  The
GF(2) work is exact: the CRC products run in float64 and the encoder's
feedback is a prefix XOR per residue of its period.
"""

from __future__ import annotations

import math

import torch

from . import spec

# impulse response of the feedback 1 / (1 + D^2 + D^3): period 7
_H = (1, 0, 1, 1, 1, 0, 0)


def crc_attach(bits: torch.Tensor, poly: int) -> torch.Tensor:
    """(n, k) 0/1 int8 -> (n, k + 24) with the CRC appended."""
    M = torch.from_numpy(spec.crc_parity_matrix(bits.shape[1], poly)).to(
        bits.device, torch.float64)
    par = ((bits.to(torch.float64) @ M) % 2).to(torch.int8)
    return torch.cat([bits, par], dim=1)


def _rsc(u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One constituent encoder: (n, K) int8 -> parity (n, K) and the
    termination (n, 6) = x_K, z_K, x_K+1, z_K+1, x_K+2, z_K+2."""
    n, K = u.shape
    dev = u.device
    k = torch.arange(K, device=dev)
    h = torch.tensor(_H, device=dev, dtype=torch.int32)
    a = torch.zeros((n, K), dtype=torch.int32, device=dev)
    ui = u.to(torch.int32)
    for c in range(7):
        # prefix XOR of the inputs at positions = c (mod 7)
        s = torch.cumsum(ui * (k % 7 == c), dim=1) & 1
        a ^= s * h[(k - c) % 7]
    ap = torch.nn.functional.pad(a, (3, 0))
    z = a ^ ap[:, 2:K + 2] ^ ap[:, 0:K]             # a_k ^ a_k-1 ^ a_k-3
    s1, s2, s3 = a[:, K - 1], a[:, K - 2], a[:, K - 3]
    tail = []
    for _ in range(3):
        tail += [s2 ^ s3, s1 ^ s3]                   # input = feedback
        s1, s2, s3 = torch.zeros_like(s1), s1, s2
    return z.to(torch.int8), torch.stack(tail, dim=1).to(torch.int8)


def turbo_encode(bits: torch.Tensor):
    """(n, K) int8 -> (sys, par1, par2, tail1, tail2), int8."""
    perm = torch.from_numpy(spec.qpp_perm(bits.shape[1])).to(bits.device)
    z1, t1 = _rsc(bits)
    z2, t2 = _rsc(bits.index_select(1, perm))
    return bits, z1, z2, t1, t2


def d_streams(sys, z1, z2, t1, t2) -> torch.Tensor:
    """Canonical parts -> flat [d0 | d1 | d2] (n, 3 (K + 4)), section
    5.1.3.2.2's tail multiplexing."""
    col = lambda t, i: t[:, i:i + 1]
    d0 = torch.cat([sys, col(t1, 0), col(t1, 3), col(t2, 0), col(t2, 3)], 1)
    d1 = torch.cat([z1, col(t1, 1), col(t1, 4), col(t2, 1), col(t2, 4)], 1)
    d2 = torch.cat([z2, col(t1, 2), col(t1, 5), col(t2, 2), col(t2, 5)], 1)
    return torch.cat([d0, d1, d2], dim=1)


def channel(gen: torch.Generator, bits: torch.Tensor, esn0_db: float
            ) -> torch.Tensor:
    """BPSK over AWGN at Es/N0 (dB), unit-energy symbols; returns the LLRs
    2y / sigma^2 (positive favours 0), float32."""
    sigma2 = 1.0 / (2.0 * 10.0 ** (esn0_db / 10.0))
    x = 1.0 - 2.0 * bits.to(torch.float32)
    y = x + math.sqrt(sigma2) * torch.randn(bits.shape, generator=gen,
                                            device=bits.device,
                                            dtype=torch.float32)
    return y * (2.0 / sigma2)


def _chunked(n: int, size: int):
    return [(i, min(n, i + size)) for i in range(0, n, size)]


def codeblocks(gen, n: int, K: int, ebn0_db: float, chunk: int = 2048):
    """n mother-rate (1/3) LTE code blocks of K bits carrying K - 24
    payload bits and CRC-24A, at Eb/N0 with Es/N0 = Eb/N0 / 3.  Returns
    (ls, lp1, lp2, tail1, tail2) float32 LLRs, (n, K) and (n, 6)."""
    esn0 = ebn0_db + 10 * math.log10(1 / 3)
    dev = gen.device
    parts = [[] for _ in range(5)]
    for lo, hi in _chunked(n, chunk):
        bits = torch.randint(0, 2, (hi - lo, K - 24), generator=gen,
                             device=dev, dtype=torch.int8)
        for lst, p in zip(parts, turbo_encode(crc_attach(bits, spec.CRC24A))):
            lst.append(channel(gen, p, esn0))
    return tuple(torch.cat(p) for p in parts)


def block_layout(A: int, G: int, Qm: int):
    """(segmentation, per-block (K, E, F)) of a transport block of A bits
    sent over G channel bits of modulation order Qm."""
    seg = spec.segment(A + spec.CRC_LEN)
    Es = spec.block_e(G, seg.C, Qm)
    return seg, [(K, Es[r], seg.F if r == 0 else 0)
                 for r, K in enumerate(seg.sizes)]


def runs(layout) -> list[tuple[int, int]]:
    """[first block, end) of each run of consecutive blocks with one
    (K, E, F): the receiver de-rate-matches a run in one call."""
    out, r0 = [], 0
    for r in range(1, len(layout) + 1):
        if r == len(layout) or layout[r] != layout[r0]:
            out.append((r0, r))
            r0 = r
    return out


def transport_blocks(gen, n: int, A: int, G: int, Qm: int, ebn0_db: float,
                     chunk: int = 64):
    """n transport blocks of A bits: CRC-24A, segmentation, CRC-24B per
    block when C > 1, filler bits in block 0, turbo encoding and rate
    matching of block r to E_r bits, BPSK/AWGN at Es/N0 = Eb/N0 * A / G.
    Returns the received LLRs as one (n * (r1 - r0), E) float32 tensor per
    run of blocks, row (r - r0) * n + t for block r of block t, and the
    transmitted CRC-attached blocks (n, A + 24) int8."""
    seg, layout = block_layout(A, G, Qm)
    esn0 = ebn0_db + 10 * math.log10(A / G)
    dev = gen.device
    per_block = [[] for _ in layout]
    tbs = []
    for lo, hi in _chunked(n, chunk):
        tb = crc_attach(torch.randint(0, 2, (hi - lo, A), generator=gen,
                                      device=dev, dtype=torch.int8),
                        spec.CRC24A)
        tbs.append(tb)
        for r, ((off, take), (K, E, F)) in enumerate(zip(seg.chunks(),
                                                         layout)):
            blk = torch.nn.functional.pad(tb[:, off:off + take], (F, 0))
            if seg.C > 1:
                blk = crc_attach(blk, spec.CRC24B)
            d = d_streams(*turbo_encode(blk))
            sel = torch.from_numpy(spec.selection(K, E, 0, F)).to(dev)
            per_block[r].append(channel(gen, d.index_select(1, sel), esn0))
    blocks = [torch.cat(b) for b in per_block]
    return ([torch.cat(blocks[r0:r1]) for r0, r1 in runs(layout)],
            torch.cat(tbs))
