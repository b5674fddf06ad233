"""Plain receive chain of a segmented transport block: the reference of the
transport-block cells.

From each block's E_r received LLRs to its transport block's bits and
CRC-24A verdict, written from TS 36.212 sections 5.1.2-5.1.4:
de-rate-matching (the LLRs of one position summed in the order they were
sent; punctured, dummy and filler positions 0), the d-stream
demultiplexing, known filler bits as certain zeros, every block decoded in
one batch at the largest block size K+ (a smaller block embedded behind
K+ - K known zero steps, its interleaver shifted behind them), and the
blocks' data bits put back together and checked.
"""

from __future__ import annotations

import dataclasses

import torch

from ..harness import gen, spec
from . import turbo_ref

BIG_LLR = 1e9


def de_rate_match(llr: torch.Tensor, K: int, F: int) -> torch.Tensor:
    """(n, E) -> (n, 3 (K + 4)), redundancy version 0."""
    n, E = llr.shape
    idx = torch.from_numpy(spec.selection(K, E, 0, F)).to(llr.device)
    out = torch.zeros((n, 3 * (K + 4)), dtype=torch.float32,
                      device=llr.device)
    seen = set()
    start = 0
    # one pass over the sequence as sent, a position at most once a pass
    for i, p in enumerate(idx.tolist()):
        if p in seen:
            out[:, idx[start:i]] += llr[:, start:i]
            seen, start = set(), i
        seen.add(p)
    out[:, idx[start:]] += llr[:, start:]
    return out


def demux(d: torch.Tensor, K: int):
    D = K + 4
    d0, d1, d2 = d[:, :D], d[:, D:2 * D], d[:, 2 * D:]
    tail = lambda i: torch.stack([d0[:, i], d1[:, i], d2[:, i],
                                  d0[:, i + 1], d1[:, i + 1], d2[:, i + 1]],
                                 dim=1)
    return d0[:, :K], d1[:, :K], d2[:, :K], tail(K), tail(K + 2)


def embedded_perm(K: int, bucket: int) -> torch.Tensor:
    Fe = bucket - K
    p = torch.arange(bucket)
    p[Fe:] = Fe + torch.from_numpy(spec.qpp_perm(K))
    return p


def receive(llr_runs, n: int, A: int, G: int, Qm: int,
            dec: turbo_ref.Decoder):
    """The LLR runs of n transport blocks (gen.transport_blocks' layout)
    -> (blocks' data reassembled (n, A + 24) int8, CRC-24A verdicts (n,),
    per-block iterations (C n,) and L (C n, K+)) in block-major rows."""
    seg, layout = gen.block_layout(A, G, Qm)
    bucket = max(seg.sizes)
    cols = [[] for _ in range(5)]
    perms = []
    for (r0, r1), llr in zip(gen.runs(layout), llr_runs):
        K, _, F = layout[r0]
        ls, lp1, lp2, t1, t2 = demux(de_rate_match(llr, K, F), K)
        if F:
            ls = ls.clone()
            ls[:, :F] = BIG_LLR
        Fe = bucket - K
        pad = torch.nn.functional.pad
        for c, x in zip(cols, (pad(ls, (Fe, 0), value=BIG_LLR),
                               pad(lp1, (Fe, 0)), pad(lp2, (Fe, 0)), t1, t2)):
            c.append(x)
        perms.append(embedded_perm(K, bucket).expand(ls.shape[0], bucket))
    streams = [torch.cat(c) for c in cols]
    poly = spec.CRC24B if seg.C > 1 else spec.CRC24A
    hard, iters, L = turbo_ref.decode(
        *streams, dataclasses.replace(dec, K=bucket, crc_poly=poly),
        perm=torch.cat(perms).to(streams[0].device))
    tb = reassemble(hard, seg, n)
    return tb, turbo_ref.crc_pass(tb, spec.CRC24A), iters, L


def reassemble(hard: torch.Tensor, seg: spec.Segmentation, n: int):
    """Block-major (C n, K+) decoded blocks -> (n, B) transport blocks."""
    bucket = max(seg.sizes)
    parts = []
    for r, (K, (_, take)) in enumerate(zip(seg.sizes, seg.chunks())):
        lo = bucket - K + (seg.F if r == 0 else 0)
        parts.append(hard[r * n:(r + 1) * n, lo:lo + take])
    return torch.cat(parts, dim=1)
