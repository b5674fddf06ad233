"""Plain HARQ incremental-redundancy receiver: the reference of the HARQ
cells.

A transport block's soft buffer is rebuilt from its transmissions alone:
each one de-rate-matched at its own redundancy version (rx_ref's
`de_rate_match`, one version a call, its one-pass order) and the results
summed in the order they were sent, 0 + d_0 + d_1 + ..., in float32 (TS
36.212 5.1.4.1.2: one circular buffer, N_cb = K_w for the UL-SCH; TS 36.213
8.6.1: redundancy versions 0, 2, 3, 1).  The buffer is then received as
rx_ref receives a first transmission: demultiplexed, fillers known, every
block decoded at the bucket K+ with turbo_ref, reassembled and checked
against CRC-24A.  Nothing is kept between calls and nothing of the program
under test is imported.
"""

from __future__ import annotations

import dataclasses

import torch

from ..harness import gen, spec
from . import rx_ref, turbo_ref

RV_ORDER = (0, 2, 3, 1)


def _exact_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def soft_buffers(txs, n: int, A: int, G: int, Qm: int,
                 buffer: torch.dtype = torch.float32) -> list:
    """The flat [d0 | d1 | d2] soft buffers of n transport blocks, one
    (n (r1 - r0), 3 (K + 4)) fp32 tensor a run of equal blocks, block-major.
    txs: the transmissions in the order sent, each (llr_runs, rv, which):
    the received LLR runs (gen.transport_blocks' layout) of the blocks
    `which` (a list of indices among the n) sent at redundancy version
    rv.  Each sum is stored as `buffer` holds it (a control: bfloat16
    rounds the buffer at every transmission)."""
    _, layout = gen.block_layout(A, G, Qm)
    runs = gen.runs(layout)
    dev = txs[0][0][0].device
    out = [torch.zeros((n * (r1 - r0), 3 * (layout[r0][0] + 4)),
                       dtype=torch.float32, device=dev) for r0, r1 in runs]
    for llr_runs, rv, which in txs:
        w = torch.as_tensor(which, dtype=torch.int64, device=dev)
        for buf, (r0, r1), llr in zip(out, runs, llr_runs):
            K, _, F = layout[r0]
            rows = (torch.arange(r1 - r0, device=dev)[:, None] * n
                    + w[None, :]).reshape(-1)
            buf[rows] = (buf[rows] + rx_ref.de_rate_match(llr, K, F, rv)
                         ).to(buffer).float()
    return out


def decoder_streams(d_runs, A: int, G: int, Qm: int):
    """Soft buffers -> the decoder's five input streams (ls, lp1, lp2 at
    the bucket width K+, tail1, tail2) of every block, block-major, and the
    embedded interleaver of each row."""
    seg, layout = gen.block_layout(A, G, Qm)
    bucket = max(seg.sizes)
    pad = torch.nn.functional.pad
    cols = [[] for _ in range(5)]
    perms = []
    for (r0, _), d in zip(gen.runs(layout), d_runs):
        K, _, F = layout[r0]
        ls, lp1, lp2, t1, t2 = rx_ref.demux(d, K)
        if F:
            ls = ls.clone()
            ls[:, :F] = rx_ref.BIG_LLR
        Fe = bucket - K
        for c, x in zip(cols, (pad(ls, (Fe, 0), value=rx_ref.BIG_LLR),
                               pad(lp1, (Fe, 0)), pad(lp2, (Fe, 0)), t1, t2)):
            c.append(x)
        perms.append(rx_ref.embedded_perm(K, bucket).expand(ls.shape[0],
                                                            bucket))
    return [torch.cat(c) for c in cols], torch.cat(perms)


def receive(txs, n: int, A: int, G: int, Qm: int, dec: turbo_ref.Decoder,
            buffer: torch.dtype = torch.float32):
    """n transport blocks from their transmissions (`soft_buffers`' txs and
    buffer) -> (blocks' data reassembled (n, A + 24) int8, CRC-24A verdicts
    (n,), per-block iterations (C n,) and L (C n, K+)), block-major rows."""
    _exact_matmuls()
    seg, _ = gen.block_layout(A, G, Qm)
    streams, perm = decoder_streams(
        soft_buffers(txs, n, A, G, Qm, buffer), A, G, Qm)
    poly = spec.CRC24B if seg.C > 1 else spec.CRC24A
    hard, iters, L = turbo_ref.decode(
        *streams, dataclasses.replace(dec, K=max(seg.sizes), crc_poly=poly),
        perm=perm.to(streams[0].device))
    tb = rx_ref.reassemble(hard, seg, n)
    return tb, turbo_ref.crc_pass(tb, spec.CRC24A), iters, L
