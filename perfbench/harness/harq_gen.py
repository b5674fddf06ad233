"""The HARQ cells' input generator and schedule.

The schedule is what the MAC scheduler hands the PHY: for each TTI of each
HARQ process (TTI i on process i mod P), whether each slot carries new data
or a retransmission, and at which redundancy version (TS 36.213 8.6.1:
0, 2, 3, 1 for the first to the fourth transmission).  It is drawn from the
seed on the host and is cyclic over the pool: a process's `rounds` TTIs are
replayed in turn, so each slot's rounds are split into transport blocks
whose transmissions fill them exactly (a block may run from the last round
into the first).  The splits of four rounds are drawn with weights that
give the configured shares of transmissions per transport block exactly
in expectation (`split_weights`), each at a random rotation.

The inputs: every transport block's payload, CRC, segmentation and turbo
encoding once (gen.py's functions), and each of its transmissions rate-
matched at its own redundancy version with fresh BPSK/AWGN noise, all at
the Es/N0 of the first transmission's rate (Eb/N0 x A / G), made on the
device from one generator seeded with the run's seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import gen, spec

RV_ORDER = (0, 2, 3, 1)
# the splits of four rounds into transmissions per transport block
SPLITS = ((2, 2), (1, 1, 2), (1, 3), (4,))


def split_weights(shares) -> np.ndarray:
    """Weights of SPLITS under which the transport blocks' numbers of
    transmissions 1-4 take `shares` exactly in expectation.  With no split
    of four new blocks, the weights of (1, 3) and (4,) are fixed by the
    shares of 3 and 4, that of (1, 1, 2) by the rest of the share of 1, and
    that of (2, 2) by the rest of the share of 2."""
    p1, p2, p3, p4 = shares
    w = np.array([(p2 - (p1 - p3) / 2) / 2, (p1 - p3) / 2, p3, p4])
    if (w < 0).any():
        raise ValueError(f"shares {shares} need other splits")
    return w / w.sum()


def schedule(seed: int, processes: int, rounds: int, slots: int, shares
             ) -> dict:
    """The pool's schedule: `k` (pool batches, slots) int, each slot's
    transmission index (0 new data, 1-3 the second to the fourth
    transmission), `tb` (pool batches, slots) the transport block it
    carries (blocks numbered 0 .. n_tb - 1), and `n_tb`.  Pool batch
    round * processes + process is that process's TTI of that round."""
    if rounds != 4:
        raise ValueError(f"the splits fill 4 rounds, not {rounds}")
    rng = np.random.default_rng([seed % 2 ** 64, 0x4A52])
    pick = rng.choice(len(SPLITS), size=(processes, slots),
                      p=split_weights(shares))
    rot = rng.integers(0, rounds, size=(processes, slots))
    k = np.zeros((rounds, processes, slots), dtype=np.int64)
    tb = np.zeros((rounds, processes, slots), dtype=np.int64)
    n_tb = 0
    for q in range(processes):
        for t in range(slots):
            r = int(rot[q, t])
            for length in SPLITS[pick[q, t]]:
                for i in range(length):
                    k[(r + i) % rounds, q, t] = i
                    tb[(r + i) % rounds, q, t] = n_tb
                n_tb += 1
                r += length
    shape = (rounds * processes, slots)
    return {"k": k.reshape(shape), "tb": tb.reshape(shape), "n_tb": n_tb}


def realized_shares(sch: dict) -> dict:
    """The shares of each transmission index among the pool's slots, and of
    each number of transmissions among its transport blocks."""
    k, tb = sch["k"], sch["tb"]
    length = np.zeros(sch["n_tb"], dtype=np.int64)
    np.maximum.at(length, tb.reshape(-1), k.reshape(-1) + 1)
    return {"tx_index": [float((k == i).mean()) for i in range(4)],
            "transmissions": [float((length == n).mean())
                              for n in range(1, 5)]}


def encode(g: torch.Generator, n: int, A: int, G: int, Qm: int,
           chunk: int = 256):
    """n transport blocks of A bits: CRC-24A, segmentation, CRC-24B per
    block when C > 1, filler bits in block 0, turbo encoding.  Returns the
    CRC-attached blocks (n, A + 24) int8 and each code block's flat
    [d0 | d1 | d2] streams (n, 3 (K_r + 4)) int8."""
    seg, layout = gen.block_layout(A, G, Qm)
    dev = g.device
    tbs, per_block = [], [[] for _ in layout]
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        tb = gen.crc_attach(torch.randint(0, 2, (hi - lo, A), generator=g,
                                          device=dev, dtype=torch.int8),
                            spec.CRC24A)
        tbs.append(tb)
        for r, ((off, take), (_, _, F)) in enumerate(zip(seg.chunks(),
                                                         layout)):
            blk = torch.nn.functional.pad(tb[:, off:off + take], (F, 0))
            if seg.C > 1:
                blk = gen.crc_attach(blk, spec.CRC24B)
            per_block[r].append(gen.d_streams(*gen.turbo_encode(blk)))
    return torch.cat(tbs), [torch.cat(b) for b in per_block]


def transmit(g: torch.Generator, blocks, layout, tb_ids: torch.Tensor,
             rvs: torch.Tensor, esn0_db: float) -> list:
    """One TTI: slot t sends transport block tb_ids[t] (encoded `blocks`,
    `encode`'s) at redundancy version rvs[t].  Returns the received LLRs
    as one ((r1 - r0) n, E) float32 tensor a run of equal blocks,
    block-major, as gen.transport_blocks lays them out."""
    dev = g.device
    out = []
    for r0, r1 in gen.runs(layout):
        K, E, F = layout[r0]
        sel = torch.stack([torch.from_numpy(spec.selection(K, E, rv, F))
                           for rv in range(4)]).to(dev)[rvs]
        bits = torch.cat([blocks[r].index_select(0, tb_ids).gather(1, sel)
                          for r in range(r0, r1)])
        out.append(gen.channel(g, bits, esn0_db))
    return out


def esn0_db(ebn0_db: float, A: int, G: int) -> float:
    """Es/N0 of every transmission: Eb/N0 at the first transmission's rate
    A / G."""
    return ebn0_db + 10 * math.log10(A / G)
