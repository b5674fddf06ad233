"""Transport-block pipeline (TS 36.212 section 5.1): the full LTE framing
chain over the decoder.

Transmit: CRC-24A attach -> code block segmentation (CRC-24B per block,
filler bits in block 0) -> per-block turbo encoding.  Receive: per-block
decode with blocks GROUPED BY K so each distinct block size is a single
batched device decode (at most two sizes exist per TS 36.212, K- and K+),
CRC-24B check per block, filler stripping, reassembly, CRC-24A check.

Filler bits are known zeros at the receiver, so their systematic LLRs are
overwritten with +BIG before decoding (the known-0-bit trick).  Under rate
matching they are additionally spec-exact: the first F positions of d^(0)
and d^(1) of code block 0 are <NULL> (TS 36.212 s5.1.3.2) and the bit
selection skips them, so fillers are never transmitted; the receiver's
de-rate-matching leaves them 0 before the +BIG overwrite.

HARQ incremental redundancy: transmit_transport_block / decode_transport_
block accept a redundancy-version SEQUENCE (e.g. (0, 2, 3, 1)); each
retransmission selects a different circular-buffer window and the receiver
soft-combines the de-rate-matched LLRs by addition before one decode.

Counterpart of turbotpu/transport.py: a host pipeline on numpy arrays around
`turbo_decode`, which runs on `device` (the card unless the caller asks for
"cpu").
"""

from __future__ import annotations

import numpy as np

from .decoder.turbo import DecoderConfig, turbo_decode
from .golden import numpy_ref as npr
from .spec.crc import CRC24A_POLY, CRC24B_POLY, CRC_LEN, crc_attach, crc_check
from .spec.qpp import qpp_perm
from .spec.rate_match import de_rate_match, rate_match
from .spec.segmentation import desegment, segment, segment_params

BIG = 1e9


def per_block_e(G: int, C: int, q_m: int = 1, n_l: int = 1) -> tuple[int, ...]:
    """TS 36.212 section 5.1.4.1.2: split G available bits across C code
    blocks (first C-1-gamma blocks get floor, the rest ceil)."""
    gp = G // (n_l * q_m)
    gamma = gp % C
    lo = n_l * q_m * (gp // C)
    hi = n_l * q_m * (-(-gp // C))
    return tuple(lo if r <= C - 1 - gamma else hi for r in range(C))


def encode_transport_block(info_bits: np.ndarray):
    """CRC-24A attach, segment, turbo-encode each code block.

    Returns (blocks, seg): `blocks` is a list of per-block encoded parts
    (sys, par1, par2, tail1, tail2) as int8 arrays; `seg` the Segmentation
    (seg.B is the CRC-attached length needed at the receiver).
    """
    tb = crc_attach(np.asarray(info_bits, np.int8), CRC24A_POLY)
    seg = segment_params(len(tb))
    blocks = [npr.turbo_encode(blk, qpp_perm(len(blk))) for blk in segment(tb)]
    return blocks, seg


def transmit_transport_block(info_bits: np.ndarray, ebn0_db: float,
                             seed: int = 0, G: int | None = None,
                             rv: int | tuple[int, ...] = 0):
    """encode_transport_block + BPSK + AWGN + LLR demap.

    With G=None (no rate matching, rate 1/3) returns (llr_blocks, seg)
    with llr_blocks[r] = per-block float32 LLR parts in the
    (sys, par1, par2, tail1, tail2) layout.  With G set, each block is
    rate-matched to its TS 36.212 share E_r of the G available bits
    (puncturing when E_r < 3K+12, repetition when larger) and
    llr_blocks[r] is the flat length-E_r received LLR vector; pass
    rate_matched=True (and the same rv) to decode_transport_block.
    Filler bits of block 0 are <NULL> and never transmitted.

    HARQ: pass rv as a sequence of redundancy versions; each entry is an
    independent transmission (fresh noise) of the same circular buffer and
    llr_blocks[r] becomes a tuple of per-transmission LLR vectors.
    """
    blocks, seg = encode_transport_block(info_bits)
    rng = np.random.default_rng(seed)
    rvs = rv if isinstance(rv, (tuple, list)) else (rv,)
    n_tx = len(rvs)
    # Es/N0 = rate * Eb/N0 with the TRUE information rate (info bits per
    # channel bit over ALL transmissions), so the Eb/N0 label stays honest
    # under rate matching and HARQ retransmission.
    if G is not None:
        n_chan = G * n_tx
    else:
        n_chan = sum(3 * K + 12 for K in seg.sizes)
    rate = len(np.asarray(info_bits)) / n_chan
    sigma = np.sqrt(1 / (2 * rate * 10 ** (ebn0_db / 10)))

    def demap(a):
        y = (1 - 2 * a.astype(np.float64)) + sigma * rng.normal(size=a.shape)
        return (2 * y / sigma ** 2).astype(np.float32)

    llr_blocks = []
    if G is None:
        for parts in blocks:
            llr_blocks.append(tuple(demap(a) for a in parts))
    else:
        for r, (parts, E) in enumerate(zip(blocks, per_block_e(G, seg.C))):
            F = seg.F if r == 0 else 0
            d = npr.lte_mux(*parts)
            txs = tuple(demap(rate_match(*d, E, v, F=F)) for v in rvs)
            llr_blocks.append(txs if isinstance(rv, (tuple, list))
                              else txs[0])
    return llr_blocks, seg


def decode_transport_block(llr_blocks, B: int, n_iters: int = 6,
                           mode: str = "logmap", siso: str = "scan",
                           ext_scale: float | None = None,
                           rate_matched: bool = False,
                           rv: int | tuple[int, ...] = 0, device="cuda"):
    """Decode a transport block from per-code-block LLRs.

    llr_blocks: list (block order) of (sys, par1, par2, tail1, tail2) LLR
    arrays — or, with rate_matched=True, of flat length-E_r LLR vectors
    that are first de-rate-matched (repetition LLRs combine, punctured
    positions start at 0).  B: CRC-attached transport block length (seg.B
    from the transmit side).  With rv a sequence (HARQ), llr_blocks[r] is
    a tuple of per-transmission LLR vectors whose de-rate-matched LLRs are
    soft-combined by addition (incremental redundancy).  Returns
    (info_bits, crc_ok, details) where details carries per-block CRC-24B
    results and iteration counts.
    """
    seg = segment_params(B)
    if len(llr_blocks) != seg.C:
        raise ValueError(f"{len(llr_blocks)} LLR blocks for a transport "
                         f"block of {seg.C} code blocks")
    if rate_matched:
        rvs = rv if isinstance(rv, (tuple, list)) else (rv,)

        def combine(r, txs):
            if not isinstance(txs, (tuple, list)):
                txs = (txs,)
            if len(txs) != len(rvs):
                raise ValueError("one LLR vector per redundancy version")
            F = seg.F if r == 0 else 0
            acc = None
            for llr_e, v in zip(txs, rvs):
                d = np.concatenate(de_rate_match(
                    np.asarray(llr_e, np.float64), seg.sizes[r], v, F=F))
                acc = d if acc is None else acc + d
            D = seg.sizes[r] + 4
            return npr.lte_demux(acc[:D], acc[D:2 * D], acc[2 * D:])

        llr_blocks = [combine(r, txs) for r, txs in enumerate(llr_blocks)]
    llr_blocks = [tuple(np.asarray(p, np.float32) for p in blk)
                  for blk in llr_blocks]
    if seg.F:
        # Filler bits live at the head of block 0 and are known zeros.
        ls0 = llr_blocks[0][0].copy()
        ls0[:seg.F] = BIG
        llr_blocks[0] = (ls0,) + llr_blocks[0][1:]

    hard_blocks: list[np.ndarray | None] = [None] * seg.C
    iters_out = np.zeros(seg.C, np.int32)
    # One batched decode per distinct K (TS 36.212 yields at most two).
    for K in sorted({b[0].shape[0] for b in llr_blocks}):
        idxs = [r for r, b in enumerate(llr_blocks) if b[0].shape[0] == K]
        batch = [np.stack([llr_blocks[r][i] for r in idxs])
                 for i in range(5)]
        cfg = DecoderConfig(
            K=K, n_iters=n_iters, mode=mode, ext_scale=ext_scale, siso=siso,
            early_term="crc" if seg.C > 1 else "none",
            crc_poly=CRC24B_POLY)
        hard, iters, _ = turbo_decode(*batch, cfg, device=device)
        hard, iters = hard.cpu().numpy(), iters.cpu().numpy()
        for j, r in enumerate(idxs):
            hard_blocks[r] = hard[j]
            iters_out[r] = int(iters[j])

    block_crc_ok = [bool(crc_check(h, CRC24B_POLY)) if seg.C > 1 else True
                    for h in hard_blocks]
    tb = desegment(hard_blocks, B)
    crc_ok = bool(crc_check(tb, CRC24A_POLY))
    info = tb[:-CRC_LEN]
    return info, crc_ok, {
        "seg": seg, "block_crc_ok": block_crc_ok, "iters": iters_out,
    }
