"""Device-side transport-block Monte-Carlo.

Counterpart of turbotpu/harness/tb.py.  The host-side `turbotpu_torch.transport`
pipeline proves segmentation correctness block by block; this module runs the
FULL TS 36.212 section 5.1 transport-block chain on the device so segmented
TBs (> 6144 info bits) get real BER/TBLER curves at device speed:

    payload -> CRC-24A -> segmentation (CRC-24B per block, filler bits in
    block 0) -> per-block turbo encode -> per-block rate matching to its
    E_r share of G (fillers never transmitted) -> BPSK/AWGN -> per-block
    de-rate-matching, each transmission of the HARQ rv_sequence combined
    into the decoder's streams by the HARQ receiver's combine (harq.py)
    -> ONE batched mixed-K decode of all C blocks of all
    n_tb transport blocks via embedded permutation tables (K- and K+
    blocks in the same call, CRC-24B early termination) -> reassembly ->
    CRC-24A check -> error counters.

Segment boundaries, filler counts and E_r splits are static per config; the
host only checks the stopping rule between batches.

The step is built like `ber.make_step`: `step.gen` makes one batch's decoder
LLR streams and transmitted transport blocks from a `torch.Generator`,
`step.decode` decodes them and `step.tally` reassembles and counts, so the
port's frames can be pushed through another decoder.  The random numbers are
PyTorch's, so a sweep lands within sampling error of the JAX package's, not
on its counts.

Leading-zero CRC property used by the embedded decode: a CRC register
initialized to zero stays at zero over leading zero bits, so
CRC24B(0^F ++ blk) == CRC24B(blk) -- the bucket-wide CRC-24B check
matrix is exact for embedded codewords whose fillers decode to 0 (they
do: filler systematic LLRs are pinned to +BIG).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import time

import numpy as np
import torch

from .._device import resolve_device
from ..decoder.bucketing import grouped_perm_tables
from ..decoder.early_term import crc_ok_batch, make_crc_matrix
from ..decoder.turbo import DecoderConfig, turbo_decode
from ..spec.crc import CRC24A_POLY, CRC24B_POLY, CRC_LEN
from ..spec.qpp import qpp_perm
from ..spec.segmentation import segment_params
from ..transport import per_block_e
from ..tx import chain
from ..tx.rate_match import lte_demux, lte_mux, rate_match
from .ber import BIG_LLR, _device_name


@dataclasses.dataclass(frozen=True)
class TBConfig:
    """Static transport-block simulation configuration (same fields and
    defaults as the JAX package's TBConfig; the fused-kernel path is
    `siso="cuda"` where it says "pallas")."""
    name: str = "tb"
    A: int = 12000                  # info bits per transport block
    n_tb: int = 8                   # transport blocks per device batch
    ebn0_db_grid: tuple[float, ...] = (0.5, 1.0)
    G: int = 0                      # rate-matched channel bits per TB per
                                    # transmission (0 = mother rate 1/3;
                                    # each block then gets its TS 36.212
                                    # s5.1.4.1.2 share E_r)
    rv_sequence: tuple[int, ...] = (0,)   # HARQ IR transmissions
    n_iters: int = 6
    mode: str = "maxlog"
    ext_scale: float | None = None
    siso: str = "cuda"
    io_dtype: str = "float32"
    nii: bool = False
    window: int = 0
    min_tb_errors: int = 20
    max_tbs: int = 20_000
    seed: int = 0
    steps_per_check: int = 1

    def seg(self):
        return segment_params(self.A + CRC_LEN)

    @property
    def rate(self) -> float:
        """Info bits per transmitted channel bit (BPSK)."""
        seg = self.seg()
        if self.G:
            n_chan = self.G * len(self.rv_sequence)
        else:
            n_chan = sum(3 * K + 12 for K in seg.sizes)
        return self.A / n_chan

    def decoder_config(self) -> DecoderConfig:
        """The one grouped mixed-K decode of all code blocks: bucket K+,
        CRC-24B early termination (CRC-24A when the block is not split)."""
        seg = self.seg()
        return DecoderConfig(
            K=max(seg.sizes), n_iters=self.n_iters, mode=self.mode,
            ext_scale=self.ext_scale, siso=self.siso, io_dtype=self.io_dtype,
            nii=self.nii, window=self.window, early_term="crc",
            crc_poly=CRC24B_POLY if seg.C > 1 else CRC24A_POLY)


def chunk_layout(seg) -> tuple[list[int], list[int]]:
    """Static data-chunk (offset, length) per code block within the
    CRC-attached TB -- mirrors spec.segmentation.segment."""
    offs, takes = [], []
    s = 0
    for r, K in enumerate(seg.sizes):
        payload = K - (CRC_LEN if seg.C > 1 else 0)
        take = payload - (seg.F if r == 0 else 0)
        offs.append(s)
        takes.append(take)
        s += take
    if s != seg.B:
        raise AssertionError(f"chunks cover {s} of {seg.B} bits")
    return offs, takes


def tb_encode_blocks(tb: torch.Tensor, seg
                     ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Device-side segmentation + per-block encode of a batch of
    CRC-attached transport blocks (n, seg.B), int8.

    Returns, per code block r, (blk_bits (n, K_r) int8, d_flat
    (n, 3*K_r+12) fp32) with filler zeros prepended to block 0 and CRC-24B
    attached when C > 1 (TS 36.212 section 5.1.2-5.1.3)."""
    offs, takes = chunk_layout(seg)
    out = []
    for r, K in enumerate(seg.sizes):
        F = seg.F if r == 0 else 0
        blk = tb[:, offs[r]:offs[r] + takes[r]]
        if F:
            blk = torch.nn.functional.pad(blk, (F, 0))      # filler zeros
        if seg.C > 1:
            blk = chain.crc_attach_batch(blk, CRC24B_POLY)
        d_flat = lte_mux(*chain.turbo_encode(blk, qpp_perm(K))
                         ).to(torch.float32)
        out.append((blk, d_flat))
    return out


def make_tb_step(cfg: TBConfig, device="cuda"):
    """Build the per-check TB simulation step for `device`:
    step(gen, esn0_db) -> (bit errors, TB errors, CRC-24A failures, sum of
    iterations over code blocks, sum over batches of the batch's largest
    iteration count), a (5,) int64 tensor on the device covering
    cfg.steps_per_check batches.  `gen` is a torch.Generator on the same
    device.

    step.gen(gen, esn0_db) -> (streams, tb): the five decoder LLR streams of
    one batch, all C code blocks of all n_tb transport blocks embedded in
    the K+ bucket in block-major row order (row = r * n_tb + t), and the
    transmitted CRC-attached blocks (n_tb, seg.B).  step.decode(streams) ->
    (hard, iters); step.tally(hard, iters, tb) -> (5,) counters;
    step.count = tally after decode.  step.encode(gen) is the transmitter
    alone.  step.group_tables and step.decoder are what the decode runs on."""
    dev = resolve_device(device)
    seg = cfg.seg()
    C = seg.C
    bucket = max(seg.sizes)
    B_len = seg.B
    Es = per_block_e(cfg.G, C) if cfg.G else (0,) * C
    rvs = cfg.rv_sequence
    offs, takes = chunk_layout(seg)
    n_tb = cfg.n_tb

    # One embedded mixed-K decode for all C blocks x n_tb TBs, through
    # grouped tables (distinct block sizes, usually 2).
    group_tables = tuple(
        torch.from_numpy(t.astype(np.int64)).to(dev)
        for t in grouped_perm_tables(
            [K for K in seg.sizes for _ in range(n_tb)], bucket))
    dcfg = cfg.decoder_config()
    G24a = make_crc_matrix(B_len, CRC24A_POLY, dev)
    pad = torch.nn.functional.pad

    def encode(gen):
        payload = chain.gen_payload(gen, n_tb, cfg.A)
        tb = chain.crc_attach_batch(payload, CRC24A_POLY)   # (n_tb, B_len)
        return tb_encode_blocks(tb, seg), tb

    def channel(gen, tx_bits, esn0_db):
        x = chain.modulate_bpsk(tx_bits.to(torch.int8))
        return chain.demap_bpsk(chain.awgn(gen, x, esn0_db), esn0_db)

    if cfg.G:
        # the HARQ receiver's combine: each transmission into the decoder's
        # streams at its redundancy version, 0 + d_0 + d_1 + ... in order
        from ..harq import combine, combine_table
        rv_new = [(torch.full((1,), v, dtype=torch.int64, device=dev),
                   torch.full((1,), i == 0, device=dev))
                  for i, v in enumerate(rvs)]

    def gen_batch(gen, esn0_db):
        blocks, tb = encode(gen)
        parts = [[] for _ in range(5)]
        for r, ((_, d_flat), K) in enumerate(zip(blocks, seg.sizes)):
            F = seg.F if r == 0 else 0
            if cfg.G:
                table, period = combine_table(K, Es[r], F, bucket, dev)
                streams = tuple(torch.empty((n_tb, w), device=dev)
                                for w in (bucket,) * 3 + (6, 6))
                for v, (rv, new) in zip(rvs, rv_new):
                    tx_bits = rate_match(d_flat, Es[r], v, F=F)
                    combine(streams, channel(gen, tx_bits, esn0_db), table,
                            period, rv, new)
            else:
                ls, lp1, lp2, t1, t2 = lte_demux(
                    channel(gen, d_flat, esn0_db))
                if F:
                    # Spec fillers are known zeros at the receiver.
                    ls = ls.clone()
                    ls[:, :F] = BIG_LLR
                Fe = bucket - K                   # bucket embedding filler
                streams = (pad(ls, (Fe, 0), value=BIG_LLR), pad(lp1, (Fe, 0)),
                           pad(lp2, (Fe, 0)), t1, t2)
            for lst, x in zip(parts, streams):
                lst.append(x)
        return tuple(torch.cat(xs, dim=0) for xs in parts), tb

    def decode(streams):
        hard, iters, _ = turbo_decode(*streams, dcfg,
                                      group_tables=group_tables, device=dev)
        return hard, iters

    def tally(hard, iters, tb):
        # Reassemble each TB from its blocks' data chunks (static slices).
        chunks = []
        for r, K in enumerate(seg.sizes):
            lo = bucket - K + (seg.F if r == 0 else 0)
            chunks.append(hard[r * n_tb:(r + 1) * n_tb, lo:lo + takes[r]])
        tb_hat = torch.cat(chunks, dim=1)                   # (n_tb, B_len)
        err = tb_hat != tb.to(dev)
        # CRC-24A verdict on the reassembled TB (the receiver's own oracle):
        # an exact fp32 matmul, TF32 refused.
        crc_fail = ~crc_ok_batch(tb_hat, G24a)
        return torch.stack([err[:, :cfg.A].sum(), err.any(dim=1).sum(),
                            crc_fail.sum(), iters.sum(dtype=torch.int64),
                            iters.max().to(torch.int64)])

    def count(streams, tb):
        return tally(*decode(streams), tb)

    def step(gen, esn0_db):
        total = torch.zeros((5,), dtype=torch.int64, device=dev)
        for _ in range(cfg.steps_per_check):
            total = total + count(*gen_batch(gen, esn0_db))
        return total

    step.gen, step.decode, step.tally, step.count = (gen_batch, decode, tally,
                                                     count)
    step.encode = encode
    step.group_tables, step.decoder, step.device = group_tables, dcfg, dev
    return step


def tb_esn0_db(cfg: TBConfig, ebn0_db: float) -> float:
    """Es/N0 = Eb/N0 * rate (BPSK, unit-energy symbols)."""
    return float(ebn0_db + 10 * np.log10(cfg.rate))


def point_generator(cfg: TBConfig, ebn0_db: float, device) -> torch.Generator:
    """The generator a grid point's transport blocks are drawn from."""
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed ^ int(round(ebn0_db * 1000)) & 0x7FFFFFFF)
    return gen


def simulate_tb_point(cfg: TBConfig, ebn0_db: float, step=None,
                      device="cuda") -> dict:
    """Run one Eb/N0 point to the TB-error stopping rule.  `step` (from
    make_tb_step) is reused across points when given, and then names the
    device."""
    if step is None:
        step = make_tb_step(cfg, device)
    esn0 = tb_esn0_db(cfg, ebn0_db)
    gen = point_generator(cfg, ebn0_db, step.device)
    bit_errs = tb_errs = crc_fails = tbs = iters_sum = iter_batches = 0
    t0 = time.perf_counter()
    while tb_errs < cfg.min_tb_errors and tbs < cfg.max_tbs:
        be, te, cf, it, mx = step(gen, esn0).tolist()  # the check's host read
        bit_errs += be
        tb_errs += te
        crc_fails += cf
        iters_sum += it
        iter_batches += mx
        tbs += cfg.n_tb * cfg.steps_per_check
    wall = time.perf_counter() - t0
    seg = cfg.seg()
    info_bits = tbs * cfg.A
    n_blocks = tbs * seg.C
    return {
        "config": cfg.name, "A": cfg.A, "C": seg.C,
        "K_plus": seg.K_plus, "K_minus": seg.K_minus, "F": seg.F,
        "G": cfg.G, "rvs": list(cfg.rv_sequence), "mode": cfg.mode,
        "iters_max": cfg.n_iters, "ebn0_db": float(ebn0_db),
        "tbs": tbs, "bits": info_bits,
        "bit_errs": bit_errs, "tb_errs": tb_errs, "crc24a_fails": crc_fails,
        "ber": bit_errs / info_bits if info_bits else 0.0,
        "tbler": tb_errs / tbs if tbs else 0.0,
        "avg_iters": iters_sum / n_blocks if n_blocks else 0.0,
        "wall_s": wall,
        "mbit_per_s": info_bits / wall / 1e6 if wall > 0 else 0.0,
        # Realized device work: each batch runs until its slowest code
        # block's CRC passes, max(iters) batch-iterations of two launches.
        "iter_batches": iter_batches,
        "device": _device_name(step.device),
    }


def simulate_tbler(cfg: TBConfig,
                   results_path: str | pathlib.Path | None = None,
                   resume: bool = True, verbose: bool = True,
                   device="cuda") -> list[dict]:
    """Sweep the Eb/N0 grid; resumable via the JSONL results file
    (same torn-record handling as harness.ber.simulate_ber)."""
    resolve_device(device)
    done: dict[float, dict] = {}
    path = pathlib.Path(results_path) if results_path else None
    if path and path.exists() and resume:
        text = path.read_text()
        if text and not text.endswith("\n"):
            with path.open("a") as f:
                f.write("\n")
        for line in text.splitlines():
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) and rec.get("config") == cfg.name:
                done[rec["ebn0_db"]] = rec
    step = None
    out = []
    for ebn0 in cfg.ebn0_db_grid:
        if float(ebn0) in done:
            out.append(done[float(ebn0)])
            if verbose:
                print(f"[{cfg.name}] Eb/N0={ebn0:5.2f} dB  (resumed)")
            continue
        if step is None:
            step = make_tb_step(cfg, device)
        rec = simulate_tb_point(cfg, float(ebn0), step)
        out.append(rec)
        if path:
            path.parent.mkdir(parents=True, exist_ok=True)
            with path.open("a") as f:
                f.write(json.dumps(rec) + "\n")
        if verbose:
            print(f"[{cfg.name}] Eb/N0={ebn0:5.2f} dB  BER={rec['ber']:.3e} "
                  f"TBLER={rec['tbler']:.3e} avg_iters={rec['avg_iters']:.2f}"
                  f" {rec['mbit_per_s']:.2f} Mbit/s")
    return out
