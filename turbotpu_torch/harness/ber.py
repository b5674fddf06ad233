"""Monte-Carlo BER/FER-vs-Eb/N0 simulation harness.

Counterpart of turbotpu/harness/ber.py.  One step per configuration runs
the entire payload -> CRC -> encode -> rate match -> BPSK/QPSK/QAM -> channel
-> demap -> de-rate-match -> turbo decode -> error count chain on the device;
the host reads the counters once per stopping-rule check.

The step has two halves, as in the JAX package: `step.gen` makes one batch's
decoder LLR streams and transmitted bits from a `torch.Generator`, and
`step.count` decodes streams and counts errors.  The random numbers are
PyTorch's, so a sweep lands within sampling error of the JAX package's, not
on its counts; fed the same streams, `step.count` gives the same counts.

`simulate_point(compact_stage1=N)` is the convergence-compaction sweep
(harness/compact.py): the same frames, stage-1 decoded at a cap of N
iterations, the CRC failures re-batched on the host and finished at the full
cap; its counts equal the plain sweep's.

Supports checkpoint/resume: completed (config, Eb/N0) points are written to
a JSONL results file and skipped on restart.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import time
from collections import Counter

import numpy as np
import torch

from .._device import resolve_device
from ..decoder.bucketing import grouped_perm_tables
from ..decoder.turbo import DecoderConfig, turbo_decode
from ..tx import chain, qam
from ..tx.rate_match import (de_rate_match, lte_demux, lte_mux, rate_match,
                             umts_demux, umts_mux)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation configuration (same fields and defaults as the JAX
    package's SimConfig)."""
    name: str = "sim"
    K: int = 40
    B: int = 64                       # codewords per Monte-Carlo batch
    ebn0_db_grid: tuple[float, ...] = (0.0, 0.5, 1.0)
    decoder: DecoderConfig = dataclasses.field(
        default_factory=lambda: DecoderConfig(K=40))
    modulation: str = "bpsk"          # "bpsk" | "qpsk" | "qam16" | "qam64"
    channel: str = "awgn"             # "awgn" | "rayleigh" (flat per-symbol
                                      # Rayleigh fading, perfect CSI at the
                                      # receiver; E[|h|^2]=1 keeps the Eb/N0
                                      # label an AVERAGE-energy statement)
    use_crc: bool = True              # attach CRC-24A inside the payload
    K_mix: tuple[int, ...] = ()       # TRUE mixed block sizes: each codeword
                                      # i carries K_mix[i % len] info bits,
                                      # is encoded with ITS OWN interleaver
                                      # at its own 3K+12 mother-rate length
                                      # and per-K Eb/N0->Es/N0 conversion,
                                      # then EMBEDDED into the K bucket with
                                      # leading known-zero fillers and
                                      # decoded in ONE call via embedded
                                      # permutation tables
                                      # (bucketing.grouped_perm_tables).
                                      # () = homogeneous batch at K.
    E: int = 0                        # rate-matched length (0 = mother rate)
    E_mix: tuple[int, ...] = ()       # per-K_mix rate-matched lengths
                                      # (parallel to K_mix); empty with
                                      # K_mix + E set derives each group's
                                      # E_g proportionally (E * K_g / K),
                                      # preserving the aggregate code rate
                                      # -- the shape of TS 36.212 s5.1.4.3's
                                      # per-code-block E_r split
    rv: int = 0
    rv_sequence: tuple[int, ...] = ()  # HARQ IR: redundancy versions of the
                                       # retransmissions soft-combined at the
                                       # receiver; () = single transmission
                                       # at `rv`.  Requires E > 0.
    min_frame_errors: int = 50
    max_frames: int = 200_000
    seed: int = 0
    steps_per_check: int = 1   # device batches per host stopping-rule check

    @property
    def rvs(self) -> tuple[int, ...]:
        return self.rv_sequence if self.rv_sequence else (self.rv,)

    def filler_lengths(self) -> np.ndarray | None:
        """Per-codeword filler counts (B,) for a K_mix batch, else None."""
        if not self.K_mix:
            return None
        if max(self.K_mix) > self.K:
            raise ValueError(f"K_mix {self.K_mix} exceeds bucket K={self.K}")
        ks = np.array([self.K_mix[i % len(self.K_mix)] for i in range(self.B)])
        return (self.K - ks).astype(np.int32)

    @property
    def mean_true_k(self) -> float:
        """Mean non-filler block length (== K when homogeneous)."""
        f = self.filler_lengths()
        return float(self.K - f.mean()) if f is not None else float(self.K)

    @property
    def rate(self) -> float:
        """Information rate in info bits per channel bit, counting EVERY
        transmitted channel bit: HARQ retransmissions and the zero-pad to
        whole modulation symbols (the pad carries symbol energy, so folding
        it in keeps the Eb/N0 label honest for QAM with E % m != 0)."""
        per_tx = self.E if self.E else 3 * self.K + 12
        m = qam.BITS_PER_SYMBOL[self.modulation]
        per_tx = -(-per_tx // m) * m
        return self.K / (per_tx * len(self.rvs))

    def e_mix_resolved(self) -> tuple[int, ...]:
        """Per-K_mix rate-matched lengths; zeros = mother rate."""
        if not self.K_mix:
            return ()
        if self.E_mix:
            if len(self.E_mix) != len(self.K_mix):
                raise ValueError(
                    f"E_mix has {len(self.E_mix)} entries for "
                    f"{len(self.K_mix)} K_mix entries")
            return self.E_mix
        if self.E:
            return tuple(int(round(self.E * k / self.K)) for k in self.K_mix)
        return (0,) * len(self.K_mix)

    def mixed_groups(self) -> list[tuple[tuple[int, int], int]]:
        """Grouped ((K, E), count) for a K_mix batch, ascending.  Codewords
        are generated group-contiguous (the batch is i.i.d., so ordering
        is statistically irrelevant; grouping keeps the tx chain to one
        shape per distinct (K, E))."""
        es = self.e_mix_resolved()
        c = Counter((self.K_mix[i % len(self.K_mix)],
                     es[i % len(self.K_mix)]) for i in range(self.B))
        return sorted(c.items())


def _ebn0_to_esn0_db(cfg: SimConfig, ebn0_db: float) -> float:
    """Es/N0 = Eb/N0 * rate * bits-per-symbol (unit-energy symbols).

    For a K_mix batch each block size has its own mother-rate K/(3K+12):
    the per-group rate factor is applied inside the step, so this returns
    Eb/N0 adjusted only by bits-per-symbol."""
    bps = qam.BITS_PER_SYMBOL[cfg.modulation]
    if cfg.K_mix:
        return ebn0_db + 10 * np.log10(bps)
    return ebn0_db + 10 * np.log10(cfg.rate * bps)


BIG_LLR = 1e9  # known-zero filler certainty


def make_step(cfg: SimConfig, device="cuda"):
    """Build the per-check simulation step for `device`:
    step(gen, esn0_db) -> (bit errors, frame errors, sum of iterations,
    sum over batches of the batch's largest iteration count), a (4,) int64
    tensor on the device covering cfg.steps_per_check batches.  `gen` is a
    torch.Generator on the same device.

    step.gen(gen, esn0_db) -> (streams, bits) is the generation half: the
    five decoder LLR streams of one batch (mixed-K groups embedded in the K
    bucket) and the transmitted bits (B, K).  step.decode(streams) ->
    (hard, iters) and step.count(streams, bits) -> (4,) int64 counters are
    the other half (count = step.tally(hard, iters, bits) after decode).
    step.encode(gen) is the transmitter alone (per group: code bits,
    information bits), for timing it apart from the channel."""
    dev = resolve_device(device)
    if cfg.channel not in ("awgn", "rayleigh"):
        raise ValueError(f"unknown channel {cfg.channel!r}")
    if cfg.modulation not in qam.BITS_PER_SYMBOL:
        raise ValueError(f"unknown modulation {cfg.modulation!r}")
    fading = cfg.channel == "rayleigh"
    m_bps = qam.BITS_PER_SYMBOL[cfg.modulation]
    n_rvs = len(cfg.rvs)

    # Wire order: UMTS codewords ride the TS 25.212 section 4.2.3.1 per-bit
    # interlace, LTE the TS 36.212 d-streams.
    umts_wire = cfg.decoder.interleaver == "umts"
    if umts_wire and (cfg.E or cfg.E_mix):
        raise ValueError("rate matching (TS 36.212) is defined on LTE "
                         "d-streams; UMTS wire order is mother-rate only")
    mux = umts_mux if umts_wire else lte_mux
    demux = umts_demux if umts_wire else lte_demux

    if cfg.K_mix:
        groups = cfg.mixed_groups()                  # [((K_g, E_g), count)]
        if cfg.rv_sequence and any(e == 0 for (_, e), _ in groups):
            raise ValueError("rv_sequence (HARQ) needs rate matching: every "
                             "K_mix group must resolve a nonzero E")
    else:
        groups = [((cfg.K, cfg.E), cfg.B)]
    Ks_g = np.concatenate([[k] * n for (k, _), n in groups]).astype(np.int32)
    group_perms = {k: dataclasses.replace(cfg.decoder, K=k).perm()
                   for (k, _), _ in groups}
    if cfg.K_mix:
        # grouped row order: fillers lead each embedded codeword
        info_mask = (torch.arange(cfg.K, device=dev)[None, :]
                     >= torch.from_numpy(cfg.K - Ks_g).to(dev)[:, None])
        group_tables = tuple(
            torch.from_numpy(t.astype(np.int64)).to(dev)
            for t in grouped_perm_tables(list(Ks_g), cfg.K,
                                         cfg.decoder.interleaver))
    else:
        info_mask, group_tables = None, None

    def channel(gen, tx_bits, esn0_db):
        """modulate -> channel -> demap; pads to whole symbols for m > 1."""
        nb = tx_bits.shape[1]
        xb = torch.nn.functional.pad(tx_bits.to(torch.int8),
                                     (0, (-nb) % m_bps))
        if cfg.modulation == "bpsk":
            x = chain.modulate_bpsk(xb)
            if fading:
                z, a = chain.rayleigh_fading(gen, x, esn0_db)
                return chain.demap_bpsk_csi(z, a, esn0_db)
            return chain.demap_bpsk(chain.awgn(gen, x, esn0_db), esn0_db)
        if cfg.modulation == "qpsk":
            x = chain.modulate_qpsk(xb)
            if fading:
                z, a = chain.rayleigh_fading(gen, x, esn0_db)
                return chain.demap_qpsk_csi(z, a, esn0_db)[:, :nb]
            y = chain.awgn_complex(gen, x, esn0_db)
            return chain.demap_qpsk(y, esn0_db)[:, :nb]
        x = qam.modulate_qam(xb, m_bps)
        if fading:
            z, a = chain.rayleigh_fading(gen, x, esn0_db)
            return qam.demap_qam(z, esn0_db, m_bps, amp=a)[:, :nb]
        y = chain.awgn_complex(gen, x, esn0_db)
        return qam.demap_qam(y, esn0_db, m_bps)[:, :nb]

    def encode_group(gen, K_g, n_g):
        """payload -> CRC -> encode -> mux of one (K, E) group: the flat
        mother-rate code bits as fp32 and the transmitted information bits."""
        n_payload = K_g - 24 if cfg.use_crc else K_g
        payload = chain.gen_payload(gen, n_g, n_payload)
        bits = (chain.crc_attach_batch(payload, cfg.decoder.crc_poly)
                if cfg.use_crc else payload)
        d_flat = mux(*chain.turbo_encode(bits, group_perms[K_g])
                     ).to(torch.float32)
        return d_flat, bits

    def gen_group(gen, esn0_db, K_g, E_g, n_g):
        """One (K, E) group: payload -> ... -> demuxed decoder LLR streams
        at the group's own size, and its transmitted bits."""
        d_flat, bits = encode_group(gen, K_g, n_g)
        if E_g:
            # One or more (HARQ IR) transmissions of the circular buffer;
            # each rv window sees fresh noise, the receiver adds all
            # de-rate-matched LLRs (soft combining).
            llr_d = torch.zeros_like(d_flat)
            for v in cfg.rvs:
                tx_bits = rate_match(d_flat, E_g, v)
                llr_d = llr_d + de_rate_match(channel(gen, tx_bits, esn0_db),
                                              K_g, v)
        else:
            llr_d = channel(gen, d_flat, esn0_db)
        return demux(llr_d), bits

    def gen_batch(gen, esn0_db):
        if not cfg.K_mix:
            return gen_group(gen, esn0_db, cfg.K, cfg.E, cfg.B)
        # TRUE mixed-K batch: each group is encoded with its own
        # interleaver, rate-matched to its own E_g (or transmitted at its
        # 3K+12 mother rate), sent at its per-group rate-adjusted Es/N0,
        # then embedded into the K bucket with leading known-filler LLRs
        # (+BIG systematic / 0 parity).
        parts = [[] for _ in range(6)]
        pad = torch.nn.functional.pad
        for (K_g, E_g), n_g in groups:
            # Per-group rate K_g / channel bits, counting the zero-pad to
            # whole modulation symbols and HARQ retransmissions (esn0_db
            # here carries only the bits-per-symbol factor, see
            # _ebn0_to_esn0_db).
            per_tx = E_g if E_g else 3 * K_g + 12
            per_tx = -(-per_tx // m_bps) * m_bps
            esn0_g = esn0_db + 10 * np.log10(
                K_g / (per_tx * (n_rvs if E_g else 1)))
            (ls, lp1, lp2, t1, t2), bits = gen_group(gen, esn0_g, K_g, E_g,
                                                     n_g)
            Fg = cfg.K - K_g
            for lst, x in zip(parts, (pad(ls, (Fg, 0), value=BIG_LLR),
                                      pad(lp1, (Fg, 0)), pad(lp2, (Fg, 0)),
                                      t1, t2, pad(bits, (Fg, 0)))):
                lst.append(x)
        *streams, bits = (torch.cat(xs, dim=0) for xs in parts)
        return tuple(streams), bits

    def decode(streams):
        hard, iters, _ = turbo_decode(*streams, cfg.decoder,
                                      group_tables=group_tables, device=dev)
        return hard, iters

    def tally(hard, iters, bits):
        err = hard != bits.to(dev)
        if info_mask is not None:
            err = err & info_mask     # fillers are not information
        return torch.stack([err.sum(), err.any(dim=1).sum(),
                            iters.sum(dtype=torch.int64),
                            iters.max().to(torch.int64)])

    def count(streams, bits):
        return tally(*decode(streams), bits)

    def step(gen, esn0_db):
        total = torch.zeros((4,), dtype=torch.int64, device=dev)
        for _ in range(cfg.steps_per_check):
            total = total + count(*gen_batch(gen, esn0_db))
        return total

    step.gen, step.decode, step.count = gen_batch, decode, count
    step.tally = tally
    step.encode = lambda gen: [encode_group(gen, k, n)
                               for (k, _), n in groups]
    step.device = dev
    return step


def point_generator(cfg: SimConfig, ebn0_db: float, device) -> torch.Generator:
    """The generator a grid point's frames are drawn from."""
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed ^ int(round(ebn0_db * 1000)) & 0x7FFFFFFF)
    return gen


def _point_record(cfg: SimConfig, ebn0_db: float, frames: int, bit_errs: int,
                  frame_errs: int, iters_sum: int, wall: float) -> dict:
    # Fillers of a mixed-K batch are known bits, not information.
    info_bits = int(round(frames * cfg.mean_true_k))
    return {
        "config": cfg.name, "K": cfg.K, "mode": cfg.decoder.mode,
        **({"k_mix": list(cfg.K_mix)} if cfg.K_mix else {}),
        "iters_max": cfg.decoder.n_iters, "ebn0_db": float(ebn0_db),
        "frames": frames, "bits": info_bits,
        "bit_errs": bit_errs, "frame_errs": frame_errs,
        "ber": bit_errs / info_bits if info_bits else 0.0,
        "fer": frame_errs / frames if frames else 0.0,
        "avg_iters": iters_sum / frames if frames else 0.0,
        "wall_s": wall,
        "mbit_per_s": info_bits / wall / 1e6 if wall > 0 else 0.0,
    }


def simulate_point(cfg: SimConfig, ebn0_db: float, step=None,
                   compact_stage1: int = 0, compact_flush: int = 0,
                   device="cuda") -> dict:
    """Run one Eb/N0 grid point to the stopping rule; returns a record.
    `step` (from make_step) is reused across points when given, and then
    names the device.

    compact_stage1 > 0 switches to two-stage convergence compaction
    (host-side re-batching of CRC failures between super-batches) with
    the given stage-1 iteration cap -- same frames, same counts (the
    compaction contract is bit-identical hard decisions), plus device-work
    fields.  compact_flush > 0 additionally accumulates failures ACROSS
    check groups up to that many retained super-batches before flushing
    (denser stage-2 fill; see _simulate_point_compacted)."""
    if compact_stage1:
        return _simulate_point_compacted(cfg, ebn0_db, step, compact_stage1,
                                         compact_flush, device)
    if step is None:
        step = make_step(cfg, device)
    esn0 = float(_ebn0_to_esn0_db(cfg, ebn0_db))
    gen = point_generator(cfg, ebn0_db, step.device)
    bit_errs = frame_errs = frames = iters_sum = iter_batches = 0
    t0 = time.perf_counter()
    while frame_errs < cfg.min_frame_errors and frames < cfg.max_frames:
        be, fe, it, mx = step(gen, esn0).tolist()   # the check's host read
        bit_errs += be
        frame_errs += fe
        iters_sum += it
        iter_batches += mx
        frames += cfg.B * cfg.steps_per_check
    wall = time.perf_counter() - t0
    rec = _point_record(cfg, ebn0_db, frames, bit_errs, frame_errs,
                        iters_sum, wall)
    # Realized device work: the batched loop runs until its SLOWEST frame
    # converges, so each batch costs max(iters) batch-iterations.
    rec["iter_batches"] = iter_batches
    rec["device"] = _device_name(step.device)
    return rec


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _simulate_point_compacted(cfg: SimConfig, ebn0_db: float, step,
                              stage1_iters: int, flush_batches: int = 0,
                              device="cuda") -> dict:
    """Compaction sweep mode: generate the SAME super-batches as the plain
    sweep (the same generator, drawn from in the same order), stage-1 decode
    them at a small cap, re-batch the CRC failures into dense batches
    host-side, and finish those at the full cap.  Counts are bit-identical
    to the non-compact sweep on the same seeds (the decode_compacted
    equivalence contract).

    flush_batches = 0 (default): failures re-batch within each check
    group, so the stopping rule sees complete counts at every check --
    exact stopping parity with the non-compact sweep.
    flush_batches = R > 0: failures ACCUMULATE across check groups and flush
    only when a dense full-size batch is ready (deferred >= B) or R
    super-batches are retained on device (the memory bound) -- much denser
    stage-2 fill, so more device work is saved at low deferral rates.
    Between flushes the stopping rule sees stage-1-converged errors only,
    so a stopping-rule run may take extra frames (never fewer); with a
    fixed frame budget (min_frame_errors pinned high) the counts are
    exactly the non-compact sweep's."""
    from .compact import _stage_fns
    if cfg.K_mix:
        raise ValueError("compaction re-batches through plain turbo_decode; "
                         "mixed-K batches (per-codeword embedded tables) are "
                         "not supported -- run without --compact")
    if cfg.decoder.early_term != "crc":
        raise ValueError("convergence compaction needs early_term='crc'")
    if step is None:
        step = make_step(cfg, device)
    dev = step.device
    esn0 = float(_ebn0_to_esn0_db(cfg, ebn0_db))
    gen = point_generator(cfg, ebn0_db, dev)
    B = cfg.B
    bit_errs = frame_errs = frames = iters_sum = 0
    units = n2_total = deferred_total = 0

    cfg1 = dataclasses.replace(cfg.decoder, n_iters=stage1_iters)
    stage1, stage2 = _stage_fns(cfg1, cfg.decoder, dev)
    R = max(flush_batches, 0)
    pending: list[tuple] = []      # (inputs5, bits, deferred row indices)

    def flush():
        """Gather every pending deferred frame into dense full-cap
        batches."""
        nonlocal bit_errs, frame_errs, iters_sum, units, n2_total
        live = [p for p in pending if len(p[2])]
        pending.clear()
        if not live:
            return
        flat_inputs = tuple(
            torch.cat([p[0][k] for p in live]) for k in range(5))
        flat_bits = torch.cat([p[1] for p in live])
        rows = np.concatenate([np.asarray(p[2], np.int64) + i * B
                               for i, p in enumerate(live)])
        n2 = -(-len(rows) // B)
        n_pad = n2 * B - len(rows)
        idx_all = torch.from_numpy(
            np.concatenate([rows, np.zeros(n_pad, np.int64)])).to(dev)
        val_all = torch.from_numpy(np.concatenate(
            [np.ones(len(rows), bool), np.zeros(n_pad, bool)])).to(dev)
        for b in range(n2):
            p2, _ = stage2(flat_inputs, idx_all[b * B:(b + 1) * B],
                           val_all[b * B:(b + 1) * B], flat_bits)
            be, fe, it = p2.tolist()           # ONE read per stage-2 batch
            bit_errs += be
            frame_errs += fe
            iters_sum += it
        units += n2 * cfg.decoder.n_iters
        n2_total += n2

    t0 = time.perf_counter()
    while frame_errs < cfg.min_frame_errors and frames < cfg.max_frames:
        for _ in range(cfg.steps_per_check):
            streams, bits = step.gen(gen, esn0)
            packed, _ = stage1(streams, bits)
            p = packed.cpu().numpy()           # ONE read per super-batch
            bit_errs += int(p[0])
            frame_errs += int(p[1])
            iters_sum += int(p[2])
            rows = np.nonzero(p[3:])[0]
            deferred_total += len(rows)
            if len(rows):
                pending.append((streams, bits, rows))
            units += stage1_iters
            if (sum(len(p[2]) for p in pending) >= B
                    or (R and len(pending) >= R)):
                flush()
        if not R:
            flush()                # per-check exactness (default)
        frames += cfg.B * cfg.steps_per_check
    flush()
    wall = time.perf_counter() - t0
    rec = _point_record(cfg, ebn0_db, frames, bit_errs, frame_errs,
                        iters_sum, wall)
    rec.update({
        "compact_stage1": stage1_iters,
        **({"compact_flush_batches": R} if R else {}),
        "iter_batches": units,
        "n_stage2_batches": n2_total,
        "deferred_frac": round(deferred_total / frames, 4) if frames else 0.0,
        # avg_iters here sums stage-1 converged iters + stage-2 realized
        # iters -- per-frame device iterations, not the single-stage
        # loop's (which the non-compact record reports).
        "device": _device_name(dev),
    })
    return rec


def simulate_ber(cfg: SimConfig, results_path: str | pathlib.Path | None = None,
                 resume: bool = True, verbose: bool = True,
                 compact_stage1: int = 0, compact_flush: int = 0,
                 device="cuda") -> list[dict]:
    """Sweep the Eb/N0 grid; resumable via the JSONL results file."""
    resolve_device(device)
    done: dict[float, dict] = {}
    path = pathlib.Path(results_path) if results_path else None
    if path and path.exists() and resume:
        text = path.read_text()
        if text and not text.endswith("\n"):
            # Terminate a record torn by a killed writer so appended
            # records land on their own line.
            with path.open("a") as f:
                f.write("\n")
        for line in text.splitlines():
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn trailing line from a killed writer
            # A compacted point only resumes a record compacted the same
            # way (and vice versa): the counts match, but the device-work
            # fields and the stopping behaviour do not.
            if (isinstance(rec, dict) and rec.get("config") == cfg.name
                    and rec.get("compact_stage1", 0) == compact_stage1
                    and rec.get("compact_flush_batches", 0) == compact_flush):
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
            step = make_step(cfg, device)
        rec = simulate_point(cfg, float(ebn0), step,
                             compact_stage1=compact_stage1,
                             compact_flush=compact_flush)
        out.append(rec)
        if path:
            path.parent.mkdir(parents=True, exist_ok=True)
            with path.open("a") as f:
                f.write(json.dumps(rec) + "\n")
        if verbose:
            print(f"[{cfg.name}] Eb/N0={ebn0:5.2f} dB  BER={rec['ber']:.3e} "
                  f"FER={rec['fer']:.3e} avg_iters={rec['avg_iters']:.2f} "
                  f"{rec['mbit_per_s']:.2f} Mbit/s")
    return out
