"""HARQ incremental-redundancy reception of segmented transport blocks, with
soft buffers that stay on the device from one TTI to the next.

A receiver holds, for each HARQ process and each of its slots (the
transport blocks one TTI carries), the soft buffer of every code block in
the decoder's input layout: ls, lp1, lp2 at the bucket width K+ (a smaller
block embedded behind K+ - K known zero steps, as `harness/tb.py` embeds
it) and the two (rows, 6) tails, fp32, rows block-major (row r n + t is
block r of slot t).  `receive` takes one TTI of one process: each slot's
received LLRs with its redundancy version and new-data flag (what the MAC
scheduler hands the PHY), combines them into the process's buffers, decodes
every buffer through `turbo_decode` with grouped tables, reassembles, and
checks CRC-24A (the ACK or NACK).  It reads nothing back to the host beyond
what the decode's early exit reads.

`combine` is the one pass that puts a run of block rows into their buffers
at per-slot redundancy versions (csrc/harq.cu on the card, `combine_plain`
on the CPU, byte for byte the same): a new-data row overwrites its buffer
row (the received LLRs where its redundancy version puts them, 0 at the
punctured positions, +BIG at the pinned ones: the embedding pad and the
fillers of the systematic stream), a retransmission adds its LLRs where its
redundancy version puts them.  Repeated bits (E over a wrap of the circular
buffer) are summed wrap after wrap, as `tx.rate_match.de_rate_match` sums
them, so buffer = 0 + d_0 + d_1 + ... in transmission order, d_i the i-th
transmission de-rate-matched at its own redundancy version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.profiler import record_function

from . import _build
from ._device import launch_on, resolve_device
from .decoder.bucketing import grouped_perm_tables
from .decoder.early_term import crc_ok_batch, make_crc_matrix
from .decoder.turbo import DecoderConfig, turbo_decode
from .harness.ber import BIG_LLR
from .harness.tb import chunk_layout
from .spec.crc import CRC24A_POLY, CRC_LEN
from .spec.segmentation import segment_params
from .transport import per_block_e
from .tx.rate_match import inverse_map

TARGET: _build.Target = ("harq", ())
N_RV = 4
# table entries that are not an index into the received wrap
NONE, PINNED = -1, -2
_COMBINE = _build.PackedEntry(TARGET, "turbotpu_harq_combine_launch", 16)


@functools.lru_cache(maxsize=None)
def combine_table(K: int, E: int, F: int, bucket: int,
                  device: torch.device) -> tuple[torch.Tensor, int]:
    """(the (4, 3 bucket + 12) int32 table of a block of K bits sent in E
    bits with F fillers, decoded at the bucket width: entry [rv, q] is the
    index among the first wrap's received bits at redundancy version rv of
    the one that lands on buffer position q, or NONE, or PINNED; the
    selection's period).  Buffer positions: ls, lp1, lp2 (bucket each), then
    tail1 and tail2 (6 each), as lte_demux and the bucket embedding lay the
    flat d streams out."""
    if not 0 < K <= bucket:
        raise ValueError(f"K={K} outside the bucket {bucket}")
    D, Fe = K + 4, bucket - K
    p = np.arange(3 * D)
    s, i = p // D, p % D
    j = i - K                       # tail entries: d_s[K + j]
    dest = np.where(i < K, s * bucket + Fe + i,
                    3 * bucket + 6 * (j // 2) + 3 * (j % 2) + s)
    table = torch.full((N_RV, 3 * bucket + 12), NONE, dtype=torch.int32)
    periods = set()
    for rv in range(N_RV):
        inv, period = inverse_map(K, E, rv, F, torch.device("cpu"))
        table[rv, torch.from_numpy(dest)] = inv.to(torch.int32)
        periods.add(period)
    table[:, :Fe + F] = PINNED      # the embedding pad and d0's fillers
    if len(periods) != 1:
        raise AssertionError(f"periods {periods} differ across rv")
    return table.to(device), periods.pop()


def combine_plain(streams, llr, table, period, rv, new):
    """Plain version of `combine` (the same arguments), in place."""
    rows, E = llr.shape
    n_wraps = -(-E // period)
    wraps = torch.nn.functional.pad(llr, (0, n_wraps * period - E)
                                    ).view(rows, n_wraps, period)
    acc = wraps[:, 0]
    for w in range(1, n_wraps):
        acc = acc + wraps[:, w]
    reps = rows // rv.shape[0]
    tab = table.long()[(rv & 3).repeat(reps)]
    got = torch.gather(acc, 1, tab.clamp(min=0))
    buf = torch.cat(streams, dim=1)
    hit = tab >= 0
    fresh = torch.where(hit, got, torch.where(tab == PINNED, BIG_LLR, 0.0))
    out = torch.where(new.repeat(reps)[:, None], fresh,
                      torch.where(hit, buf + got, buf))
    lo = 0
    for x in streams:
        x.copy_(out[:, lo:lo + x.shape[1]])
        lo += x.shape[1]


def combine(streams, llr, table, period, rv, new):
    """Combine one run of block rows into their soft buffers, in place.

    streams: the rows' buffers (ls, lp1, lp2 (rows, bucket), tail1, tail2
    (rows, 6)), fp32, contiguous; llr: (rows, E) fp32 received LLRs; table,
    period: `combine_table` of the run's (K, E, F, bucket); rv: (m,) int64
    redundancy versions (read modulo 4) and new: (m,) bool new-data flags,
    on the device, rows a multiple of m and row i taking entry i % m (the
    slot of a block-major row).  On a CUDA tensor one launch of
    csrc/harq.cu; on the CPU the plain version."""
    rows, E = llr.shape
    bucket = streams[0].shape[1]
    dev = llr.device
    for name, x, shape in zip(("ls", "lp1", "lp2", "tail1", "tail2"),
                              streams, [(rows, bucket)] * 3 + [(rows, 6)] * 2):
        if (x.dtype != torch.float32 or tuple(x.shape) != shape
                or x.device != dev or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous fp32 {shape} on "
                             f"{dev}, got {x.dtype} {tuple(x.shape)}")
    m = rv.shape[0]
    if (llr.dtype != torch.float32 or rv.dtype != torch.int64
            or new.dtype != torch.bool or tuple(new.shape) != (m,)
            or m == 0 or rows % m or not period <= E
            or tuple(table.shape) != (N_RV, 3 * bucket + 12)):
        raise ValueError(f"llr {llr.dtype} {(rows, E)}, rv {rv.dtype} "
                         f"{tuple(rv.shape)}, new {new.dtype} "
                         f"{tuple(new.shape)}, table {tuple(table.shape)}, "
                         f"period {period}: not one combine")
    if dev.type == "cpu":
        return combine_plain(streams, llr, table, period, rv, new)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    llr, rv, new, table = (x.contiguous() for x in (llr, rv, new, table))
    if any(x.device != dev for x in (rv, new, table)):
        raise ValueError(f"rv, new and the table must be on {dev}")
    rc = launch_on(dev.index, _COMBINE, llr.data_ptr(), rv.data_ptr(),
                   new.data_ptr(), table.data_ptr(),
                   *(x.data_ptr() for x in streams), rows, m, E, period,
                   bucket, _build.f64_bits(BIG_LLR),
                   count=("combine_kernel",))
    if rc != 0:
        raise RuntimeError(f"harq combine launch failed: cudaError {rc} "
                           f"(rows={rows}, m={m}, E={E}, bucket={bucket})")


class HarqReceiver:
    """The soft buffers of `processes` HARQ processes of `slots` transport
    blocks of A bits each, sent in G channel bits of modulation order Qm
    (TS 36.212 5.1.2-5.1.4; N_cb = K_w, as for the UL-SCH), on `device`,
    decoded with `cfg` (its K the bucket K+)."""

    def __init__(self, A: int, G: int, Qm: int, slots: int,
                 cfg: DecoderConfig, processes: int = 8, device="cuda"):
        dev = self.device = resolve_device(device)
        seg = self.seg = segment_params(A + CRC_LEN)
        C, bucket = seg.C, max(seg.sizes)
        if cfg.K != bucket:
            raise ValueError(f"the decoder's K={cfg.K}, the bucket {bucket}")
        self.cfg, self.slots, self.processes = cfg, slots, processes
        Es = per_block_e(G, C, Qm)
        layout = [(K, Es[r], seg.F if r == 0 else 0)
                  for r, K in enumerate(seg.sizes)]
        # runs of consecutive blocks of one (K, E, F): one combine each
        self.runs = []
        for r, blk in enumerate(layout):
            if self.runs and self.runs[-1][2] == blk:
                self.runs[-1][1] = r + 1
            else:
                self.runs.append([r, r + 1, blk])
        self.tables = [combine_table(K, E, F, bucket, dev)
                       for _, _, (K, E, F) in self.runs]
        self.group_tables = tuple(
            torch.from_numpy(t.astype(np.int64)).to(dev)
            for t in grouped_perm_tables(
                [K for K in seg.sizes for _ in range(slots)], bucket))
        self.crc = make_crc_matrix(seg.B, CRC24A_POLY, dev)
        _, takes = chunk_layout(seg)
        self.cuts = [(r * slots, (r + 1) * slots,
                      bucket - K + (seg.F if r == 0 else 0), take)
                     for r, (K, take) in enumerate(zip(seg.sizes, takes))]
        rows = C * slots
        f32 = dict(dtype=torch.float32, device=dev)
        self.buffers = []
        for _ in range(processes):
            bufs = tuple(torch.zeros((rows, w), **f32)
                         for w in (bucket,) * 3 + (6, 6))
            for (r0, r1, _), (table, _) in zip(self.runs, self.tables):
                bufs[0][r0 * slots:r1 * slots, table[0, :bucket] == PINNED] \
                    = BIG_LLR
            self.buffers.append(bufs)
        self.n_tx = torch.zeros((processes, slots), dtype=torch.int32,
                                device=dev)
        # rows combined: [new data, retransmission] x redundancy version
        self.combined = torch.zeros((2, N_RV), dtype=torch.int64, device=dev)
        self._blocks = torch.full((slots,), C, dtype=torch.int64, device=dev)

    def combine_tti(self, proc: int, llr_runs, rv: torch.Tensor,
                    new: torch.Tensor) -> torch.Tensor:
        """The first half of `receive` (the same arguments): the TTI's
        transmissions into process `proc`'s buffers, and the counts.
        Returns the process's `n_tx` (slots,), a view."""
        n = self.slots
        bufs = self.buffers[proc]
        if len(llr_runs) != len(self.runs):
            raise ValueError(f"{len(llr_runs)} LLR runs for "
                             f"{len(self.runs)} runs of blocks")
        with record_function("harq.combine"):
            for (r0, r1, _), llr, (table, period) in zip(
                    self.runs, llr_runs, self.tables):
                combine(tuple(b[r0 * n:r1 * n] for b in bufs), llr, table,
                        period, rv, new)
        with record_function("harq.count"):
            n_tx = self.n_tx[proc]
            n_tx.add_(1).masked_fill_(new, 1)
            v = rv & 3
            self.combined.view(-1).index_add_(
                0, torch.where(new, v, v + N_RV), self._blocks)
        return n_tx

    def receive(self, proc: int, llr_runs, rv: torch.Tensor,
                new: torch.Tensor) -> dict:
        """One TTI of process `proc`: llr_runs, one (rows, E) fp32 tensor a
        run of equal (K, E, F) blocks, block-major; rv (slots,) int64 and
        new (slots,) bool on the device.  Returns, on the device, `hard`
        (slots, B) the reassembled CRC-attached blocks, `ok` (slots,) their
        CRC-24A verdicts, `iters` (C slots,), `L` (C slots, K+), and `n_tx`
        (slots,) the transmissions combined into each buffer since its last
        new data."""
        n_tx = self.combine_tti(proc, llr_runs, rv, new)
        hard, iters, L = turbo_decode(*self.buffers[proc], self.cfg,
                                      group_tables=self.group_tables,
                                      device=self.device)
        with record_function("harq.verdict"):
            tb = torch.cat([hard[a:b, lo:lo + take]
                            for a, b, lo, take in self.cuts], dim=1)
            ok = crc_ok_batch(tb, self.crc)
        return {"hard": tb, "ok": ok, "iters": iters, "L": L,
                "n_tx": n_tx.clone()}

    def counts(self) -> dict:
        """Block rows combined so far, as new data and as retransmissions at
        each redundancy version (one host read)."""
        new, retx = self.combined.tolist()
        return {"new": dict(enumerate(new)), "retx": dict(enumerate(retx))}
