"""kind "transport_block": transport blocks of A bits with CRC-24A,
segmented into C code blocks (CRC-24B each where C > 1, filler bits in
block 0) and rate-matched to G channel bits of modulation order Qm
(TS 36.212 5.1.1-5.1.4), `units_per_batch` of them a batch, received by the
port's chain: de-rate-matching, demultiplexing, one grouped decode of every
block at the largest block size, reassembly and the CRC-24A verdict.  A
batch's codewords are block-major: row r n + t is block r of transport
block t.  The interface is perfbench/harness/cell.py's."""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from perfbench.harness import cell, gen, spec
from perfbench.reference import rx_ref

BIG_LLR = 1e9


class Cell(cell.Cell):

    crc = True

    def layout(self):
        c = self.config
        return gen.block_layout(c["A"], c["G"], c["Qm"])

    @property
    def K(self) -> int:
        """The bucket K+."""
        return max(self.layout()[0].sizes)

    @property
    def rows(self) -> int:
        return self.units * self.layout()[0].C

    @property
    def info_bits(self) -> int:
        return self.units * self.config["A"]

    def decoder_settings(self) -> dict:
        d = self.config["decoder"]
        poly = spec.CRC24B if self.layout()[0].C > 1 else spec.CRC24A
        return {**d, "K": self.K, "crc_poly": poly}

    def codeword_K(self) -> np.ndarray:
        return np.repeat(np.array(self.layout()[0].sizes, dtype=np.int64),
                         self.units)

    def make_pool(self, seed: int, device) -> list:
        g = torch.Generator(device=device)
        g.manual_seed(seed % 2 ** 64)
        P, n = self.traffic["pool_batches"], self.units
        c = self.config
        runs, _ = gen.transport_blocks(g, P * n, c["A"], c["G"], c["Qm"],
                                       self.ebn0_db)
        layout = self.layout()[1]
        pool = []
        for i in range(P):
            batch = []
            for (r0, r1), x in zip(gen.runs(layout), runs):
                # rows (r - r0) * P n + t -> this batch's (r - r0) * n + t'
                x = x.view(r1 - r0, P * n, -1)[:, i * n:(i + 1) * n]
                batch.append(x.reshape((r1 - r0) * n, -1).contiguous())
            pool.append(batch)
        return pool

    def timed_path(self, device):
        from turbotpu_torch.decoder.bucketing import grouped_perm_tables
        from turbotpu_torch.decoder.early_term import (crc_ok_batch,
                                                       make_crc_matrix)
        from turbotpu_torch.decoder.turbo import turbo_decode
        from turbotpu_torch.harness.tb import chunk_layout
        from turbotpu_torch.spec.crc import CRC_LEN
        from turbotpu_torch.spec.segmentation import segment_params
        from turbotpu_torch.tx.rate_match import de_rate_match, lte_demux
        dcfg = self.decoder_config()
        dev = torch.device(device)
        # the receiver's segmentation and chunks are the program's own
        seg = segment_params(self.config["A"] + CRC_LEN)
        n = self.units
        bucket = max(seg.sizes)
        tables = tuple(torch.from_numpy(t.astype(np.int64)).to(dev)
                       for t in grouped_perm_tables(
                           [K for K in seg.sizes for _ in range(n)], bucket))
        H = make_crc_matrix(seg.B, spec.CRC24A, dev)
        runs = gen.runs(self.layout()[1])
        _, takes = chunk_layout(seg)
        cuts = [(r * n, (r + 1) * n, bucket - K + (seg.F if r == 0 else 0),
                 take) for r, (K, take) in enumerate(zip(seg.sizes, takes))]
        pad = torch.nn.functional.pad

        def fn(batch):
            with record_function("bench.rx.derate"):
                cols = [[] for _ in range(5)]
                for (r0, _), llr in zip(runs, batch):
                    K, F = seg.sizes[r0], (seg.F if r0 == 0 else 0)
                    ls, lp1, lp2, t1, t2 = lte_demux(
                        de_rate_match(llr, K, 0, F=F))
                    if F:
                        ls = ls.clone()
                        ls[:, :F] = BIG_LLR
                    Fe = bucket - K
                    for c, x in zip(cols, (pad(ls, (Fe, 0), value=BIG_LLR),
                                           pad(lp1, (Fe, 0)),
                                           pad(lp2, (Fe, 0)), t1, t2)):
                        c.append(x)
                streams = [c[0] if len(c) == 1 else torch.cat(c)
                           for c in cols]
            hard, iters, L = turbo_decode(*streams, dcfg, group_tables=tables,
                                          device=dev)
            with record_function("bench.rx.crc"):
                # the slicing of the program's transport-block receiver
                # (harness/tb.py, make_tb_step's tally)
                tb = torch.cat([hard[a:b, lo:lo + take]
                                for a, b, lo, take in cuts], dim=1)
                ok = crc_ok_batch(tb, H)
            return {"hard": tb, "iters": iters, "L": L, "ok": ok}
        return fn, cell.to_host

    def reference_outputs(self, pool, batches, units, precision):
        dec = self.reference_decoder(precision)
        c = self.config
        seg, layout = self.layout()
        n = self.units
        runs = []
        for j, (r0, r1) in enumerate(gen.runs(layout)):
            rows = [(r - r0) * n + t for r in range(r0, r1) for t in units]
            idx = torch.tensor(rows, device=pool[batches[0]][j].device)
            blocks = torch.stack([pool[b][j].index_select(0, idx)
                                  .view(r1 - r0, len(units), -1)
                                  for b in batches], dim=1)
            runs.append(blocks.reshape((r1 - r0) * len(batches) * len(units),
                                       -1))
        tb, ok, iters, L = rx_ref.receive(runs, len(batches) * len(units),
                                          c["A"], c["G"], c["Qm"], dec)
        return {"hard": tb, "iters": iters, "L": L, "ok": ok}

    def select(self, kept: dict, batches, units):
        """Transport blocks batch by batch; their codewords block-major over
        all sampled transport blocks."""
        dev = kept[batches[0]]["L"].device
        u = torch.tensor(units, device=dev)
        pick = lambda key, b, rows: kept[b][key].to(dev).index_select(0, rows)
        C, n = self.layout()[0].C, self.units
        blk = lambda key: torch.cat([
            torch.stack([pick(key, b, r * n + u) for b in batches])
            .reshape(-1, *kept[batches[0]][key].shape[1:])
            for r in range(C)])
        return {"hard": torch.cat([pick("hard", b, u) for b in batches]),
                "ok": torch.cat([pick("ok", b, u) for b in batches]),
                "iters": blk("iters"), "L": blk("L")}
