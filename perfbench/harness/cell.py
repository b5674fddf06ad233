"""One cell of the benchmark: its files, its inputs, its timed path and its
reference.

A cell names a configuration and a traffic mix in BENCHMARK.json.  The
configuration's file says what is decoded (`kind` "codeblock": LTE code
blocks of K bits at rate 1/3; `kind` "transport_block": transport blocks of
A bits rate-matched to G channel bits) and the decoder's settings; the
traffic file (perfbench/workloads/<traffic>.json) says how it arrives: units
(code blocks or transport blocks) per batch, the loop ("chained": batches
back to back; "oneshot": each batch submitted after the last result reached
the host), early termination, Eb/N0 (a number, or "operating_point" for the
configuration's own), the pool of distinct batches the window cycles
through, and the sample the reference checks.  Nothing here knows a cell
by name.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import torch
from torch.profiler import record_function

from . import gen, spec
from ..reference import rx_ref, turbo_ref

ROOT = Path(__file__).resolve().parents[2]
BIG_LLR = 1e9


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict                  # the workload entry of BENCHMARK.json
    config: dict                 # the configuration's file
    traffic: dict                # the traffic file
    limits: dict                 # perfbench/limits/<cell>.json

    @classmethod
    def load(cls, name: str, root: Path = ROOT, bench: dict | None = None):
        bench = bench or load_benchmark(root)
        entry = next((w for w in bench["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        cfg = next(c for c in bench["configs"] if c["name"] == entry["config"])
        read = lambda p: json.loads((root / p).read_text())
        return cls(name, entry, read(cfg["file"]),
                   read(f"perfbench/workloads/{entry['traffic']}.json"),
                   read(f"perfbench/limits/{name}.json"))

    # --- what is decoded -------------------------------------------------

    @property
    def kind(self) -> str:
        return self.config["kind"]

    @property
    def crc(self) -> bool:
        return self.kind == "transport_block" or \
            self.traffic["early_term"] == "crc"

    @property
    def ebn0_db(self) -> float:
        e = self.traffic["ebn0_db"]
        return self.config["operating_point_ebn0_db"] if e == \
            "operating_point" else float(e)

    def layout(self):
        c = self.config
        return gen.block_layout(c["A"], c["G"], c["Qm"])

    @property
    def K(self) -> int:
        """The trellis the decoder runs (the bucket K+ for blocks)."""
        if self.kind == "codeblock":
            return self.config["K"]
        return max(self.layout()[0].sizes)

    @property
    def units(self) -> int:
        return self.traffic["units_per_batch"]

    @property
    def rows(self) -> int:
        """Codewords a batch decodes."""
        if self.kind == "codeblock":
            return self.units
        return self.units * self.layout()[0].C

    @property
    def info_bits(self) -> int:
        """Information bits a batch delivers."""
        if self.kind == "codeblock":
            return self.units * self.config["K"]
        return self.units * self.config["A"]

    def decoder_settings(self) -> dict:
        d = self.config["decoder"]
        poly = spec.CRC24B if (self.kind == "transport_block"
                               and self.layout()[0].C > 1) else spec.CRC24A
        return {**d, "K": self.K, "crc_poly": poly if self.crc else 0}

    def reference_decoder(self, precision=turbo_ref.INT8) -> turbo_ref.Decoder:
        d = self.decoder_settings()
        if d["mode"] != "maxlog" or not d["nii"]:
            raise ValueError("the reference is the max-log NII decoder")
        return turbo_ref.Decoder(K=d["K"], n_iters=d["n_iters"],
                                 scale=d["ext_scale"], window=d["window"],
                                 crc_poly=d["crc_poly"], precision=precision)

    # --- inputs ----------------------------------------------------------

    def make_pool(self, seed: int, device) -> list:
        """The pool of distinct batches, made on `device` from `seed`."""
        g = torch.Generator(device=device)
        g.manual_seed(seed % 2 ** 64)
        P, n = self.traffic["pool_batches"], self.units
        if self.kind == "codeblock":
            streams = gen.codeblocks(g, P * n, self.config["K"], self.ebn0_db)
            return [tuple(x[i * n:(i + 1) * n] for x in streams)
                    for i in range(P)]
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

    def sample(self, seed: int) -> tuple[list[int], list[int]]:
        """The pool batches and, in each, the units the reference checks,
        drawn from the seed."""
        rng = np.random.default_rng([seed % 2 ** 64, 0xC0FFEE])
        chk = self.traffic["check"]
        P = self.traffic["pool_batches"]
        batches = sorted(rng.choice(P, min(P, chk["batches"]),
                                    replace=False).tolist())
        n = chk.get("units") or self.units
        units = sorted(rng.choice(self.units, min(n, self.units),
                                  replace=False).tolist())
        return batches, units

    # --- the timed path ----------------------------------------------------

    def timed_path(self, device):
        """fn(batch) -> outputs, the program's work on one batch, and
        to_host(outputs) -> what a receiver waits for, on the host."""
        from turbotpu_torch.decoder.early_term import (crc_ok_batch,
                                                       make_crc_matrix)
        from turbotpu_torch.decoder.turbo import DecoderConfig, turbo_decode
        d = self.decoder_settings()
        dcfg = DecoderConfig(
            K=d["K"], n_iters=d["n_iters"], mode=d["mode"],
            ext_scale=d["ext_scale"], siso="cuda", io_dtype=d["io_dtype"],
            ext_dtype=d["ext_dtype"], ext_qscale=d["ext_qscale"],
            nii=d["nii"], window=d["window"],
            early_term="crc" if self.crc else "none",
            crc_poly=d["crc_poly"] or spec.CRC24A)
        dev = torch.device(device)

        if self.kind == "codeblock":
            H = make_crc_matrix(self.K, spec.CRC24A, dev) if self.crc \
                else None

            def fn(batch):
                hard, iters, L = turbo_decode(*batch, dcfg, device=dev)
                ok = crc_ok_batch(hard, H) if H is not None else None
                return {"hard": hard, "iters": iters, "L": L, "ok": ok}
            return fn, _to_host

        from turbotpu_torch.decoder.bucketing import grouped_perm_tables
        from turbotpu_torch.harness.tb import chunk_layout
        from turbotpu_torch.spec.crc import CRC_LEN
        from turbotpu_torch.spec.segmentation import segment_params
        from turbotpu_torch.tx.rate_match import de_rate_match, lte_demux
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
        return fn, _to_host

    # --- the reference -----------------------------------------------------

    def reference_outputs(self, pool, batches, units, precision):
        """The reference's outputs for the sampled units, in the order
        `select` puts the program's."""
        dec = self.reference_decoder(precision)
        if self.kind == "codeblock":
            rows = torch.tensor(units, device=pool[batches[0]][0].device)
            streams = [torch.cat([pool[b][i].index_select(0, rows)
                                  for b in batches]) for i in range(5)]
            hard, iters, L = turbo_ref.decode(*streams, dec)
            ok = turbo_ref.crc_pass(hard, spec.CRC24A) if self.crc else None
            return {"hard": hard, "iters": iters, "L": L, "ok": ok}
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
        """The program's outputs of the sampled units, in the reference's
        order: codewords (and transport blocks) batch by batch, for blocks
        block-major over all sampled transport blocks."""
        dev = kept[batches[0]]["L"].device
        u = torch.tensor(units, device=dev)
        pick = lambda key, b, rows: kept[b][key].to(dev).index_select(0, rows)
        if self.kind == "codeblock":
            out = {k: torch.cat([pick(k, b, u) for b in batches])
                   for k in ("hard", "iters", "L")}
            out["ok"] = torch.cat([pick("ok", b, u) for b in batches]) \
                if self.crc else None
            return out
        C, n = self.layout()[0].C, self.units
        blk = lambda key: torch.cat([
            torch.stack([pick(key, b, r * n + u) for b in batches])
            .reshape(-1, *kept[batches[0]][key].shape[1:])
            for r in range(C)])
        return {"hard": torch.cat([pick("hard", b, u) for b in batches]),
                "ok": torch.cat([pick("ok", b, u) for b in batches]),
                "iters": blk("iters"), "L": blk("L")}


def _to_host(out: dict) -> dict:
    """A receiver's wait: the hard bits, iteration counts and verdicts on
    the host (L stays on the device)."""
    return {k: (v.cpu() if k != "L" and v is not None else v)
            for k, v in out.items()}
