"""kind "harq_transport_block": the transport blocks of kind
"transport_block", received with HARQ incremental redundancy (TS 36.321
5.4.2: synchronous HARQ processes, TTI i on process i mod P; TS 36.213
8.6.1: redundancy versions 0, 2, 3, 1; TS 36.212 5.1.4.1.2: one circular
buffer, N_cb = K_w).  A pool batch is one TTI of one process: each slot's
received LLRs, at its redundancy version, with its new-data flag (the MAC's
decisions, drawn from the seed: perfbench/harness/harq_gen.py).  The timed
path is the port's HARQ receiver, whose soft buffers stay on the device
from one batch to the next; the reference rebuilds each sampled slot's
buffer from the transport block's transmissions in the pool
(perfbench/reference/harq_ref.py).  The interface is
perfbench/harness/cell.py's; a batch is a dict: `proc`, `runs` (one
((r1 - r0) n, E) tensor a run of equal blocks, block-major), `rv` (n,)
int64 and `new` (n,) bool."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

from perfbench.harness import cell, gen, harq_gen
from perfbench.reference import harq_ref

ROOT = Path(__file__).resolve().parents[2]
Base = cell.kind_module(ROOT, "transport_block").Cell


class Cell(Base):

    @property
    def processes(self) -> int:
        return self.config["harq"]["processes"]

    @property
    def rounds(self) -> int:
        """TTIs of each process in the pool."""
        return self.traffic["pool_batches"] // self.processes

    @property
    def rv_order(self) -> tuple:
        return tuple(self.config["harq"]["rv_order"])

    def schedule(self, seed: int) -> dict:
        """harq_gen.schedule of the seed, made once."""
        if getattr(self, "_schedule", (None,))[0] != seed:
            self._schedule = (seed, harq_gen.schedule(
                seed, self.processes, self.rounds, self.units,
                self.traffic["tx_shares"]))
        return self._schedule[1]

    def make_pool(self, seed: int, device) -> list:
        sch = self.schedule(seed)
        g = torch.Generator(device=device)
        g.manual_seed(seed % 2 ** 64)
        c = self.config
        _, blocks = harq_gen.encode(g, sch["n_tb"], c["A"], c["G"], c["Qm"])
        layout = self.layout()[1]
        es = harq_gen.esn0_db(self.ebn0_db, c["A"], c["G"])
        order = torch.tensor(self.rv_order, device=device)
        pool = []
        for i in range(self.traffic["pool_batches"]):
            k = torch.from_numpy(sch["k"][i]).to(device)
            rv = order[k]
            pool.append({"proc": i % self.processes, "rv": rv, "new": k == 0,
                         "runs": harq_gen.transmit(
                             g, blocks, layout,
                             torch.from_numpy(sch["tb"][i]).to(device), rv,
                             es)})
        # what a metric reader counts the combine's bytes from
        self.pool_schedule = sch
        print("realized shares: " + json.dumps(harq_gen.realized_shares(sch)),
              file=sys.stderr)
        return pool

    def timed_path(self, device):
        from turbotpu_torch.harq import HarqReceiver
        c = self.config
        rx = HarqReceiver(c["A"], c["G"], c["Qm"], self.units,
                          self.decoder_config(), processes=self.processes,
                          device=device)

        def fn(batch):
            return rx.receive(batch["proc"], batch["runs"], batch["rv"],
                              batch["new"])
        return fn, cell.to_host

    def warmup(self, pool: list) -> list:
        """The pool once through: every process's buffers then hold what
        the window's first batch expects."""
        return list(pool)

    def needs(self, sampled: list[int]) -> list[int]:
        """Every round of each sampled batch's process."""
        P = self.processes
        return sorted({b % P + P * r for b in sampled
                       for r in range(self.rounds)})

    def sample(self, seed: int) -> tuple[list[int], list[int]]:
        """The pool batches as the generic draw makes them; the slots so
        that each transmission index a sampled batch carries is checked at
        one slot at least, the rest drawn at random."""
        rng = np.random.default_rng([seed % 2 ** 64, 0xC0FFEE])
        chk = self.traffic["check"]
        P = self.traffic["pool_batches"]
        batches = sorted(rng.choice(P, min(P, chk["batches"]),
                                    replace=False).tolist())
        k = self.schedule(seed)["k"]
        units = set()
        for b in batches:
            for i in range(len(self.rv_order)):
                at = np.flatnonzero(k[b] == i)
                if len(at):
                    units.add(int(rng.choice(at)))
        n = min(chk.get("units") or self.units, self.units)
        for t in rng.permutation(self.units).tolist():
            if len(units) >= n:
                break
            units.add(t)
        return batches, sorted(units)

    def reference_outputs(self, pool, batches, units, precision,
                          buffer=torch.float32):
        """Each sampled slot's transport block rebuilt from its
        transmissions in the pool, in the order they were sent, the soft
        buffer stored as `buffer` (a control: bfloat16)."""
        dec = self.reference_decoder(precision)
        c = self.config
        P, R, n = self.processes, self.rounds, self.units
        runs = gen.runs(self.layout()[1])
        index = {rv: i for i, rv in enumerate(self.rv_order)}
        seen = {}

        def tx_index(b):
            if b not in seen:
                seen[b] = [index[v] for v in pool[b]["rv"].tolist()]
            return seen[b]
        # per transmission index: source batch -> [(unit, slot)]
        groups = [{} for _ in self.rv_order]
        for bi, b in enumerate(batches):
            kb = tx_index(b)
            for ui, t in enumerate(units):
                k = kb[t]
                for i in range(k + 1):
                    src = ((b // P - k + i) % R) * P + b % P
                    if tx_index(src)[t] != i:
                        raise ValueError(f"pool batch {src} slot {t} is not "
                                         f"transmission {i} of batch {b}'s")
                    groups[i].setdefault(src, []).append(
                        (bi * len(units) + ui, t))
        txs = []
        for i, by_src in enumerate(groups):
            for src, pairs in sorted(by_src.items()):
                dev = pool[src]["runs"][0].device
                slots = torch.tensor([t for _, t in pairs], device=dev)
                llr = [pool[src]["runs"][j].index_select(0, (
                    torch.arange(r1 - r0, device=dev)[:, None] * n
                    + slots[None, :]).reshape(-1))
                    for j, (r0, r1) in enumerate(runs)]
                txs.append((llr, self.rv_order[i], [u for u, _ in pairs]))
        tb, ok, iters, L = harq_ref.receive(
            txs, len(batches) * len(units), c["A"], c["G"], c["Qm"], dec,
            buffer)
        return {"hard": tb, "iters": iters, "L": L, "ok": ok}
