"""kind "codeblock": LTE code blocks of K bits at rate 1/3 (the
configuration's `K`), CRC-24A over the K - 24 payload bits, decoded as one
batch of `units_per_batch` codewords; CRC verdicts where the traffic
terminates early on CRC.  The interface is perfbench/harness/cell.py's."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.harness import cell, gen, spec
from perfbench.reference import turbo_ref


class Cell(cell.Cell):

    @property
    def crc(self) -> bool:
        return self.traffic["early_term"] == "crc"

    @property
    def K(self) -> int:
        return self.config["K"]

    @property
    def rows(self) -> int:
        return self.units

    @property
    def info_bits(self) -> int:
        return self.units * self.config["K"]

    def decoder_settings(self) -> dict:
        d = self.config["decoder"]
        return {**d, "K": self.K, "crc_poly": spec.CRC24A if self.crc else 0}

    def codeword_K(self) -> np.ndarray:
        return np.full(self.rows, self.K, dtype=np.int64)

    def make_pool(self, seed: int, device) -> list:
        g = torch.Generator(device=device)
        g.manual_seed(seed % 2 ** 64)
        P, n = self.traffic["pool_batches"], self.units
        streams = gen.codeblocks(g, P * n, self.config["K"], self.ebn0_db)
        return [tuple(x[i * n:(i + 1) * n] for x in streams)
                for i in range(P)]

    def timed_path(self, device):
        from turbotpu_torch.decoder.early_term import (crc_ok_batch,
                                                       make_crc_matrix)
        from turbotpu_torch.decoder.turbo import turbo_decode
        dcfg = self.decoder_config()
        dev = torch.device(device)
        H = make_crc_matrix(self.K, spec.CRC24A, dev) if self.crc else None

        def fn(batch):
            hard, iters, L = turbo_decode(*batch, dcfg, device=dev)
            ok = crc_ok_batch(hard, H) if H is not None else None
            return {"hard": hard, "iters": iters, "L": L, "ok": ok}
        return fn, cell.to_host

    def reference_outputs(self, pool, batches, units, precision):
        dec = self.reference_decoder(precision)
        rows = torch.tensor(units, device=pool[batches[0]][0].device)
        streams = [torch.cat([pool[b][i].index_select(0, rows)
                              for b in batches]) for i in range(5)]
        hard, iters, L = turbo_ref.decode(*streams, dec)
        ok = turbo_ref.crc_pass(hard, spec.CRC24A) if self.crc else None
        return {"hard": hard, "iters": iters, "L": L, "ok": ok}

    def select(self, kept: dict, batches, units):
        """Codewords batch by batch."""
        dev = kept[batches[0]]["L"].device
        u = torch.tensor(units, device=dev)
        pick = lambda key, b: kept[b][key].to(dev).index_select(0, u)
        out = {k: torch.cat([pick(k, b) for b in batches])
               for k in ("hard", "iters", "L")}
        out["ok"] = torch.cat([pick("ok", b) for b in batches]) \
            if self.crc else None
        return out
