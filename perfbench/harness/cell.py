"""One cell of the benchmark: its files, its inputs, its timed path and its
reference.

A cell names a configuration and a traffic mix in BENCHMARK.json.  The
configuration's file says what is decoded, by its `kind`, and the decoder's
settings; the traffic file (perfbench/workloads/<traffic>.json) says how it
arrives: units (code blocks or transport blocks) per batch, the loop
("chained": batches back to back; "oneshot": each batch submitted after the
last result reached the host), early termination, Eb/N0 (a number, or
"operating_point" for the configuration's own), the pool of distinct
batches the window cycles through, and the sample the reference checks.
Nothing here knows a cell by name, nor a kind.

What depends on what is decoded lives in perfbench/kinds/<kind>.py, found by
the configuration's `kind` ("codeblock": LTE code blocks of K bits at rate
1/3; "transport_block": transport blocks of A bits rate-matched to G channel
bits).  Such a file defines `Cell`, a subclass of the `Cell` below, with

* `K`, the trellis the decoder runs; `rows`, the codewords a batch decodes;
  `info_bits`, the information bits a batch delivers; `crc`, whether CRC
  verdicts come out (properties);
* `decoder_settings()`, the configuration's decoder with its K and CRC;
* `codeword_K()`, each codeword's own K, aligned with the rows of a batch's
  iteration counts (the SISO work of siso_roofline);
* `make_pool(seed, device)`, the pool of distinct batches, made on the
  device from the seed;
* `timed_path(device)` -> `(fn, to_host)`: fn(batch) -> outputs (`hard`,
  `iters`, `L`, `ok`), the program's work on one batch, and
  to_host(outputs) -> what a receiver waits for, on the host.  The port is
  imported inside it, so that what a run loads, and when, is the timed
  path's alone.  fn may keep state on the device from one call to the next;
* `reference_outputs(pool, batches, units, precision)`: the reference's
  outputs of the sampled units of the sampled batches, in the order
  `select` puts the program's; `pool` maps a batch index to its inputs and
  holds every batch that `needs` names;
* `select(kept, batches, units)`: the program's outputs of the sampled
  units, from each sampled batch's outputs as the window last produced them;

and, where the defaults below do not hold, `reference_decoder(precision)`
(the max-log NII reference), `decoder_config()` (the port's decoder of
`decoder_settings()`), `warmup(pool)` (the batches run before the window, in
order: they build and warm every shape, and leave fn's state as the window
finds it) and `needs(sampled)` (the pool batches the reference reads).  The
window runs pool batch i % P as its i-th batch, after the warm-up.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np

from ..reference import turbo_ref
from . import spec

ROOT = Path(__file__).resolve().parents[2]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def kind_module(root: Path, kind: str):
    """perfbench/kinds/<kind>.py under `root`, loaded by path."""
    path = root / "perfbench" / "kinds" / f"{kind}.py"
    if not path.is_file():
        raise ValueError(f"kind {kind!r}: no file {path}")
    found = importlib.util.spec_from_file_location(
        "perfbench_kind_" + kind.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(found)
    found.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict                  # the workload entry of BENCHMARK.json
    config: dict                 # the configuration's file
    traffic: dict                # the traffic file
    limits: dict                 # perfbench/limits/<cell>.json

    @classmethod
    def load(cls, name: str, root: Path = ROOT, bench: dict | None = None):
        """The cell, as its configuration's kind's `Cell`."""
        bench = bench or load_benchmark(root)
        entry = next((w for w in bench["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        cfg = next(c for c in bench["configs"] if c["name"] == entry["config"])
        read = lambda p: json.loads((root / p).read_text())
        config = read(cfg["file"])
        kind = kind_module(root, config["kind"]).Cell
        return kind(name, entry, config,
                    read(f"perfbench/workloads/{entry['traffic']}.json"),
                    read(f"perfbench/limits/{name}.json"))

    @property
    def ebn0_db(self) -> float:
        e = self.traffic["ebn0_db"]
        return self.config["operating_point_ebn0_db"] if e == \
            "operating_point" else float(e)

    @property
    def units(self) -> int:
        return self.traffic["units_per_batch"]

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

    # --- defaults a kind may replace -----------------------------------------

    def reference_decoder(self, precision=turbo_ref.INT8) -> turbo_ref.Decoder:
        d = self.decoder_settings()
        if d["mode"] != "maxlog" or not d["nii"]:
            raise ValueError("the reference is the max-log NII decoder")
        return turbo_ref.Decoder(K=d["K"], n_iters=d["n_iters"],
                                 scale=d["ext_scale"], window=d["window"],
                                 crc_poly=d["crc_poly"], precision=precision)

    def decoder_config(self):
        """The port's DecoderConfig of `decoder_settings()`, on its CUDA
        kernel path (imported here: only a timed path calls it)."""
        from turbotpu_torch.decoder.turbo import DecoderConfig
        d = self.decoder_settings()
        return DecoderConfig(
            K=d["K"], n_iters=d["n_iters"], mode=d["mode"],
            ext_scale=d["ext_scale"], siso="cuda", io_dtype=d["io_dtype"],
            ext_dtype=d["ext_dtype"], ext_qscale=d["ext_qscale"],
            nii=d["nii"], window=d["window"],
            early_term="crc" if self.crc else "none",
            crc_poly=d["crc_poly"] or spec.CRC24A)

    def warmup(self, pool: list) -> list:
        """The batches run before the window, in order."""
        return pool[:2]

    def needs(self, sampled: list[int]) -> list[int]:
        """The pool batches `reference_outputs` reads for these sampled
        batches."""
        return sampled


def to_host(out: dict) -> dict:
    """A receiver's wait: the hard bits, iteration counts and verdicts on
    the host (L stays on the device)."""
    return {k: (v.cpu() if k != "L" and v is not None else v)
            for k, v in out.items()}
