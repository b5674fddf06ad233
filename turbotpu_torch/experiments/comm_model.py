"""Communication model of the sequence-sharded decode across cards.

Counterpart of experiments/comm_model.py of the JAX package, three parts:

1. `exchange_volume`: the extrinsic rows each shard ships per codeword and
   exchange, counted from the decoder's own routing tables
   (`dist.seq_parallel.exchange_tables`) at its own geometry
   (`chunk_sizing`); not an estimate.
2. `collective_counts`: in place of the reference's count of collectives in
   compiled HLO, the collective calls, and the bytes each shard sends, of
   one iteration of the port's sequence decoder (kernel route, NII, CRC
   early termination), recorded by a `CountingMesh`: a local mesh whose
   collectives count themselves.  One iteration is the difference of a
   two-iteration and a one-iteration decode of noise (whose CRC fails), so
   the assembly after the loop drops out.
3. `scaling_model`: per-iteration communication against compute for a
   seq ring decoding one batch of b_local codewords, serialised (no
   overlap) and with split-batch overlap, fed by this port's own records:
   the flagship rate of flagship_tuning (`variance.median`) and the glue of
   seq_glue (B=1024 rows).  The link rate is NVLink's on an H100 SXM from
   NVIDIA's datasheet (900 GB/s per card, both directions together; 450 GB/s
   a direction), a datasheet figure and not a measurement.

Nothing across cards can be measured on one card: parts 1 and 2 are counts,
part 3 is a model.

    python -m turbotpu_torch.experiments.comm_model [--k 6144] [--b-local 1024]
        [--tuning FILE] [--glue FILE] [--out FILE]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .._device import resolve_device
from ..dist.mesh import Mesh
from .common import RECORDS, out_path, run_meta, write_record

# NVIDIA H100 SXM datasheet: NVLink 900 GB/s per card, the sum of both
# directions.  A ring moves each payload one way: 450 GB/s.
NVLINK_GBYTES_PER_DIRECTION = 900.0 / 2
FLAGSHIP_ITERS = 6


def exchange_volume(K: int, n_seq: int, dtype_bytes: int = 2) -> dict:
    """Cross-shard extrinsic rows per codeword and exchange, from the
    decoder's routing tables; bytes_per_cw_iter is what one shard's two
    all_to_alls of an iteration move (the padded buckets)."""
    from ..decoder.turbo import DecoderConfig
    from ..dist.seq_parallel import chunk_sizing, exchange_tables
    KT = K + 3
    C, _, _, _ = chunk_sizing(KT, n_seq)
    cfg = DecoderConfig(K=K)
    perm = np.asarray(cfg.perm(), np.int64)
    ext = np.arange(K, C * n_seq, dtype=np.int64)
    out = {}
    for name, p in (("perm", np.concatenate([perm, ext])),
                    ("inv", np.concatenate(
                        [np.asarray(cfg.inv(), np.int64), ext]))):
        local, send, slot, M = exchange_tables(p, C, n_seq)
        real = (send != C).sum(axis=(1, 2))        # per-shard egress rows
        out[name] = {
            "C": C, "M_bucket": int(M),
            "egress_rows_max": int(real.max()),
            "egress_rows_mean": float(real.mean()),
            "egress_rows_padded": int((n_seq - 1) * M),
        }
    out["bytes_per_cw_iter"] = int(
        2 * (n_seq - 1) * max(out["perm"]["M_bucket"],
                              out["inv"]["M_bucket"]) * dtype_bytes)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CountingMesh(Mesh):
    """A local mesh whose collectives count their calls and the bytes one
    shard sends in each (the largest over the shards): `counts[kind] =
    [calls, bytes]`.  A collective over an axis of one shard sends
    nothing."""

    def __init__(self, data: int, seq: int, device):
        super().__init__(data, seq, "local", device)
        self.counts: dict[str, list[int]] = {}

    def _count(self, kind: str, nbytes: int) -> None:
        c = self.counts.setdefault(kind, [0, 0])
        c[0] += 1
        c[1] += nbytes

    def seq_ring(self, fwd, bwd):
        self._count("seq_ring", max(_nbytes(a) + _nbytes(b)
                                    for a, b in zip(fwd, bwd))
                    if self.seq > 1 else 0)
        return super().seq_ring(fwd, bwd)

    def seq_all_to_all(self, bufs):
        n = self.seq
        self._count("all_to_all", max(_nbytes(b) * (n - 1) // n
                                      for b in bufs))
        return super().seq_all_to_all(bufs)

    def seq_sum(self, xs):
        self._count("seq_sum", max(map(_nbytes, xs)) if self.seq > 1 else 0)
        return super().seq_sum(xs)

    def data_sum(self, xs):
        self._count("data_sum", max(map(_nbytes, xs)) if self.data > 1 else 0)
        return super().data_sum(xs)

    def seq_all_gather(self, xs):
        self._count("seq_all_gather",
                    max(map(_nbytes, xs)) if self.seq > 1 else 0)
        return super().seq_all_gather(xs)


def collective_counts(K: int = 320, n_seq: int = 4, data: int = 2,
                      B: int = 4, nii: bool = True, device="cuda") -> dict:
    """{kind: {"calls", "bytes_per_shard"}} of one iteration of the kernel
    route's sequence decode (max-log, bf16 streams, CRC early termination)
    of B codewords of noise on a counting (data, n_seq) mesh."""
    from ..decoder.turbo import DecoderConfig
    from ..dist.seq_parallel import decode_seq_sharded
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    mk = lambda n: rng.normal(size=(B, n)).astype(np.float32)
    inputs = (mk(K), mk(K), mk(K), mk(6), mk(6))
    counts = {}
    for iters in (1, 2):
        mesh = CountingMesh(data, n_seq, dev)
        cfg = DecoderConfig(K=K, n_iters=iters, mode="maxlog", siso="cuda",
                            io_dtype="bfloat16", early_term="crc", nii=nii)
        _, its, _ = decode_seq_sharded(mesh, cfg)(*inputs)
        if int(its.min()) != iters:
            raise AssertionError(f"the noise decode stopped after "
                                 f"{int(its.min())} of {iters} iterations")
        counts[iters] = mesh.counts
    out = {}
    for kind, (calls, nbytes) in counts[2].items():
        calls1, nbytes1 = counts[1].get(kind, (0, 0))
        if calls != calls1:
            out[kind] = {"calls": calls - calls1,
                         "bytes_per_shard": nbytes - nbytes1}
    return out


def scaling_model(K: int, b_local: int, n_seq: int,
                  dtype_bytes: int = 2,
                  link_gbytes: float = NVLINK_GBYTES_PER_DIRECTION,
                  flagship_gbit_s: float | None = None,
                  overlap_groups: int = 1,
                  glue_us_per_half_iter: float = 0.0) -> dict:
    """Per-iteration communication against compute for a seq ring decoding
    one batch of b_local codewords (the reference's model).  Efficiency is
    T_1card / (n_seq x T_nseq); flagship_gbit_s is the measured one-card
    rate at FLAGSHIP_ITERS iterations (no default: it comes from a record);
    overlap_groups=G models split-batch pipelining as max(compute, comm) +
    comm / G; glue_us_per_half_iter is the measured per-shard glue at
    B=1024, scaled with b_local."""
    if flagship_gbit_s is None:
        raise ValueError("flagship_gbit_s: the measured one-card rate")
    vol = exchange_volume(K, n_seq, dtype_bytes)
    a2a_bytes = vol["bytes_per_cw_iter"]
    boundary_bytes = 4 * 8 * 4                      # 4 edges x 8 states fp32
    crc_bytes = 24 * 4
    per_cw = a2a_bytes + boundary_bytes + crc_bytes
    comm_s = b_local * per_cw / (link_gbytes * 1e9)
    compute_full = (b_local * K / (flagship_gbit_s * 1e9)) / FLAGSHIP_ITERS
    pad = vol["perm"]["C"] * n_seq / (K + 3)
    compute_s = compute_full * pad / n_seq
    compute_s += 2 * glue_us_per_half_iter * 1e-6 * (b_local / 1024)
    if overlap_groups > 1:
        iter_s = max(compute_s, comm_s) + comm_s / overlap_groups
    else:
        iter_s = compute_s + comm_s
    eff = (compute_full / n_seq) / iter_s
    return {
        "K": K, "b_local": b_local, "n_seq": n_seq,
        "ext_dtype_bytes": dtype_bytes,
        "overlap_groups": overlap_groups,
        "glue_us_per_half_iter": glue_us_per_half_iter,
        "a2a_bytes_per_cw_iter": a2a_bytes,
        "boundary_bytes_per_cw_iter": boundary_bytes,
        "crc_psum_bytes_per_cw_iter": crc_bytes,
        "chunk_padding_factor": pad,
        "comm_ms_per_iter": comm_s * 1e3,
        "compute_ms_per_iter_per_chip": compute_s * 1e3,
        "latency_speedup_vs_1chip": compute_full / iter_s,
        "efficiency": eff,
        "efficiency_zero_overlap": (compute_full / n_seq)
        / (compute_s + comm_s),
        "link_gbytes_per_s": link_gbytes,
    }


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, default=6144)
    ap.add_argument("--b-local", type=int, default=1024)
    ap.add_argument("--seqs", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--tuning", default=str(RECORDS / "flagship_tuning.json"))
    ap.add_argument("--glue", default=str(RECORDS / "seq_glue.json"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    with open(args.tuning) as f:
        tuning = json.load(f)
    with open(args.glue) as f:
        glue_rec = json.load(f)
    gbit = tuning["variance"]["median"] / 1e3
    glue = {r["n_seq"]: r["glue_us"] for r in glue_rec["rows"]
            if r["B"] == 1024}
    rec = {**run_meta(argv, dev), "K": args.k, "b_local": args.b_local,
           "flagship_gbit_s": gbit,
           "flagship_source": {"record": "flagship_tuning",
                               "card": tuning["card"],
                               "commit": tuning["commit"],
                               "config": tuning["variance"]["config"]},
           "glue_source": {"record": "seq_glue (B=1024 rows)",
                           "card": glue_rec["card"],
                           "commit": glue_rec["commit"]},
           "link": {"gbytes_per_s_per_direction":
                    NVLINK_GBYTES_PER_DIRECTION,
                    "source": "NVIDIA H100 SXM datasheet, NVLink 900 GB/s "
                              "(both directions); a datasheet figure, not a "
                              "measurement"},
           "across_cards": "not measured: one card; the exchange volumes "
                           "and collective counts are counts, the scaling "
                           "rows a model",
           "seq_sharded": [], "collectives_per_iteration": {}}
    for n_seq in args.seqs:
        g = glue.get(n_seq, 0.0)
        m = scaling_model(args.k, args.b_local, n_seq, flagship_gbit_s=gbit,
                          glue_us_per_half_iter=g)
        m["exchange_volume"] = exchange_volume(args.k, n_seq)
        for name, bw in (("half", 0.5), ("double", 2.0)):
            m[f"efficiency_at_{name}_bw"] = scaling_model(
                args.k, args.b_local, n_seq, flagship_gbit_s=gbit,
                glue_us_per_half_iter=g,
                link_gbytes=NVLINK_GBYTES_PER_DIRECTION * bw
            )["efficiency_zero_overlap"]
        m["efficiency_int8"] = scaling_model(
            args.k, args.b_local, n_seq, dtype_bytes=1, flagship_gbit_s=gbit,
            glue_us_per_half_iter=g)["efficiency_zero_overlap"]
        for G in (2, 4):
            m[f"efficiency_int8_overlap{G}"] = scaling_model(
                args.k, args.b_local, n_seq, dtype_bytes=1,
                flagship_gbit_s=gbit, overlap_groups=G,
                glue_us_per_half_iter=g)["efficiency"]
        rec["seq_sharded"].append(m)
        rec["collectives_per_iteration"][str(n_seq)] = collective_counts(
            args.k, n_seq, data=1, B=args.b_local, device=dev)
        print(json.dumps({k: m[k] for k in (
            "n_seq", "a2a_bytes_per_cw_iter", "comm_ms_per_iter",
            "compute_ms_per_iter_per_chip", "latency_speedup_vs_1chip",
            "efficiency_zero_overlap", "efficiency_int8",
            "efficiency_int8_overlap4")}), flush=True)
    rec["collectives_per_iteration"]["K=320, data=2, seq=4, B=4"] = (
        collective_counts(device=dev))
    write_record(rec, out_path(args.out, "comm_model"))
    return rec


if __name__ == "__main__":
    main()
