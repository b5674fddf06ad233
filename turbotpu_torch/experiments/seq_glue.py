"""The sequence decoder's glue per shard: what a half-iteration costs
besides its chunk kernel, at the chunk each seq width gives.

Counterpart of experiments/seq_glue.py of the JAX package.  One card cannot
run a seq ring across cards, but the glue is shard-local, so it can be
timed alone.  For n_seq in {1, 2, 4, 8}, at the production geometry
(`dist.seq_parallel.chunk_sizing`) and with the production exchange
(`make_exchange`, the same object the decoder and `chip_smoke.py`'s
iteration split use, built by `shard_setup`), shard 0's half-iteration is
timed two ways (CUDA events):

* the chunk kernel alone (`siso_bnd_nii`, K4, NII contract, row offset 0);
* the kernel and the exchange's shard-local gathers: the send buckets
  gathered from le, and la gathered from [le ++ received rows], where a
  buffer of the size of the received buckets stands in for the all_to_all
  (a collective, modelled in comm_model).  With one shard the exchange is
  one gather.  The decoder picks e0 at the open ends on the host, so no
  edge select runs on the card.

The difference is the glue; B is 1024 (the reference's) and C5's 4096.

    python -m turbotpu_torch.experiments.seq_glue [--seqs 1 2 4 8]
        [--batches 1024 4096] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import types

import torch

from .._device import resolve_device
from .common import need_card, out_path, run_meta, write_record


def shard_setup(K: int, n_seq: int, dev, window: int = 0):
    """The production pieces of a seq ring of n_seq on a local mesh of
    `dev`: geometry (C, W, n_win, KTp), the mesh, the decoder configuration
    of C5 and the perm exchange."""
    from ..dist.mesh import make_mesh
    from ..dist.seq_parallel import (_extended_tables, chunk_sizing,
                                     make_exchange)
    from ..harness.c5 import c5_config
    C, W, n_win, KTp = chunk_sizing(K + 3, n_seq, window)
    mesh = make_mesh(1, n_seq, device=dev)
    cfg = c5_config(K)
    perm_e, _ = _extended_tables(cfg, KTp)
    return types.SimpleNamespace(C=C, W=W, n_win=n_win, KTp=KTp, mesh=mesh,
                                 cfg=cfg, xch=make_exchange(perm_e, C, mesh))


def measure(n_seq: int, K: int = 6144, B: int = 1024, device="cuda",
            reps: int = 48) -> dict:
    from ..harness.bench import event_ms
    from ..siso.cuda_kernel import _e0, siso_cells
    dev = resolve_device(device)
    need_card(dev, "seq_glue")
    s = shard_setup(K, n_seq, dev)
    C, W, xch = s.C, s.W, s.xch
    dt = torch.bfloat16
    ls = torch.full((C, B), 1.0, dtype=dt, device=dev)
    lp = torch.zeros((C, B), dtype=dt, device=dev)
    e0 = _e0(B, dev)
    rb = torch.zeros((n_seq * xch.M, B), dtype=dt, device=dev)
    j = 0                                       # shard 0 of the ring

    def half_iter(st, glue: bool):
        le, st["ain"], st["edge"], _ = siso_cells(
            ls, lp, st["la"], K, "maxlog", 0.75,
            nii_boundaries=(st["ain"], st["edge"], e0), window=W,
            row_offset=0)
        if glue:
            if xch.M:
                xch.send[j](le, 0)              # the all_to_all's payload
                st["la"] = xch.merged[j](torch.cat([le, rb]), 0)
            else:
                st["la"] = xch.local[j](le, 0)

    us = {}
    for glue in (False, True):
        st = {"la": torch.zeros((C, B), dtype=dt, device=dev),
              "ain": torch.zeros((s.n_win, 8, B), device=dev), "edge": e0}
        us[glue] = event_ms(lambda: half_iter(st, glue), reps) * 1e3
    return {"n_seq": n_seq, "B": B, "C": C, "W": W, "KTp": s.KTp,
            "M_bucket": int(xch.M), "kernel_us": us[False],
            "kernel_plus_glue_us": us[True], "glue_us": us[True] - us[False],
            "glue_frac_of_kernel": (us[True] - us[False]) / us[False]}


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seqs", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--batches", type=int, nargs="+", default=[1024, 4096])
    ap.add_argument("--k", type=int, default=6144)
    ap.add_argument("--reps", type=int, default=48)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    rows = []
    for B in args.batches:
        for n in args.seqs:
            rows.append(measure(n, args.k, B, dev, args.reps))
            print(json.dumps(rows[-1]), flush=True)
    rec = {**run_meta(argv, dev), "K": args.k,
           "note": "per-shard per-half-iteration glue (the exchange's "
                   "shard-local gathers, the collective excluded) at the "
                   "chunk size each n_seq gives", "rows": rows}
    write_record(rec, out_path(args.out, "seq_glue"))
    return rec


if __name__ == "__main__":
    main()
