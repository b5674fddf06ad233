"""What the sequence decoder's chunk contract costs on one card: the plain
NII kernel against the boundary NII kernel, and the monolithic decode
against the seq=1 sharded decode.

Counterpart of experiments/seq_gap.py of the JAX package.  At the flagship
shape (K=6144, B=1024, window 256, bf16 streams, max-log), CUDA-event
timed:

* one half-iteration of `siso_nii` (K1, the monolithic contract) and of
  `siso_bnd_nii` (K4, the chunk contract with edges; one chunk holds the
  whole trellis), each call feeding the next its window table;
* the kernel-only decode: 12 half-iterations of each;
* the lean flagship decode (`harness.bench.flagship_config`) monolithic
  (`turbo_decode`) and through `decode_seq_sharded` on a 1 x 1 mesh.

If the boundary kernel costs what the plain one does, the gap between the
two decodes is the sharded loop's glue.

    python -m turbotpu_torch.experiments.seq_gap [--reps 64] [--out FILE]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .._device import resolve_device
from .common import need_card, out_path, run_meta, write_record

K, B, W, ITERS = 6144, 1024, 256, 6


def bench_kernel(boundary: bool, dev, reps: int = 64) -> float:
    """ms per half-iteration of the plain or the boundary NII kernel."""
    from ..harness.bench import event_ms
    from ..siso.cuda_kernel import _e0, _round_up, siso_cells
    KTp = _round_up(K + 3, W)
    rng = np.random.default_rng(0)
    ls, lp, la = (torch.from_numpy((rng.normal(size=(KTp, B)) * 4).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(3))
    e0 = _e0(B, dev)
    st = {"ck": torch.zeros((KTp // W, 8, B), device=dev), "edge": e0}

    def call():
        if boundary:
            _, st["ck"], st["edge"], _ = siso_cells(
                ls, lp, la, K, "maxlog", 0.75,
                nii_boundaries=(st["ck"], st["edge"], e0), window=W)
        else:
            _, st["ck"] = siso_cells(ls, lp, la, K, "maxlog", 0.75,
                                     nii_ckpt=st["ck"], window=W)
    return event_ms(call, reps)


def main(argv=None, device="cuda") -> dict:
    from ..decoder.turbo import turbo_decode
    from ..dist.mesh import make_mesh
    from ..dist.seq_parallel import decode_seq_sharded
    from ..harness.bench import event_ms, flagship_config, make_decode_inputs
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=64)
    ap.add_argument("--timed", type=int, default=16)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    need_card(dev, "seq_gap")
    ta = bench_kernel(False, dev, args.reps)
    tb = bench_kernel(True, dev, args.reps)
    cfg = flagship_config()
    inputs = tuple(x.to(dev) for x in make_decode_inputs(K, B))
    sharded = decode_seq_sharded(make_mesh(1, 1, device=dev), cfg)
    decodes = {"monolithic": lambda: turbo_decode(*inputs, cfg, device=dev),
               "seq1": lambda: sharded(*inputs)}
    ms = {k: [] for k in decodes}
    for k in ("monolithic", "seq1", "seq1", "monolithic"):    # in turns
        ms[k].append(event_ms(decodes[k], args.timed))
    rec = {**run_meta(argv, dev), "K": K, "B": B, "window": W,
           "iters": ITERS, "config": "flagship_config(), lean",
           "plain_nii_ms_per_half_iter": ta,
           "boundary_nii_ms_per_half_iter": tb,
           "kernel_contract_overhead_pct": 100 * (tb - ta) / ta,
           "kernel_only_decode_ms": {"plain": 2 * ITERS * ta,
                                     "boundary": 2 * ITERS * tb},
           "decode_ms": ms,
           "seq1_over_monolithic": (min(ms["seq1"])
                                    / min(ms["monolithic"]))}
    print(json.dumps(rec), flush=True)
    write_record(rec, out_path(args.out, "seq_gap"))
    return rec


if __name__ == "__main__":
    main()
