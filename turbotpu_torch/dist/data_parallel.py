"""Data-parallel batched decode: the codeword batch split over the 'data'
axis of a mesh.

Counterpart of turbotpu/dist/data_parallel.py.  Each data row decodes its
codewords with the monolithic `turbo_decode` (codewords do not couple);
error counts are summed over data, so every shard sees the global counts
without gathering decoded bits.  On a local mesh the rows run one after the
other on the mesh's device; on a process mesh each rank decodes its own
row's batch.
"""

from __future__ import annotations

import torch

from ..decoder.turbo import DecoderConfig, turbo_decode
from .mesh import Mesh


def decode_batch_sharded(mesh: Mesh, cfg: DecoderConfig):
    """fn(ls, lp1, lp2, tail1, tail2) -> (hard, iters, L), the batch split
    over data (and replicated over seq: a seq column decodes the same rows,
    so each row is decoded once).  Local mesh: the whole batch in and out;
    process mesh: this rank's row's batch."""

    def fn(ls, lp1, lp2, t1, t2):
        args = [torch.as_tensor(x).to(mesh.device) for x in
                (ls, lp1, lp2, t1, t2)]
        rows = [mesh.row_batches(x) for x in args]
        per_row = [turbo_decode(*(r[d] for r in rows), cfg,
                                device=mesh.device) for d in rows[0]]
        return tuple(mesh.assemble([o[k] for o in per_row])
                     for k in range(3))

    return fn


def count_errors_sharded(mesh: Mesh):
    """fn(hard, ref) -> (bit_errs, frame_errs), global counts as int64
    tensors: each row's counts, summed over data."""

    def fn(hard, ref):
        hard = torch.as_tensor(hard).to(mesh.device)
        ref = torch.as_tensor(ref).to(device=mesh.device, dtype=hard.dtype)
        rows_h, rows_r = mesh.row_batches(hard), mesh.row_batches(ref)
        counts = []
        for d, _ in mesh.shards:
            wrong = rows_h[d] != rows_r[d]
            counts.append(torch.stack([wrong.sum(), wrong.any(dim=1).sum()]))
        # Inputs are REPLICATED over 'seq' (every seq shard holds the same
        # rows and computes the same local count), so the reduction runs
        # over 'data' only -- summing over 'seq' too would multiply the
        # counts by n_seq (the reference marks the grave of that bug: it
        # inflated FER above 1.0 on seq>1 meshes).  The sum over 'data'
        # already leaves the result identical on every shard.
        total = mesh.data_sum(counts)[0]
        return total[0], total[1]

    return fn
