"""The (data, seq) grid of the sharded decoders.

Counterpart of turbotpu/dist/mesh.py.  'data' shards the codeword batch;
'seq' shards each codeword's trellis into chunks (dist/seq_parallel.py).  Two
backends run the same decode code:

* local: every (data, seq) shard lives in this process, on one explicit
  device.  A collective is a tensor operation over the shards' tensors: the
  ring exchange rotates a list, the all_to_all rearranges buckets, the
  reductions add in a fixed order.  One card runs the sharded decoders this
  way; the JAX package's tests run them on 8 fake CPU devices.
* process: one shard per rank of torch.distributed (initialised by the
  caller, e.g. dist/multihost.init_distributed); rank d * seq + s holds shard
  (d, s), row-major as dist/dma.py numbers its shards.  The groups of the data
  rows and of the seq columns come from torch.distributed.new_group: every
  rank creates every group, in the same order.

The decoders keep one entry per shard this process holds, in lists ordered
as `mesh.shards` (row-major), and call the collectives below on such lists.
The process backend moves tensors as bytes, so every dtype rides every
collective backend.
"""

from __future__ import annotations

import torch
import torch.distributed as tdist

from .._device import resolve_device


class Mesh:
    """A (data, seq) grid; see the module docstring.  `shards` lists the
    (d, s) this process holds; `state` keeps the buffers of kernels that
    reuse them across calls (dist/dma.py)."""

    def __init__(self, data: int, seq: int, backend: str, device):
        if data < 1 or seq < 1:
            raise ValueError(f"mesh {data}x{seq}: both axes need a shard")
        if backend not in ("local", "process"):
            raise ValueError(f"unknown mesh backend {backend!r}")
        self.data, self.seq, self.backend = data, seq, backend
        self.device = resolve_device(device)
        self.state: dict = {}
        if backend == "local":
            self.shards = [(d, s) for d in range(data) for s in range(seq)]
            return
        if not tdist.is_initialized():
            raise RuntimeError("a process mesh needs torch.distributed "
                               "initialised (dist/multihost.init_distributed)")
        world = tdist.get_world_size()
        if world != data * seq:
            raise ValueError(f"mesh {data}x{seq} needs {data * seq} ranks, "
                             f"the world has {world}")
        rank = tdist.get_rank()
        self.shards = [(rank // seq, rank % seq)]
        # every rank creates every group, rows first, in the same order
        rows = [tdist.new_group([d * seq + s for s in range(seq)])
                for d in range(data)]
        cols = [tdist.new_group([d * seq + s for d in range(data)])
                for s in range(seq)]
        self._seq_group = rows[rank // seq]
        self._data_group = cols[rank % seq]

    @property
    def shape(self) -> dict:
        return {"data": self.data, "seq": self.seq}

    def rank_of(self, d: int, s: int) -> int:
        return d * self.seq + s

    # -- collectives over the shards' lists ---------------------------------

    def seq_ring(self, fwd: list, bwd: list) -> tuple[list, list]:
        """The ring shift along seq (the reference's ppermute pair): shard
        (d, s) receives fwd of (d, s-1) and bwd of (d, s+1), cyclically."""
        n = self.seq
        if self.backend == "local":
            return ([fwd[i - i % n + (i % n - 1) % n] for i in range(len(fwd))],
                    [bwd[i - i % n + (i % n + 1) % n] for i in range(len(bwd))])
        if n == 1:
            return list(fwd), list(bwd)
        d, s = self.shards[0]
        nxt, prv = self.rank_of(d, (s + 1) % n), self.rank_of(d, (s - 1) % n)
        x, y = (_bytes(t[0]) for t in (fwd, bwd))
        rx, ry = torch.empty_like(x), torch.empty_like(y)
        ops = [tdist.P2POp(tdist.isend, x, nxt, tag=1),
               tdist.P2POp(tdist.isend, y, prv, tag=2),
               tdist.P2POp(tdist.irecv, rx, prv, tag=1),
               tdist.P2POp(tdist.irecv, ry, nxt, tag=2)]
        for req in tdist.batch_isend_irecv(ops):
            req.wait()
        return [_unbytes(rx, fwd[0])], [_unbytes(ry, bwd[0])]

    def seq_all_to_all(self, bufs: list) -> list:
        """Tiled all_to_all along seq on dim 0: each shard's buffer is seq
        equal buckets; bucket k goes to seq shard k, and shard j's result is
        the buckets addressed to it, in the senders' order."""
        n = self.seq
        if n == 1:
            return list(bufs)
        if self.backend == "local":
            out = []
            for i in range(len(bufs)):
                row, j = i - i % n, i % n
                M = bufs[i].shape[0] // n
                out.append(torch.cat([bufs[row + s][j * M:(j + 1) * M]
                                      for s in range(n)]))
            return out
        x = _bytes(bufs[0])
        y = torch.empty_like(x)
        tdist.all_to_all_single(y, x, group=self._seq_group)
        return [_unbytes(y, bufs[0])]

    def seq_sum(self, xs: list) -> list:
        """Sum over each seq row; every shard of a row gets the sum."""
        n = self.seq
        if self.backend == "local":
            out = []
            for row in range(0, len(xs), n):
                total = xs[row]
                for s in range(1, n):
                    total = total + xs[row + s]
                out.extend([total] * n)
            return out
        y = xs[0].clone()
        tdist.all_reduce(y, group=self._seq_group)
        return [y]

    def data_sum(self, xs: list) -> list:
        """Sum over each data column (the shards with the same s)."""
        n = self.seq
        if self.backend == "local":
            cols = []
            for s in range(n):
                total = xs[s]
                for row in range(n, len(xs), n):
                    total = total + xs[row + s]
                cols.append(total)
            return [cols[i % n] for i in range(len(xs))]
        y = xs[0].clone()
        tdist.all_reduce(y, group=self._data_group)
        return [y]

    def seq_all_gather(self, xs: list) -> list:
        """Concatenation along dim 0 of each seq row's tensors, in seq order;
        every shard of a row gets it."""
        n = self.seq
        if self.backend == "local":
            out = []
            for row in range(0, len(xs), n):
                whole = torch.cat(xs[row:row + n]) if n > 1 else xs[row]
                out.extend([whole] * n)
            return out
        if n == 1:
            return list(xs)
        x = _bytes(xs[0])
        parts = [torch.empty_like(x) for _ in range(n)]
        tdist.all_gather(parts, x, group=self._seq_group)
        return [torch.cat([_unbytes(p, xs[0]) for p in parts])]

    # -- batches over the data rows ----------------------------------------

    def row_batches(self, x: torch.Tensor) -> dict:
        """The batch rows of each data row held here, by row: a local mesh
        splits the global batch evenly; a process mesh's input is already its
        row's batch."""
        if self.backend == "process":
            return {self.shards[0][0]: x}
        if x.shape[0] % self.data:
            raise ValueError(f"a batch of {x.shape[0]} does not split over "
                             f"{self.data} data rows")
        n = x.shape[0] // self.data
        return {d: x[d * n:(d + 1) * n] for d in range(self.data)}

    @property
    def leaders(self) -> list[int]:
        """Indices into `shards` of the first shard of each data row held
        here, in row order."""
        return [i for i, (_, s) in enumerate(self.shards)
                if s == self.shards[0][1]]

    def assemble(self, per_row: list, dim: int = 0) -> torch.Tensor:
        """One tensor per data row held here, in row order, concatenated
        along the batch axis `dim`: the inverse of row_batches."""
        return per_row[0] if len(per_row) == 1 else torch.cat(per_row, dim)


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor as its bytes, (rows, bytes per row): what the
    process backend sends, whatever the dtype."""
    t = t.contiguous()
    return t.reshape(t.shape[0] if t.dim() else 1, -1).view(torch.uint8)


def _unbytes(b: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Bytes back to `like`'s dtype and trailing shape (rows may differ)."""
    return b.view(like.dtype).reshape((-1,) + tuple(like.shape[1:]))


def make_mesh(data: int | None = None, seq: int = 1, backend: str = "local",
              device="cuda") -> Mesh:
    """The (data, seq) mesh.  local: every shard in this process on `device`
    (data defaults to 1); process: one shard per rank of the initialised
    torch.distributed world (data defaults to world // seq), its tensors on
    `device`."""
    if data is None:
        data = 1 if backend == "local" else tdist.get_world_size() // seq
    return Mesh(data, seq, backend, device)
