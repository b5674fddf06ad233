"""Boundary-metric ring exchange in one kernel: K6.

Counterpart of turbotpu/dist/dma.py.  Each iteration of the sequence-sharded
decoder ships every chunk's outgoing edges to its neighbours: the alpha edges
of both SISOs forward to seq shard s+1, the beta edges backward to s-1,
within each data row.  `boundary_exchange_dma` does both directions for
every shard of the mesh in one launch of csrc/ring_xch.cu; the reference's
version is one Pallas kernel with two remote DMAs in flight and a barrier
before the writes.  `boundary_exchange_plain` is the list rotation it must
equal, and what the wrapper runs on CPU tensors.

Buffers.  The kernel works on a device table of send and receive buffers
that the mesh keeps per payload shape (`ring_buffers`), as a peer-to-peer
exchange would work on registered (peer-mapped or symmetric) memory: a
caller that builds its payload straight into `send_fwd[i]` / `send_bwd[i]`
saves a copy, any other payload is copied there first.  The received lists
are the mesh's receive buffers: valid until the next exchange of that shape
on that mesh.  A flag buffer per shape carries the barrier and the exchange
count, both on the device: the flags only grow, ready flags read 2 x the
exchanges made after them.

An exchange is launched like a device operation: no host read.  A spin that
times out sets a sticky error flag instead; `check(mesh)` reads the flags of
every ring of the mesh (a host sync) and raises, and a caller makes it once,
after its loop of exchanges (the sequence-sharded decoder does so after its
iterations).

On a local mesh with CUDA tensors the wrapper launches the kernel or raises;
with CPU tensors it takes the plain version.  On a process mesh the plain
version is the send/recv pair of `Mesh.seq_ring` (CPU tensors); with CUDA
tensors there it raises NotImplementedError: a peer-to-peer kernel needs the
shards on two cards, with peer-mapped buffers in the table.
"""

from __future__ import annotations

import functools
import math

import torch

from .. import _build
from .._device import launch_on
from .mesh import Mesh

TARGET: _build.Target = ("ring_xch", ())
THREADS = 128
VEC = 4                           # 16-byte vectors per thread and direction
TIMEOUT_NS = 2_000_000_000        # a spin that outlasts this is a fault
_ERRORS = {1: "a shard's ring neighbours never signalled the barrier",
           2: "an incoming payload never landed"}
_ENTRY = _build.PackedEntry(TARGET, "turbotpu_ring_xch_launch", 9)

LAUNCHES = {"ring_xch": 0}


def boundary_exchange_plain(fwd: list, bwd: list, n_seq: int
                            ) -> tuple[list, list]:
    """The list rotation: shard i = d * n_seq + s receives fwd of
    (d, s-1) and bwd of (d, s+1), cyclically within its data row."""
    n = len(fwd)
    if n % n_seq or len(bwd) != n:
        raise ValueError(f"{n} forward and {len(bwd)} backward payloads for "
                         f"rows of {n_seq} shards")
    row = lambda i: i - i % n_seq
    return ([fwd[row(i) + (i % n_seq - 1) % n_seq] for i in range(n)],
            [bwd[row(i) + (i % n_seq + 1) % n_seq] for i in range(n)])


class RingBuffers:
    """Send and receive buffers of every shard of a local mesh for one
    payload shape and dtype, the kernel's pointer table over them, and its
    flags: ready[n], arrived[n], the error flag, and one exchange count per
    CTA (n x ctas; none on the CPU, where no kernel runs)."""

    def __init__(self, n: int, shape: tuple, dtype: torch.dtype,
                 device: torch.device):
        numel = math.prod(shape)
        nbytes = numel * torch.empty((), dtype=dtype).element_size()
        self.n = n
        self.n_vec = -(-nbytes // 16)          # the kernel copies 16 B at a time
        raw = [torch.zeros(self.n_vec * 16, dtype=torch.uint8, device=device)
               for _ in range(4 * n)]
        view = lambda b: b[:nbytes].view(dtype).view(shape)
        self.send_fwd = [view(b) for b in raw[:n]]
        self.send_bwd = [view(b) for b in raw[n:2 * n]]
        self.recv_fwd = [view(b) for b in raw[2 * n:3 * n]]
        self.recv_bwd = [view(b) for b in raw[3 * n:]]
        self._raw = raw
        self.table = torch.tensor([b.data_ptr() for b in raw],
                                  dtype=torch.int64, device=device)
        dev = self.table.device
        self.ctas = (ctas_per_shard(n, self.n_vec, dev.index)
                     if dev.type == "cuda" else 0)
        self.flags = torch.zeros(2 * n + 1 + n * self.ctas, dtype=torch.int32,
                                 device=device)

    @property
    def error(self) -> torch.Tensor:
        """The error flag (0: no exchange timed out), on the device."""
        return self.flags[2 * self.n]


def ring_buffers(mesh: Mesh, n: int, shape: tuple, dtype: torch.dtype
                 ) -> RingBuffers:
    """The mesh's buffers for n shards' payloads of `shape` and `dtype`."""
    key = ("ring_xch", n, tuple(shape), dtype)
    if key not in mesh.state:
        mesh.state[key] = RingBuffers(n, tuple(shape), dtype, mesh.device)
    return mesh.state[key]


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def ctas_per_shard(n: int, n_vec: int, index: int) -> int:
    """CTAs per shard: enough that each thread makes one round of VEC
    vectors per direction, at most one CTA per SM for the whole grid (the
    kernel's spin-waits need every CTA resident at once)."""
    most = _sm_count(index) // n
    if most < 1:
        raise ValueError(f"{n} shards do not fit one CTA each on "
                         f"{_sm_count(index)} SMs")
    return max(1, min(-(-n_vec // (THREADS * VEC)), most))


def launch(ring: RingBuffers, n_seq: int) -> None:
    """One exchange over the ring's buffers: send_* -> recv_* of the
    neighbours.  Asynchronous, and reads nothing back: a timeout sets the
    ring's error flag, which `check` reads."""
    rc = launch_on(ring.table.device.index, _ENTRY, ring.table.data_ptr(),
                   ring.flags.data_ptr(), ring.n, n_seq, ring.ctas,
                   ring.n_vec, THREADS, TIMEOUT_NS)
    if rc != 0:
        raise RuntimeError(f"ring_xch launch failed: cudaError {rc} "
                           f"({ring.n} shards, rows of {n_seq}, {ring.ctas} "
                           f"CTAs each)")
    LAUNCHES["ring_xch"] += 1


def check(mesh: Mesh) -> None:
    """Raise if an exchange on any of the mesh's ring buffers hit its
    timeout.  Reads the error flags back (a host sync), so a caller makes it
    once after its loop of exchanges.  The flags are sticky: a fault stays
    reported."""
    for ring in mesh.state.values():
        if isinstance(ring, RingBuffers):
            err = int(ring.error)
            if err:
                raise RuntimeError(
                    f"ring_xch timed out: {_ERRORS.get(err, err)}")


def boundary_exchange_dma(fwd: list, bwd: list, mesh: Mesh
                          ) -> tuple[list, list]:
    """Ring-shift every shard's fwd payload to seq shard s+1 and its bwd
    payload to s-1 (within data rows), both directions in one launch.

    fwd, bwd: one tensor per shard this process holds, in `mesh.shards`
    order, all of one shape and dtype.  Returns (fwd_received,
    bwd_received), equal to boundary_exchange_plain(fwd, bwd, mesh.seq)."""
    if len(fwd) != len(mesh.shards) or len(bwd) != len(fwd):
        raise ValueError(f"one payload per shard: {len(mesh.shards)} shards, "
                         f"{len(fwd)} forward, {len(bwd)} backward")
    x = fwd[0]
    if any(t.shape != x.shape or t.dtype != x.dtype or t.device != x.device
           for t in (*fwd, *bwd)):
        raise ValueError("all payloads must share one shape, dtype and device")
    if mesh.backend == "process":
        if x.device.type == "cuda":
            raise NotImplementedError(
                "boundary_exchange_dma on a process mesh needs the "
                "peer-to-peer form of the kernel, with the shards on a second "
                "card and peer-mapped buffers in its table; use "
                "boundary_xch='ppermute'")
        return mesh.seq_ring(fwd, bwd)
    if x.device.type == "cpu":
        return boundary_exchange_plain(fwd, bwd, mesh.seq)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    ring = ring_buffers(mesh, len(fwd), tuple(x.shape), x.dtype)
    for src, dst in ((fwd, ring.send_fwd), (bwd, ring.send_bwd)):
        for a, b in zip(src, dst):
            if a.data_ptr() != b.data_ptr():
                b.copy_(a)
    launch(ring, mesh.seq)
    return list(ring.recv_fwd), list(ring.recv_bwd)
