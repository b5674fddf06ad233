"""Multi-process bring-up of the process mesh.

Counterpart of turbotpu/dist/multihost.py.  One process per shard of a
(data, seq) mesh; `init_distributed()` initialises torch.distributed from
arguments or the same environment names as the reference, and each process
makes only its own data row's batch: no input crosses processes, the
collectives carry boundary metrics, extrinsic buckets and counters only.

With nothing given and nothing in the environment everything stays a
single process, so the same harness code runs on one card.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as tdist

from .mesh import Mesh


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> bool:
    """Initialise torch.distributed from the arguments or the environment;
    returns True if more than one process takes part.

    Environment fallbacks: TURBOTPU_COORDINATOR (host:port of rank 0's
    store), TURBOTPU_NUM_PROCS, TURBOTPU_PROC_ID.  backend defaults to nccl
    with a card, else gloo.  With neither a coordinator nor a process count,
    an already initialised process group is used as it is, and otherwise
    nothing is initialised."""
    coordinator = coordinator or os.environ.get("TURBOTPU_COORDINATOR")
    if num_processes is None and "TURBOTPU_NUM_PROCS" in os.environ:
        num_processes = int(os.environ["TURBOTPU_NUM_PROCS"])
    if process_id is None and "TURBOTPU_PROC_ID" in os.environ:
        process_id = int(os.environ["TURBOTPU_PROC_ID"])
    if coordinator is None and num_processes is None:
        return tdist.is_initialized() and tdist.get_world_size() > 1
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("init_distributed needs the coordinator, the number "
                         "of processes and this process's id")
    if not tdist.is_initialized():
        backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
        tdist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                 world_size=num_processes, rank=process_id)
    return tdist.get_world_size() > 1


def host_local_batch(global_batch: int, mesh: Mesh | None = None) -> int:
    """Codewords this process must make for a 'data'-sharded global batch:
    its data row's share on a process mesh (a row's seq shards hold the same
    codewords), all of them on a local mesh.  Without a mesh: the share of
    one process among all of them."""
    if mesh is not None:
        n = mesh.data if mesh.backend == "process" else 1
    else:
        n = tdist.get_world_size() if tdist.is_initialized() else 1
    if global_batch % n:
        raise ValueError(f"a batch of {global_batch} does not split over {n}")
    return global_batch // n


def make_global_array(local: np.ndarray, mesh: Mesh) -> torch.Tensor:
    """This process's share of a batch as a tensor on the mesh's device.

    The reference assembles per-host shards into one jax.Array that spans
    the mesh's devices.  A torch tensor lives on one device of one process,
    and nothing spans processes: so on a process mesh the rank keeps its own
    shard (its data row's rows), and the decoders' collectives combine
    results; on a local mesh the "global array" is the whole batch on the
    one device."""
    return torch.as_tensor(np.asarray(local)).to(mesh.device)
