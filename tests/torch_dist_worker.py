"""The process side of test_torch_dist.py's multi-process test: one rank of
a (data, seq) process mesh over gloo on the CPU.

Imports torch and turbotpu_torch only, so that processes spawned with it do
not load JAX (they do not run the tests' conftest either).  Each rank
decodes its data row's codewords with every configuration of CONFIGS, counts
errors, and saves what it got for the parent to compare with the local
mesh's decode.
"""

import sys

import torch
import torch.distributed as tdist

from turbotpu_torch import DecoderConfig
from turbotpu_torch.dist.data_parallel import (count_errors_sharded,
                                               decode_batch_sharded)
from turbotpu_torch.dist.mesh import make_mesh
from turbotpu_torch.dist.seq_parallel import decode_seq_sharded
from turbotpu_torch.harness.bench import make_decode_inputs

K, B = 168, 4
KERNEL = dict(K=K, n_iters=3, mode="maxlog", ext_scale=0.75, siso="cuda")
CONFIGS = {
    "cells-exact-crc": DecoderConfig(**KERNEL, io_dtype="bfloat16",
                                     ext_dtype="int8", early_term="crc"),
    "cells-nii-dma": DecoderConfig(**KERNEL, nii=True, window=16,
                                   boundary_xch="dma"),
    "scan-sign": DecoderConfig(K=K, n_iters=3, mode="maxlog",
                               early_term="sign"),
}


def batch():
    """The global batch: five (B, K)/(B, 6) tensors and the sent bits."""
    return make_decode_inputs(K, B, seed=12, ebn0_db=1.5, with_crc=True,
                              return_bits=True)


def run(rank: int, world: int, store_path: str, out_dir: str, data: int,
        seq: int) -> None:
    assert "jax" not in sys.modules, "a spawned rank loaded JAX"
    tdist.init_process_group("gloo", store=tdist.FileStore(store_path, world),
                             rank=rank, world_size=world)
    try:
        mesh = make_mesh(data, seq, backend="process", device="cpu")
        d, _ = mesh.shards[0]
        inputs, bits = batch()
        rows = slice(d * B // data, (d + 1) * B // data)
        mine = [x[rows] for x in inputs]
        out = {name: decode_seq_sharded(mesh, cfg)(*mine)
               for name, cfg in CONFIGS.items()}
        hard, _, _ = decode_batch_sharded(mesh, CONFIGS["scan-sign"])(*mine)
        out["data_parallel_hard"] = hard
        out["counts"] = count_errors_sharded(mesh)(
            out["cells-exact-crc"][0], torch.from_numpy(bits[rows]))
        torch.save(out, f"{out_dir}/rank{rank}.pt")
    finally:
        tdist.destroy_process_group()
