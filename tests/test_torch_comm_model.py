"""The communication model of the evidence layer
(turbotpu_torch/experiments/comm_model.py) against the JAX package's
experiments/comm_model.py, and the counting mesh against the routing
tables, on the CPU.
"""

import importlib.util
import sys
from pathlib import Path

import pytest

from turbotpu_torch.experiments import comm_model as cm

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_cm():
    if str(REPO / "experiments") not in sys.path:
        sys.path.insert(0, str(REPO / "experiments"))
    spec = importlib.util.spec_from_file_location(
        "jax_experiments_comm_model", REPO / "experiments" / "comm_model.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n_seq", [2, 4, 8])
@pytest.mark.parametrize("K", [6144, 320])
def test_exchange_volume_equals_jax(jax_cm, K, n_seq):
    """Row counts and bytes exactly equal: both come from the decoders'
    routing tables at their own chunk geometry."""
    for dtype_bytes in (2, 1):
        assert cm.exchange_volume(K, n_seq, dtype_bytes) == \
            jax_cm.exchange_volume(K, n_seq, dtype_bytes)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(dtype_bytes=1),
    dict(dtype_bytes=1, overlap_groups=4),
    dict(glue_us_per_half_iter=37.5, overlap_groups=2),
])
@pytest.mark.parametrize("n_seq", [2, 8])
def test_scaling_model_equals_jax_given_the_same_constants(jax_cm, n_seq, kw):
    """Given the same link rate, flagship rate and glue, every float of the
    model is equal (tolerance 0)."""
    consts = dict(link_gbytes=123.0, flagship_gbit_s=2.5, **kw)
    assert cm.scaling_model(6144, 1024, n_seq, **consts) == \
        jax_cm.scaling_model(6144, 1024, n_seq, **consts)


def test_scaling_model_needs_a_measured_rate():
    with pytest.raises(ValueError, match="flagship_gbit_s"):
        cm.scaling_model(6144, 1024, 4)
    assert cm.scaling_model(6144, 1024, 4, flagship_gbit_s=1.0)[
        "link_gbytes_per_s"] == cm.NVLINK_GBYTES_PER_DIRECTION


@pytest.mark.parametrize("data", [1, 2])
def test_counted_all_to_all_bytes_equal_exchange_volume(data):
    """One iteration of the sequence decoder on a counting local CPU mesh at
    K=320, n_seq=4: two all_to_alls whose bytes per shard are
    exchange_volume's bytes per codeword-iteration times the shard's
    codewords (bf16 extrinsics), exactly; the edges (4 of 8 fp32 a codeword)
    and the CRC syndrome (24 fp32) as the model counts them."""
    B = 8
    b_row = B // data
    got = cm.collective_counts(K=320, n_seq=4, data=data, B=B, device="cpu")
    vol = cm.exchange_volume(320, 4, 2)["bytes_per_cw_iter"]
    assert got["all_to_all"] == {"calls": 2, "bytes_per_shard": vol * b_row}
    assert got["seq_ring"] == {"calls": 2,
                               "bytes_per_shard": 4 * 8 * 4 * b_row}
    assert got["seq_sum"] == {"calls": 1, "bytes_per_shard": 24 * 4 * b_row}
    assert got["data_sum"] == {"calls": 1,
                               "bytes_per_shard": 8 if data > 1 else 0}
    assert "seq_all_gather" not in got          # assembly is after the loop


def test_counting_mesh_counts_nothing_across_one_shard():
    mesh = cm.CountingMesh(1, 1, "cpu")
    import torch
    x = [torch.zeros(4, 3)]
    mesh.seq_ring(x, x)
    mesh.seq_sum(x)
    mesh.seq_all_to_all(x)
    assert mesh.counts == {"seq_ring": [1, 0], "seq_sum": [1, 0],
                           "all_to_all": [1, 0]}
