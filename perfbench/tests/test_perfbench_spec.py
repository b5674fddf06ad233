"""The benchmark's frozen 3GPP tables, its generator and its count of a
SISO's work, on the CPU."""

import numpy as np
import pytest
import torch

from pbtestlib import REPO  # noqa: F401  (puts the checkout on sys.path)
from perfbench.harness import gen, roofline, spec


def test_segmentation_and_split_of_the_peak_pusch_block():
    """TS 36.212 5.1.2 and 5.1.4.1.2 for A = 75376, G = 86400, Qm = 6:
    B = 75400, C = 13, B' = 75712 = 13 x 5824, no filler; G' = 14400,
    gamma = 14400 mod 13 = 9, so 4 blocks of 6 x 1107 and 9 of 6 x 1108."""
    seg, layout = gen.block_layout(75376, 86400, 6)
    assert (seg.B, seg.C, seg.K_plus, seg.C_minus, seg.F) == \
        (75400, 13, 5824, 0, 0)
    assert [E for _, E, _ in layout] == [6642] * 4 + [6648] * 9
    assert sum(E for _, E, _ in layout) == 86400
    assert sum(n for _, n in seg.chunks()) == 75400
    assert gen.runs(layout) == [(0, 4), (4, 13)]
    assert spec.QPP[6144] == (263, 480) and spec.QPP[5824] == (89, 182)


@pytest.mark.parametrize("B", [40, 300, 6144, 6145, 12000, 75400, 100000])
def test_segmentation_matches_the_port(B):
    from turbotpu_torch.spec.segmentation import segment_params
    p, q = segment_params(B), spec.segment(B)
    assert (p.C, p.K_plus, p.K_minus, p.F, p.sizes) == \
        (q.C, q.K_plus, q.K_minus, q.F, q.sizes)


@pytest.mark.parametrize("K,E,rv,F", [(5824, 6642, 0, 0), (5824, 6648, 0, 0),
                                      (40, 200, 1, 8), (512, 3000, 3, 0),
                                      (40, 400, 2, 0)])
def test_bit_selection_matches_the_port(K, E, rv, F):
    from turbotpu_torch.spec.rate_match import select_indices
    assert (spec.selection(K, E, rv, F) == select_indices(K, E, rv, None, F)
            ).all()


def test_crc_and_qpp_match_the_port():
    from turbotpu_torch.spec import crc, qpp
    bits = np.random.default_rng(1).integers(0, 2, 300)
    for poly in (spec.CRC24A, spec.CRC24B):
        assert (spec.crc24(bits, poly) == crc.crc24(bits, poly)).all()
        assert (spec.crc_parity_matrix(300, poly) == crc.crc_matrix(300, poly)
                ).all()
    for K in (40, 5824, 6144):
        assert (spec.qpp_perm(K) == qpp.qpp_perm(K)).all()


def test_encoder_matches_the_golden_model():
    from turbotpu_torch.golden import numpy_ref
    bits = torch.randint(0, 2, (5, 104), generator=torch.Generator()
                         .manual_seed(3), dtype=torch.int8)
    mine = gen.turbo_encode(bits)
    for i in range(5):
        ref = numpy_ref.turbo_encode(bits[i].numpy(), spec.qpp_perm(104))
        for a, b in zip(mine, ref):
            assert (a[i].numpy() == b).all()
    d = gen.d_streams(*mine)
    d0, d1, d2 = numpy_ref.lte_mux(*(x[0].numpy() for x in mine))
    assert (d[0].numpy() == np.concatenate([d0, d1, d2])).all()
    assert (gen.crc_attach(bits, spec.CRC24A)[2, 104:].numpy()
            == spec.crc24(bits[2].numpy(), spec.CRC24A)).all()


def test_generator_is_deterministic_in_the_seed():
    def make(seed):
        g = torch.Generator().manual_seed(seed % 2 ** 64)
        return gen.transport_blocks(g, 3, 250, 600, 2, 2.0)
    (a, ta), (b, tb), (c, _) = make(2 ** 31 + 5), make(2 ** 31 + 5), make(6)
    assert (ta == tb).all()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    # the block's CRC-24A holds over the transmitted bits
    assert all((spec.crc24(t[:-24].numpy(), spec.CRC24A) == t[-24:].numpy())
               .all() for t in ta)


def test_siso_work_counted_by_hand():
    """One iteration of one codeword of K = 5 (two half-iterations of 8
    steps with the termination): 84 operations a step, and 2 bf16 channel
    streams plus the int8 a-priori and extrinsic, 6 bytes a step."""
    d = {"io_dtype": "bfloat16", "ext_dtype": "int8"}
    assert roofline.OPS_PER_STEP == 3 + 8 * 3 + 8 * 3 + 2 * (8 + 6 + 1 + 1) + 1
    assert roofline.siso_work(1, 5, d) == (84 * 8 * 2, 6 * 8 * 2)
    assert roofline.siso_work(6, 5, {"io_dtype": "float32",
                                     "ext_dtype": ""})[1] == 16 * 8 * 2 * 6
    pk = {"fp32_ops_per_s": 100.0, "hbm_bytes_per_s": 10.0}
    assert roofline.least_seconds(1000.0, 50.0, pk) == 10.0
    assert roofline.least_seconds(100.0, 50.0, pk) == 5.0
    assert roofline.peak("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12


def test_roofline_counts_each_codewords_own_iterations():
    """An early-terminated batch runs until its slowest codeword is done;
    the roofline's work counts what each codeword needed (1 + 3 + 6 + 6
    iterations over the two traced batches), not codewords x the batch's
    largest count (2 x 3 + 2 x 6)."""
    from types import SimpleNamespace

    from perfbench import run
    d = {"io_dtype": "bfloat16", "ext_dtype": "int8"}
    trace = SimpleNamespace(n_batches=2, device_us=lambda select: 1e6)
    ops = 84 * 8 * 2 * 16.0
    fake = SimpleNamespace(
        trace=trace, traced=range(1, 3),
        iters=[torch.tensor([6, 6]), torch.tensor([1, 3]),
               torch.tensor([6, 6])],
        peak=lambda: {"fp32_ops_per_s": 4 * ops, "hbm_bytes_per_s": 1e30},
        cell=SimpleNamespace(K=5, decoder_settings=lambda: d))
    assert run.read_metric(REPO, "siso_roofline", fake) == 25.0
