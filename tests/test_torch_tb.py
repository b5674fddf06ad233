"""The port's transport-block chain against the JAX package's, on the CPU.

Segmentation, the host pipeline (`transport.py`) and the device-side sweep
(`harness/tb.py`).  The two packages draw different random numbers, so the
deterministic stages are held bit-identical on the same inputs, the decoders
are fed the same LLRs (the JAX package's numpy transmit chain, or the port's
frames pushed through the JAX decoder), and the sweep itself is held to zero
errors at high SNR.  The scan SISO keeps the JAX side's compiles short.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax.numpy as jnp
import torch

import configs.acceptance as jacc
from turbotpu import transport as jtp
from turbotpu.decoder.turbo import DecoderConfig as JaxDecoder
from turbotpu.decoder.turbo import turbo_decode as jax_decode
from turbotpu.harness import tb as jtb
from turbotpu.spec import segmentation as jseg
from turbotpu_torch import cli
from turbotpu_torch import transport as ttp
from turbotpu_torch.configs import acceptance as tacc
from turbotpu_torch.convert import tb_config_from_dict
from turbotpu_torch.golden import numpy_ref as tref
from turbotpu_torch.harness import tb as ttb
from turbotpu_torch.spec import segmentation as tseg
from turbotpu_torch.spec.crc import CRC24A_POLY, CRC24B_POLY, crc_attach, crc_check


@pytest.mark.parametrize("B", [40, 100, 6144, 6145, 10000, 20000])
def test_segmentation_matches_jax(B):
    want, got = jseg.segment_params(B), tseg.segment_params(B)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert sum(got.sizes) == B + got.F + (24 * got.C if got.C > 1 else 0)
    bits = np.random.default_rng(B).integers(0, 2, B).astype(np.int8)
    j_blocks, t_blocks = jseg.segment(bits), tseg.segment(bits)
    assert len(t_blocks) == got.C
    for a, b in zip(j_blocks, t_blocks):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tseg.desegment(t_blocks, B), bits)
    assert ttb.chunk_layout(got) == jtb.chunk_layout(want)


def test_per_block_e_and_mux_match_jax():
    for G, C in ((24000, 2), (24001, 2), (10, 3), (40000, 4), (7, 7)):
        for q_m in (1, 2, 6):
            assert ttp.per_block_e(G, C, q_m) == jtp.per_block_e(G, C, q_m)
            assert sum(ttp.per_block_e(G, C, q_m)) <= G
    from turbotpu.golden import numpy_ref as jref
    rng = np.random.default_rng(0)
    parts = [rng.normal(size=n).astype(np.float32) for n in (40, 40, 40, 6, 6)]
    for a, b in zip(tref.lte_mux(*parts), jref.lte_mux(*parts)):
        np.testing.assert_array_equal(a, b)
    back = tref.lte_demux(*tref.lte_mux(*parts))
    for a, b in zip(back, parts):
        np.testing.assert_array_equal(a, b)


def test_tb_encode_blocks_is_bit_identical_to_jax():
    """A=6128: C=2 with two block sizes (3072, 3136) and F=8 fillers."""
    A, n = 6128, 3
    seg = tseg.segment_params(A + 24)
    assert seg.sizes == (3072, 3136) and seg.F == 8
    rng = np.random.default_rng(1)
    tb = np.stack([crc_attach(rng.integers(0, 2, A).astype(np.int8),
                              CRC24A_POLY) for _ in range(n)])
    got = ttb.tb_encode_blocks(torch.from_numpy(tb), seg)
    want = jtb.tb_encode_blocks(jnp.asarray(tb), jseg.segment_params(A + 24))
    for r, ((blk_t, d_t), (blk_j, d_j)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(blk_t.numpy(), np.asarray(blk_j))
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
        assert d_t.dtype == torch.float32
        assert d_t.shape == (n, 3 * seg.sizes[r] + 12)
        for row, blocks in zip(blk_t.numpy(), (tseg.segment(t) for t in tb)):
            np.testing.assert_array_equal(row, blocks[r])


@pytest.mark.parametrize("G,rv", [(None, 0), (13000, (0, 2))])
def test_decode_transport_block_matches_jax(G, rv):
    """Both packages' decode_transport_block on the LLRs of the JAX
    package's numpy transmit chain (A=6200, C=2), at the mother rate and
    rate-matched with HARQ: same info bits, CRC verdicts and iteration
    counts."""
    A = 6200
    info = np.random.default_rng(2).integers(0, 2, A).astype(np.int8)
    llr, seg = jtp.transmit_transport_block(info, 2.0, seed=5, G=G, rv=rv)
    t_llr, t_seg = ttp.transmit_transport_block(info, 2.0, seed=5, G=G, rv=rv)
    assert dataclasses.asdict(t_seg) == dataclasses.asdict(seg)
    for a, b in zip(llr, t_llr):          # the numpy chain is the same code
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    kw = dict(n_iters=4, mode="maxlog", siso="scan",
              rate_matched=G is not None, rv=rv)
    info_j, ok_j, det_j = jtp.decode_transport_block(llr, seg.B, **kw)
    info_t, ok_t, det_t = ttp.decode_transport_block(llr, seg.B, device="cpu",
                                                     **kw)
    np.testing.assert_array_equal(info_t, info_j)
    np.testing.assert_array_equal(info_t, info)
    assert ok_t and ok_t == ok_j
    assert det_t["block_crc_ok"] == det_j["block_crc_ok"] == [True, True]
    np.testing.assert_array_equal(det_t["iters"], det_j["iters"])
    assert (det_t["iters"] < 4).all()
    with pytest.raises(ValueError, match="code blocks"):
        ttp.decode_transport_block(llr[:1], seg.B, device="cpu", **kw)


TB = ttb.TBConfig(name="t", A=6128, n_tb=2, n_iters=4, siso="scan", seed=4,
                  G=12400, max_tbs=2, min_tb_errors=10 ** 9)


def test_the_ports_frames_through_the_jax_decoder():
    """step.gen's streams through the JAX turbo_decode with the grouped
    tables and the converted decoder configuration: hard bits and
    iteration counts equal to step.decode; step.tally equal to a numpy
    tally through the host-side desegment and CRC."""
    step = ttb.make_tb_step(TB, "cpu")
    seg = TB.seg()
    esn0 = ttb.tb_esn0_db(TB, 0.4)
    streams, tb = step.gen(ttb.point_generator(TB, 0.4, "cpu"), esn0)
    assert streams[0].shape == (2 * seg.C, max(seg.sizes))
    assert tb.shape == (2, seg.B)
    hard, iters = step.decode(streams)
    jcfg = JaxDecoder(**{**dataclasses.asdict(step.decoder), "siso": "scan"})
    assert jcfg.crc_poly == CRC24B_POLY and jcfg.early_term == "crc"
    hj, ij, _ = jax_decode(*(jnp.asarray(s.numpy()) for s in streams), jcfg,
                           group_tables=tuple(jnp.asarray(t.numpy())
                                              for t in step.group_tables))
    np.testing.assert_array_equal(hard.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(iters.numpy(), np.asarray(ij))

    # numpy tally: strip the bucket embedding, desegment, compare, CRC-24A
    bucket = max(seg.sizes)
    bit_errs = tb_errs = crc_fails = 0
    for t in range(TB.n_tb):
        blocks = [hard.numpy()[r * TB.n_tb + t, bucket - K:]
                  for r, K in enumerate(seg.sizes)]
        tb_hat = tseg.desegment(blocks, seg.B)
        err = tb_hat != tb.numpy()[t]
        bit_errs += int(err[:TB.A].sum())
        tb_errs += int(err.any())
        crc_fails += int(not crc_check(tb_hat, CRC24A_POLY))
    want = [bit_errs, tb_errs, crc_fails, int(iters.sum()), int(iters.max())]
    assert step.tally(hard, iters, tb).tolist() == want
    assert step.count(streams, tb).tolist() == want
    assert tb_errs > 0 and crc_fails == tb_errs    # 0.4 dB: errors to count


@pytest.mark.parametrize("kw", [dict(G=0), dict(G=12400),
                                dict(G=9000, rv_sequence=(0, 2))],
                         ids=["mother-rate", "rate-matched", "harq"])
def test_simulate_tb_point_is_error_free_at_high_snr(kw):
    cfg = dataclasses.replace(TB, n_tb=1, max_tbs=1, **kw)
    rec = ttb.simulate_tb_point(cfg, 4.0, device="cpu")
    assert rec["tbs"] == 1 and rec["bits"] == cfg.A and rec["C"] == 2
    assert (rec["K_minus"], rec["K_plus"], rec["F"]) == (3072, 3136, 8)
    assert rec["bit_errs"] == rec["tb_errs"] == rec["crc24a_fails"] == 0
    assert rec["avg_iters"] < cfg.n_iters and rec["iter_batches"] >= 1
    assert rec["device"] == "cpu" and np.isfinite(rec["mbit_per_s"])
    assert all(isinstance(rec[k], int) for k in
               ("bit_errs", "tb_errs", "crc24a_fails", "tbs", "iter_batches"))


def test_tb_config_carries_over():
    fields = lambda c: [(f.name, f.default) for f in dataclasses.fields(c)
                        if f.name != "siso"]
    assert fields(ttb.TBConfig) == fields(jtb.TBConfig)
    got = tb_config_from_dict(dataclasses.asdict(jacc.C6_TB))
    assert got == tacc.C6_TB and got.siso == "cuda"
    assert got.rate == jacc.C6_TB.rate == 0.5
    seg = got.seg()
    assert (seg.C, seg.K_minus, seg.K_plus, seg.F) == (2, 6016, 6080, 24)
    dec = got.decoder_config()
    assert (dec.K, dec.n_iters, dec.io_dtype, dec.early_term, dec.crc_poly) \
        == (6080, 8, "bfloat16", "crc", CRC24B_POLY)
    assert tacc.ALL["c6"] is tacc.C6_TB
    with pytest.raises(ValueError, match="unknown TBConfig"):
        tb_config_from_dict({"A": 40, "codewords": 3})
    # an unsegmented block is checked with CRC-24A
    assert ttb.TBConfig(A=1000).decoder_config().crc_poly == CRC24A_POLY
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttb.simulate_tb_point(tacc.C6_TB, 1.2)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttb.simulate_tbler(tacc.C6_TB, verbose=False)


def test_cli_tb_writes_and_resumes_a_record(tmp_path, capsys):
    path = tmp_path / "sub" / "tb.jsonl"
    argv = ["tb", "--a", "6200", "--n-tb", "2", "--siso", "scan", "--iters",
            "4", "--ebn0", "4.0", "--max-tbs", "2", "--device", "cpu",
            "--results", str(path)]
    assert cli.main(argv) == 0
    rec = json.loads(path.read_text())
    assert rec["config"] == "cli_tb_a6200" and rec["tbs"] == 2
    assert rec["tb_errs"] == 0 and rec["C"] == 2 and rec["device"] == "cpu"
    assert "TBLER=" in capsys.readouterr().out
    assert cli.main(argv) == 0                      # resumed, nothing added
    assert "(resumed)" in capsys.readouterr().out
    assert len(path.read_text().splitlines()) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["tb", "--config", "c6", "--results", str(path)])
