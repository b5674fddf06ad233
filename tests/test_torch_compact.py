"""The port's convergence compaction against its own single-stage decode and
against the JAX package's compaction, on the CPU.

Frames are made from a seed with numpy (`make_crc_batches` draws the same
frames in both packages) and handed to both sides.  K=40 with the scan SISO
keeps the JAX side's compiles short; the compaction logic does not depend on
the SISO.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from turbotpu.decoder.turbo import DecoderConfig as JaxDecoder
from turbotpu.harness import compact as jcompact
from turbotpu_torch import cli, turbo_decode
from turbotpu_torch.convert import config_from_dict
from turbotpu_torch.harness import ber as tber
from turbotpu_torch.harness import compact as tcompact

K, B, N_SUPER = 40, 16, 3
JCFG = JaxDecoder(K=K, n_iters=6, mode="maxlog", ext_scale=0.75,
                  early_term="crc", siso="scan")
TCFG = config_from_dict(dataclasses.asdict(JCFG))


def test_both_packages_draw_the_same_frames():
    ji, jb = jcompact.make_crc_batches(K, B, 2, 1.0, seed=3, n_base=8)
    ti, tb = tcompact.make_crc_batches(K, B, 2, 1.0, seed=3, n_base=8,
                                       device="cpu")
    for j_batch, t_batch, j_bits, t_bits in zip(ji, ti, jb, tb):
        for a, b in zip(j_batch, t_batch):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        np.testing.assert_array_equal(np.asarray(j_bits), t_bits.numpy())


@pytest.mark.parametrize("ebn0_db", [-2.0, 1.0, 4.0])
def test_compaction_matches_single_stage_and_jax(ebn0_db):
    """-2 dB: nearly every frame defers; 1 dB: mixed; 4 dB: none defer.
    Hard bits and counts equal to the port's single-stage decode at the full
    cap; bit errors, frame errors, iteration total, stage-2 batches and
    deferred count equal to the JAX package's decode_compacted."""
    inputs_list, bits_list = tcompact.make_crc_batches(
        K, B, N_SUPER, ebn0_db, seed=3, n_base=8, device="cpu")
    bit_s = frame_s = 0
    hard_s = []
    for inp, bits in zip(inputs_list, bits_list):
        hard, _, _ = turbo_decode(*inp, TCFG, device="cpu")
        errs = hard != bits
        bit_s += int(errs.sum())
        frame_s += int(errs.any(dim=1).sum())
        hard_s.append(hard.numpy())
    got = tcompact.decode_compacted(inputs_list, bits_list, TCFG,
                                    stage1_iters=2, keep_hard=True,
                                    device="cpu")
    bit_c, frame_c, iters_c, n2, hard_c, n_def = got
    assert (bit_c, frame_c) == (bit_s, frame_s)
    for hc, hs in zip(hard_c, hard_s):
        np.testing.assert_array_equal(hc, hs)
    if ebn0_db <= -2.0:
        assert n_def > 0          # the deferred path actually executed
    if ebn0_db >= 4.0:
        assert n_def == 0 and n2 == 0

    j_in = [tuple(jnp.asarray(x.numpy()) for x in inp) for inp in inputs_list]
    j_bits = [jnp.asarray(b.numpy()) for b in bits_list]
    want = jcompact.decode_compacted(j_in, j_bits, JCFG, stage1_iters=2)
    assert (bit_c, frame_c, iters_c, n2, n_def) == (
        want[0], want[1], want[2], want[3], want[5])


def test_counters_stay_integer():
    """The host read is one int64 vector: counts are never cast into a
    float (a batch's bit errors can pass 2^24)."""
    inputs_list, bits_list = tcompact.make_crc_batches(
        K, B, 1, 0.0, seed=1, n_base=4, device="cpu")
    stage1, stage2 = tcompact._stage_fns(
        dataclasses.replace(TCFG, n_iters=1), TCFG, "cpu")
    packed, hard = stage1(inputs_list[0], bits_list[0])
    assert packed.dtype == torch.int64 and packed.shape == (3 + B,)
    assert hard.shape == (B, K)
    idx = torch.arange(B)
    valid = torch.arange(B) < 5
    p2, _ = stage2(inputs_list[0], idx, valid, bits_list[0])
    assert p2.dtype == torch.int64 and p2.shape == (3,)
    hard_full, iters_full, _ = turbo_decode(*inputs_list[0], TCFG,
                                            device="cpu")
    assert int(p2[2]) == int(iters_full[:5].sum())
    assert int(p2[0]) == int((hard_full[:5] != bits_list[0][:5]).sum())


SWEEP = tber.SimConfig(
    name="sweep", K=40, B=16, ebn0_db_grid=(1.0,), use_crc=True, seed=3,
    min_frame_errors=10 ** 9, max_frames=128, steps_per_check=2,
    decoder=tber.DecoderConfig(K=40, n_iters=6, mode="maxlog",
                               early_term="crc"))
COUNTS = ("frames", "bits", "bit_errs", "frame_errs", "avg_iters")


def test_compacted_sweeps_give_the_plain_sweeps_counts():
    """Plain, --compact and --compact-flush at a fixed frame budget: the
    same generator drawn from in the same order, so equal counts."""
    plain = tber.simulate_point(SWEEP, 1.0, device="cpu")
    comp = tber.simulate_point(SWEEP, 1.0, compact_stage1=2, device="cpu")
    flush = tber.simulate_point(SWEEP, 1.0, compact_stage1=2, compact_flush=2,
                                device="cpu")
    assert plain["frame_errs"] > 0 and plain["frames"] == 128
    for rec in (comp, flush):
        assert {k: rec[k] for k in COUNTS} == {k: plain[k] for k in COUNTS}
        assert rec["compact_stage1"] == 2 and rec["device"] == "cpu"
        assert 0 < rec["deferred_frac"] < 1 and rec["n_stage2_batches"] > 0
        assert rec["iter_batches"] == (8 * 2 + rec["n_stage2_batches"] * 6)
    assert "compact_flush_batches" not in comp
    assert flush["compact_flush_batches"] == 2
    # denser stage-2 fill: never more finishing batches than per-check
    assert flush["n_stage2_batches"] <= comp["n_stage2_batches"]
    # a step built once is reused, as the sweep does
    step = tber.make_step(SWEEP, "cpu")
    again = tber.simulate_point(SWEEP, 1.0, step, compact_stage1=2)
    assert {k: again[k] for k in COUNTS} == {k: plain[k] for k in COUNTS}


def test_stopping_rule_parity_without_flush():
    """With the default per-check flush the stopping rule sees complete
    counts at every check: the compacted sweep stops where the plain one
    does."""
    cfg = dataclasses.replace(SWEEP, min_frame_errors=5, max_frames=10_000)
    plain = tber.simulate_point(cfg, 1.0, device="cpu")
    comp = tber.simulate_point(cfg, 1.0, compact_stage1=2, device="cpu")
    assert plain["frames"] < 10_000
    assert {k: comp[k] for k in COUNTS} == {k: plain[k] for k in COUNTS}


def test_resume_keys_do_not_cross(tmp_path):
    path = tmp_path / "ber.jsonl"
    cfg = dataclasses.replace(SWEEP, max_frames=32)
    plain = tber.simulate_ber(cfg, path, device="cpu", verbose=False)
    comp = tber.simulate_ber(cfg, path, device="cpu", verbose=False,
                             compact_stage1=2)
    flush = tber.simulate_ber(cfg, path, device="cpu", verbose=False,
                              compact_stage1=2, compact_flush=2)
    lines = [json.loads(l) for l in path.read_text().splitlines()]
    assert lines == plain + comp + flush        # each ran and wrote its own
    assert [l.get("compact_stage1", 0) for l in lines] == [0, 2, 2]
    assert [l.get("compact_flush_batches", 0) for l in lines] == [0, 0, 2]
    # and each resumes its own record only
    assert tber.simulate_ber(cfg, path, device="cpu", verbose=False) == plain
    assert tber.simulate_ber(cfg, path, device="cpu", verbose=False,
                             compact_stage1=2) == comp
    assert tber.simulate_ber(cfg, path, device="cpu", verbose=False,
                             compact_stage1=2, compact_flush=2) == flush
    assert len(path.read_text().splitlines()) == 3


def test_compaction_refuses_what_the_jax_code_refuses():
    mixed = tber.SimConfig(K=168, K_mix=(40, 168), B=4,
                           decoder=tber.DecoderConfig(K=168, early_term="crc"))
    with pytest.raises(ValueError, match="mixed-K"):
        tber.simulate_point(mixed, 1.0, compact_stage1=2, device="cpu")
    no_crc = dataclasses.replace(
        SWEEP, decoder=dataclasses.replace(SWEEP.decoder, early_term="none"))
    with pytest.raises(ValueError, match="early_term='crc'"):
        tber.simulate_point(no_crc, 1.0, compact_stage1=2, device="cpu")
    with pytest.raises(ValueError, match="CRC early termination"):
        tcompact.decode_compacted([], [], no_crc.decoder, device="cpu")
    with pytest.raises(ValueError, match="early_term='crc'"):
        tcompact.bench_compaction(no_crc.decoder, 4, 1.0, device="cpu")
    with pytest.raises(RuntimeError, match="needs a card"):
        tcompact.bench_compaction(SWEEP.decoder, 4, 1.0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcompact.bench_compaction(SWEEP.decoder, 4, 1.0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tber.simulate_point(SWEEP, 1.0, compact_stage1=2)


def test_cli_ber_compact_runs_on_the_cpu(tmp_path):
    path = tmp_path / "cli.jsonl"
    argv = ["ber", "--k", "40", "--batch", "8", "--iters", "4", "--mode",
            "maxlog", "--early-term", "crc", "--ebn0", "1.0", "--max-frames",
            "16", "--min-frame-errors", "1000", "--device", "cpu",
            "--results", str(path)]
    assert cli.main(argv + ["--compact", "2"]) == 0
    assert cli.main(argv + ["--compact", "2", "--compact-flush", "2"]) == 0
    assert cli.main(argv) == 0
    comp, flush, plain = (json.loads(l) for l in path.read_text().splitlines())
    assert comp["compact_stage1"] == flush["compact_stage1"] == 2
    assert flush["compact_flush_batches"] == 2
    assert "compact_stage1" not in plain
    for rec in (comp, flush):
        assert {k: rec[k] for k in COUNTS} == {k: plain[k] for k in COUNTS}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["bench", "--k", "40", "--batch", "4", "--early-term",
                      "crc", "--compact", "2"])
