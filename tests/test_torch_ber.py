"""The port's Monte-Carlo sweep against the JAX package's, on the CPU.

The two packages draw different random numbers, so the sweep is held to the
reference by feeding it the reference's frames: streams and transmitted bits
made by the JAX package's chain go, as numpy, into the port's counting half
(`make_step(cfg, "cpu").count`) and into the reference's turbo_decode, and
the counters must be equal.  On the kernel path the JAX side runs its Pallas
kernel in interpret mode and the port its kernels' plain versions.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import configs.acceptance as jacc
from turbotpu.decoder.bucketing import grouped_perm_tables as j_grouped
from turbotpu.decoder.turbo import DecoderConfig as JaxDecoder
from turbotpu.decoder.turbo import turbo_decode as jax_decode
from turbotpu.harness import ber as jber
from turbotpu.tx import chain as jchain
from turbotpu.tx import rate_match_jax as jrm
from turbotpu_torch import cli
from turbotpu_torch.configs import acceptance as tacc
from turbotpu_torch.convert import sim_config_from_dict
from turbotpu_torch.harness import ber as tber

T = torch.from_numpy

CONFIGS = {
    "punctured-linlog-kernel": (jber.SimConfig(
        name="p", K=168, B=16, E=336, decoder=JaxDecoder(
            K=168, n_iters=6, mode="linlog", early_term="crc", siso="pallas")),
        2.5),
    "repeated-linlog-scan": (jber.SimConfig(
        name="r", K=168, B=16, E=672, decoder=JaxDecoder(
            K=168, n_iters=6, mode="linlog", early_term="crc")), 0.5),
    "umts-mixed-linlog-kernel": (jber.SimConfig(
        name="m", K=320, K_mix=(40, 168, 320), B=12, decoder=JaxDecoder(
            K=320, n_iters=6, mode="linlog", interleaver="umts",
            early_term="crc", siso="pallas")), 2.0),
    "maxlog-crc-kernel": (jber.SimConfig(
        name="x", K=168, B=16, decoder=JaxDecoder(
            K=168, n_iters=6, mode="maxlog", ext_scale=0.75,
            early_term="crc", siso="pallas")), 1.5),
}


def to_port(jcfg):
    return sim_config_from_dict(dataclasses.asdict(jcfg))


def reference_frames(jcfg, ebn0_db, seed):
    """One batch from the JAX package's chain: (five LLR streams, bits,
    group tables or None), numpy.  Homogeneous configurations use the
    reference's own generation half; a mixed one repeats the reference's
    per-group chain (its step does not expose that half)."""
    key = jax.random.key(seed)
    esn0 = jnp.float32(jber._ebn0_to_esn0_db(jcfg, ebn0_db))
    if not jcfg.K_mix:
        streams, bits = jber.make_step(jcfg).gen(key, esn0)
        return [np.asarray(s) for s in streams], np.asarray(bits), None
    cols = [[] for _ in range(6)]
    Ks = []
    for (K_g, E_g), n_g in jcfg.mixed_groups():
        assert E_g == 0
        kp, kn = jax.random.split(jax.random.fold_in(key, K_g))
        bits = jchain.crc_attach_batch(
            jchain.gen_payload(kp, n_g, K_g - 24), jcfg.decoder.crc_poly)
        perm = dataclasses.replace(jcfg.decoder, K=K_g).perm()
        d = jrm.umts_mux_jax(*jchain.turbo_encode(bits, perm)).astype(jnp.float32)
        esn0_g = esn0 + 10 * np.log10(K_g / (3 * K_g + 12))
        llr = jchain.demap_bpsk(
            jchain.awgn(kn, jchain.modulate_bpsk(d.astype(jnp.int8)), esn0_g),
            esn0_g)
        ls, lp1, lp2, t1, t2 = jrm.umts_demux_jax(llr)
        F = jcfg.K - K_g
        pad = lambda x, v=0: np.pad(np.asarray(x), ((0, 0), (F, 0)),
                                    constant_values=v)
        for col, x in zip(cols, (pad(ls, jber.BIG_LLR), pad(lp1), pad(lp2),
                                 np.asarray(t1), np.asarray(t2), pad(bits))):
            col.append(x)
        Ks += [K_g] * n_g
    *streams, bits = (np.concatenate(c) for c in cols)
    return streams, bits, j_grouped(Ks, jcfg.K, jcfg.decoder.interleaver)


@pytest.mark.parametrize("case", list(CONFIGS))
def test_counting_half_matches_reference_on_its_frames(case):
    jcfg, ebn0 = CONFIGS[case]
    streams, bits, tables = reference_frames(jcfg, ebn0, seed=len(case))
    kw = ({} if tables is None else
          {"group_tables": tuple(jnp.asarray(t) for t in tables)})
    hard, iters, _ = jax_decode(*[jnp.asarray(s) for s in streams],
                                jcfg.decoder, **kw)
    err = np.asarray(hard) != bits
    if jcfg.K_mix:
        F = np.concatenate([[jcfg.K - k] * n
                            for (k, _), n in jcfg.mixed_groups()])
        err &= np.arange(jcfg.K)[None, :] >= F[:, None]
    want = [int(err.sum()), int(err.any(axis=1).sum()),
            int(np.asarray(iters).sum()), int(np.asarray(iters).max())]

    step = tber.make_step(to_port(jcfg), "cpu")
    got = step.count(tuple(T(np.array(s)) for s in streams),
                     T(bits))
    assert got.dtype == torch.int64 and got.tolist() == want
    # the point is a working one: some frames decode, early exit fires
    assert want[1] < jcfg.B and want[2] < jcfg.B * jcfg.decoder.n_iters


@pytest.mark.parametrize("case", list(CONFIGS))
def test_generation_half_shapes_and_clean_decode(case):
    """The port's own frames at a high Eb/N0: right shapes and types, fillers
    marked, and its counting half finds no error in them."""
    jcfg, _ = CONFIGS[case]
    cfg = to_port(jcfg)
    step = tber.make_step(cfg, "cpu")
    esn0 = float(tber._ebn0_to_esn0_db(cfg, 8.0))
    streams, bits = step.gen(tber.point_generator(cfg, 8.0, "cpu"), esn0)
    assert [tuple(s.shape) for s in streams] == (
        [(cfg.B, cfg.K)] * 3 + [(cfg.B, 6)] * 2)
    assert bits.shape == (cfg.B, cfg.K) and bits.dtype == torch.int8
    assert all(s.dtype == torch.float32 for s in streams)
    if cfg.K_mix:
        F = T(np.concatenate([[cfg.K - k] * n
                              for (k, _), n in cfg.mixed_groups()]))
        filler = torch.arange(cfg.K)[None, :] < F[:, None]
        assert bool((streams[0][filler] == tber.BIG_LLR).all())
        assert not bool(streams[1][filler].any() or bits[filler].any())
    be, fe, it, mx = step.count(streams, bits).tolist()
    assert (be, fe) == (0, 0) and it == cfg.B and mx == 1
    enc = step.encode(tber.point_generator(cfg, 8.0, "cpu"))
    assert sum(b.shape[0] for _, b in enc) == cfg.B


def test_sim_config_carries_over():
    fields = lambda c: [(f.name, f.default) for f in dataclasses.fields(c)
                        if f.name != "decoder"]
    assert fields(tber.SimConfig) == fields(jber.SimConfig)
    for jcfg, _ in CONFIGS.values():
        cfg = to_port(jcfg)
        assert cfg.rate == jcfg.rate and cfg.rvs == jcfg.rvs
        assert cfg.mean_true_k == jcfg.mean_true_k
        assert cfg.mixed_groups() == jcfg.mixed_groups() if jcfg.K_mix else True
        assert cfg.e_mix_resolved() == jcfg.e_mix_resolved()
        for db in (-0.6, 1.4):
            assert (tber._ebn0_to_esn0_db(cfg, db)
                    == jber._ebn0_to_esn0_db(jcfg, db))
    harq = jber.SimConfig(K=168, E=300, rv_sequence=(0, 2), modulation="qam16",
                          K_mix=(40, 168), E_mix=(90, 300))
    assert to_port(harq).rate == harq.rate
    assert to_port(harq).mixed_groups() == harq.mixed_groups()
    with pytest.raises(ValueError, match="unknown SimConfig fields"):
        sim_config_from_dict({"K": 40, "speed": 3})


@pytest.mark.parametrize("name", ["C1", "C2", "C3", "C3_RM", "C4_PUNCTURED",
                                  "C4_REPEATED", "C5"])
def test_acceptance_configs_equal_reference(name):
    """The port's own copy of the acceptance configurations: the reference's
    values, with the kernel path under its own name."""
    want = to_port(getattr(jacc, name))
    assert getattr(tacc, name) == want
    if want.decoder.siso != "scan":
        assert want.decoder.siso == "cuda"
    assert set(tacc.ALL) == {"c1", "c2", "c3", "c3rm", "c4", "c5", "c6"}


@pytest.mark.parametrize("modulation,channel,E,rvs", [
    ("qpsk", "awgn", 0, ()), ("qam16", "rayleigh", 0, ()),
    ("qam64", "awgn", 200, ()), ("bpsk", "rayleigh", 100, (0, 2)),
    ("qpsk", "rayleigh", 0, ())])
def test_step_runs_every_modulation_and_channel(modulation, channel, E, rvs):
    """At a high Eb/N0 every front end hands the decoder frames it decodes
    without error (HARQ combining and the whole-symbol pad included)."""
    cfg = tber.SimConfig(
        name="f", K=40, B=8, E=E, rv_sequence=rvs, modulation=modulation,
        channel=channel, steps_per_check=2, use_crc=False,
        decoder=tber.DecoderConfig(K=40, n_iters=4, mode="maxlog"))
    step = tber.make_step(cfg, "cpu")
    ebn0 = 30.0 if channel == "rayleigh" else 12.0
    be, fe, it, mx = step(tber.point_generator(cfg, ebn0, "cpu"),
                          float(tber._ebn0_to_esn0_db(cfg, ebn0))).tolist()
    assert (be, fe) == (0, 0) and it == 2 * 8 * 4 and mx == 2 * 4


def test_make_step_refuses_what_the_reference_refuses():
    dec = tber.DecoderConfig(K=40, interleaver="umts")
    with pytest.raises(ValueError, match="UMTS wire order"):
        tber.make_step(tber.SimConfig(K=40, E=60, decoder=dec), "cpu")
    with pytest.raises(ValueError, match="unknown channel"):
        tber.make_step(tber.SimConfig(channel="rician"), "cpu")
    with pytest.raises(ValueError, match="unknown modulation"):
        tber.make_step(tber.SimConfig(modulation="qam256"), "cpu")
    with pytest.raises(ValueError, match="HARQ"):
        tber.make_step(tber.SimConfig(K=168, K_mix=(40, 168),
                                      rv_sequence=(0, 2)), "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tber.make_step(tber.SimConfig())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tber.simulate_ber(tber.SimConfig(), verbose=False)


TINY = tber.SimConfig(
    name="tiny", K=40, B=4, ebn0_db_grid=(1.0, 3.0), use_crc=False,
    min_frame_errors=1, max_frames=8, steps_per_check=2,
    decoder=tber.DecoderConfig(K=40, n_iters=2, mode="maxlog"))


def test_simulate_ber_writes_and_resumes(tmp_path, capsys):
    path = tmp_path / "sub" / "ber.jsonl"
    recs = tber.simulate_ber(TINY, path, device="cpu", verbose=False)
    assert [r["ebn0_db"] for r in recs] == [1.0, 3.0]
    for r in recs:
        assert r["config"] == "tiny" and r["device"] == "cpu"
        assert r["frames"] == 8 and r["bits"] == 8 * 40
        assert all(isinstance(r[k], int) for k in
                   ("bit_errs", "frame_errs", "frames", "bits", "iter_batches"))
        assert r["avg_iters"] == 2.0 and r["iter_batches"] == 4
    lines = path.read_text().splitlines()
    assert [json.loads(l) for l in lines] == recs
    # a second sweep resumes both points and writes nothing
    again = tber.simulate_ber(TINY, path, device="cpu")
    assert again == recs and path.read_text().splitlines() == lines
    assert capsys.readouterr().out.count("(resumed)") == 2
    # the same seed gives the same counts when not resumed
    fresh = tber.simulate_ber(TINY, path, resume=False, device="cpu",
                              verbose=False)
    strip = lambda r: {k: v for k, v in r.items()
                       if k not in ("wall_s", "mbit_per_s")}
    assert [strip(r) for r in fresh] == [strip(r) for r in recs]


def test_simulate_ber_tolerates_a_torn_line_and_other_sweeps(tmp_path):
    path = tmp_path / "ber.jsonl"
    first = tber.simulate_ber(dataclasses.replace(TINY, ebn0_db_grid=(1.0,)),
                              path, device="cpu", verbose=False)
    other = dict(first[0], ebn0_db=3.0, compact_flush_batches=2, frames=-1)
    foreign = dict(first[0], ebn0_db=3.0, config="someone_else", frames=-2)
    with path.open("a") as f:
        f.write(json.dumps(other) + "\n" + json.dumps(foreign) + "\n")
        f.write("[1, 2]\n")
        f.write('{"config": "tiny", "ebn0_db": 3.0, "fra')     # torn, no \n
    recs = tber.simulate_ber(TINY, path, device="cpu", verbose=False)
    # 1.0 dB resumed; 3.0 dB run anew: neither the record of a sweep with
    # another compact_flush nor another configuration's stands in for it
    assert recs[0] == first[0] and recs[1]["frames"] == 8
    lines = path.read_text().splitlines()
    assert json.loads(lines[-1]) == recs[1]
    assert lines[-2].startswith('{"config": "tiny", "ebn0_db": 3.0, "fra')
    # a sweep with that compact_flush does resume the record written for it
    got = tber.simulate_ber(TINY, path, device="cpu", verbose=False,
                            compact_flush=2)
    assert got[1]["frames"] == -1


def test_cli_ber_runs_on_the_cpu(tmp_path, capsys):
    path = tmp_path / "cli.jsonl"
    argv = ["ber", "--k", "320", "--k-mix", "40", "168", "320", "--batch", "6",
            "--iters", "3", "--mode", "linlog", "--siso", "cuda",
            "--interleaver", "umts", "--early-term", "crc", "--ebn0", "4.0",
            "--max-frames", "6", "--min-frame-errors", "1", "--device", "cpu",
            "--results", str(path)]
    assert cli.main(argv) == 0
    rec = json.loads(path.read_text())
    assert rec["config"] == "cli_k320_linlog" and rec["k_mix"] == [40, 168, 320]
    assert rec["frames"] == 6 and rec["bits"] == 2 * (40 + 168 + 320)
    assert rec["frame_errs"] == 0 and rec["avg_iters"] < 3
    assert "BER=" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["ber", "--config", "c1", "--results", str(path)])
