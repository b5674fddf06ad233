"""The slice as a whole: turbotpu_torch.turbo_decode against the JAX
package's turbo_decode on the CPU, and the port's import hygiene.

Inputs are made from a seed with numpy and handed to both sides.  On the
kernel path the JAX side runs its Pallas kernel in interpret mode and the
port runs its kernels' plain versions (device="cpu").
"""

import dataclasses
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from turbotpu.decoder.turbo import DecoderConfig as JaxConfig
from turbotpu.decoder.turbo import turbo_decode as jax_decode
from turbotpu_torch import DecoderConfig, turbo_decode
import turbotpu_torch.golden.numpy_ref as tref
from turbotpu_torch.convert import config_from_dict
from turbotpu_torch.decoder.bucketing import grouped_perm_tables
from turbotpu_torch.decoder.early_term import crc_ok_batch, make_crc_matrix
from turbotpu_torch.decoder.turbo import get_siso
from turbotpu_torch.harness.bench import (bench_decode, flagship_config,
                                          make_decode_inputs)
from turbotpu_torch.spec.crc import CRC24A_POLY

REPO = Path(__file__).resolve().parents[1]

KERNEL = dict(K=168, n_iters=6, mode="maxlog", ext_scale=0.75, siso="pallas",
              window=32)
CASES = {
    # the flagship's options at a small size: NII, bf16 streams, int8 codes, CRC
    "kernel-nii-bf16-int8-crc": (dict(KERNEL, nii=True, io_dtype="bfloat16",
                                      ext_dtype="int8", early_term="crc"),
                                 dict(seed=4, ebn0_db=2.5)),
    "kernel-nii-bf16-lean": (dict(KERNEL, n_iters=4, nii=True,
                                  io_dtype="bfloat16"),
                             dict(seed=11, ebn0_db=1.8)),
    "kernel-exact-f32-sign": (dict(KERNEL, n_iters=5, early_term="sign"),
                              dict(seed=9, ebn0_db=2.0)),
    "scan-none": (dict(K=104, n_iters=4), dict(seed=3, ebn0_db=1.5)),
    "scan-crc": (dict(K=104, n_iters=4, early_term="crc"),
                 dict(seed=3, ebn0_db=1.5)),
    "scan-sign": (dict(K=104, n_iters=4, early_term="sign", mode="linlog"),
                  dict(seed=3, ebn0_db=1.5)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_turbo_decode_matches_jax(case):
    """(d) Hard bits and iteration counts identical, L within 1e-4 (the scan
    path reduces max* in another order; the fp32 kernel path differs in the
    last bit of la*scale + ls, see test_torch_siso)."""
    cfg_kw, inp_kw = CASES[case]
    jcfg = JaxConfig(**cfg_kw)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    inputs, bits = make_decode_inputs(
        jcfg.K, 3, with_crc=jcfg.early_term == "crc", return_bits=True, **inp_kw)
    arrays = [x.numpy() for x in inputs]
    hj, ij, Lj = jax_decode(*[jnp.asarray(a) for a in arrays], jcfg)
    ht, it, Lt = turbo_decode(*arrays, tcfg, device="cpu")
    assert (ht.dtype, it.dtype, Lt.dtype) == (torch.int8, torch.int32,
                                              torch.float32)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(ht.numpy(), bits)
    if jcfg.early_term != "none":
        assert (it.numpy() < jcfg.n_iters).all()   # early exit actually fired


def test_config_carries_over():
    fields = lambda c: [(f.name, f.default) for f in dataclasses.fields(c)]
    assert fields(DecoderConfig) == fields(JaxConfig)
    j = JaxConfig(K=6144, n_iters=6, mode="maxlog", siso="pallas",
                  io_dtype="bfloat16", nii=True, window=256, ext_dtype="int8")
    t = config_from_dict(dataclasses.asdict(j))
    assert t == flagship_config(ext_scale=None) and t.siso == "cuda"
    assert t.ext_io() == j.ext_io() == ("int8", 0.25)
    assert t.resolved_ext_scale() == j.resolved_ext_scale() == 0.75
    assert DecoderConfig(K=40).resolved_ext_scale() == 1.0
    np.testing.assert_array_equal(t.perm(), j.perm())
    np.testing.assert_array_equal(t.inv(), j.inv())
    with pytest.raises(ValueError, match="unknown DecoderConfig fields"):
        config_from_dict({"K": 40, "speed": 11})
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        DecoderConfig(K=6144, nii=True, window=128)
    assert any("0.05 dB" in str(x.message) for x in w)


def test_crc_ok_batch():
    frames, bits = make_decode_inputs(64, 5, seed=1, with_crc=True,
                                      return_bits=True)
    hard = torch.from_numpy(bits.copy())
    hard[2, 7] ^= 1
    ok = crc_ok_batch(hard, make_crc_matrix(64, CRC24A_POLY))
    assert ok.tolist() == [True, True, False, True, True]


@pytest.mark.parametrize("module", ["turbotpu_torch", "chip_smoke",
                                    "turbotpu_torch.cli",
                                    "turbotpu_torch.harness.ber",
                                    "turbotpu_torch.configs.acceptance",
                                    "turbotpu_torch.harness.bench",
                                    "turbotpu_torch.convert",
                                    "turbotpu_torch.dist.seq_parallel",
                                    "turbotpu_torch.dist.dma",
                                    "turbotpu_torch.dist.multihost",
                                    "turbotpu_torch.harness.c5",
                                    *(f"turbotpu_torch.experiments.{m}" for m in (
                                        "common", "run_acceptance",
                                        "nii_window_sweep", "ext_dtype_ber",
                                        "map_variant_ber", "map_variant_umts",
                                        "flagship_tuning", "latency", "k_sweep",
                                        "siso_shapes", "cost_breakdown",
                                        "seq_gap", "seq_glue", "seq_nii_ber",
                                        "comm_model", "gather_inkernel"))])
def test_import_leaves_jax_out(module):
    """(e) Importing the port in a fresh interpreter loads neither jax nor
    the JAX package."""
    code = (f"import sys, {module}\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'turbotpu'))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_entry_points_need_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    inputs = make_decode_inputs(40, 2, seed=0)
    cfg = DecoderConfig(K=40, n_iters=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        turbo_decode(*inputs, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_decode(cfg, 2)
    with pytest.raises(RuntimeError, match="needs a card"):
        bench_decode(cfg, 2, device="cpu")
    hard, iters, L = turbo_decode(*inputs, cfg, device="cpu")
    assert hard.shape == L.shape == (2, 40) and iters.tolist() == [1, 1]
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.parametrize("cfg_kw,what", [
    (dict(siso="cuda", mode="maxlog", ext_dtype="float8_e4m3fn"), "float8"),
    (dict(siso="ascan"), "ascan"),
    (dict(siso="window"), "windowed"),
])
def test_out_of_slice_options_raise(cfg_kw, what):
    """(e) The options that earlier slices refused (float8 extrinsics, the
    associative-scan and the windowed SISO) decode now, through their own
    code (no fall-through to another path): on the same tiny decode (K=40,
    B=2) hard bits and iteration counts equal the JAX package's, L within
    1e-4."""
    inputs = make_decode_inputs(40, 2, seed=0)
    cfg = DecoderConfig(K=40, n_iters=2, **cfg_kw)
    jcfg = JaxConfig(**{**dataclasses.asdict(cfg), "siso": {
        "cuda": "pallas"}.get(cfg.siso, cfg.siso)})
    siso = get_siso(cfg) if cfg.siso != "cuda" else None
    assert siso is None or what[:5] in siso.__name__
    hj, ij, Lj = jax_decode(*[jnp.asarray(x.numpy()) for x in inputs], jcfg)
    ht, it, Lt = turbo_decode(*inputs, cfg, device="cpu")
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), atol=1e-4, rtol=0)


@pytest.mark.parametrize("cfg_kw,tables", [
    (dict(interleaver="umts"), None),
    (dict(siso="cuda", mode="linlog"), None),
    (dict(siso="cuda", mode="logmap"), None),
    ({}, "perm_b"),
    ({}, "group_tables"),
    (dict(siso="cuda", mode="linlog", interleaver="umts"), "group_tables"),
])
def test_options_of_the_sweep_path_decode(cfg_kw, tables):
    """The options the BER sweep brought to the decoder (UMTS interleaver,
    linlog and log-MAP on the kernel path, per-codeword and grouped mixed-K
    tables) decode a clean batch to the transmitted bits."""
    cfg = DecoderConfig(K=40, n_iters=2, **cfg_kw)
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, (2, 40)).astype(np.int8)
    enc = [np.stack(x) for x in zip(*(
        tref.turbo_encode(b, cfg.perm()) for b in bits))]
    llrs = [4.0 * (1.0 - 2.0 * x.astype(np.float32)) for x in enc]
    kw = {}
    if tables:
        pg, ig, gid = grouped_perm_tables([40, 40], 40, cfg.interleaver)
        kw = (dict(group_tables=(pg, ig, gid)) if tables == "group_tables"
              else dict(perm_b=pg[gid], inv_b=ig[gid]))
    hard, iters, L = turbo_decode(*llrs, cfg, device="cpu", **kw)
    np.testing.assert_array_equal(hard.numpy(), bits)
    assert iters.tolist() == [2, 2] and bool(torch.isfinite(L).all())


def test_unknown_values_raise():
    inputs = make_decode_inputs(40, 2, seed=0)
    with pytest.raises(ValueError, match="unknown siso"):
        get_siso(DecoderConfig(K=40, siso="pallas"))
    with pytest.raises(ValueError, match="early_term"):
        turbo_decode(*inputs, DecoderConfig(K=40, early_term="genie"),
                     device="cpu")
    with pytest.raises(ValueError, match="K=40"):
        turbo_decode(*inputs, DecoderConfig(K=48), device="cpu")


@pytest.mark.cuda
def test_decode_on_card_matches_cpu_plain_path():
    """Needs a card: a small decode through the CUDA kernels against the same
    decode through their plain versions on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    inputs = make_decode_inputs(168, 40, seed=3, ebn0_db=1.5, with_crc=True)
    cfg = flagship_config(K=168, window=32, early_term="crc")
    got = turbo_decode(*inputs, cfg)
    want = turbo_decode(*inputs, cfg, device="cpu")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
