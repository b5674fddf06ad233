"""Float8 (e4m3fn) extrinsic streams in the SISO kernels (K1-K5) and the
decoders, against the JAX package's, on the CPU.

Inputs are made from a seed with numpy and handed to both sides.  The JAX
side runs its Pallas kernel in interpret mode; the port's wrappers take
their kernels' plain versions (the tensors lie on the CPU), and layouts cross
through turbotpu_torch.convert.  fp8 codes are compared as bytes.  The CUDA
kernels themselves are held to the same plain versions on a card by the test
marked `cuda` and by chip_smoke.py (phase `fp8`).

With fp8 extrinsics the a-priori product scale*la is exact in fp32 (3
mantissa bits times 0.75 or 1.0), so XLA:CPU's contraction of la*scale + ls
into one FMA rounds as the port does: codes are held equal, not close.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from turbotpu.decoder.turbo import DecoderConfig as JaxConfig
from turbotpu.decoder.turbo import turbo_decode as jax_decode
from turbotpu.dist import seq_parallel as jsp
from turbotpu.dist.mesh import make_mesh as jax_mesh
from turbotpu.siso import pallas_kernel as jk
from turbotpu_torch import _build, convert, turbo_decode
from turbotpu_torch.dist import seq_parallel as sp
from turbotpu_torch.dist.mesh import make_mesh
from turbotpu_torch.harness.bench import make_decode_inputs
from turbotpu_torch.siso import cuda_kernel as ck

FP8 = torch.float8_e4m3fn
CHAN = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _streams(K, B, W, seed):
    """fp32 (KTp, B) numpy streams of one SISO, padded as the decoder pads."""
    ls, lp1, _, t1, _ = (x.numpy() for x in
                         make_decode_inputs(K, B, seed=seed, ebn0_db=1.0))
    KTp = -(-(K + 3) // W) * W
    pad = lambda body, tail, v: np.ascontiguousarray(np.pad(
        np.concatenate([body, tail], 1), ((0, 0), (0, KTp - K - 3)),
        constant_values=v).T.astype(np.float32))
    return pad(ls, t1[:, 0::2], jk.BIG), pad(lp1, t1[:, 1::2], 0.0)


def _codes(x) -> np.ndarray:
    """The bytes of an fp8 tensor or JAX array."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _jax_cells(x_tb, dtype):
    return jnp.asarray(convert.tb_to_cells(x_tb)).astype(dtype)


def _fp8_to_jax(le_t):
    """A port fp8 (T, B) stream as JAX fp8 cells, bit for bit."""
    cells = convert.tb_to_cells(_codes(le_t))
    return jnp.asarray(cells).view(jnp.float8_e4m3fn)


def test_quantize_matches_jax():
    """`_quantize_le` to fp8 equals the reference's (saturate at +-448, then
    round to nearest even) byte for byte: ties, subnormals, saturation."""
    x = np.concatenate([
        np.arange(-40, 40, 0.0625), [1.0625, 1.1875, 1.0625 + 2 ** -20,
                                     2 ** -9, 1.5 * 2 ** -9, 3 * 2 ** -10,
                                     447.0, 449.0, 470.0, 1e4, -1e4, 0.0],
        np.random.default_rng(0).normal(size=4000) * 50]).astype(np.float32)
    got = ck._quantize_le(torch.from_numpy(x), FP8, 0.0)
    want = jk._quantize_le(jnp.asarray(x), jnp.float8_e4m3fn, 0.0)
    np.testing.assert_array_equal(_codes(got), _codes(want))
    assert float(got.to(torch.float32).abs().max()) == ck.FP8_MAX


@pytest.mark.parametrize("nii,chan,mode", [
    (True, "bfloat16", "maxlog"), (True, "bfloat16", "linlog"),
    (False, "float32", "logmap")])
def test_one_siso_call_matches_pallas_interpret(nii, chan, mode):
    """One SISO call, K=168, W=32, B=8, fp8 extrinsics: the Pallas kernel in
    interpret mode against the port's plain versions, fed an fp8 a-priori
    stream and (NII) window starts from a previous call of the port.  fp8
    codes equal; window starts equal (max-log, linlog) or within 1e-4
    (log-MAP: libm's exp/log1p against XLA's)."""
    K, W, B = 168, 32, 8
    scale = 0.75 if mode == "maxlog" else 1.0
    ls_np, lp_np = _streams(K, B, W, seed=17)
    T = ls_np.shape[0]
    n_win = T // W
    ls_t, lp_t = (torch.from_numpy(x).to(CHAN[chan]) for x in (ls_np, lp_np))
    ls_j, lp_j = _jax_cells(ls_np, chan), _jax_cells(lp_np, chan)
    la_t, ck_t = ck.siso_cells(ls_t, lp_t, torch.zeros((T, B), dtype=FP8), K,
                               mode, scale, nii_ckpt=torch.zeros((n_win, 8, B)),
                               window=W)
    assert la_t.dtype == FP8 and la_t.to(torch.float32).abs().max() > 0
    la_j = _fp8_to_jax(la_t)
    if nii:
        le_t, out_t = ck.siso_cells(ls_t, lp_t, la_t, K, mode, scale,
                                    nii_ckpt=ck_t, window=W)
        le_j, out_j = jk.siso_cells(
            ls_j, lp_j, la_j, K, mode, scale, interpret=True, window=W,
            nii_ckpt=jnp.asarray(convert.ckpt_port_to_cells(ck_t.numpy())))
        np.testing.assert_allclose(
            out_t.numpy()[1:],
            convert.ckpt_cells_to_port(np.asarray(out_j), B)[1:],
            atol=1e-4 if mode == "logmap" else 0, rtol=0)
    else:
        le_t = ck.siso_cells(ls_t, lp_t, la_t, K, mode, scale, window=W)
        le_j = jk.siso_cells(ls_j, lp_j, la_j, K, mode, scale,
                             interpret=True, window=W)
    assert le_t.dtype == FP8
    np.testing.assert_array_equal(
        _codes(le_t)[:K], convert.cells_to_tb(_codes(le_j), B)[:K])


@functools.lru_cache(maxsize=None)
def _jax_k4(K, W, scale):
    """Both boundary contracts of the Pallas kernel, interpret mode, one
    jit (one compile)."""

    @jax.jit
    def run(ls, lp, la, a0, bT, ain, off):
        exact = jk.siso_cells(ls, lp, la, K, "maxlog", scale,
                              boundaries=(a0, bT), interpret=True, window=W,
                              row_offset=off)
        nii = jk.siso_cells(ls, lp, la, K, "maxlog", scale,
                            nii_boundaries=(ain, a0, bT), interpret=True,
                            window=W, row_offset=off)
        return exact, nii
    return run


def test_k4_plain_matches_pallas_interpret():
    """K4 (both boundary contracts) with fp8 extrinsics at KTp=96, W=32,
    max-log, bf16 channel streams, edges and window starts from the seed,
    row offset 70 of a global K=150: le codes, outgoing edges and the window
    table (slot 0 is never written) equal bit for bit."""
    T, B, W, K, off, scale = 96, 5, 32, 150, 70, 0.75
    rng = np.random.default_rng(43)
    bf = lambda x: torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    ls, lp = bf(rng.normal(size=(T, B)) * 3), bf(rng.normal(size=(T, B)) * 3)
    la = torch.from_numpy((rng.normal(size=(T, B)) * 6).astype(np.float32)
                          ).to(FP8)
    a0, bT = (torch.from_numpy(rng.normal(size=(8, B)).astype(np.float32) * 4)
              for _ in range(2))
    ain = torch.from_numpy(rng.normal(size=(T // W, 8, B)).astype(np.float32))
    le_x, aout_x, bout_x = ck.siso_cells(ls, lp, la, K, "maxlog", scale,
                                         boundaries=(a0, bT), window=W,
                                         row_offset=off)
    le_n, tbl_n, eout_n, bout_n = ck.siso_cells(
        ls, lp, la, K, "maxlog", scale, nii_boundaries=(ain, a0, bT),
        window=W, row_offset=off)
    cells = lambda x: jnp.asarray(convert.tb_to_cells(
        x.to(torch.float32).numpy())).astype(jnp.bfloat16)
    edge = lambda x: jnp.asarray(convert.edge_port_to_cells(x.numpy()))
    (jle_x, jaout_x, jbout_x), (jle_n, jtbl_n, jeout_n, jbout_n) = _jax_k4(
        K, W, scale)(cells(ls), cells(lp), _fp8_to_jax(la), edge(a0),
                     edge(bT),
                     jnp.asarray(convert.ckpt_port_to_cells(ain.numpy())),
                     jnp.asarray([off], jnp.int32))
    from_edge = lambda x: convert.edge_cells_to_port(np.asarray(x), B)
    for got, want in ((le_x, jle_x), (le_n, jle_n)):
        np.testing.assert_array_equal(
            _codes(got), convert.cells_to_tb(_codes(want), B))
    for got, want in ((aout_x, jaout_x), (bout_x, jbout_x),
                      (eout_n, jeout_n), (bout_n, jbout_n)):
        np.testing.assert_array_equal(got.numpy(), from_edge(want))
    np.testing.assert_array_equal(
        tbl_n.numpy()[1:],
        convert.ckpt_cells_to_port(np.asarray(jtbl_n), B)[1:])


@pytest.mark.parametrize("mode", ["maxlog", "linlog", "logmap"])
def test_folded_read_equals_materialised_gather(mode):
    """K5 with fp8 extrinsics: the folded read through a random row table
    equals the NII call on the gathered stream bit for bit."""
    K, W, B = 168, 32, 6
    ls_np, lp_np = _streams(K, B, W, seed=23)
    ls, lp = torch.from_numpy(ls_np), torch.from_numpy(lp_np)
    T = ls.shape[0]
    ain = torch.zeros((T // W, 8, B))
    la, ain = ck.siso_cells(ls, lp, torch.zeros((T, B), dtype=FP8), K, mode,
                            nii_ckpt=ain, window=W)
    idx = torch.from_numpy(np.random.default_rng(5).permutation(T).astype(
        np.int32))
    le_f, ck_f = ck.siso_cells(ls, lp, la, K, mode, nii_ckpt=ain, window=W,
                               gather_idx=idx)
    le_m, ck_m = ck.siso_cells(ls, lp, la.index_select(0, idx.long()), K, mode,
                               nii_ckpt=ain, window=W)
    assert torch.equal(le_f.view(torch.uint8), le_m.view(torch.uint8))
    assert torch.equal(ck_f[1:], ck_m[1:])


def test_eighteen_libraries_and_their_counters():
    """fp8 adds one library per (mode, channel type, form): 72 variants of
    siso.cu in all, and 18 launch names, one per fp8 library, under which
    the calls that launch it count."""
    targets = ck.build_targets()
    assert len(targets) == len(set(targets)) == 72
    fp8 = [t for t in targets if "-DSISO_EXT=3" in t[1]]
    assert len(fp8) == 18
    assert len(set(ck.FP8_NAMES)) == 18 and len(ck.KERNEL_NAMES) == 15
    assert not set(ck.FP8_NAMES) & set(ck.KERNEL_NAMES)
    count = ck.kernel_name
    assert count(True, "maxlog", False, False, torch.bfloat16,
                 FP8) == "siso_fp8_bf16"
    assert count(False, "maxlog", False, False, torch.bfloat16,
                 FP8) == "siso_fp8_bf16"
    assert count(True, "linlog", True, False, torch.float32,
                 FP8) == "siso_fp8_fold_f32_linlog"
    assert count(False, "logmap", False, True, torch.bfloat16,
                 FP8) == "siso_fp8_bnd_bf16_logmap"
    assert count(True, "maxlog", False, False, torch.bfloat16,
                 torch.int8) == "siso_nii"
    assert _build.library(fp8[0]).name.startswith("libsiso-")


DECODES = {
    # the flagship's options at a tiny size with fp8 extrinsics, CRC exit
    "nii-bf16-crc": (dict(K=40, n_iters=4, mode="maxlog", ext_scale=0.75,
                          siso="pallas", nii=True, window=16,
                          io_dtype="bfloat16", ext_dtype="float8_e4m3fn",
                          early_term="crc"),
                     dict(seed=5, ebn0_db=1.0, with_crc=True)),
    "exact-f32-sign": (dict(K=40, n_iters=4, mode="maxlog", ext_scale=0.75,
                            siso="pallas", ext_dtype="float8_e4m3fn",
                            early_term="sign"),
                       dict(seed=6, ebn0_db=1.5)),
}


@pytest.mark.parametrize("case", list(DECODES))
def test_decode_matches_jax(case):
    """The whole decode with fp8 extrinsics, 3 codewords: hard bits and
    iteration counts equal, L within 1e-4."""
    cfg_kw, inp_kw = DECODES[case]
    jcfg = JaxConfig(**cfg_kw)
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    arrays = [x.numpy() for x in make_decode_inputs(jcfg.K, 3, **inp_kw)]
    hj, ij, Lj = jax_decode(*[jnp.asarray(a) for a in arrays], jcfg)
    ht, it, Lt = turbo_decode(*arrays, tcfg, device="cpu")
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), atol=1e-4, rtol=0)


def test_fold_gather_decode_equals_materialised():
    """fold_gather=True with fp8 extrinsics gives the decode of the
    materialised gathers bit for bit (hard bits, iterations, L)."""
    cfg = dict(K=40, n_iters=4, mode="maxlog", ext_scale=0.75, siso="cuda",
               nii=True, window=16, io_dtype="bfloat16",
               ext_dtype="float8_e4m3fn", early_term="crc")
    inputs = make_decode_inputs(40, 4, seed=8, ebn0_db=1.2, with_crc=True)
    a = turbo_decode(*inputs, convert.config_from_dict(cfg), device="cpu")
    b = turbo_decode(*inputs, convert.config_from_dict(
        dict(cfg, fold_gather=True)), device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_seq_decode_matches_jax():
    """The sequence-sharded decoder (seq=2, K4 exact contract, CRC exit)
    with fp8 extrinsics, which travel through the partitioned exchange as
    their bytes: hard bits and iteration counts equal to the JAX package's,
    L within 1e-4."""
    cfg = dict(K=40, n_iters=4, mode="maxlog", ext_scale=0.75, siso="pallas",
               io_dtype="bfloat16", ext_dtype="float8_e4m3fn",
               early_term="crc")
    inputs = make_decode_inputs(40, 4, seed=4, ebn0_db=1.5, with_crc=True)
    hard_j, iters_j, L_j = jsp.decode_seq_sharded(
        jax_mesh(data=1, seq=2), JaxConfig(**cfg))(
        *(jnp.asarray(x.numpy()) for x in inputs))
    hard, iters, L = sp.decode_seq_sharded(
        make_mesh(1, 2, device="cpu"), convert.config_from_dict(cfg))(*inputs)
    np.testing.assert_array_equal(hard.numpy(), np.asarray(hard_j))
    np.testing.assert_array_equal(iters.numpy(), np.asarray(iters_j))
    np.testing.assert_allclose(L.numpy(), np.asarray(L_j), atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("chan", ["bfloat16", "float32"])
def test_fp8_kernels_match_plain_on_card(chan):
    """Needs a card: every fp8 kernel form (NII, exact, folded, both
    boundary contracts) in every mode against its plain version, equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    K, W, B = 168, 32, 70
    ls_np, lp_np = _streams(K, B, W, seed=29)
    ls, lp = (torch.from_numpy(x).to(dev, CHAN[chan]) for x in (ls_np, lp_np))
    T = ls.shape[0]
    idx = torch.from_numpy(np.random.default_rng(3).permutation(T).astype(
        np.int32)).to(dev)
    e = lambda: torch.randn((8, B), device=dev)
    for mode in ("maxlog", "linlog", "logmap"):
        la, ain = ck.siso_cells(ls, lp, torch.zeros((T, B), dtype=FP8,
                                                    device=dev),
                                K, mode, nii_ckpt=torch.zeros(
                                    (T // W, 8, B), device=dev), window=W)
        for gather in (None, idx):
            got = ck.siso_cells(ls, lp, la, K, mode, nii_ckpt=ain, window=W,
                                gather_idx=gather)
            want = ck.siso_nii_plain(ls, lp, la, ain, K, W, 1.0, 0.0, mode,
                                     gather_idx=gather)
            assert torch.equal(got[0].view(torch.uint8),
                               want[0].view(torch.uint8))
            assert torch.equal(got[1][1:], want[1][1:])
        got = ck.siso_cells(ls, lp, la, K, mode, window=W)
        want = ck.siso_exact_plain(ls, lp, la, K, W, 1.0, 0.0, mode)
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
        a0, bT = e(), e()
        got = ck.siso_cells(ls, lp, la, K, mode, boundaries=(a0, bT),
                            window=W, row_offset=8)
        want = ck.siso_bnd_exact_plain(ls, lp, la, a0, bT, K, W, 1.0, 0.0,
                                       mode, row_offset=8)
        assert torch.equal(got[0].view(torch.uint8),
                           want[0].view(torch.uint8))
        assert all(torch.equal(x, y) for x, y in zip(got[1:], want[1:]))
