"""The folded interleave (`fold_gather`) and the two microbenchmark kernels'
plain versions against the JAX package's, on the CPU.

Inputs are made from a seed with numpy and handed to both sides.  The JAX
side runs its Pallas kernels in interpret mode; the port's wrappers take
their kernels' plain PyTorch versions because the tensors lie on the CPU.
The kernels themselves are held to the same plain versions on a card by the
tests marked `cuda` and by chip_smoke.py.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from turbotpu.decoder.turbo import DecoderConfig as JaxConfig
from turbotpu.decoder.turbo import turbo_decode as jax_decode
from turbotpu.siso import pallas_kernel as jk
from turbotpu_torch import DecoderConfig, convert, turbo_decode
from turbotpu_torch.decoder.bucketing import grouped_perm_tables
from turbotpu_torch.experiments import cost_breakdown as cb
from turbotpu_torch.experiments import gather_inkernel as gi
from turbotpu_torch.harness.bench import make_decode_inputs
from turbotpu_torch.siso import cuda_kernel as ck
from turbotpu_torch.spec.qpp import qpp_inv, qpp_perm

REPO = Path(__file__).resolve().parents[1]
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "int8": torch.int8}


def _jax_experiment(name):
    """A module of the JAX package's experiments/ directory (scripts, not a
    package), loaded from its file."""
    spec = importlib.util.spec_from_file_location(
        f"jax_experiments_{name}", REPO / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _streams(K, B, W, seed):
    """fp32 (KTp, B) numpy streams of SISO2 (interleaved order), padded as
    the decoder pads, and the extended interleaver table (KTp,) int32."""
    ls, _, lp2, _, t2 = (x.numpy() for x in
                         make_decode_inputs(K, B, seed=seed, ebn0_db=1.0))
    KTp = -(-(K + 3) // W) * W
    perm = qpp_perm(K)
    pad = lambda body, tail, v: np.ascontiguousarray(np.pad(
        np.concatenate([body, tail], 1), ((0, 0), (0, KTp - K - 3)),
        constant_values=v).T.astype(np.float32))
    table = np.concatenate([perm, np.arange(K, KTp)]).astype(np.int32)
    return pad(ls[:, perm], t2[:, 0::2], jk.BIG), pad(lp2, t2[:, 1::2], 0.0), table


def _raw_extrinsics(ls_t, lp_t, dte, K, W, qs, mode="maxlog", scale=0.75):
    """A non-zero raw extrinsic stream and non-zero window starts, from a
    cold first call."""
    T, B = ls_t.shape
    return ck.siso_cells(ls_t, lp_t, torch.zeros((T, B), dtype=dte), K, mode,
                         scale, nii_ckpt=torch.zeros((T // W, 8, B)),
                         window=W, ext_qscale=qs)


@pytest.mark.parametrize("chan,ext", [("bfloat16", "int8"),
                                      ("float32", "float32")])
def test_folded_siso_call_matches_pallas_interpret(chan, ext):
    """(a) One folded SISO call, K=168, W=32, B=4, scale 0.75: the JAX
    package's fold_gather kernel in interpret mode against the port's plain
    version, through the layout converters.  int8 codes and their window
    starts are held to 0.  With fp32 extrinsics scale*la is not exact and
    XLA:CPU contracts la*scale + ls into one FMA where the port rounds the
    product first (as in test_torch_siso): le and window starts within
    1e-4."""
    K, W, B, scale = 168, 32, 4, 0.75
    qs = 0.25 if ext == "int8" else 0.0
    tol = 0.0 if ext == "int8" else 1e-4
    ls_np, lp_np, table = _streams(K, B, W, seed=7)
    dt, dte = TORCH_DT[chan], TORCH_DT[ext]
    ls_t, lp_t = (torch.from_numpy(x).to(dt) for x in (ls_np, lp_np))
    raw_t, ck_t = _raw_extrinsics(ls_t, lp_t, dte, K, W, qs)
    le_t, aout_t = ck.siso_cells(ls_t, lp_t, raw_t, K, "maxlog", scale,
                                 nii_ckpt=ck_t, window=W, ext_qscale=qs,
                                 gather_idx=torch.from_numpy(table))
    to_jax = lambda x, d: jnp.asarray(convert.tb_to_cells(x)).astype(d)
    raw_np = raw_t.numpy() if ext == "int8" else raw_t.to(torch.float32).numpy()
    le_j, aout_j = jk.siso_cells(
        to_jax(ls_np, chan), to_jax(lp_np, chan), to_jax(raw_np, ext), K,
        "maxlog", scale, interpret=True, window=W, ext_qscale=qs,
        nii_ckpt=jnp.asarray(convert.ckpt_port_to_cells(ck_t.numpy())),
        gather_idx=jnp.asarray(table))
    want = convert.cells_to_tb(np.asarray(le_j.astype(jnp.float32)), B)
    np.testing.assert_allclose(le_t.to(torch.float32).numpy(), want,
                               atol=tol, rtol=0)
    want_ck = convert.ckpt_cells_to_port(np.asarray(aout_j), B)
    np.testing.assert_allclose(aout_t.numpy()[1:], want_ck[1:], atol=tol,
                               rtol=0)


@pytest.mark.parametrize("mode", ["maxlog", "linlog", "logmap"])
@pytest.mark.parametrize("chan,ext", [("bfloat16", "int8"),
                                      ("float32", "float32")])
def test_fold_equals_the_materialised_gather(mode, chan, ext):
    """(b) The folded call equals the unfolded call on a gathered copy:
    torch.equal on le and window starts, in every mode."""
    K, W, B = 168, 32, 4
    scale = 0.75 if mode == "maxlog" else 1.0
    qs = 0.25 if ext == "int8" else 0.0
    ls_np, lp_np, table = _streams(K, B, W, seed=8)
    ls_t, lp_t = (torch.from_numpy(x).to(TORCH_DT[chan]) for x in (ls_np, lp_np))
    raw, ck0 = _raw_extrinsics(ls_t, lp_t, TORCH_DT[ext], K, W, qs, mode, scale)
    idx = torch.from_numpy(table)
    kw = dict(nii_ckpt=ck0, window=W, ext_qscale=qs)
    le_f, a_f = ck.siso_cells(ls_t, lp_t, raw, K, mode, scale, gather_idx=idx,
                              **kw)
    le_m, a_m = ck.siso_cells(ls_t, lp_t, raw.index_select(0, idx.long()), K,
                              mode, scale, **kw)
    assert torch.equal(le_f, le_m) and torch.equal(a_f, a_m)
    le_p, a_p = ck.siso_nii_plain(ls_t, lp_t, raw, ck0, K, W, scale, qs, mode,
                                  gather_idx=idx)
    assert torch.equal(le_f, le_p) and torch.equal(a_f, a_p)
    assert not torch.equal(le_f, ck.siso_cells(ls_t, lp_t, raw, K, mode, scale,
                                               **kw)[0])


FOLD = dict(K=168, n_iters=4, mode="maxlog", ext_scale=0.75, siso="pallas",
            io_dtype="bfloat16", ext_dtype="int8", nii=True, window=32,
            fold_gather=True)


@pytest.mark.parametrize("early,ebn0", [("none", 1.5), ("crc", 2.5),
                                        ("sign", 2.0)])
def test_fold_decode_matches_jax_and_the_unfolded_decode(early, ebn0):
    """(c) turbo_decode with fold_gather=True, K=168, B=4, 4 iterations:
    hard bits and iteration counts equal to the JAX decode with the same
    option, L within 1e-4, and everything torch.equal to the port's own
    decode without the option."""
    jcfg = JaxConfig(**dict(FOLD, early_term=early))
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    assert tcfg.fold_gather and tcfg.siso == "cuda"
    inputs = make_decode_inputs(168, 4, seed=13, ebn0_db=ebn0,
                                with_crc=early == "crc")
    arrays = [x.numpy() for x in inputs]
    hj, ij, Lj = jax_decode(*[jnp.asarray(a) for a in arrays], jcfg)
    ht, it, Lt = turbo_decode(*arrays, tcfg, device="cpu")
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), atol=1e-4, rtol=0)
    h0, i0, L0 = turbo_decode(*arrays, dataclasses.replace(
        tcfg, fold_gather=False), device="cpu")
    assert torch.equal(ht, h0) and torch.equal(it, i0) and torch.equal(Lt, L0)


def test_fold_decode_launches_only_the_folded_contract(monkeypatch):
    """The fold loop passes a table to every SISO call (inv for SISO1, perm
    for SISO2) and runs one de-interleave after the lean loop."""
    from turbotpu_torch.decoder import turbo_cells
    seen = []
    real = turbo_cells.siso_cells

    def spy(*a, **kw):
        seen.append(kw.get("gather_idx"))
        return real(*a, **kw)
    monkeypatch.setattr(turbo_cells, "siso_cells", spy)
    K = 168
    cfg = DecoderConfig(**dict(FOLD, siso="cuda", n_iters=2))
    turbo_decode(*make_decode_inputs(K, 2, seed=1), cfg, device="cpu")
    assert len(seen) == 4 and all(t is not None and t.dtype == torch.int32
                                  for t in seen)
    np.testing.assert_array_equal(seen[0][:K].numpy(), qpp_inv(K))
    np.testing.assert_array_equal(seen[1][:K].numpy(), qpp_perm(K))
    np.testing.assert_array_equal(seen[1][K:].numpy(),
                                  np.arange(K, seen[1].shape[0]))


@pytest.mark.parametrize("how", ["perm_b", "group_tables", "exact"])
def test_fold_is_ignored_where_the_jax_code_ignores_it(how, monkeypatch):
    """(d) With per-codeword tables, grouped tables or the exact contract
    the option is ignored and the decode is the unfolded one."""
    from turbotpu_torch.decoder import turbo_cells
    real = turbo_cells.siso_cells

    def no_table(*a, **kw):
        assert kw.get("gather_idx") is None
        return real(*a, **kw)
    monkeypatch.setattr(turbo_cells, "siso_cells", no_table)
    K, B = 168, 3
    cfg = DecoderConfig(**dict(FOLD, siso="cuda", nii=how != "exact"))
    inputs = make_decode_inputs(K, B, seed=5, ebn0_db=2.0)
    pg, ig, gid = grouped_perm_tables([K] * B, K)
    kw = {"perm_b": dict(perm_b=pg[gid], inv_b=ig[gid]),
          "group_tables": dict(group_tables=(pg, ig, gid)), "exact": {}}[how]
    got = turbo_decode(*inputs, cfg, device="cpu", **kw)
    ref = turbo_decode(*inputs, dataclasses.replace(cfg, fold_gather=False),
                       device="cpu", **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_wrapper_checks_the_gather_table():
    T, B, K, W = 64, 4, 40, 32
    z = lambda dt=torch.float32: torch.zeros((T, B), dtype=dt)
    ckpt = torch.zeros((T // W, 8, B))
    idx = torch.arange(T, dtype=torch.int32)
    le, _ = ck.siso_cells(z(), z(), z(), K, "maxlog", window=W, nii_ckpt=ckpt,
                          gather_idx=idx)
    assert le.shape == (T, B)
    with pytest.raises(ValueError, match="NII"):
        ck.siso_cells(z(), z(), z(), K, "maxlog", window=W, gather_idx=idx)
    with pytest.raises(ValueError, match="int32"):
        ck.siso_cells(z(), z(), z(), K, "maxlog", window=W, nii_ckpt=ckpt,
                      gather_idx=idx.long())
    with pytest.raises(ValueError, match="int32"):
        ck.siso_cells(z(), z(), z(), K, "maxlog", window=W, nii_ckpt=ckpt,
                      gather_idx=idx[:-1])
    with pytest.raises(ValueError, match="NII contract only"):
        ck.kernel_name(False, "maxlog", fold=True)
    assert ck.kernel_name(True, "linlog", fold=True) == "siso_nii_fold_linlog"
    assert set(ck.LAUNCHES) == {
        f"siso_{c}{m}" for c in ("nii", "exact", "nii_fold", "bnd_nii",
                                 "bnd_exact")
        for m in ("", "_linlog", "_logmap")}
    # plain, folded and boundary libraries x 3 modes x 2 x 4 stream types
    # (float8_e4m3fn extrinsics the fourth)
    assert len(ck.build_targets()) == 3 * 3 * 2 * 4


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_row_gather_plain_matches_jax(dtype):
    """(e) row_gather's plain version against jnp.take and against the JAX
    package's row_gather_pallas in interpret mode, T=256, W=128."""
    T = 256
    rng = np.random.default_rng(0)
    idx = rng.permutation(T).astype(np.int32)
    src = (rng.normal(size=(T, 8 * 128)) * 20).astype(np.float32)
    src_t = torch.from_numpy(src).to(TORCH_DT[dtype])
    got = gi.row_gather(src_t, torch.from_numpy(idx))
    assert torch.equal(got, gi.row_gather_plain(src_t, torch.from_numpy(idx)))
    src_j = jnp.asarray(src_t.to(torch.float32).numpy()).astype(dtype)
    want = jnp.take(src_j, jnp.asarray(idx), axis=0)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    if dtype != "int8":     # the Pallas kernel is written for float rows
        jgi = _jax_experiment("gather_inkernel")
        pal = jgi.row_gather_pallas(src_j.reshape(T, 8, 128), jnp.asarray(idx),
                                    128, interpret=True)
        np.testing.assert_array_equal(
            got.to(torch.float32).numpy(),
            np.asarray(pal.astype(jnp.float32)).reshape(T, -1))


def test_row_gather_rejects_what_the_kernel_does_not_take():
    src = torch.zeros((8, 4))
    idx = torch.arange(8, dtype=torch.int32)
    assert gi.row_gather(src, idx).shape == (8, 4)
    with pytest.raises(ValueError, match="int32"):
        gi.row_gather(src, idx.long())
    with pytest.raises(ValueError, match="int32"):
        gi.row_gather(src, idx[:4])
    with pytest.raises(ValueError, match="contiguous"):
        gi.row_gather(torch.zeros((4, 8)).T, idx)
    with pytest.raises(ValueError, match="elements"):
        gi.row_gather(src.double(), idx)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gi.main([])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cb.calibrate()


@pytest.mark.parametrize("lanes", cb.LANES)
def test_issue_rate_plain_matches_the_closed_form(lanes):
    """(e) With x = 1 every chain grows by c = 0.5 per step, exactly in
    fp32: v = 1 + lane + 0.5 * steps."""
    n_ops = 4096
    steps = cb.chain_steps(n_ops, lanes)
    assert steps == n_ops // (2 * lanes * 8) * 8 and steps > 0
    got = cb.issue_rate(torch.ones(6), lanes, n_ops)
    want = 1.0 + np.arange(lanes, dtype=np.float32)[None, :] + 0.5 * steps
    np.testing.assert_array_equal(got.numpy(), np.broadcast_to(want, (6, lanes)))
    # a negative start never takes the add: max(v + c, v) = v for c < 0
    neg = cb.issue_rate_plain(torch.full((2,), -4.0), lanes, n_ops)
    np.testing.assert_array_equal(
        neg.numpy(), np.broadcast_to(-4.0 + np.arange(lanes), (2, lanes)))


def test_issue_rate_matches_the_jax_recurrence():
    """The JAX kernel sums its chains; the same sum from the port's chain
    values, one (8, 128) tile of ones, n_ops=4096, 8 chains."""
    import jax
    from jax.experimental import pallas as pl
    lanes, n_ops, unroll = 8, 4096, 8

    def kern(x_ref, o_ref):        # the body of _calibrate_vpu's kernel
        c = x_ref[...] * 0.5
        vs = tuple(x_ref[...] + float(i) for i in range(lanes))

        def body(i, vs):
            for _ in range(unroll):
                vs = tuple(jnp.maximum(v + c, v) for v in vs)
            return vs
        vs = jax.lax.fori_loop(0, n_ops // (2 * lanes * unroll), body, vs)
        acc = vs[0]
        for v in vs[1:]:
            acc = acc + v
        o_ref[...] = acc
    want = pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
        interpret=True)(jnp.ones((8, 128), jnp.float32))
    got = cb.issue_rate(torch.ones(8 * 128), lanes, n_ops).sum(dim=1)
    np.testing.assert_array_equal(got.numpy().reshape(8, 128), np.asarray(want))
    jcb = _jax_experiment("cost_breakdown")
    assert cb.OP_COUNT == jcb.OP_COUNT
    with pytest.raises(ValueError, match="lanes"):
        cb.issue_rate(torch.ones(4), 4)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["siso_nii_fold", "row_gather",
                                    "issue_rate"])
def test_new_kernels_match_plain_on_card(kernel):
    """(f) Needs a card: each of the three kernels against its plain
    version, equal, and its launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    if kernel == "siso_nii_fold":
        K, W, B = 168, 32, 70
        ls_np, lp_np, table = _streams(K, B, W, seed=11)
        ls, lp = (torch.from_numpy(x).to(dev, torch.bfloat16)
                  for x in (ls_np, lp_np))
        idx = torch.from_numpy(table).to(dev)
        T = ls.shape[0]
        raw, ain = ck.siso_cells(
            ls, lp, torch.zeros((T, B), dtype=torch.int8, device=dev), K,
            "maxlog", 0.75, window=W, ext_qscale=0.25,
            nii_ckpt=torch.zeros((T // W, 8, B), device=dev))
        before = ck.LAUNCHES["siso_nii_fold"]
        le, aout = ck.siso_cells(ls, lp, raw, K, "maxlog", 0.75, window=W,
                                 ext_qscale=0.25, nii_ckpt=ain, gather_idx=idx)
        assert ck.LAUNCHES["siso_nii_fold"] == before + 1
        le_p, aout_p = ck.siso_nii_plain(ls, lp, raw, ain, K, W, 0.75, 0.25,
                                         gather_idx=idx)
        assert torch.equal(le, le_p) and torch.equal(aout[1:], aout_p[1:])
    elif kernel == "row_gather":
        # rows of 16-byte multiples and of every narrower vector width
        for dt, B in ((torch.int8, 1024), (torch.bfloat16, 16384),
                      (torch.float32, 4), (torch.bfloat16, 70),
                      (torch.float32, 3), (torch.int8, 7)):
            src = (torch.randn((96, B), device=dev) * 20).to(dt)
            idx = torch.randperm(96, device=dev).to(torch.int32)
            before = gi.LAUNCHES["row_gather"]
            assert torch.equal(gi.row_gather(src, idx),
                               gi.row_gather_plain(src, idx))
            assert gi.LAUNCHES["row_gather"] == before + 1
    else:
        x = torch.rand(200, device=dev) + 0.5
        for lanes in cb.LANES:
            before = cb.LAUNCHES["issue_rate"]
            assert torch.equal(cb.issue_rate(x, lanes, 4096),
                               cb.issue_rate_plain(x, lanes, 4096))
            assert cb.LAUNCHES["issue_rate"] == before + 1
