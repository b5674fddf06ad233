"""The linlog and log-MAP SISO kernels' plain PyTorch versions against the JAX
package's Pallas kernel in interpret mode, on the CPU.

Inputs are made from a seed with numpy and handed to both sides; layouts
cross through turbotpu_torch.convert.  The CUDA kernels themselves are held
against the same plain versions on a card by the test marked `cuda` and by
chip_smoke.py.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from turbotpu.siso import pallas_kernel as jk
from turbotpu.siso.scan import siso_decode_scan as j_scan
from turbotpu_torch import _device, convert
from turbotpu_torch.harness.bench import make_decode_inputs
from turbotpu_torch.siso import cuda_kernel as ck

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "int8": torch.int8}


def _streams(K, B, W, seed):
    """fp32 (KTp, B) numpy streams of one SISO, padded as the decoder pads."""
    ls, lp1, _, t1, _ = (x.numpy() for x in
                         make_decode_inputs(K, B, seed=seed, ebn0_db=1.0))
    KTp = -(-(K + 3) // W) * W
    pad = lambda body, tail, v: np.ascontiguousarray(np.pad(
        np.concatenate([body, tail], 1), ((0, 0), (0, KTp - K - 3)),
        constant_values=v).T.astype(np.float32))
    return pad(ls, t1[:, 0::2], jk.BIG), pad(lp1, t1[:, 1::2], 0.0)


def _to_jax(x_tb, dtype):
    return jnp.asarray(convert.tb_to_cells(x_tb)).astype(dtype)


@pytest.mark.parametrize("K,W,mode,nii,ext", [
    (168, 32, "linlog", True, "float32"), (168, 32, "linlog", False, "float32"),
    (168, 32, "logmap", True, "float32"), (168, 32, "logmap", False, "float32"),
    (40, 48, "linlog", False, "float32"), (40, 16, "logmap", True, "float32"),
    (168, 32, "linlog", False, "int8")])
def test_mode_matches_pallas_interpret(K, W, mode, nii, ext):
    """One SISO call, B=6, fed a non-zero a-priori stream and (NII) non-zero
    window starts from a previous call of the port.  fp32 le and checkpoints
    within 1e-4 (the bar of tests/unit/test_siso_variants.py); the int8 case
    must give equal codes.  linlog at scale 1.0 has no inexact product left
    for XLA:CPU to contract (0.25 * |a - b| is exact), so it is also counted
    how many values differ at all: none are expected, and the count is
    asserted so a drift shows."""
    B, scale = 6, 1.0
    qs = 0.25 if ext == "int8" else 0.0
    ls_np, lp_np = _streams(K, B, W, seed=K + W)
    T = ls_np.shape[0]
    n_win = T // W
    dte = TORCH_DT[ext]
    ls_t, lp_t = torch.from_numpy(ls_np), torch.from_numpy(lp_np)
    ls_j, lp_j = _to_jax(ls_np, "float32"), _to_jax(lp_np, "float32")
    la_t, ck_t = ck.siso_cells(ls_t, lp_t, torch.zeros((T, B), dtype=dte), K,
                               mode, scale, window=W, ext_qscale=qs,
                               nii_ckpt=torch.zeros((n_win, 8, B)))
    assert la_t.to(torch.float32).abs().max() > 0
    la_j = _to_jax(la_t.numpy(), ext)
    kw = dict(window=W, ext_qscale=qs)
    if nii:
        le_t, out_t = ck.siso_cells(ls_t, lp_t, la_t, K, mode, scale,
                                    nii_ckpt=ck_t, **kw)
        le_j, out_j = jk.siso_cells(
            ls_j, lp_j, la_j, K, mode, scale, interpret=True,
            nii_ckpt=jnp.asarray(convert.ckpt_port_to_cells(ck_t.numpy())),
            **kw)
        np.testing.assert_allclose(
            out_t.numpy()[1:],
            convert.ckpt_cells_to_port(np.asarray(out_j), B)[1:],
            atol=1e-4, rtol=0)
    else:
        le_t = ck.siso_cells(ls_t, lp_t, la_t, K, mode, scale, **kw)
        le_j = jk.siso_cells(ls_j, lp_j, la_j, K, mode, scale,
                             interpret=True, **kw)
    got = le_t.to(torch.float32).numpy()[:K]
    want = convert.cells_to_tb(np.asarray(le_j.astype(jnp.float32)), B)[:K]
    if ext == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if mode == "linlog":
        assert int((got != want).sum()) == 0


@pytest.mark.parametrize("mode", ["linlog", "logmap"])
def test_exact_contract_matches_scan_siso(mode):
    """The exact contract is the unwindowed BCJR: through the drop-in entry
    against the JAX scan SISO.  log-MAP within 1e-4 (the scan reduces the
    extrinsic with logsumexp, the kernel pairwise); linlog follows the same
    pairwise tree in both, 1e-4 for the renormalisation cadence."""
    rng = np.random.default_rng(5)
    ls, lp, la = ((2.0 * rng.normal(size=s)).astype(np.float32)
                  for s in ((3, 171), (3, 171), (3, 168)))
    Lj, lej = j_scan(jnp.asarray(ls), jnp.asarray(lp), jnp.asarray(la),
                     mode=mode)
    Lt, let = ck.siso_decode_cuda(*map(torch.from_numpy, (ls, lp, la)),
                                  mode=mode)
    np.testing.assert_allclose(let.numpy(), np.asarray(lej), atol=1e-4, rtol=0)
    np.testing.assert_allclose(Lt.numpy(), np.asarray(Lj), atol=1e-4, rtol=0)


def test_modes_differ_and_launch_names():
    """The three modes are three functions (a mode that silently ran another
    mode's arithmetic would pass a self-comparison), and each contract/mode
    pair has its own launch counter."""
    K, W, B = 40, 48, 4
    ls_np, lp_np = _streams(K, B, W, seed=3)
    ls, lp = torch.from_numpy(ls_np), torch.from_numpy(lp_np)
    la = torch.from_numpy(np.random.default_rng(3).normal(
        size=ls_np.shape).astype(np.float32))
    le = {m: ck.siso_exact_plain(ls, lp, la, K, W, 1.0, mode=m)[:K]
          for m in ("maxlog", "linlog", "logmap")}
    assert (le["maxlog"] - le["logmap"]).abs().max() > 1e-2
    assert (le["linlog"] - le["maxlog"]).abs().max() > 1e-2
    assert (le["linlog"] - le["logmap"]).abs().max() > 1e-4
    # linlog tracks log-MAP more closely than max-log does
    assert ((le["linlog"] - le["logmap"]).abs().mean()
            < (le["maxlog"] - le["logmap"]).abs().mean())
    assert sorted(ck.KERNEL_NAMES) == sorted(
        ["siso_nii", "siso_exact", "siso_nii_linlog", "siso_exact_linlog",
         "siso_nii_logmap", "siso_exact_logmap", "siso_nii_fold",
         "siso_nii_fold_linlog", "siso_nii_fold_logmap", "siso_bnd_nii",
         "siso_bnd_exact", "siso_bnd_nii_linlog", "siso_bnd_exact_linlog",
         "siso_bnd_nii_logmap", "siso_bnd_exact_logmap"])
    assert ck.kernel_name(True, "maxlog") == "siso_nii"
    assert ck.kernel_name(False, "linlog") == "siso_exact_linlog"
    before = _device.LAUNCHES.copy()
    ck.siso_cells(ls, lp, la, K, "linlog", window=W)
    assert _device.LAUNCHES == before  # a CPU tensor launches nothing


@pytest.mark.cuda
@pytest.mark.parametrize("mode,tol", [("linlog", 0.0), ("logmap", 1e-4)])
def test_mode_kernels_match_plain_on_card(mode, tol):
    """Needs a card: the linlog / log-MAP CUDA kernels against their plain
    versions, fp32 streams."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    K, W, B = 168, 32, 70
    dev = torch.device("cuda")
    ls, lp = (torch.from_numpy(x).to(dev) for x in _streams(K, B, W, seed=11))
    T = ls.shape[0]
    before = _device.LAUNCHES.copy()
    la, ain = ck.siso_cells(ls, lp, torch.zeros((T, B), device=dev), K, mode,
                            window=W,
                            nii_ckpt=torch.zeros((T // W, 8, B), device=dev))
    le, aout = ck.siso_cells(ls, lp, la, K, mode, window=W, nii_ckpt=ain)
    le_x = ck.siso_cells(ls, lp, la, K, mode, window=W)
    for name, n in ((f"siso_nii_{mode}", 2), (f"siso_exact_{mode}", 1)):
        assert _device.LAUNCHES[name] == before[name] + n
    le_p, aout_p = ck.siso_nii_plain(ls, lp, la, ain, K, W, mode=mode)
    le_xp = ck.siso_exact_plain(ls, lp, la, K, W, mode=mode)
    assert float((le - le_p).abs().max()) <= tol
    assert float((aout[1:] - aout_p[1:]).abs().max()) <= tol
    assert float((le_x - le_xp).abs().max()) <= tol
