"""The window-parallel schedule of the boundary SISO kernels (K4), on the CPU.

csrc/siso.cu runs the boundary contracts on the passes of the exact and NII
contracts, with the chunk's edges in place of e0: pass 1 walks beta backward
from the edge bT at the chunk end and alpha forward from a0 (exact) or every
window's alpha from its inherited start, window 0 from the received edge
(NII), leaving checkpoints at segment edges; pass 2 decodes every segment
alone from its two checkpoints (segment 0 from the alpha edge, the last one
from bT), and the outgoing edges come from pass 2: beta at row 0 from the
first segment, alpha at the chunk end from the last segment, which runs
its last block forward too.  A chunk of one segment has no pass 1.  The
a-priori mask is on the global row, row_offset + t < K.  The kernel cannot
run here.  `_bnd_window_parallel` below is a plain rendering of that
schedule with the same step functions, and it must equal
`siso_bnd_exact_plain` / `siso_bnd_nii_plain` (the serial schedule, which
the Pallas kernel is held to in tests/test_torch_seq.py and the CUDA kernel
on the card) bit for bit in le, the outgoing edges and the window table's
slots 1.., in every mode and stream type.  With e0 edges at offset 0 it is
the exact and NII renderings of tests/test_torch_exact.py and
tests/test_torch_nii.py.  On one shape the Pallas kernel in interpret mode
is held to the rendering directly.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_exact import _window_parallel
from test_torch_nii import _nii_window_parallel
from turbotpu.siso import pallas_kernel as jk
from turbotpu_torch import convert
from turbotpu_torch.dist.seq_parallel import chunk_sizing
from turbotpu_torch.harness.bench import make_decode_inputs
from turbotpu_torch.siso import cuda_kernel as ck

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "int8": torch.int8}
U = ck.UNROLL
PAIRS = [("bfloat16", "int8"), ("bfloat16", "bfloat16"),
         ("float32", "float32")]


def _bnd_window_parallel(ls, lp, la, ain, a_in, b_in, K_real, W, seg, scale,
                         qs, mode, row_offset=0):
    """A boundary contract in the kernel's window-parallel schedule: exact
    (ain None; any seg that divides the chunk) or NII (seg divides the
    window W), segments of `seg` steps.  Returns (le, aout, a_out, b_out) as
    the plain versions do; aout (NII only) has slot 0 zero."""
    T, B = ls.shape
    n_win, n_seg, nsub = T // W, T // seg, seg // U
    assert W % seg == 0 and seg % U == 0
    nii = ain is not None
    tb = ck._Tables(ls.device)
    f32 = torch.float32
    eff = scale * (qs if qs else 1.0)
    sm = torch.where(torch.arange(T) + row_offset < K_real,
                     torch.tensor(eff, dtype=f32),
                     torch.zeros((), dtype=f32))[:, None]
    A = -(la.to(f32) * sm + ls.to(f32))
    P = -lp.to(f32)
    G = torch.stack([torch.zeros_like(P), P, A, A + P], dim=1)

    bck = [None] * (n_seg - 1) + [b_in]
    ack = [a_in] + [None] * (n_seg - 1)
    aout = torch.zeros((n_win, 8, B), dtype=f32) if nii else None
    if n_seg > 1:
        # pass 1, beta: from b_in at the chunk end down to row seg
        beta = b_in
        for t in range(T - 1, seg - 1, -1):
            beta = ck._beta_step(beta, G[t], tb, mode)
            if t % U == 0:
                beta = ck._renorm(beta)
            if t % seg == 0:
                bck[t // seg - 1] = beta
        if nii:
            # pass 1, alpha: every window from its inherited start, window
            # 0 from the received edge
            for w in range(n_win):
                alpha = a_in if w == 0 else ain[w]
                for tw in range(W):
                    t = w * W + tw
                    if tw % seg == 0 and t > 0:
                        ack[t // seg] = alpha
                    alpha = ck._alpha_step(alpha, G[t], tb, mode)
                    if (tw + 1) % U == 0:
                        alpha = ck._renorm(alpha)
                if w + 1 < n_win:
                    aout[w + 1] = alpha
        else:
            # pass 1, alpha: from a0 over segments 0..n_seg-2
            alpha = a_in
            for t in range(T - seg):
                alpha = ck._alpha_step(alpha, G[t], tb, mode)
                if (t + 1) % U == 0:
                    alpha = ck._renorm(alpha)
                if (t + 1) % seg == 0:
                    ack[(t + 1) // seg] = alpha

    # pass 2: each segment alone, from its two checkpoints; the first and
    # the last segment give the outgoing edges
    le = torch.empty((T, B), dtype=la.dtype)
    a_out = b_out = None
    for j in reversed(range(n_seg)):      # any order: segments are independent
        base, last = j * seg, j == n_seg - 1
        sub, alpha = [], ack[j]
        for i in range(nsub):
            sub.append(alpha)
            if i + 1 < nsub or last:
                for t in range(base + i * U, base + (i + 1) * U):
                    alpha = ck._alpha_step(alpha, G[t], tb, mode)
                alpha = ck._renorm(alpha)
        if last:
            a_out = alpha
        beta = bck[j]
        for i in reversed(range(nsub)):
            t0 = base + i * U
            at = [sub[i]]
            for k in range(U - 1):
                at.append(ck._alpha_step(at[-1], G[t0 + k], tb, mode))
            for k in reversed(range(U)):
                le[t0 + k] = ck._quantize_le(
                    ck._extrinsic(at[k], beta, P[t0 + k], tb, mode),
                    la.dtype, qs)
                beta = ck._beta_step(beta, G[t0 + k], tb, mode)
            beta = ck._renorm(beta)
        if j == 0:
            b_out = beta
    return le, aout, a_out, b_out


def _chunk_case(K, n_seq, window, B, chan, ext, seed, mode, j):
    """Chunk j of a decoder-padded stream pair of one SISO, cut as the
    sequence-sharded decoder cuts it, with an a-priori stream and a beta
    edge from a cold call on the chunk, an alpha edge from a call on chunk
    0, and (NII) a window table from a cold call: edges taken from earlier
    calls, as the decoder's are."""
    C, W, n_win, KTp = chunk_sizing(K + 3, n_seq, window)
    ls, lp1, _, t1, _ = (x.numpy() for x in
                         make_decode_inputs(K, B, seed=seed, ebn0_db=1.0))
    pad = lambda body, tail, v: torch.from_numpy(np.ascontiguousarray(np.pad(
        np.concatenate([body, tail], 1), ((0, 0), (0, KTp - K - 3)),
        constant_values=v).T.astype(np.float32))).to(TORCH_DT[chan])
    ls_t, lp_t = pad(ls, t1[:, 0::2], ck.BIG), pad(lp1, t1[:, 1::2], 0.0)
    qs = 0.25 if ext == "int8" else 0.0
    scale = 0.75 if mode == "maxlog" else 1.0
    first, cur = (ls_t[:C], lp_t[:C]), (ls_t[j * C:(j + 1) * C].contiguous(),
                                        lp_t[j * C:(j + 1) * C].contiguous())
    uni = torch.zeros((8, B))
    z = torch.zeros((C, B), dtype=TORCH_DT[ext])
    opt = dict(window=W, ext_qscale=qs)
    _, a_edge, _ = ck.siso_cells(*first, z, K, mode, scale,
                                 boundaries=(ck._e0(B, "cpu"), uni), **opt)
    la, _, b_edge = ck.siso_cells(*cur, z, K, mode, scale,
                                  boundaries=(uni, uni), row_offset=j * C,
                                  **opt)
    tbl = ck.siso_cells(*cur, z, K, mode, scale, row_offset=j * C,
                        nii_boundaries=(torch.zeros((n_win, 8, B)), uni, uni),
                        **opt)[1]
    tbl[0] = 0.0                          # slot 0 is never written
    assert la.to(torch.float32).abs().max() > 0
    return (*cur, la, tbl, a_edge, b_edge, K, C, W, scale, qs, j * C)


def _assert_equal_to_plain(nii, mode, case, segs):
    ls, lp, la, tbl, a_edge, b_edge, K, C, W, scale, qs, off = case
    if nii:
        want = ck.siso_bnd_nii_plain(ls, lp, la, tbl, a_edge, b_edge, K, W,
                                     scale, qs, mode, row_offset=off)
    else:
        want = ck.siso_bnd_exact_plain(ls, lp, la, a_edge, b_edge, K, W,
                                       scale, qs, mode, row_offset=off)
        want = (want[0], None, *want[1:])
    assert ck.exact_segment(W if nii else C) in segs
    for seg in segs:
        got = _bnd_window_parallel(ls, lp, la, tbl if nii else None, a_edge,
                                   b_edge, K, W, seg, scale, qs, mode, off)
        assert torch.equal(got[0], want[0]), seg
        assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])
        if nii:
            assert torch.equal(got[1][1:], want[1][1:]), seg


@pytest.mark.parametrize("mode", ["maxlog", "linlog", "logmap"])
@pytest.mark.parametrize("chan,ext", PAIRS)
@pytest.mark.parametrize("nii", [False, True])
def test_boundary_schedule_equals_the_serial_plain_version(nii, mode, chan,
                                                           ext):
    """The last chunk of K=168 at seq=2 (C=96, three windows of 32, row
    offset 96: global row K falls at chunk row 72), B=6 (not a multiple of
    4): le, the outgoing edges and aout[1:] equal bit for bit, on segments
    of 8 and the kernel's own 32."""
    case = _chunk_case(168, 2, 32, 6, chan, ext, 41, mode, 1)
    assert case[7] == 96 and case[-1] == 96
    _assert_equal_to_plain(nii, mode, case, (8, 32))


@pytest.mark.parametrize("mode", ["maxlog", "linlog", "logmap"])
@pytest.mark.parametrize("nii", [False, True])
@pytest.mark.parametrize("j", [0, 1])
def test_boundary_schedule_one_segment(nii, mode, j):
    """A chunk of one segment (K=120 at seq=2: chunks of 64 steps, one
    window): no pass 1, both edges come from the one segment of pass 2;
    the first chunk and the last, where global row K falls at chunk row 56.
    B=5, bf16 channel and int8 extrinsic streams."""
    case = _chunk_case(120, 2, 0, 5, "bfloat16", "int8", 42, mode, j)
    assert case[7] == case[8] == ck.exact_segment(case[7]) == 64
    _assert_equal_to_plain(nii, mode, case, (64,))


@pytest.mark.parametrize("mode", ["maxlog", "linlog", "logmap"])
def test_e0_edges_give_the_non_boundary_renderings(mode):
    """With e0 at both ends and offset 0 the boundary rendering is the
    exact and NII renderings (le and window table bit for bit), K=168 in
    windows of 32, B=7, bf16 channel and int8 extrinsic streams."""
    W, B = 32, 7
    ls, lp, _, _, _, _, K, C, _, scale, qs, off = _chunk_case(
        168, 1, W, B, "bfloat16", "int8", 43, mode, 0)
    assert off == 0 and C == 192
    la, ain = ck.siso_cells(ls, lp, torch.zeros((C, B), dtype=torch.int8), K,
                            mode, scale, window=W, ext_qscale=qs,
                            nii_ckpt=torch.zeros((C // W, 8, B)))
    e0 = ck._e0(B, "cpu")
    seg = ck.exact_segment(C)
    le_x = _bnd_window_parallel(ls, lp, la, None, e0, e0, K, seg, seg, scale,
                                qs, mode)[0]
    assert torch.equal(le_x, _window_parallel(ls, lp, la, K, seg, scale, qs,
                                              mode))
    le_n, aout_n, _, _ = _bnd_window_parallel(ls, lp, la, ain, e0, e0, K, W,
                                              W, scale, qs, mode)
    le_m, aout_m = _nii_window_parallel(ls, lp, la, ain, K, W, W, scale, qs,
                                        mode)
    assert torch.equal(le_n, le_m) and torch.equal(aout_n[1:], aout_m[1:])


@functools.lru_cache(maxsize=None)
def _jax_k4(K, W, scale, qs):
    """Both boundary contracts of the Pallas kernel, interpret mode, one
    jit (one compile)."""

    @jax.jit
    def run(ls, lp, la, a0, bT, ain, off):
        exact = jk.siso_cells(ls, lp, la, K, "maxlog", scale,
                              boundaries=(a0, bT), interpret=True, window=W,
                              row_offset=off, ext_qscale=qs)
        nii = jk.siso_cells(ls, lp, la, K, "maxlog", scale,
                            nii_boundaries=(ain, a0, bT), interpret=True,
                            window=W, row_offset=off, ext_qscale=qs)
        return exact, nii
    return run


def test_pallas_interpret_equals_the_boundary_schedule():
    """The reference itself: the JAX package's Pallas kernel (both boundary
    contracts, interpret mode) gives the rendering's le codes, outgoing
    edges and window table bit for bit on the case of the first test
    (max-log, bf16 channel and int8 extrinsic streams, B=6)."""
    ls, lp, la, tbl, a_edge, b_edge, K, C, W, scale, qs, off = _chunk_case(
        168, 2, 32, 6, "bfloat16", "int8", 41, "maxlog", 1)
    B = ls.shape[1]
    seg = ck.exact_segment(C)
    le_x, _, aout_x, bout_x = _bnd_window_parallel(
        ls, lp, la, None, a_edge, b_edge, K, W, seg, scale, qs, "maxlog", off)
    le_n, tbl_n, eout_n, bout_n = _bnd_window_parallel(
        ls, lp, la, tbl, a_edge, b_edge, K, W, ck.exact_segment(W), scale, qs,
        "maxlog", off)

    cells = lambda x, d: jnp.asarray(convert.tb_to_cells(x)).astype(d)
    edge = lambda x: jnp.asarray(convert.edge_port_to_cells(x.numpy()))
    (jle_x, jaout_x, jbout_x), (jle_n, jtbl_n, jeout_n, jbout_n) = _jax_k4(
        K, W, scale, qs)(
        cells(ls.float().numpy(), jnp.bfloat16),
        cells(lp.float().numpy(), jnp.bfloat16), cells(la.numpy(), jnp.int8),
        edge(a_edge), edge(b_edge),
        jnp.asarray(convert.ckpt_port_to_cells(tbl.numpy())),
        jnp.asarray([off], jnp.int32))
    from_edge = lambda x: convert.edge_cells_to_port(np.asarray(x), B)
    np.testing.assert_array_equal(
        le_x.numpy(), convert.cells_to_tb(np.asarray(jle_x), B))
    np.testing.assert_array_equal(aout_x.numpy(), from_edge(jaout_x))
    np.testing.assert_array_equal(bout_x.numpy(), from_edge(jbout_x))
    np.testing.assert_array_equal(
        le_n.numpy(), convert.cells_to_tb(np.asarray(jle_n), B))
    np.testing.assert_array_equal(
        tbl_n.numpy()[1:], convert.ckpt_cells_to_port(np.asarray(jtbl_n), B)[1:])
    np.testing.assert_array_equal(eout_n.numpy(), from_edge(jeout_n))
    np.testing.assert_array_equal(bout_n.numpy(), from_edge(jbout_n))
