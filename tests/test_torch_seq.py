"""The sequence-sharded decoder (dist/seq_parallel.py) and K4, the boundary
contracts of the SISO kernel, against the JAX package's, on the CPU.

Inputs are made from a seed with numpy and handed to both sides.  The JAX
side runs on the conftest's 8 fake CPU devices, its Pallas kernels in
interpret mode (three distinct interpret programs in this file: the two K4
calls in one jit, and two kernel-route decodes); the port runs on a local
mesh, where every shard lives in this process and the wrappers take their
kernels' plain versions because the tensors lie on the CPU.  The kernels
themselves are held to those plain versions on a card by the tests marked
`cuda` and by chip_smoke.py.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from turbotpu.decoder.turbo import DecoderConfig as JaxConfig
from turbotpu.dist import seq_parallel as jsp
from turbotpu.dist.mesh import make_mesh as jax_mesh
from turbotpu.siso import pallas_kernel as jk
from turbotpu_torch import DecoderConfig, convert, turbo_decode
from turbotpu_torch.dist import seq_parallel as sp
from turbotpu_torch.dist.mesh import make_mesh
from turbotpu_torch.harness.bench import make_decode_inputs
from turbotpu_torch.siso import cuda_kernel as ck
from turbotpu_torch.spec.qpp import qpp_perm


# ---------------------------------------------------------------------------
# geometry and routing tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_seq", [1, 2, 4])
@pytest.mark.parametrize("real_len", [None, 40])
def test_exchange_tables_equal_jax(n_seq, real_len):
    """The routing tables are numpy on both sides and must be identical,
    for QPP and a random permutation, with and without real_len."""
    K = 40
    C, _, _, KTp = sp.chunk_sizing(K + 3, n_seq, window=8)
    assert (C, KTp) == jsp.chunk_sizing(K + 3, n_seq, window=8)[::3]
    ext = np.arange(K, KTp)
    for perm in (qpp_perm(K), np.random.default_rng(n_seq).permutation(K)):
        perm_e = np.concatenate([perm, ext])
        got = sp.exchange_tables(perm_e, C, n_seq, real_len)
        want = jsp.exchange_tables(perm_e, C, n_seq, real_len)
        assert got[3] == want[3]
        for a, b in zip(got[:3], want[:3]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_seq", [1, 2, 4])
def test_exchange_applies_the_permutation(n_seq):
    """The partitioned exchange on a local mesh (gather of the send buckets,
    all_to_all, merged gather) equals le[perm_e] on the whole trellis, in
    both layouts it runs in, and with real_len the rows whose source is
    beyond K read zero."""
    K = 168
    C, _, _, KTp = sp.chunk_sizing(K + 3, n_seq)
    perm_e = np.concatenate([qpp_perm(K), np.arange(K, KTp)])
    mesh = make_mesh(2, n_seq, device="cpu")
    le = torch.arange(1, 2 * KTp * 3 + 1, dtype=torch.float32).reshape(
        2, KTp, 3)                      # two data rows, 3 codewords each
    chunks = [le[d, s * C:(s + 1) * C] for d, s in mesh.shards]
    for real_len in (None, K):
        want = le[:, perm_e].clone()
        if real_len is not None:
            want[:, perm_e >= real_len] = 0.0
        xch = sp.make_exchange(perm_e, C, mesh, real_len)
        got = xch(chunks)
        got_t = xch([c.T for c in chunks], dim=1)
        for (d, s), x, y in zip(mesh.shards, got, got_t):
            assert torch.equal(x, want[d, s * C:(s + 1) * C])
            assert torch.equal(y, want[d, s * C:(s + 1) * C].T)


def test_effective_seq_groups_and_crc_slices_equal_jax():
    base = dict(K=40, n_iters=2, nii=True)
    for groups, xch in ((1, "ppermute"), (2, "ppermute"), (2, "dma"),
                        (4, "ppermute")):
        for B in (1024, 1536, 2048, 4096):
            cfg = dict(base, seq_groups=groups, boundary_xch=xch)
            assert (sp.effective_seq_groups(DecoderConfig(**cfg), B)
                    == jsp.effective_seq_groups(JaxConfig(**cfg), B))
    for K, n_seq in ((40, 2), (168, 4), (6144, 2)):
        C = sp.chunk_sizing(K + 3, n_seq)[0]
        np.testing.assert_array_equal(
            sp._chunked_crc_matrix(K, 0x1864CFB, C, n_seq),
            jsp._chunked_crc_matrix(K, 0x1864CFB, C, n_seq))


def test_edge_layout_round_trip():
    x = np.random.default_rng(0).normal(size=(8, 1100)).astype(np.float32)
    cells = convert.edge_port_to_cells(x)
    assert cells.shape == (2, 8, 8, 128)
    np.testing.assert_array_equal(convert.edge_cells_to_port(cells, 1100), x)
    # codeword b's state s sits where the JAX layout puts it
    assert cells[1, 3, 0, 5] == x[3, 1024 + 5]


# ---------------------------------------------------------------------------
# K4: the boundary contracts
# ---------------------------------------------------------------------------

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


def test_k4_plain_matches_pallas_interpret():
    """K4's plain versions against the Pallas kernel's boundary contracts
    at KTp=96, W=32, max-log, bf16 channel and int8 extrinsic streams,
    edges and window starts made from the seed, row offset 70 of a global
    K=150 (the mask cuts the chunk at row 80): le codes, outgoing edges and
    the window table (slot 0 is never written) equal bit for bit (the int8
    dequantisation 0.75 x 0.25 is exact, so no FMA contraction can differ)."""
    T, B, W, K, off, scale, qs = 96, 5, 32, 150, 70, 0.75, 0.25
    rng = np.random.default_rng(41)
    bf = lambda x: torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    ls, lp = bf(rng.normal(size=(T, B)) * 3), bf(rng.normal(size=(T, B)) * 3)
    la = torch.from_numpy(rng.integers(-60, 61, (T, B)).astype(np.int8))
    a0, bT = (torch.from_numpy(rng.normal(size=(8, B)).astype(np.float32) * 4)
              for _ in range(2))
    ain = torch.from_numpy(rng.normal(size=(T // W, 8, B)).astype(np.float32))

    le_x, aout_x, bout_x = ck.siso_cells(ls, lp, la, K, "maxlog", scale,
                                         boundaries=(a0, bT), window=W,
                                         row_offset=off, ext_qscale=qs)
    le_n, tbl_n, eout_n, bout_n = ck.siso_cells(
        ls, lp, la, K, "maxlog", scale, nii_boundaries=(ain, a0, bT),
        window=W, row_offset=off, ext_qscale=qs)

    cells = lambda x, d: jnp.asarray(convert.tb_to_cells(x)).astype(d)
    f32 = lambda x: x.to(torch.float32).numpy()
    edge = lambda x: jnp.asarray(convert.edge_port_to_cells(x.numpy()))
    (jle_x, jaout_x, jbout_x), (jle_n, jtbl_n, jeout_n, jbout_n) = _jax_k4(
        K, W, scale, qs)(
        cells(f32(ls), jnp.bfloat16), cells(f32(lp), jnp.bfloat16),
        cells(la.numpy(), jnp.int8), edge(a0), edge(bT),
        jnp.asarray(convert.ckpt_port_to_cells(ain.numpy())),
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
    # the mask: rows at and beyond global row K read no a-priori
    assert not torch.equal(le_x, ck.siso_cells(
        ls, lp, la, K, "maxlog", scale, boundaries=(a0, bT), window=W,
        ext_qscale=qs)[0])


@pytest.mark.parametrize("mode", ["maxlog", "linlog", "logmap"])
def test_e0_identities(mode):
    """With a0 = bT = e0 and offset 0 the exact boundary contract is the
    exact kernel; with edge_in = bT = e0 the NII boundary contract is the
    NII kernel (le and window starts; slot 0 is never written).  torch.equal:
    the same arithmetic."""
    K, W, B = 168, 32, 6
    rng = np.random.default_rng(5)
    T = -(-(K + 3) // W) * W
    ls, lp = (torch.from_numpy(rng.normal(size=(T, B)).astype(np.float32) * 2)
              for _ in range(2))
    la = torch.from_numpy(rng.normal(size=(T, B)).astype(np.float32))
    ain = torch.from_numpy(rng.normal(size=(T // W, 8, B)).astype(np.float32))
    e0 = ck._e0(B, "cpu")
    le, _, _ = ck.siso_cells(ls, lp, la, K, mode, boundaries=(e0, e0),
                             window=W)
    assert torch.equal(le, ck.siso_cells(ls, lp, la, K, mode, window=W))
    le_n, tbl, _, _ = ck.siso_cells(ls, lp, la, K, mode, window=W,
                                    nii_boundaries=(ain, e0, e0))
    le_m, tbl_m = ck.siso_cells(ls, lp, la, K, mode, window=W, nii_ckpt=ain)
    assert torch.equal(le_n, le_m) and torch.equal(tbl[1:], tbl_m[1:])


@pytest.mark.parametrize("nii", [False, True])
def test_boundary_edges_written_into_given_tensors(nii):
    """edges_out: the boundary forms write their outgoing edges into the
    tensors given (the sequence decoder passes views of K6's send buffers)
    and return those, with the values of the call without it."""
    K, W, B = 168, 32, 5
    rng = np.random.default_rng(6)
    T = -(-(K + 3) // W) * W
    ls, lp, la = (torch.from_numpy(rng.normal(size=(T, B)).astype(np.float32))
                  for _ in range(3))
    a_in, b_in = (torch.from_numpy(rng.normal(size=(8, B)).astype(np.float32))
                  for _ in range(2))
    kw = (dict(nii_boundaries=(torch.zeros((T // W, 8, B)), a_in, b_in))
          if nii else dict(boundaries=(a_in, b_in)))
    want = ck.siso_cells(ls, lp, la, K, "maxlog", window=W, row_offset=8,
                         **kw)
    send = torch.zeros((2, 2, 8, B))
    out = (send[0, 1], send[1, 1])
    got = ck.siso_cells(ls, lp, la, K, "maxlog", window=W, row_offset=8,
                        edges_out=out, **kw)
    assert got[-2] is out[0] and got[-1] is out[1]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(send[:, 0], torch.zeros((2, 8, B)))
    with pytest.raises(ValueError, match="edges_out needs"):
        ck.siso_cells(ls, lp, la, K, "maxlog", window=W, edges_out=out)
    with pytest.raises(ValueError, match="edges_out must"):
        ck.siso_cells(ls, lp, la, K, "maxlog", window=W,
                      edges_out=(out[0], torch.zeros((8, B + 1))), **kw)


def test_wrapper_checks_the_boundary_operands():
    T, B, K, W = 64, 4, 40, 32
    z = torch.zeros((T, B))
    e, tbl = torch.zeros((8, B)), torch.zeros((T // W, 8, B))
    with pytest.raises(ValueError, match="mutually exclusive"):
        ck.siso_cells(z, z, z, K, "maxlog", window=W, nii_ckpt=tbl,
                      boundaries=(e, e))
    with pytest.raises(ValueError, match="row_offset"):
        ck.siso_cells(z, z, z, K, "maxlog", window=W, row_offset=8)
    with pytest.raises(ValueError, match="edges"):
        ck.siso_cells(z, z, z, K, "maxlog", window=W,
                      boundaries=(e, torch.zeros((8, B + 1))))
    with pytest.raises(ValueError, match="boundary form"):
        ck.kernel_name(True, "maxlog", fold=True, bnd=True)
    assert ck.kernel_name(False, "logmap", bnd=True) == "siso_bnd_exact_logmap"


# ---------------------------------------------------------------------------
# the sharded decoder against the JAX package's
# ---------------------------------------------------------------------------

CASES = {
    # kernel route: exact chunk contract, CRC, a 2x2 mesh, bf16 + int8
    "cells-exact-crc-2x2": ((2, 2), dict(
        K=168, n_iters=4, mode="maxlog", ext_scale=0.75, siso="pallas",
        io_dtype="bfloat16", ext_dtype="int8", early_term="crc"),
        dict(seed=4, ebn0_db=1.8, with_crc=True)),
    # kernel route: NII at window and chunk seams (3 windows of 16 per chunk),
    # lean, seq 4, fp32 streams
    "cells-nii-lean-1x4": ((1, 4), dict(
        K=168, n_iters=3, mode="maxlog", ext_scale=0.75, siso="pallas",
        nii=True, window=16), dict(seed=6, ebn0_db=1.5)),
    "scan-lean-1x2": ((1, 2), dict(K=168, n_iters=3, mode="maxlog"),
                      dict(seed=7, ebn0_db=1.5)),
    "scan-crc-1x4": ((1, 4), dict(K=168, n_iters=4, mode="maxlog",
                                  early_term="crc"),
                     dict(seed=8, ebn0_db=1.8, with_crc=True)),
    "scan-sign-2x2": ((2, 2), dict(K=168, n_iters=4, mode="linlog",
                                   early_term="sign"),
                      dict(seed=9, ebn0_db=1.8)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_seq_decode_matches_jax(case):
    """decode_seq_sharded on the port's local mesh against the JAX package's
    on its fake mesh, K=168, 4 codewords: hard bits and iteration counts
    equal, L within 1e-4 (XLA:CPU may contract la*scale + ls into an FMA on
    fp32 streams)."""
    (data, seq), cfg, batch = CASES[case]
    inputs = make_decode_inputs(cfg["K"], 4, **batch)
    hard_j, iters_j, L_j = jsp.decode_seq_sharded(
        jax_mesh(data=data, seq=seq), JaxConfig(**cfg))(
        *(jnp.asarray(x.numpy()) for x in inputs))
    hard, iters, L = sp.decode_seq_sharded(
        make_mesh(data, seq, device="cpu"), convert.config_from_dict(cfg))(
        *inputs)
    np.testing.assert_array_equal(hard.numpy(), np.asarray(hard_j))
    np.testing.assert_array_equal(iters.numpy(), np.asarray(iters_j))
    np.testing.assert_allclose(L.numpy(), np.asarray(L_j), atol=1e-4, rtol=0)
    if cfg.get("early_term") == "crc":
        assert iters.max() < cfg["n_iters"]     # the CRC exit fired


KERNEL = dict(K=168, n_iters=4, mode="maxlog", ext_scale=0.75, siso="cuda",
              io_dtype="bfloat16", ext_dtype="int8")


@pytest.mark.parametrize("nii,early", [(False, "crc"), (True, "none")])
def test_seq1_cells_matches_monolithic_exactly(nii, early):
    """With one seq shard the chunk is the whole trellis and the edges are
    e0: the kernel route is the monolithic decode, bit for bit (hard bits,
    iteration counts and L), on a 2x1 mesh."""
    cfg = DecoderConfig(**KERNEL, nii=nii, window=32, early_term=early)
    inputs = make_decode_inputs(168, 4, seed=3, ebn0_db=1.5, with_crc=True)
    got = sp.decode_seq_sharded(make_mesh(2, 1, device="cpu"), cfg)(*inputs)
    want = turbo_decode(*inputs, cfg, device="cpu")
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_seq_nii_single_window_equals_exact():
    """One window per chunk: the NII chunk contract and the exact one are
    the same computation, bit for bit."""
    inputs = make_decode_inputs(168, 2, seed=5, ebn0_db=1.2)
    mesh = make_mesh(1, 4, device="cpu")
    assert sp.chunk_sizing(171, 4)[2] == 1
    outs = [sp.decode_seq_sharded(mesh, DecoderConfig(**KERNEL, nii=nii))(
        *inputs) for nii in (False, True)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_seq_groups_split_equals_unsplit():
    """seq_groups=2 splits a 2048-codeword row into two independent groups
    of whole cells: a pure partition of the batch, so the outputs are those
    of the unsplit decode."""
    inputs = make_decode_inputs(40, 2048, seed=9, ebn0_db=2.0, with_crc=True)
    mesh = make_mesh(1, 2, device="cpu")
    base = dict(KERNEL, K=40, n_iters=2, nii=True, early_term="crc")
    one = sp.decode_seq_sharded(mesh, DecoderConfig(**base))(*inputs)
    two = sp.decode_seq_sharded(mesh, DecoderConfig(**base, seq_groups=2))(
        *inputs)
    assert sp.effective_seq_groups(DecoderConfig(**base, seq_groups=2),
                                   2048) == 2
    for a, b in zip(one, two):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["maxlog", "linlog", "logmap"])
def test_k4_kernels_match_plain_on_card(mode):
    """Needs a card: both boundary kernels against their plain versions,
    equal in every mode, and the e0 identities bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    dev = torch.device("cuda")
    T, B, W, K, off = 96, 70, 32, 150, 70
    rng = np.random.default_rng(12)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)
    ls, lp, la = t(T, B) * 2, t(T, B) * 2, t(T, B)
    a0, bT, ain = t(8, B), t(8, B), t(T // W, 8, B)
    got = ck.siso_cells(ls, lp, la, K, mode, boundaries=(a0, bT), window=W,
                        row_offset=off)
    want = ck.siso_bnd_exact_plain(ls, lp, la, a0, bT, K, W, mode=mode,
                                   row_offset=off)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    got = ck.siso_cells(ls, lp, la, K, mode, nii_boundaries=(ain, a0, bT),
                        window=W, row_offset=off)
    want = ck.siso_bnd_nii_plain(ls, lp, la, ain, a0, bT, K, W, mode=mode,
                                 row_offset=off)
    for k, (a, b) in enumerate(zip(got, want)):
        a, b = (a[1:], b[1:]) if k == 1 else (a, b)
        assert torch.equal(a, b)
    e0 = ck._e0(B, dev)
    assert torch.equal(ck.siso_cells(ls, lp, la, K, mode, window=W),
                       ck.siso_cells(ls, lp, la, K, mode, window=W,
                                     boundaries=(e0, e0))[0])
