"""Sequence-sharded decode: each codeword's trellis cut into chunks over the
'seq' axis of a (data, seq) mesh, the batch split over 'data'.

Counterpart of turbotpu/dist/seq_parallel.py.  Each seq shard runs the SISO
recursions over its chunk of C trellis steps, starting from boundary metrics
that its ring neighbours sent after the previous iteration (next-iteration
initialisation at the chunk seams; iteration 0 starts from uniform metrics,
and the first and last chunks from the exact trellis edge e0).  Every
per-iteration tensor stays chunk-local: channel streams are cut once, as row
slices [j*C, (j+1)*C) of the time-major (KTp, B) streams (contiguous, so no
copy), and the extrinsic interleave between the half-iterations is a
partitioned exchange: a gather of the rows each peer needs, one all_to_all of
those buckets, one merged gather (`make_exchange`).  CRC early termination
sums shard-local partial syndromes over seq (GF(2) linearity; exact in fp32:
the sums are integers below K), and the early exit is in lockstep over data
(on the kernel route its read waits behind the next iteration's SISO1
launches, as in decoder/turbo_cells.py).

Two routes, as in the reference: `siso="cuda"` runs the chunk SISO through
K4, the boundary contracts of the fused kernel (siso/cuda_kernel.py:
`siso_cells(boundaries=)` exact, `nii_boundaries=` NII at window and chunk
seams alike), with the a-priori mask on the global row (row_offset); any
other siso runs siso/scan.py's `siso_scan_boundary` on batch-major chunks.
Edges ride `Mesh.seq_ring` (the reference's ppermute pair), or with
`boundary_xch="dma"` one K6 launch per iteration (dist/dma.py; its error
flag is read once, after the iterations).  The mesh's backend decides how
the collectives move data; the decode code is the same.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from ..decoder.early_term import _crc_check_matrix_np
from ..decoder.turbo import DecoderConfig
from ..siso.cuda_kernel import BIG
from ..spec.trellis import N_STATES
from .mesh import Mesh

CELL = 1024          # the reference's cell: seq_groups count in these units


def _round_up(x, m):
    return -(-x // m) * m


def chunk_sizing(KT: int, n_seq: int, window: int = 0
                 ) -> tuple[int, int, int, int]:
    """The chunk/window geometry of the kernel route: (C, W, n_win, KTp).
    A chunk is a multiple of the window (cfg.window, or 128 for chunks of
    more than 248 steps, else one window of the chunk rounded to 8)."""
    c0 = -(-KT // n_seq)
    W = window or (128 if c0 > 248 else 0)
    if W and c0 > W:
        C = _round_up(c0, W)
    else:
        C = _round_up(c0, 8)
        W = C
    return C, W, C // W, C * n_seq


def effective_seq_groups(cfg: DecoderConfig, B_shard: int) -> int:
    """The seq_groups the kernel route runs for a per-data-shard batch of
    B_shard: the batch splits into groups of whole 1024-codeword cells (the
    reference's unit, so the two agree), and not under the dma boundary
    exchange, whose barrier assumes one boundary round per iteration.
    Otherwise 1; the C5 record reports it."""
    n_cells = -(-B_shard // CELL)
    if (cfg.seq_groups > 1 and n_cells % cfg.seq_groups == 0
            and cfg.boundary_xch != "dma"):
        return cfg.seq_groups
    return 1


# ---------------------------------------------------------------------------
# Partitioned extrinsic exchange
# ---------------------------------------------------------------------------

def exchange_tables(perm_e: np.ndarray, C: int, n_seq: int,
                    real_len: int | None = None):
    """Static routing tables for la_local[t] = le[perm_e[j*C + t]] with le
    chunk-sharded over seq (C rows per shard).

    real_len: if given, an entry whose SOURCE row is >= real_len reads the
    pad (zero) slot instead: the "extrinsics beyond row K read as a-priori 0"
    mask folded into the gather.

    Returns (local_tbl, send_tbl, slot_tbl, M):
      local_tbl (n_seq, C):        shard j's same-shard source offsets (C =
                                   pad, reads a zero row);
      send_tbl (n_seq, n_seq, M):  send_tbl[s, j, m] = offset on shard s of
                                   the m-th value s ships to j (C = pad);
      slot_tbl (n_seq, n_seq*M):   slot_tbl[j, s*M+m] = destination offset on
                                   shard j of that value (C = pad, dropped);
      M: the largest bucket over s != j; 0 when nothing crosses shards.
    """
    KTp = C * n_seq
    assert len(perm_e) == KTp
    src = perm_e // C
    off = perm_e % C
    local_tbl = np.full((n_seq, C), C, np.int32)
    buckets: dict[tuple[int, int], list[tuple[int, int]]] = {}
    M = 0
    for j in range(n_seq):
        for t in range(C):
            if real_len is not None and perm_e[j * C + t] >= real_len:
                continue                        # reads the zero row
            s = int(src[j * C + t])
            o = int(off[j * C + t])
            if s == j:
                local_tbl[j, t] = o
            else:
                b = buckets.setdefault((s, j), [])
                b.append((t, o))
                M = max(M, len(b))
    send_tbl = np.full((n_seq, n_seq, M), C, np.int32)
    slot_tbl = np.full((n_seq, n_seq * M), C, np.int32)
    for (s, j), pairs in buckets.items():
        for m, (t, o) in enumerate(pairs):
            send_tbl[s, j, m] = o
            slot_tbl[j, s * M + m] = t
    return local_tbl, send_tbl, slot_tbl, M


class _Take:
    """Row gather through one shard's table along `dim`; entries >= n_src
    read zero."""

    def __init__(self, tbl: np.ndarray, n_src: int, device):
        pad = tbl >= n_src
        self.idx = torch.from_numpy(np.where(pad, 0, tbl).astype(np.int64)
                                    ).to(device)
        self.keep = (torch.from_numpy(~pad).to(device) if pad.any() else None)

    def __call__(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        out = x.index_select(dim, self.idx)
        if self.keep is None:
            return out
        shape = [1] * x.dim()
        shape[dim] = -1
        return torch.where(self.keep.view(shape), out,
                           torch.zeros((), dtype=x.dtype, device=x.device))


class Exchange:
    """fn(le, dim) -> la over the shards a mesh holds: le is one chunk per
    shard (rows along `dim`), la[j][t] = le_global[perm_e[j*C + t]].

    Per shard: a gather of the send buckets, one all_to_all of them over
    seq, one gather from [local rows ++ received rows] (the reference's
    merged form; the pad sentinel reads zero).  With nothing crossing shards
    (n_seq == 1) it is one gather, as in the monolithic decoder."""

    def __init__(self, perm_e: np.ndarray, C: int, mesh: Mesh,
                 real_len: int | None = None):
        n_seq = mesh.seq
        local_np, send_np, slot_np, M = exchange_tables(perm_e, C, n_seq,
                                                        real_len)
        S = C + n_seq * M
        merged_np = np.where(local_np == C, S, local_np).astype(np.int32)
        for j in range(n_seq):
            for r in range(n_seq * M):
                t = slot_np[j, r]
                if t != C:
                    merged_np[j, t] = C + r
        dev = mesh.device
        self.mesh, self.M = mesh, M
        self.js = [s for _, s in mesh.shards]
        self.local = {j: _Take(local_np[j], C, dev) for j in set(self.js)}
        self.send = {j: _Take(send_np[j].reshape(-1), C, dev)
                     for j in set(self.js)}
        self.merged = {j: _Take(merged_np[j], S, dev) for j in set(self.js)}

    def __call__(self, le: list, dim: int = 0) -> list:
        if self.M == 0:
            return [self.local[j](x, dim) for x, j in zip(le, self.js)]
        # the per-peer send buckets, rows along dim 0 (the all_to_all
        # payload), then la from [local rows ++ received rows] in one gather
        sb = [self.send[j](x, dim).movedim(dim, 0).contiguous()
              for x, j in zip(le, self.js)]
        rb = self.mesh.seq_all_to_all(sb)
        return [self.merged[j](torch.cat([x, r.movedim(0, dim)], dim), dim)
                for x, r, j in zip(le, rb, self.js)]


def make_exchange(perm_e: np.ndarray, C: int, mesh: Mesh,
                  real_len: int | None = None) -> Exchange:
    """The partitioned exchange applying perm_e across chunk-sharded rows."""
    return Exchange(perm_e, C, mesh, real_len)


def _chunked_crc_matrix(K: int, crc_poly: int, C: int, n_seq: int):
    """(n_seq, C, 24) per-shard slices of the CRC check matrix, zero beyond
    K so pad-row hard bits contribute nothing."""
    G = _crc_check_matrix_np(K, crc_poly)
    Gp = np.zeros((C * n_seq, G.shape[1]), G.dtype)
    Gp[:K] = G
    return Gp.reshape(n_seq, C, G.shape[1])


def _extended_tables(cfg: DecoderConfig, KTp: int):
    """perm and inv extended by the identity over the pad rows K..KTp."""
    ext = np.arange(cfg.K, KTp, dtype=np.int64)
    return (np.concatenate([cfg.perm().astype(np.int64), ext]),
            np.concatenate([cfg.inv().astype(np.int64), ext]))


def _check_crc_matmul(dev: torch.device) -> None:
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the CRC syndrome needs an exact fp32 matmul: "
            "torch.backends.cuda.matmul.allow_tf32 must be False")


def decode_seq_sharded(mesh: Mesh, cfg: DecoderConfig):
    """The sharded decoder for canonical-format inputs.

    Returns fn(ls, lp1, lp2, tail1, tail2) -> (hard, iters, L): (B, K) int8,
    (B,) int32, (B, K) fp32 on mesh.device.  On a local mesh the inputs are
    the whole batch (B a multiple of mesh.data); on a process mesh they are
    this rank's data row's batch, and so are the outputs.  `cfg.siso ==
    "cuda"` selects the kernel route, anything else the scan route.
    Homogeneous-K batches only, as in the reference (its mixed-K decoding
    shards over data, through dist/data_parallel.py's monolithic decode)."""
    if cfg.siso == "cuda":
        return _decode_seq_sharded_cells(mesh, cfg)
    return _decode_seq_sharded_scan(mesh, cfg)


def _inputs(mesh: Mesh, args):
    return [torch.as_tensor(x).to(device=mesh.device, dtype=torch.float32)
            for x in args]


def _decode_seq_sharded_scan(mesh: Mesh, cfg: DecoderConfig):
    from ..siso.scan import NEG, siso_scan_boundary
    n_seq = mesh.seq
    K = cfg.K
    KT = K + 3
    # The scan SISO has no window: C rounds to 8 only (an explicit window of
    # 8 in the shared geometry).
    C, _, _, KTp = chunk_sizing(KT, n_seq, window=8)
    perm_e, inv_e = _extended_tables(cfg, KTp)
    # real_len folds the "extrinsics beyond row K are garbage" mask into the
    # routing tables (sources >= K read zero): no masking pass in the loop.
    xch_perm = make_exchange(perm_e, C, mesh, real_len=K)
    xch_inv = make_exchange(inv_e, C, mesh, real_len=K)
    scale = cfg.resolved_ext_scale()
    dev = mesh.device
    js = [s for _, s in mesh.shards]
    perm = torch.from_numpy(cfg.perm().astype(np.int64)).to(dev)
    if cfg.early_term not in ("none", "crc", "sign"):
        raise ValueError(f"unknown early_term {cfg.early_term!r}")
    G_chunks = None
    if cfg.early_term == "crc":
        _check_crc_matmul(dev)
        G_chunks = torch.from_numpy(
            _chunked_crc_matrix(K, cfg.crc_poly, C, n_seq)).to(dev)

    def decode(ls, lp1, lp2, t1, t2):
        ls, lp1, lp2, t1, t2 = _inputs(mesh, (ls, lp1, lp2, t1, t2))
        pad = torch.nn.functional.pad
        rows = {k: mesh.row_batches(x)
                for k, x in zip(("ls", "lp1", "lp2", "t1", "t2"),
                                (ls, lp1, lp2, t1, t2))}
        full = {}
        for d in rows["ls"]:
            r = {k: v[d] for k, v in rows.items()}
            # known-0 padding beyond the real trellis (the state-0 fixed
            # point); streams are chunked once below
            full[d] = (
                pad(torch.cat([r["ls"], r["t1"][:, 0::2]], 1), (0, KTp - KT),
                    value=BIG),
                pad(torch.cat([r["lp1"], r["t1"][:, 1::2]], 1), (0, KTp - KT)),
                pad(torch.cat([r["ls"][:, perm], r["t2"][:, 0::2]], 1),
                    (0, KTp - KT), value=BIG),
                pad(torch.cat([r["lp2"], r["t2"][:, 1::2]], 1), (0, KTp - KT)),
                # the raw systematic for L is K wide: it pads by KTp - K
                pad(r["ls"], (0, KTp - K)))
        chunk = [tuple(x[:, j * C:(j + 1) * C] for x in full[d])
                 for d, j in mesh.shards]
        B = chunk[0][0].shape[0]
        f32 = torch.float32
        e0 = torch.full((B, N_STATES), NEG, dtype=f32, device=dev)
        e0[:, 0] = 0.0
        uni = torch.zeros((B, N_STATES), dtype=f32, device=dev)
        real_mask = [((j * C + torch.arange(C, device=dev)) < K)[None, :]
                     for j in js]
        n = len(js)

        def siso(which, la, a_in, b_in):
            """One half-iteration on every shard's chunk: (le, a_out, b_out)
            lists, le scaled."""
            out = ([], [], [])
            for i, j in enumerate(js):
                ls_c, lp_c = chunk[i][which], chunk[i][which + 1]
                a0 = e0 if j == 0 else a_in[i]
                bT = e0 if j == n_seq - 1 else b_in[i]
                _, le, a_out, b_out = siso_scan_boundary(ls_c, lp_c, la[i],
                                                         a0, bT, cfg.mode)
                for lst, x in zip(out, (le * scale, a_out, b_out)):
                    lst.append(x)
            return out

        zC = torch.zeros((B, C), dtype=f32, device=dev)
        le21, L, a1, b1, a2, b2 = ([zC] * n, [zC] * n, [uni] * n, [uni] * n,
                                   [uni] * n, [uni] * n)
        hard = [torch.zeros((B, C), dtype=torch.int8, device=dev)] * n
        done = [torch.zeros((B,), dtype=torch.bool, device=dev)] * n
        iters = [torch.zeros((B,), dtype=torch.int32, device=dev)] * n
        it, undone = 0, 1
        while it < cfg.n_iters and undone > 0:
            le1, a1o, b1o = siso(0, le21, a1, b1)
            le2, a2o, b2o = siso(2, xch_perm(le1, dim=1), a2, b2)
            le21_new = xch_inv(le2, dim=1)
            L_new = [chunk[i][4] + le1[i] + le21_new[i] for i in range(n)]
            hard_new = [(x < 0).to(torch.int8) for x in L_new]
            a1, b1 = mesh.seq_ring(a1o, b1o)
            a2, b2 = mesh.seq_ring(a2o, b2o)
            if cfg.early_term == "crc":
                # partial syndromes on local rows, summed over seq
                synd = mesh.seq_sum([h.to(f32) @ G_chunks[j]
                                     for h, j in zip(hard_new, js)])
                newly = [(x % 2.0 == 0.0).all(dim=-1) for x in synd]
            elif cfg.early_term == "sign":
                agree = mesh.seq_sum([
                    ((h == hp) | ~m).all(dim=1).to(torch.int32)
                    for h, hp, m in zip(hard_new, hard, real_mask)])
                newly = [a == n_seq for a in agree]
            else:
                newly = [torch.zeros((B,), dtype=torch.bool, device=dev)] * n
            # freeze converged codewords branchlessly
            for i in range(n):
                keep = done[i][:, None]
                le21[i] = torch.where(keep, le21[i], le21_new[i])
                L[i] = torch.where(keep, L[i], L_new[i])
                hard[i] = torch.where(keep, hard[i], hard_new[i])
                iters[i] = iters[i] + (~done[i]).to(torch.int32)
                done[i] = done[i] | newly[i]
            # the exit is global over data: every row takes the same trips,
            # or a process mesh's collectives would fall out of step
            undone = int(mesh.data_sum(
                [(~x).sum().to(torch.int64) for x in done])[0])
            it += 1
        # one assembly gather after the loop
        hard_g = mesh.seq_all_gather([h.T.contiguous() for h in hard])
        L_g = mesh.seq_all_gather([x.T.contiguous() for x in L])
        lead = mesh.leaders
        return (mesh.assemble([hard_g[i][:K] for i in lead], 1).T.contiguous(),
                mesh.assemble([iters[i] for i in lead]),
                mesh.assemble([L_g[i][:K] for i in lead], 1).T.contiguous())

    return decode


def _decode_seq_sharded_cells(mesh: Mesh, cfg: DecoderConfig):
    from ..decoder.turbo_cells import DROPPED, _STREAM_TYPES, carry_type
    from ..siso.cuda_kernel import _e0, launch_count, siso_cells
    from . import dma

    n_seq = mesh.seq
    K = cfg.K
    KT = K + 3
    # The chunk is a multiple of the kernel's window; pad steps carry the
    # known-0-bit metrics, so padded chunks are exact at real positions.
    C, W, n_win, KTp = chunk_sizing(KT, n_seq, cfg.window)
    perm_e, inv_e = _extended_tables(cfg, KTp)
    # Extrinsics beyond global row K are zeroed as a-priori inside the
    # kernel (the global K plus the chunk's row offset), so the exchange
    # stays a pure gather.
    xch_perm = make_exchange(perm_e, C, mesh)
    xch_inv = make_exchange(inv_e, C, mesh)
    scale = cfg.resolved_ext_scale()
    ext_dt, qs = cfg.ext_io()
    if cfg.io_dtype not in ("float32", "bfloat16") or ext_dt not in _STREAM_TYPES:
        raise ValueError(f"unsupported io_dtype/ext_dtype "
                         f"{cfg.io_dtype!r}/{ext_dt!r}")
    if cfg.early_term not in ("none", "crc", "sign"):
        raise ValueError(f"unknown early_term {cfg.early_term!r}")
    dt, dte = _STREAM_TYPES[cfg.io_dtype], _STREAM_TYPES[ext_dt]
    dtc = carry_type(dte)     # float8 extrinsics travel as their bytes
    dev = mesh.device
    f32 = torch.float32
    js = [s for _, s in mesh.shards]
    n = len(js)
    perm = torch.from_numpy(cfg.perm().astype(np.int64)).to(dev)
    G_chunks = None
    if cfg.early_term == "crc":
        _check_crc_matmul(dev)
        G_chunks = torch.from_numpy(
            _chunked_crc_matrix(K, cfg.crc_poly, C, n_seq)).to(dev)
    use_dma = cfg.boundary_xch == "dma" and n_seq > 1
    # int8 extrinsics are codes: dequantise (x qs) when forming L
    deq = scale * (qs if qs else 1.0)

    def stream(body, tail, pad_val):
        """(B, K) body + (B, 3) tail -> (KTp, B) time-major stream."""
        full = torch.cat([body, tail], dim=1)
        full = torch.nn.functional.pad(full, (0, KTp - KT), value=pad_val)
        return full.to(dt).T.contiguous()

    def full_llr(ls_c, le1, le21):
        return ls_c.to(f32) + deq * (le1.view(dte).to(f32)
                                     + le21.view(dte).to(f32))

    def siso(streams, which, la, a_in, b_in, e0, outs=None):
        """One half-iteration on every shard's chunk through K4.  a_in is
        the chunk-start alpha edge (exact) or (window table, received edge)
        (NII); outs None, or per shard the (8, B) tensors the outgoing edges
        are written into.  Returns (le, a_out, b_out) lists."""
        out = ([], [], [])
        for i, j in enumerate(js):
            ls_c, lp_c = streams[i][which], streams[i][which + 1]
            bT = e0 if j == n_seq - 1 else b_in[i]
            edges_out = outs[i] if outs else None
            if cfg.nii:
                ain, edge_in = a_in[i]
                le, aout, eout, bout = siso_cells(
                    ls_c, lp_c, la[i].view(dte), K, cfg.mode, scale,
                    nii_boundaries=(ain, edge_in, bT), window=W,
                    row_offset=j * C, ext_qscale=qs, edges_out=edges_out)
                res = (le.view(dtc), (aout, eout), bout)
            else:
                a0 = e0 if j == 0 else a_in[i]
                le, aout, bout = siso_cells(
                    ls_c, lp_c, la[i].view(dte), K, cfg.mode, scale,
                    boundaries=(a0, bT), window=W, row_offset=j * C,
                    ext_qscale=qs, edges_out=edges_out)
                res = (le.view(dtc), aout, bout)
            for lst, x in zip(out, res):
                lst.append(x)
        return out

    def xch_edges(a1o, b1o, a2o, b2o, e0, ring):
        """The iteration's edges to the ring neighbours: alphas forward,
        betas backward.  Under NII the window tables stay, the chunk edge
        moves, and shard 0 pins e0.  ring: None, or the group's K6 buffers
        and views (`ring_views`), whose send buffers the SISOs have written
        their edges into."""
        fa1 = [a[1] for a in a1o] if cfg.nii else a1o
        fa2 = [a[1] for a in a2o] if cfg.nii else a2o
        if ring is not None:
            # the payloads are in place: one launch, nothing to check
            bufs, _, recv = ring
            dma.launch(bufs, n_seq)
            (a1n, b1n), (a2n, b2n) = recv
        elif use_dma:
            fwd = [torch.stack([x, y]) for x, y in zip(fa1, fa2)]
            bwd = [torch.stack([x, y]) for x, y in zip(b1o, b2o)]
            frx, brx = dma.boundary_exchange_dma(fwd, bwd, mesh)
            a1n, a2n = [x[0] for x in frx], [x[1] for x in frx]
            b1n, b2n = [x[0] for x in brx], [x[1] for x in brx]
        else:
            a1n, b1n = mesh.seq_ring(fa1, b1o)
            a2n, b2n = mesh.seq_ring(fa2, b2o)
        if cfg.nii:
            a1n = [(a[0], e0 if j == 0 else x) for a, x, j in zip(a1o, a1n, js)]
            a2n = [(a[0], e0 if j == 0 else x) for a, x, j in zip(a2o, a2n, js)]
        return a1n, b1n, a2n, b2n

    def ring_views(B):
        """K6's buffers on a local mesh of the card, for payloads of both
        SISOs' edges (2, 8, B): SISO s writes its outgoing alpha and beta
        edges straight into slot s of each shard's send buffers, and its
        next incoming edges are the same slot of the receive buffers.
        Returns (buffers, send views, receive views), the views per SISO as
        ([alpha or beta edge per shard], ...); None elsewhere (the CPU and
        the process mesh exchange copies)."""
        if not (use_dma and mesh.backend == "local" and dev.type == "cuda"):
            return None
        bufs = dma.ring_buffers(mesh, n, (2, 8, B), f32)
        send = [[(bufs.send_fwd[i][s], bufs.send_bwd[i][s]) for i in range(n)]
                for s in (0, 1)]
        recv = [([x[s] for x in bufs.recv_fwd], [x[s] for x in bufs.recv_bwd])
                for s in (0, 1)]
        return bufs, send, recv

    def decode(ls, lp1, lp2, t1, t2):
        ls, lp1, lp2, t1, t2 = _inputs(mesh, (ls, lp1, lp2, t1, t2))
        rows = {k: mesh.row_batches(x)
                for k, x in zip(("ls", "lp1", "lp2", "t1", "t2"),
                                (ls, lp1, lp2, t1, t2))}
        B_row = next(iter(rows["ls"].values())).shape[0]
        # Groups: independent batch splits of whole 1024-codeword cells,
        # iterated in the same order on every shard.
        nG = effective_seq_groups(cfg, B_row)
        n_g = -(-B_row // CELL) // nG * CELL
        bounds = [(g * n_g, min((g + 1) * n_g, B_row)) for g in range(nG)]
        groups = []
        for b0, b1 in bounds:
            full = {}
            for d in rows["ls"]:
                r = {k: v[d][b0:b1] for k, v in rows.items()}
                full[d] = (stream(r["ls"], r["t1"][:, 0::2], BIG),
                           stream(r["lp1"], r["t1"][:, 1::2], 0.0),
                           stream(r["ls"][:, perm], r["t2"][:, 0::2], BIG),
                           stream(r["lp2"], r["t2"][:, 1::2], 0.0))
            # chunk-local channel streams: row slices, no copy
            streams = [tuple(x[j * C:(j + 1) * C] for x in full[d])
                       for d, j in mesh.shards]
            Bg = b1 - b0
            e0 = _e0(Bg, dev)
            uni = torch.zeros((8, Bg), dtype=f32, device=dev)
            zE = torch.zeros((C, Bg), dtype=dtc, device=dev)
            if cfg.nii:
                # per-window alpha starts (zeros: uniform cold start) and
                # the chunk edge (e0 on shard 0)
                tbl = torch.zeros((n_win, 8, Bg), dtype=f32, device=dev)
                a_init = [(tbl, e0 if j == 0 else uni) for j in js]
            else:
                a_init = [uni] * n
            groups.append(dict(streams=streams, e0=e0, ring=ring_views(Bg),
                               le21=[zE] * n,
                               le1=[zE] * n, a1=list(a_init), b1=[uni] * n,
                               a2=list(a_init), b2=[uni] * n,
                               done=[torch.zeros((Bg,), dtype=torch.bool,
                                                 device=dev)] * n,
                               iters=[torch.zeros((Bg,), dtype=torch.int32,
                                                  device=dev)] * n,
                               hard=[torch.zeros((C, Bg), dtype=torch.int8,
                                                 device=dev)] * n))

        def siso1(g):
            """SISO1 of group g on its carry: (le1, a_out, b_out) lists."""
            send = g["ring"][1] if g["ring"] else (None, None)
            with record_function("seq.siso1"):
                return siso(g["streams"], 0, g["le21"], g["a1"], g["b1"],
                            g["e0"], send[0])

        def iteration(g, first=None):
            """Both SISOs and the exchanges of one iteration of group g;
            returns (le1, le21_new).  first: SISO1's result when it was
            launched already, or None."""
            st, ring = g["streams"], g["ring"]
            send = ring[1] if ring else (None, None)
            le1, a1o, b1o = first or siso1(g)
            with record_function("seq.xch_perm"):
                la2 = xch_perm(le1)
            with record_function("seq.siso2"):
                le2, a2o, b2o = siso(st, 2, la2, g["a2"], g["b2"], g["e0"],
                                     send[1])
            with record_function("seq.xch_inv"):
                le21_new = xch_inv(le2)
            # edges move after both SISOs of the iteration
            with record_function("seq.edges"):
                g["a1"], g["b1"], g["a2"], g["b2"] = xch_edges(
                    a1o, b1o, a2o, b2o, g["e0"], ring)
            return le1, le21_new

        if cfg.early_term == "none":
            # lean loop: no per-iteration L, hard bits or freezing
            for _ in range(cfg.n_iters):
                for g in groups:
                    g["le1"], g["le21"] = iteration(g)
        else:
            real_mask = [((j * C + torch.arange(C, device=dev)) < K)[:, None]
                         for j in js]
            # The exit read waits behind a copy of the count into pinned
            # memory and the next iteration's SISO1 of every group, as in
            # decoder/turbo_cells.py, so the card is not idle while the host
            # reads; a SISO1 dropped at the exit is counted in DROPPED.
            undone_host = torch.zeros((), dtype=torch.int64,
                                      pin_memory=dev.type == "cuda")
            ready = torch.cuda.Event() if dev.type == "cuda" else None
            first = [None] * len(groups)
            for it in range(cfg.n_iters):
                undone_local = [torch.zeros((), dtype=torch.int64, device=dev)
                                for _ in range(n)]
                for g, f in zip(groups, first):
                    le1, le21_new = iteration(g, f)
                    with record_function("seq.early_exit"):
                        # fused sign decision; L itself is formed once
                        # after the loop from the frozen extrinsics
                        hard_new = [full_llr(s[0], a, b) < 0 for s, a, b in
                                    zip(g["streams"], le1, le21_new)]
                        if cfg.early_term == "crc":
                            synd = mesh.seq_sum([
                                h.T.to(f32) @ G_chunks[j]
                                for h, j in zip(hard_new, js)])
                            newly = [(x % 2.0 == 0.0).all(dim=1) for x in synd]
                        else:
                            hard_new = [h.to(torch.int8) for h in hard_new]
                            agree = mesh.seq_sum([
                                ((h == hp) | ~m).all(dim=0).to(torch.int32)
                                for h, hp, m in zip(hard_new, g["hard"],
                                                    real_mask)])
                            newly = [a == n_seq for a in agree]
                        for i in range(n):
                            done = g["done"][i]
                            keep = done[None, :]
                            g["le21"][i] = torch.where(keep, g["le21"][i],
                                                       le21_new[i])
                            g["le1"][i] = torch.where(keep, g["le1"][i],
                                                      le1[i])
                            if cfg.early_term == "sign":
                                g["hard"][i] = torch.where(keep, g["hard"][i],
                                                           hard_new[i])
                            g["iters"][i] = (g["iters"][i]
                                             + (~done).to(torch.int32))
                            g["done"][i] = done | newly[i]
                            undone_local[i] += (~g["done"][i]).sum()
                # lockstep exit over data (see the scan route)
                with record_function("seq.exit_read"):
                    undone_host.copy_(mesh.data_sum(undone_local)[0],
                                      non_blocking=True)
                    if ready is not None:
                        ready.record()
                last = it + 1 == cfg.n_iters
                first = [None if last else siso1(g) for g in groups]
                with record_function("seq.exit_read"):
                    if ready is not None:
                        ready.synchronize()
                    undone = int(undone_host)
                if undone == 0:
                    if not last and ready is not None:
                        _, name = launch_count(cfg.nii, cfg.mode, False, True,
                                               dt, dte)
                        DROPPED[name] = (DROPPED.get(name, 0)
                                         + n * len(groups))
                    break
        if use_dma:
            # the exchanges read nothing back: a timeout in any of them
            # raises here, once per decode
            dma.check(mesh)

        # per group, the (hard, iters, L) of each data row's first shard
        lead = mesh.leaders
        parts = []
        for g in groups:
            L_c = [full_llr(s[0], a, b) for s, a, b in
                   zip(g["streams"], g["le1"], g["le21"])]
            hard_c = [(x < 0).to(torch.int8) for x in L_c]
            # one assembly gather after the loop
            hard, L = mesh.seq_all_gather(hard_c), mesh.seq_all_gather(L_c)
            iters = (g["iters"] if cfg.early_term != "none" else
                     [torch.full((g["e0"].shape[1],), cfg.n_iters,
                                 dtype=torch.int32, device=dev)] * n)
            parts.append([[x[i] for i in lead] for x in (hard, iters, L)])

        def whole(k, dim):
            """Output k of every row, the groups side by side."""
            rows_k = [torch.cat([p[k][r] for p in parts], dim)
                      for r in range(len(lead))] if nG > 1 else parts[0][k]
            return mesh.assemble(rows_k, dim)
        return (whole(0, 1)[:K].T.contiguous(), whole(1, 0),
                whole(2, 1)[:K].T.contiguous())

    return decode
