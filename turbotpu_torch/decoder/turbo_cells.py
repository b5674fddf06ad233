"""Turbo decode loop around the fused SISO kernel.

Counterpart of turbotpu/decoder/turbo_cells.py.  Every per-iteration tensor
stays in the kernel's time-major (T, B) layout, so the hot loop runs without
a transpose, and the kernel forms the branch metrics itself: the only
per-iteration work outside it is the extrinsic interleave gather and the
early-termination bookkeeping (under `crc` one pass, two launches on the
card: layout.py's `crc_exit`).  Channel-LLR packing and the output assembly
cross layouts once each, one kernel launch each on the card (layout.py),
inside the ranges `turbo.pack` and `turbo.unpack`.

The gathers run in one of two table forms, counted in `TABLE_FORMS`:
`shared`, one (KTp,) table for every codeword, read by `index_select` along
time (the configuration's table, or a single-size grouped batch's own
row); `per_codeword`, one `torch.gather` along time through a (KTp, B)
int64 index, for a batch that really mixes sizes.  turbo_decode resolves
the form from the tables' shapes and passes the tables as `perm`/`inv`.

With `cfg.fold_gather` (NII, shared interleaver table) the gathers leave the
loop too: each SISO reads the other's raw extrinsic output through its own
table inside the kernel (`siso_cells(..., gather_idx=)`), the loop carries
the raw interleaved-order le2, and one de-interleave remains: after the loop
for the outputs, plus one per iteration where early termination needs the
natural order for its check.  For a mixed-K batch or the exact contract the
option is ignored and the materialised gathers run, as in the JAX package.

The early-terminated loops read on the host once per iteration whether
every codeword is done, where the reference's `lax.while_loop` stays on the
device; the next iteration's first SISO call is launched before the host
waits for the read, so the card does not idle at it (see the loops).  A
`crc` decode with a shared table keeps the codewords not yet done in a
dense prefix of its working set (layout.py's `LivePrefix`): after each
iteration's syndromes the codewords done leave it, writing their hard bits
and L into their own rows (range `turbo.unpack`), and the others move into
the holes (range `turbo.compact`), so both SISO calls run over the live
columns alone.  The per-codeword form and `sign` keep the loop that runs
every codeword for every iteration and freezes the done ones' extrinsics.
Each SISO call counts in `_device.LAUNCHES` the columns its grid spanned,
`siso_columns.run`, beside the B that the freezing loop runs,
`siso_columns.full`.
Extrinsic streams of type float8_e4m3fn are carried as their bytes (uint8).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from .. import _device
from ..siso.cuda_kernel import (FP8, _round_up, kernel_name, siso_cells,
                                window_len)
from .layout import (assemble_outputs, crc_exit, crc_exit_scratch, full_llr,
                     live_compact, live_prefix, live_syndromes, pack_streams,
                     retire_outputs)
from .turbo import DecoderConfig

_STREAM_TYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8, "float8_e4m3fn": FP8}


# SISO1 calls the early-exit loop launched ahead of a read and dropped because
# every codeword was done, by the name they were counted under
# (`kernel_name`; `_device.LAUNCHES` includes them): the kernel launches that
# did an iteration's work are the counts less these.
DROPPED = {}

# Decodes by the table form their gathers ran through: "shared" (one (KTp,)
# table, `index_select`) or "per_codeword" (a (KTp, B) index, `torch.gather`).
TABLE_FORMS = {"shared": 0, "per_codeword": 0}


def carry_type(dte: torch.dtype) -> torch.dtype:
    """The type the loops carry an extrinsic stream of type `dte` in:
    float8 as its bytes (uint8), on which every gather, select and
    collective is implemented; the kernels and the LLR read them through a
    view.  Other types as they are."""
    return torch.uint8 if dte == FP8 else dte


def time_major_index(tab: torch.Tensor, KTp: int) -> torch.Tensor:
    """Per-codeword (B, K) table -> (KTp, B) int64 gather index along time,
    identity on the rows from K up."""
    B, K = tab.shape
    ext = torch.arange(K, KTp, device=tab.device)[:, None].expand(KTp - K, B)
    return torch.cat([tab.T.to(torch.long), ext], dim=0).contiguous()


def turbo_decode_cells(ls: torch.Tensor, lp1: torch.Tensor, lp2: torch.Tensor,
                       tail1: torch.Tensor, tail2: torch.Tensor,
                       cfg: DecoderConfig,
                       perm: torch.Tensor | None = None,
                       inv: torch.Tensor | None = None):
    """Same contract as decoder.turbo.turbo_decode for fp32 (B, K) / (B, 6)
    tensors on one device, kernel hot loop.

    perm / inv: optional int64 interleaver tables on the device, in place
    of cfg.perm() / cfg.inv() (which are built on the host and copied):
    shared (K,), a single-size grouped batch's own row, extended by the
    identity on the device; or per codeword (B, K), the embedded tables of
    a mixed-K batch (bucketing.embedded_perm_tables; turbo_decode expands
    grouped tables of more than one group to this form).  The per-codeword
    exchange is out[t, b] = x[index[t, b], b]: in the time-major layout the
    32 codewords of a warp read neighbouring addresses wherever they share a
    block size.
    """
    B, K = ls.shape
    if K != cfg.K:
        raise ValueError(f"ls has K={K}, the configuration K={cfg.K}")
    if cfg.early_term not in ("none", "crc", "sign"):
        raise ValueError(f"unknown early_term {cfg.early_term!r}")
    ext_dt, qs = cfg.ext_io()
    if cfg.io_dtype not in ("float32", "bfloat16") or ext_dt not in _STREAM_TYPES:
        raise ValueError(f"unsupported io_dtype/ext_dtype "
                         f"{cfg.io_dtype!r}/{ext_dt!r}")
    dev = ls.device
    KT = K + 3
    # cfg.window overrides the kernel window (a multiple of 8); larger
    # windows cut the number of NII seams.
    W = cfg.window if cfg.window else window_len(KT)
    KTp = _round_up(KT, W)
    n_win = KTp // W
    scale = cfg.resolved_ext_scale()
    dt = _STREAM_TYPES[cfg.io_dtype]    # channel LLR stream type
    dte = _STREAM_TYPES[ext_dt]         # extrinsic stream type
    dtc = carry_type(dte)               # ... as the loop carries it
    f32 = torch.float32

    # Extended permutations cover the pad region (gathered rows >= K are
    # masked to zero a-priori inside the kernel, so identity is fine there).
    shared = perm is None or perm.dim() == 1
    if perm is None:
        ext = np.arange(K, KTp, dtype=np.int64)
        perm_e, inv_e = (torch.from_numpy(np.concatenate(
            [t.astype(np.int64), ext])).to(dev)
            for t in (cfg.perm(), cfg.inv()))
    elif shared:
        ext = torch.arange(K, KTp, device=dev)
        perm_e, inv_e = (torch.cat([t, ext]) for t in (perm, inv))
    else:
        perm_e, inv_e = (time_major_index(t, KTp) for t in (perm, inv))
    if shared:
        g_perm = lambda x: x.index_select(0, perm_e)
        g_inv = lambda x: x.index_select(0, inv_e)
    else:
        g_perm = lambda x: torch.gather(x, 0, perm_e)
        g_inv = lambda x: torch.gather(x, 0, inv_e)
    TABLE_FORMS["shared" if shared else "per_codeword"] += 1

    with record_function("turbo.pack"):
        # ls2's body: ls along perm_e's first K rows (shared or per codeword)
        ls1, lp1s, ls2, lp2s = pack_streams(ls, lp1, lp2, tail1, tail2, KTp,
                                            dt, perm_e[:K])

    # fold_gather: both SISOs read the other's RAW extrinsic tensor through
    # their own gather table inside the kernel.  Shared-table NII batches
    # only (a single-size grouped batch among them); per-codeword (mixed-K)
    # tables keep the torch.gather path.
    fold = cfg.fold_gather and cfg.nii and shared
    if fold:
        perm_i, inv_i = perm_e.to(torch.int32), inv_e.to(torch.int32)

    zT = torch.zeros((KTp, B), dtype=dtc, device=dev)
    # NII state: per-window alpha start metrics per SISO, carried across
    # half-iterations (zeros = uniform cold start; slot 0 is never read).
    zC = torch.zeros((n_win, 8, B), dtype=f32, device=dev) if cfg.nii else None

    def carried(out, nii):
        """A SISO call's result as the loop carries it: (le, window table
        or None)."""
        le, ck = out if nii else (out, None)
        return le.view(dtc), ck

    # The live prefix (crc, shared table): the card's live count and the
    # newest bound of it the host has read; None runs every column.
    live = None

    def siso(ls_, lp_, la, ck=None, idx=None):
        """One SISO call on a carried stream."""
        _device.LAUNCHES["siso_columns.run"] += live[1] if live else B
        _device.LAUNCHES["siso_columns.full"] += B
        return carried(siso_cells(ls_, lp_, la.view(dte), K, cfg.mode, scale,
                                  nii_ckpt=ck, window=W, ext_qscale=qs,
                                  gather_idx=idx, live=live), ck is not None)

    def siso1(le21, ck1):
        """SISO1 on the carry: (le1, its window table or None)."""
        with record_function("turbo.siso1"):
            return siso(ls1, lp1s, le21, ck1, inv_i if fold else None)

    # The two SISO half-iterations + extrinsic interleave gathers -- the
    # only per-iteration work that is algorithmically required -- in two
    # parts, so that a loop can launch the first part ahead of a read.
    def front(le21, ck1, ck2, first=None):
        """SISO1 on the carry (unless `first`, its result, was launched
        already), the interleave and SISO2: (le2, le1, ck1, ck2), le2 in
        interleaved order.  Under fold the carry is le2 raw and each SISO
        reads the other's output through its own table."""
        # SISO1 (natural order); le21 rows >= K are garbage, masked in-kernel.
        # SISO2 (interleaved order): a-priori is scale*le1 gathered by perm;
        # the kernel applies the scaling, so the gather is a pure gather.
        le1, ck1 = first or siso1(le21, ck1)
        if fold:
            with record_function("turbo.siso2"):
                le2, ck2 = siso(ls2, lp2s, le1, ck2, perm_i)
            return le2, le1, ck1, ck2
        with record_function("turbo.gather_perm"):
            la2 = g_perm(le1)
        with record_function("turbo.siso2"):
            le2, ck2 = siso(ls2, lp2s, la2, ck2)
        return le2, le1, ck1, ck2

    def back(le2, le1, ck1, ck2):
        """The iteration's carry: (le21, le1, ck1, ck2), le21 le2
        de-interleaved, or le2 raw under fold."""
        if fold:
            return le2, le1, ck1, ck2
        with record_function("turbo.gather_inv"):
            return g_inv(le2), le1, ck1, ck2

    def step(le21, ck1, ck2, first=None):
        return back(*front(le21, ck1, ck2, first))

    # int8 extrinsics are stored as integer codes; dequantize (x qs) when
    # assembling the full LLR.  (Inside the kernel the dequant is folded
    # into the a-priori scale multiply.)
    deq = scale * (qs if qs else 1.0)

    def outputs(le21, le1, iters):
        # L and the hard bits are formed once, after the loop.  Under fold
        # the carry was raw le2: the one de-interleave for L runs here.
        with record_function("turbo.unpack"):
            hard, L = assemble_outputs(ls1, le1,
                                       g_inv(le21) if fold else le21, K, deq,
                                       dte)
        return hard, iters, L

    if cfg.early_term == "none":
        # Lean loop: no L/hard/freeze bookkeeping inside.
        le21, le1, ck1, ck2 = zT, zT, zC, zC
        for _ in range(cfg.n_iters):
            le21, le1, ck1, ck2 = step(le21, ck1, ck2)
        return outputs(le21, le1, torch.full((B,), cfg.n_iters,
                                             dtype=torch.int32, device=dev))

    crc = cfg.early_term == "crc"
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    # The loops read the host's flag from pinned memory behind an event.
    # A read that waited for the iteration to end would leave the card idle
    # until the host had enqueued the next one.  So the next iteration's
    # SISO1 (which reads only the carry; in the live prefix both SISO calls)
    # is launched first, and only then does the host wait, for the event:
    # the card runs it meanwhile.  If every codeword is done, what was
    # launched ahead is dropped: in the freezing loop one SISO launch of the
    # card's time is all it cost, in the live prefix blocks that return at
    # once.
    ready = torch.cuda.Event() if dev.type == "cuda" else None

    def dropped(calls):
        """Count SISO calls launched ahead of a read that ended the loop."""
        if calls and ready is not None:
            name = kernel_name(cfg.nii, cfg.mode, fold, False, dt, dte)
            DROPPED[name] = DROPPED.get(name, 0) + calls

    if crc and shared and B:
        # The live prefix.  The working set (the channel streams, the carry
        # and the window tables, all of pitch B) keeps the codewords not
        # yet done in its first n columns, n on the card; the host sizes
        # each grid by the newest n it has read, an upper bound since the
        # prefix only shrinks, and every kernel stops at the card's n.  So
        # both SISO calls of the next iteration are launched before the host
        # reads the count that this iteration's close leaves, and run on it:
        # the card has a whole iteration queued while the host waits.  A
        # codeword's outputs are written when it retires.
        lv = live_prefix(B, dev)
        live = (lv.state[:1], B)
        hard = torch.empty((B, K), dtype=torch.int8, device=dev)
        L = torch.empty((B, K), dtype=f32, device=dev)
        n_host = torch.zeros((1,), dtype=torch.int32,
                             pin_memory=dev.type == "cuda")
        ahead = front(zT, zC, zC)
        for it in range(cfg.n_iters):
            le21, le1, ck1, ck2 = back(*ahead)
            last = it + 1 == cfg.n_iters      # every codeword retires
            with record_function("turbo.early_exit"):
                le21_nat = g_inv(le21) if fold else le21
                live_syndromes(ls1, le1, le21_nat, K, deq, dte, cfg.crc_poly,
                               lv, live[1])
            with record_function("turbo.unpack"):
                retire_outputs(hard, L, ls1, le1, le21_nat, K, deq, dte, lv,
                               live[1], last)
            with record_function("turbo.compact"):
                live_compact(done, iters, lv,
                             (ls1, lp1s, ls2, lp2s, le21, ck1, ck2), last)
                n_host.copy_(lv.state[:1], non_blocking=True)
                if ready is not None:
                    ready.record()
            ahead = (front(le21, ck1, ck2) if it + 1 < cfg.n_iters
                     else None)
            with record_function("turbo.exit_read"):
                if ready is not None:
                    ready.synchronize()
                n = int(n_host[0])
            if n == 0:
                dropped(2 if ahead else 0)
                break
            live = (lv.state[:1], n)
        return hard, iters, L

    # Early-termination freezing works on the EXTRINSICS, not on stored
    # L/hard copies: L = ls + deq*(le1 + le21) is a pure function of the
    # extrinsic streams, so pinning a converged frame's le1/le21 yields the
    # bit-identical at-convergence L and hard bits when computed once after
    # the loop.  Sign-agreement mode also carries last iteration's hard bits;
    # CRC mode does not (the syndrome is memoryless), and its verdicts and
    # freezes are one pass (layout.crc_exit: two launches on the card,
    # which write the iteration's new buffers in place).
    scratch = crc_exit_scratch(B, dev) if crc else None
    le21, le1, ck1, ck2 = zT, zT, zC, zC
    hard_prev = torch.zeros((K, B), dtype=torch.int8, device=dev) \
        if cfg.early_term == "sign" else None
    # Exits as soon as every codeword passes; the outputs are those of the
    # iteration before a dropped SISO1.
    flag = torch.zeros((), dtype=torch.bool, pin_memory=dev.type == "cuda")
    first = None
    for it in range(cfg.n_iters):
        le21_new, le1_new, ck1, ck2 = step(le21, ck1, ck2, first)
        with record_function("turbo.early_exit"):
            # Under fold the carry holds raw le2; the convergence check needs
            # natural order, so ONE gather per iteration remains (vs two).
            le21_nat = g_inv(le21_new) if fold else le21_new
            if crc:
                le1, le21, done, iters, all_done = crc_exit(
                    ls1, le1, le21, le1_new, le21_nat, le21_new, done, iters,
                    K, deq, dte, cfg.crc_poly, scratch)
            else:  # sign agreement
                hard_new = (full_llr(ls1, le1_new, le21_nat, K, deq, dte)
                            < 0).to(torch.int8)
                newly_done = (hard_new == hard_prev).all(dim=0)
                # Freeze converged codewords' extrinsics branchlessly; their
                # SISO outputs keep being computed (the batch runs anyway)
                # and are discarded here, so L/hard derived after the loop
                # are pinned at the convergence iteration.
                keep = done[None, :]
                le21 = torch.where(keep, le21, le21_new)
                le1 = torch.where(keep, le1, le1_new)
                iters = iters + (~done).to(torch.int32)
                hard_prev = torch.where(keep, hard_prev, hard_new)
                done = done | newly_done
                all_done = done.all()
            flag.copy_(all_done, non_blocking=True)
            if ready is not None:
                ready.record()
        first = siso1(le21, ck1) if it + 1 < cfg.n_iters else None
        with record_function("turbo.exit_read"):
            if ready is not None:
                ready.synchronize()
            all_done = bool(flag)
        if all_done:
            dropped(1 if first else 0)
            break
    return outputs(le21, le1, iters)
