"""Turbo decode loop around the fused SISO kernel.

Counterpart of turbotpu/decoder/turbo_cells.py.  Every per-iteration tensor
stays in the kernel's time-major (T, B) layout, so the hot loop runs without
a transpose, and the kernel forms the branch metrics itself: the only
per-iteration work outside it is the extrinsic interleave gather
(`index_select` along time, or for a mixed-K batch one `torch.gather` along
time through a per-codeword `(KTp, B)` index) and the early-termination
bookkeeping.  Channel-LLR packing and hard-bit unpacking cross layouts once
each.

With `cfg.fold_gather` (NII, shared interleaver table) the gathers leave the
loop too: each SISO reads the other's raw extrinsic output through its own
table inside the kernel (`siso_cells(..., gather_idx=)`), the loop carries
the raw interleaved-order le2, and one de-interleave remains: after the loop
for the outputs, plus one per iteration where early termination needs the
natural order for its check.  For a mixed-K batch or the exact contract the
option is ignored and the materialised gathers run, as in the JAX package.

The early-terminated loop (crc, sign) reads "every codeword done" on the
host once per iteration, where the reference's `lax.while_loop` stays on the
device; the next iteration's first SISO call is launched before the host
waits for the read, so the card does not idle at it (see the loop).
Extrinsic streams of type float8_e4m3fn are carried as their bytes (uint8).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from ..siso.cuda_kernel import (BIG, FP8, _round_up, launch_count,
                                siso_cells, window_len)
from .early_term import _crc_check_matrix_np
from .turbo import DecoderConfig

_STREAM_TYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8, "float8_e4m3fn": FP8}


# SISO1 calls the early-exit loop launched ahead of a read and dropped because
# every codeword was done, by the launch counter they added to (the counts in
# siso/cuda_kernel.py include them): the kernel launches that did an
# iteration's work are the counts less these.
DROPPED = {}


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
                       perm_b: torch.Tensor | None = None,
                       inv_b: torch.Tensor | None = None):
    """Same contract as decoder.turbo.turbo_decode for fp32 (B, K) / (B, 6)
    tensors on one device, kernel hot loop.

    perm_b / inv_b: optional per-codeword (B, K) int64 embedded interleaver
    tables of a mixed-K batch (bucketing.embedded_perm_tables; turbo_decode
    expands grouped tables to this form).  The extrinsic exchange is then
    out[t, b] = x[index[t, b], b]: in the time-major layout the 32 codewords
    of a warp read neighbouring addresses wherever they share a block size.
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
    ext = np.arange(K, KTp, dtype=np.int64)
    if perm_b is None:
        perm = cfg.perm().astype(np.int64)
        perm_e = torch.from_numpy(np.concatenate([perm, ext])).to(dev)
        inv_e = torch.from_numpy(
            np.concatenate([cfg.inv().astype(np.int64), ext])).to(dev)
        perm_t = torch.from_numpy(perm).to(dev)
        g_perm = lambda x: x.index_select(0, perm_e)
        g_inv = lambda x: x.index_select(0, inv_e)
        g_sys = lambda x: x.index_select(1, perm_t)
    else:
        perm_e, inv_e = (time_major_index(t, KTp) for t in (perm_b, inv_b))
        g_perm = lambda x: torch.gather(x, 0, perm_e)
        g_inv = lambda x: torch.gather(x, 0, inv_e)
        g_sys = lambda x: torch.gather(x, 1, perm_b)

    def stream(body, tail, pad_val):
        """(B, K) body + (B, 3) tail -> (KTp, B) stream with the time pad."""
        full = torch.cat([body, tail], dim=1)
        full = torch.nn.functional.pad(full, (0, KTp - KT), value=pad_val)
        return full.to(dt).T.contiguous()

    ls1 = stream(ls, tail1[:, 0::2], BIG)
    lp1s = stream(lp1, tail1[:, 1::2], 0.0)
    ls2 = stream(g_sys(ls), tail2[:, 0::2], BIG)
    lp2s = stream(lp2, tail2[:, 1::2], 0.0)

    # fold_gather: both SISOs read the other's RAW extrinsic tensor through
    # their own gather table inside the kernel.  Shared-table NII batches
    # only; per-codeword (mixed-K) tables keep the torch.gather path.
    fold = cfg.fold_gather and cfg.nii and perm_b is None
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

    def siso(ls_, lp_, la, ck=None, idx=None):
        """One SISO call on a carried stream."""
        return carried(siso_cells(ls_, lp_, la.view(dte), K, cfg.mode, scale,
                                  nii_ckpt=ck, window=W, ext_qscale=qs,
                                  gather_idx=idx), ck is not None)

    def siso1(le21, ck1):
        """SISO1 on the carry: (le1, its window table or None)."""
        with record_function("turbo.siso1"):
            return siso(ls1, lp1s, le21, ck1, inv_i if fold else None)

    def half_iters_fold(le2, ck1, ck2, first=None):
        le1, ck1 = first or siso1(le2, ck1)
        with record_function("turbo.siso2"):
            le2, ck2 = siso(ls2, lp2s, le1, ck2, perm_i)
        return le2, le1, ck1, ck2

    def half_iters(le21, ck1, ck2, first=None):
        """The two SISO half-iterations + extrinsic interleave gathers --
        the only per-iteration work that is algorithmically required.
        first: SISO1's result when it was launched already, or None."""
        # SISO1 (natural order); le21 rows >= K are garbage, masked in-kernel.
        # SISO2 (interleaved order): a-priori is scale*le1 gathered by perm;
        # the kernel applies the scaling, so the gather is a pure gather.
        le1, ck1 = first or siso1(le21, ck1)
        with record_function("turbo.gather_perm"):
            la2 = g_perm(le1)
        with record_function("turbo.siso2"):
            le2, ck2 = siso(ls2, lp2s, la2, ck2)
        with record_function("turbo.gather_inv"):
            return g_inv(le2), le1, ck1, ck2

    # int8 extrinsics are stored as integer codes; dequantize (x qs) when
    # assembling the full LLR.  (Inside the kernel the dequant is folded
    # into the a-priori scale multiply.)
    deq = scale * (qs if qs else 1.0)

    def full_llr(le21, le1):
        return ls1[:K].to(f32) + deq * (le1[:K].view(dte).to(f32)
                                        + le21[:K].view(dte).to(f32))

    step = half_iters_fold if fold else half_iters

    def outputs(le21, le1, iters):
        # L and the hard bits are formed once, after the loop.  Under fold
        # the carry was raw le2: the one de-interleave for L runs here.
        L = full_llr(g_inv(le21) if fold else le21, le1)
        hard = (L < 0).to(torch.int8)
        return hard.T.contiguous(), iters, L.T.contiguous()

    if cfg.early_term == "none":
        # Lean loop: no L/hard/freeze bookkeeping inside.
        le21, le1, ck1, ck2 = zT, zT, zC, zC
        for _ in range(cfg.n_iters):
            le21, le1, ck1, ck2 = step(le21, ck1, ck2)
        return outputs(le21, le1, torch.full((B,), cfg.n_iters,
                                             dtype=torch.int32, device=dev))

    if cfg.early_term == "crc":
        if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "the CRC syndrome needs an exact fp32 matmul: "
                "torch.backends.cuda.matmul.allow_tf32 must be False")
        # fp32 operands: sums of 0/1 up to K are exact, with TF32 off.
        G = torch.from_numpy(_crc_check_matrix_np(K, cfg.crc_poly)).to(dev)

    # Early-termination freezing works on the EXTRINSICS, not on stored
    # L/hard copies: L = ls + deq*(le1 + le21) is a pure function of the
    # extrinsic streams, so pinning a converged frame's le1/le21 yields the
    # bit-identical at-convergence L and hard bits when computed once after
    # the loop.  Sign-agreement mode also carries last iteration's hard bits;
    # CRC mode does not (the syndrome is memoryless).
    le21, le1, ck1, ck2 = zT, zT, zC, zC
    hard_prev = torch.zeros((K, B), dtype=torch.int8, device=dev) \
        if cfg.early_term == "sign" else None
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    # Exits as soon as every codeword passes: one host read per iteration,
    # where the reference's lax.while_loop stays on the device.  A read that
    # waited for the iteration to end would leave the card idle until the
    # host had enqueued the next one.  So the flag is copied into pinned
    # memory behind an event, the next iteration's SISO1 (which reads only
    # the frozen carry) is launched, and only then does the host wait, for
    # the event: the card runs SISO1 meanwhile.  If every codeword is done,
    # that SISO1 is dropped: the outputs are those of the iteration before,
    # and one SISO call of the card's time is all it cost.
    flag = torch.zeros((), dtype=torch.bool, pin_memory=dev.type == "cuda")
    ready = torch.cuda.Event() if dev.type == "cuda" else None
    first = None
    for it in range(cfg.n_iters):
        le21_new, le1_new, ck1, ck2 = step(le21, ck1, ck2, first)
        with record_function("turbo.early_exit"):
            # Under fold the carry holds raw le2; the convergence check needs
            # natural order, so ONE gather per iteration remains (vs two).
            le21_nat = g_inv(le21_new) if fold else le21_new
            hard_new = (full_llr(le21_nat, le1_new) < 0)

            if cfg.early_term == "crc":
                synd = hard_new.T.to(f32) @ G                    # (B, 24)
                newly_done = (synd % 2.0 == 0.0).all(dim=1)
            else:  # sign agreement
                hard_new = hard_new.to(torch.int8)
                newly_done = (hard_new == hard_prev).all(dim=0)

            # Freeze converged codewords' extrinsics branchlessly; their SISO
            # outputs keep being computed (the batch runs anyway) and are
            # discarded here, so L/hard derived after the loop are pinned at
            # the convergence iteration.
            keep = done[None, :]
            le21 = torch.where(keep, le21, le21_new)
            le1 = torch.where(keep, le1, le1_new)
            iters = iters + (~done).to(torch.int32)
            if hard_prev is not None:
                hard_prev = torch.where(keep, hard_prev, hard_new)
            done = done | newly_done
            flag.copy_(done.all(), non_blocking=True)
            if ready is not None:
                ready.record()
        first = siso1(le21, ck1) if it + 1 < cfg.n_iters else None
        with record_function("turbo.exit_read"):
            if ready is not None:
                ready.synchronize()
            all_done = bool(flag)
        if all_done:
            if first is not None and ready is not None:
                _, name = launch_count(cfg.nii, cfg.mode, fold, False, dt,
                                       dte)
                DROPPED[name] = DROPPED.get(name, 0) + 1
            break
    return outputs(le21, le1, iters)
