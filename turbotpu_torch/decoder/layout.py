"""The hot loop's time-major passes outside the SISO kernels
(csrc/layout.cu): the two layout crossings, one kernel launch each, and
the CRC early exit, two launches an iteration.

`pack_streams` turns the public (B, K) fp32 channel LLRs and (B, 6) tails
into the SISO kernels' four time-major (KTp, B) streams; `assemble_outputs`
turns the loop's time-major extrinsics back into the (B, K) hard bits and
LLR L; `crc_exit` is one iteration's verdicts and freezes of the `crc`
loop.  The `crc` loop with one shared table keeps its live codewords in a
dense prefix instead (`LivePrefix`): `live_syndromes` forms the prefix's
syndromes (one launch), `retire_outputs` writes the outputs of the
codewords that retire (one launch), `live_compact` closes the iteration and
moves the live codewords into the holes (two launches).  Each sits beside
its plain version (`pack_streams_plain`, `assemble_outputs_plain`,
`crc_exit_plain`, `live_syndromes_plain`, `retire_outputs_plain`,
`live_compact_plain`): the same function in PyTorch operations, which gives
the same bytes.

On a CUDA tensor a wrapper launches its kernel, or raises for what the
kernel does not take; it takes the plain version only for tensors on the
CPU.  Each launch is counted in `_device.LAUNCHES` by its kernel's name in
layout.cu.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from .._device import launch_on
from ..siso.cuda_kernel import _CHAN_TYPES, _EXT_TYPES, BIG
from .early_term import _crc_check_matrix_np, make_crc_matrix

TARGET: _build.Target = ("layout", ())
# layout.cu's kernels, by the names their launches count under
KERNELS = ("pack_kernel", "unpack_kernel", "exit_kernel", "exit_close_kernel",
           "live_close_kernel", "compact_kernel")
# each C entry takes one pointer to its int64 arguments, the stream last,
# and the SISO library's type codes (_CHAN_TYPES, _EXT_TYPES)
_PACK = _build.PackedEntry(TARGET, "turbotpu_pack_streams_launch", 24)
_ASSEMBLE = _build.PackedEntry(TARGET, "turbotpu_assemble_outputs_launch", 16)
_EXIT = _build.PackedEntry(TARGET, "turbotpu_crc_exit_launch", 20)
_COMPACT = _build.PackedEntry(TARGET, "turbotpu_live_compact_launch", 20)
_F32 = torch.float32
# The stream format, for the plain version and the kernel alike: for ls1,
# lp1s, lp2s and ls2 in turn, the tail it reads (0: tail1, 1: tail2), the
# first of its tail columns (row K + j holds column off + 2j) and the pad of
# its rows from K + 3.
_FORMAT = ((0, 0, BIG), (0, 1, 0.0), (1, 1, 0.0), (1, 0, BIG))


def _sys_gather(ls: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """(B, K) ls in interleaved order: ls[:, perm] for a shared (K,) table,
    ls[b, perm[t, b]] for a time-major (K, B) per-codeword one."""
    if perm.dim() == 1:
        return ls.index_select(1, perm)
    return torch.gather(ls, 1, perm.T)


def pack_streams_plain(ls, lp1, lp2, tail1, tail2, KTp: int,
                       dtype: torch.dtype, perm: torch.Tensor):
    """Plain version of `pack_streams`."""
    K = ls.shape[1]
    tails = (tail1, tail2)

    def stream(body, fmt):
        """(B, K) body + its (B, 3) tail -> (KTp, B) stream with the pad."""
        tail, off, pad = fmt
        full = torch.cat([body, tails[tail][:, off::2]], dim=1)
        full = torch.nn.functional.pad(full, (0, KTp - K - 3), value=pad)
        return full.to(dtype).T.contiguous()

    ls1, lp1s, lp2s, ls2 = (stream(body, fmt) for body, fmt in zip(
        (ls, lp1, lp2, _sys_gather(ls, perm)), _FORMAT))
    return ls1, lp1s, ls2, lp2s


def _pack_launch(ls, lp1, lp2, tail1, tail2, KTp: int, dtype: torch.dtype):
    """One launch of `pack_kernel` on contiguous card tensors with B > 0:
    (ls1, lp1s, ls2, lp2s) complete but for ls2's rows [0, K), which it
    leaves unwritten."""
    B, K = ls.shape
    dev = ls.device
    ls1, lp1s, lp2s, ls2 = (torch.empty((KTp, B), dtype=dtype, device=dev)
                            for _ in range(4))
    tails = (tail1, tail2)
    rc = launch_on(dev.index, _PACK,
                   *(x.data_ptr() for x in (ls, lp1, lp2)),
                   *(tails[tail].data_ptr() for tail, _, _ in _FORMAT),
                   *(off for _, off, _ in _FORMAT),
                   *(_build.f64_bits(pad) for _, _, pad in _FORMAT),
                   *(x.data_ptr() for x in (ls1, lp1s, lp2s, ls2)),
                   B, K, KTp, _CHAN_TYPES[dtype], count=("pack_kernel",))
    if rc != 0:
        raise RuntimeError(f"pack_streams launch failed: cudaError {rc} "
                           f"(B={B}, K={K}, KTp={KTp}, {dtype})")
    return ls1, lp1s, ls2, lp2s


def pack_streams(ls, lp1, lp2, tail1, tail2, KTp: int, dtype: torch.dtype,
                 perm: torch.Tensor):
    """The SISO kernels' streams (ls1, lp1s, ls2, lp2s), each (KTp, B) of
    `dtype` (fp32 or bf16, rounded to nearest even).

    ls, lp1, lp2: (B, K) fp32; tail1, tail2: (B, 6) fp32, columns x, p, x,
    p, x, p.  Rows [0, K) hold the bodies transposed (ls2: ls in the
    interleaver's order), rows K..K+2 the systematic or parity tail
    (ls1, lp1s from tail1; ls2, lp2s from tail2), and rows from K + 3 the
    pad: BIG on the systematic streams, 0 on the parity streams.
    perm: the interleaver, a shared (K,) int64 table (ls2[t, b] =
    ls[b, perm[t]]) or a time-major (K, B) int64 per-codeword one
    (ls2[t, b] = ls[b, perm[t, b]]).

    On the card one launch writes everything but ls2's body, which is
    ls1's rows gathered along time (`index_select` or `torch.gather` into
    ls2[:K]): gather and cast commute, so the bytes are the plain version's.
    """
    B, K = ls.shape
    if KTp < K + 3:
        raise ValueError(f"KTp={KTp} leaves no room for the tail (K={K})")
    for name, x, shape in (("ls", ls, (B, K)), ("lp1", lp1, (B, K)),
                           ("lp2", lp2, (B, K)), ("tail1", tail1, (B, 6)),
                           ("tail2", tail2, (B, 6))):
        if x.dtype != _F32 or tuple(x.shape) != shape or x.device != ls.device:
            raise ValueError(f"{name} must be fp32 {shape} on {ls.device}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if dtype not in _CHAN_TYPES:
        raise ValueError(f"unsupported stream type {dtype}")
    if perm.dim() == 1:
        if tuple(perm.shape) != (K,):
            raise ValueError(f"a shared perm must be ({K},), got "
                             f"{tuple(perm.shape)}")
    elif tuple(perm.shape) != (K, B):
        raise ValueError(f"a per-codeword perm must be time-major {(K, B)}, "
                         f"got {tuple(perm.shape)}")
    dev = ls.device
    if dev.type != "cuda":
        if dev.type == "cpu":
            return pack_streams_plain(ls, lp1, lp2, tail1, tail2, KTp, dtype,
                                      perm)
        raise ValueError(f"unsupported device {dev}")
    if B == 0:
        return tuple(torch.empty((KTp, 0), dtype=dtype, device=dev)
                     for _ in range(4))
    ls1, lp1s, ls2, lp2s = _pack_launch(
        *(x.contiguous() for x in (ls, lp1, lp2, tail1, tail2)), KTp, dtype)
    if perm.dim() == 1:
        torch.index_select(ls1, 0, perm, out=ls2[:K])
    else:
        torch.gather(ls1, 0, perm, out=ls2[:K])
    return ls1, lp1s, ls2, lp2s


def full_llr(ls1, le1, le21, K: int, deq: float, ext: torch.dtype):
    """The time-major (K, B) fp32 LLR ls + deq * (le1 + le21) of the
    streams' rows [0, K); le1, le21 are read as `ext` (carried as bytes
    for float8)."""
    return ls1[:K].to(_F32) + deq * (le1[:K].view(ext).to(_F32)
                                     + le21[:K].view(ext).to(_F32))


def assemble_outputs_plain(ls1, le1, le21, K: int, deq: float,
                           ext: torch.dtype):
    """Plain version of `assemble_outputs`."""
    L = full_llr(ls1, le1, le21, K, deq, ext)
    hard = (L < 0).to(torch.int8)
    return hard.T.contiguous(), L.T.contiguous()


def assemble_outputs(ls1, le1, le21, K: int, deq: float, ext: torch.dtype):
    """(hard (B, K) int8, L (B, K) fp32) from the time-major streams:
    L = ls1 + deq * (le1 + le21) on rows [0, K), in fp32 and in that order,
    and hard = (L < 0).

    ls1: (KTp, B) fp32 or bf16; le1, le21: (KTp, B) extrinsic streams of
    type `ext` (fp32, bf16, int8 codes, or float8_e4m3fn carried as its
    uint8 bytes); deq: the factor of the extrinsic sum (scale, times the
    int8 step for codes), rounded to fp32 as PyTorch rounds a Python scalar
    that multiplies an fp32 tensor."""
    T, B = ls1.shape
    if K <= 0 or T < K + 3:
        raise ValueError(f"streams of {T} rows cannot hold K={K} and a tail")
    if ls1.dtype not in _CHAN_TYPES:
        raise ValueError(f"unsupported channel stream type {ls1.dtype}")
    if ext not in _EXT_TYPES:
        raise ValueError(f"unsupported extrinsic type {ext}")
    for name, x in (("le1", le1), ("le21", le21)):
        if (tuple(x.shape) != (T, B) or x.element_size() != ext.itemsize
                or x.device != ls1.device):
            raise ValueError(f"{name} must be {(T, B)} of {ext} on "
                             f"{ls1.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    dev = ls1.device
    if dev.type != "cuda":
        if dev.type == "cpu":
            return assemble_outputs_plain(ls1, le1, le21, K, deq, ext)
        raise ValueError(f"unsupported device {dev}")
    ls1, le1, le21 = (x.contiguous() for x in (ls1, le1, le21))
    L = torch.empty((B, K), dtype=_F32, device=dev)
    hard = torch.empty((B, K), dtype=torch.int8, device=dev)
    if B == 0:
        return hard, L
    rc = launch_on(dev.index, _ASSEMBLE,
                   *(x.data_ptr() for x in (ls1, le1, le21, L, hard)), B, K,
                   _build.f64_bits(deq), _CHAN_TYPES[ls1.dtype],
                   _EXT_TYPES[ext], 0, 0, 0, 0, B, count=("unpack_kernel",))
    if rc != 0:
        raise RuntimeError(f"assemble_outputs launch failed: cudaError {rc} "
                           f"(B={B}, K={K}, {ls1.dtype}, {ext})")
    return hard, L


@functools.lru_cache(maxsize=None)
def crc_masks_np(K: int, poly: int) -> np.ndarray:
    """(K,) int32: bit j of row t is the CRC check matrix's entry (t, j)
    (`early_term._crc_check_matrix_np`), so the syndrome of a K-bit word is
    the XOR of the masks of its 1 bits."""
    H = _crc_check_matrix_np(K, poly).astype(np.int64)
    return (H << np.arange(H.shape[1])).sum(axis=1).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _masks_on(K: int, poly: int, dev: torch.device) -> torch.Tensor:
    """`crc_masks_np(K, poly)` on `dev`, copied there once."""
    return torch.from_numpy(crc_masks_np(K, poly)).to(dev)


def crc_exit_scratch(B: int, dev: torch.device):
    """What `crc_exit` needs on the card, made once a decode: the (B,)
    int32 syndrome, zero (each call leaves it zero), and the all-done
    flag."""
    return (torch.zeros((B,), dtype=torch.int32, device=dev),
            torch.empty((), dtype=torch.bool, device=dev))


def _syndromes(hard: torch.Tensor, K: int, poly: int) -> torch.Tensor:
    """(K, n) hard bits -> (n,) int32: bit j the syndrome's bit j, as the
    XOR of the packed masks (`crc_masks_np`) forms it, through an fp32
    matmul (exact: sums of 0/1 up to K, with TF32 off)."""
    if hard.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the CRC syndrome needs an exact fp32 matmul: "
            "torch.backends.cuda.matmul.allow_tf32 must be False")
    G = make_crc_matrix(K, poly, hard.device)
    synd = (hard.T.to(_F32) @ G) % 2.0
    weights = 2 ** torch.arange(G.shape[1], dtype=torch.int64,
                                device=hard.device)
    return (synd.to(torch.int64) * weights).sum(dim=1).to(torch.int32)


def crc_exit_plain(ls1, le1, le21, le1_new, le21_nat, le21_new, done, iters,
                   K: int, deq: float, ext: torch.dtype, poly: int):
    """Plain version of `crc_exit`: hard bits, the syndromes as
    `_syndromes` forms them, and `torch.where` freezes."""
    hard_new = full_llr(ls1, le1_new, le21_nat, K, deq, ext) < 0
    newly_done = _syndromes(hard_new, K, poly) == 0
    # Freeze converged codewords' extrinsics branchlessly; their SISO
    # outputs keep being computed (the batch runs anyway) and are
    # discarded here, so L/hard derived after the loop are pinned at the
    # convergence iteration.
    keep = done[None, :]
    le21 = torch.where(keep, le21, le21_new)
    le1 = torch.where(keep, le1, le1_new)
    iters = iters + (~done).to(torch.int32)
    done = done | newly_done
    return le1, le21, done, iters, done.all()


def crc_exit(ls1, le1, le21, le1_new, le21_nat, le21_new, done, iters,
             K: int, deq: float, ext: torch.dtype, poly: int, scratch=None):
    """One iteration's early exit of the `crc` loop: returns (le1, le21,
    done, iters, all_done), the carry frozen on the codewords done before
    this iteration, done with those whose hard bits pass the CRC now,
    iters counting this iteration for each codeword not done before it,
    and done.all() as a bool scalar on the device.

    ls1: (KTp, B) channel stream; le1, le21: (KTp, B) the carry before the
    iteration; le1_new, le21_new: the iteration's new carry, le21_nat: its
    le21 in natural order (le21_new itself, unless the loop carries le2
    raw), all of type `ext` (float8 as its bytes); done (B,) bool, iters
    (B,) int32.  hard = (ls1 + deq * (le1_new + le21_nat) < 0) on rows
    [0, K), as `full_llr` forms it; the CRC has generator `poly` and covers
    the K bits, its 24 parity bits last.

    On the card one `exit_kernel` and one `exit_close_kernel` launch do it
    in place: le1_new, le21_new, done and iters are written and returned,
    the flag is `scratch`'s (`crc_exit_scratch`); nothing is allocated.
    The bytes equal the plain version's."""
    B = ls1.shape[1]
    _check_iteration(ls1, K, ext, False, le1=le1, le21=le21, le1_new=le1_new,
                     le21_nat=le21_nat, le21_new=le21_new)
    for name, x, dt in (("done", done, torch.bool),
                        ("iters", iters, torch.int32)):
        if x.dtype != dt or tuple(x.shape) != (B,) or x.device != ls1.device:
            raise ValueError(f"{name} must be ({B},) {dt} on {ls1.device}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    dev = ls1.device
    if dev.type != "cuda":
        if dev.type == "cpu":
            return crc_exit_plain(ls1, le1, le21, le1_new, le21_nat,
                                  le21_new, done, iters, K, deq, ext, poly)
        raise ValueError(f"unsupported device {dev}")
    if scratch is None:
        raise ValueError("crc_exit on the card needs its scratch "
                         "(crc_exit_scratch)")
    synd, flag = scratch
    if (synd.dtype != torch.int32 or tuple(synd.shape) != (B,)
            or flag.dtype != torch.bool or flag.dim() != 0
            or synd.device != dev or flag.device != dev):
        raise ValueError("scratch must be crc_exit_scratch(B, device)")
    for name, x in (("le1_new", le1_new), ("le21_new", le21_new),
                    ("done", done), ("iters", iters)):
        if not x.is_contiguous():
            raise ValueError(f"{name} is written in place and must be "
                             f"contiguous")
    if B == 0:
        flag.fill_(True)
    else:
        _exit_launch(*(x.contiguous() for x in (ls1, le1, le21)), le1_new,
                     le21_nat.contiguous(), le21_new, done, iters,
                     _masks_on(K, poly, dev), synd, flag, K, deq, ext)
    return le1_new, le21_new, done, iters, flag


def _exit_launch(ls1, le1, le21, le1_new, le21_nat, le21_new, done, iters,
                 masks, synd, flag, K: int, deq: float, ext: torch.dtype):
    """The two launches of `crc_exit` on contiguous tensors with B > 0."""
    T, B = ls1.shape
    rc = launch_on(ls1.device.index, _EXIT,
                   *(x.data_ptr() for x in (ls1, le1_new, le21_nat, le1,
                                            le21, le21_new, done, iters,
                                            masks, synd, flag)),
                   B, K, T, _build.f64_bits(deq), _CHAN_TYPES[ls1.dtype],
                   _EXT_TYPES[ext], 0, B,
                   count=("exit_kernel", "exit_close_kernel"))
    if rc != 0:
        raise RuntimeError(f"crc_exit launch failed: cudaError {rc} "
                           f"(B={B}, K={K}, KTp={T}, {ls1.dtype}, {ext})")


# ---- the live prefix ------------------------------------------------------

class LivePrefix(NamedTuple):
    """What the `crc` loop's live prefix keeps on its device, made once a
    decode (`live_prefix`): its working set's first state[0] columns hold
    the codewords not done yet, column j codeword col[j].

    synd (B,) int32: the syndromes `live_syndromes` leaves for
    `retire_outputs` and `live_compact` (zero between iterations); state
    (3,) int32: the live count n, then the last close's retired columns and
    moves; lists (2, B) int32: the moves' sources and holes (their first
    state[2] entries); col (B,) int32."""
    synd: torch.Tensor
    state: torch.Tensor
    lists: torch.Tensor
    col: torch.Tensor


def live_prefix(B: int, dev: torch.device) -> LivePrefix:
    """Every codeword live, in its own column.  Made on the device alone
    (a copy from pageable host memory would wait for the stream)."""
    i32 = torch.int32
    state = torch.zeros((3,), dtype=i32, device=dev)
    state[0] = B
    return LivePrefix(torch.zeros((B,), dtype=i32, device=dev), state,
                      torch.zeros((2, B), dtype=i32, device=dev),
                      torch.arange(B, dtype=i32, device=dev))


def live_syndromes_plain(ls1, le1_new, le21_nat, K: int, deq: float,
                         ext: torch.dtype, poly: int, live: LivePrefix):
    """Plain version of `live_syndromes`."""
    n = int(live.state[0])
    hard = full_llr(ls1[:, :n], le1_new[:, :n], le21_nat[:, :n], K, deq,
                    ext) < 0
    live.synd[:n] = _syndromes(hard, K, poly)


def live_syndromes(ls1, le1_new, le21_nat, K: int, deq: float,
                   ext: torch.dtype, poly: int, live: LivePrefix, N: int):
    """The CRC syndromes of the live prefix's codewords into live.synd:
    column j < n (n = live.state[0] when the call runs) gets the syndrome
    of hard = (ls1 + deq * (le1_new + le21_nat) < 0) on rows [0, K), as
    `crc_exit` forms it, bit i of the syndrome at bit i.

    ls1: the (KTp, B) working channel stream; le1_new, le21_nat: this
    iteration's (KTp, B) le1 and its le21 in natural order, of type `ext`
    (float8 as its bytes).  N: a bound of n known on the host, the columns
    the card's grid spans.  One `exit_kernel` launch on the card."""
    B = ls1.shape[1]
    _check_iteration(ls1, K, ext, True, le1_new=le1_new,
                     le21_nat=le21_nat)
    _check_live(live, B, ls1.device, N)
    dev = ls1.device
    if dev.type == "cpu":
        return live_syndromes_plain(ls1, le1_new, le21_nat, K, deq, ext,
                                    poly, live)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _syndromes_launch(ls1.contiguous(), le1_new, le21_nat,
                      _masks_on(K, poly, dev), K, deq, ext, live, N)


def _syndromes_launch(ls1, le1_new, le21_nat, masks, K: int, deq: float,
                      ext: torch.dtype, live: LivePrefix, N: int):
    """The one launch of `live_syndromes` on contiguous tensors."""
    T, B = ls1.shape
    rc = launch_on(ls1.device.index, _EXIT,
                   ls1.data_ptr(), le1_new.data_ptr(), le21_nat.data_ptr(),
                   0, 0, 0, 0, 0, masks.data_ptr(), live.synd.data_ptr(), 0,
                   B, K, T, _build.f64_bits(deq), _CHAN_TYPES[ls1.dtype],
                   _EXT_TYPES[ext], live.state.data_ptr(), N,
                   count=("exit_kernel",))
    if rc != 0:
        raise RuntimeError(f"live_syndromes launch failed: cudaError {rc} "
                           f"(B={B}, N={N}, K={K}, KTp={T}, {ls1.dtype}, "
                           f"{ext})")


def _check_iteration(ls1, K: int, ext: torch.dtype, contiguous: bool,
                     **streams):
    """Check one iteration's (KTp, B) channel stream ls1 and its extrinsic
    streams of type `ext` (float8 as its bytes), by name, contiguous where
    asked."""
    T, B = ls1.shape
    if K <= 0 or T < K + 3:
        raise ValueError(f"streams of {T} rows cannot hold K={K} and a tail")
    if ls1.dtype not in _CHAN_TYPES:
        raise ValueError(f"unsupported channel stream type {ls1.dtype}")
    if ext not in _EXT_TYPES:
        raise ValueError(f"unsupported extrinsic type {ext}")
    for name, x in streams.items():
        if (tuple(x.shape) != (T, B) or x.element_size() != ext.itemsize
                or x.device != ls1.device
                or (contiguous and not x.is_contiguous())):
            raise ValueError(f"{name} must be "
                             f"{'contiguous ' if contiguous else ''}"
                             f"{(T, B)} of {ext} on {ls1.device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")


def _check_live(live: LivePrefix, B: int, dev: torch.device,
                N: int | None = None):
    """Check a `LivePrefix` of B columns on dev, and N, the host's bound of
    its count, where given."""
    if N is not None and not 1 <= N <= B:
        raise ValueError(f"N must be in [1, {B}], got {N}")
    for name, x, shape in (("synd", live.synd, (B,)),
                           ("state", live.state, (3,)),
                           ("lists", live.lists, (2, B)),
                           ("col", live.col, (B,))):
        if (x.dtype != torch.int32 or tuple(x.shape) != shape
                or x.device != dev or not x.is_contiguous()):
            raise ValueError(f"live.{name} must be contiguous int32 {shape} "
                             f"on {dev} (live_prefix)")


def retire_outputs_plain(hard, L, ls1, le1_new, le21_nat, K: int,
                         deq: float, ext: torch.dtype, live: LivePrefix,
                         last: bool):
    """Plain version of `retire_outputs`."""
    n = int(live.state[0])
    j = ((live.synd[:n] == 0) | last).nonzero()[:, 0]
    c = live.col[j].to(torch.long)
    Lj = full_llr(ls1[:, j], le1_new[:, j], le21_nat[:, j], K, deq, ext)
    L[c] = Lj.T
    hard[c] = (Lj < 0).T.to(torch.int8)


def retire_outputs(hard, L, ls1, le1_new, le21_nat, K: int, deq: float,
                   ext: torch.dtype, live: LivePrefix, N: int, last: bool):
    """The outputs of the live prefix's codewords that retire now, after
    `live_syndromes`: for each working column j < n (n = live.state[0])
    whose syndrome is 0, or every one when `last`, rows col[j] of hard
    (B, K) int8 and L (B, K) fp32 get `assemble_outputs`' bytes for that
    column: L = ls1 + deq * (le1_new + le21_nat) on rows [0, K), in fp32 and
    in that order, and hard = (L < 0).  Other rows are not written.

    ls1: the (KTp, B) working channel stream; le1_new, le21_nat: this
    iteration's le1 and its le21 in natural order, (KTp, B) of type `ext`
    (float8 as its bytes).  N: a bound of n known on the host, the columns
    the card's grid spans.  One `unpack_kernel` launch on the card."""
    B = ls1.shape[1]
    _check_iteration(ls1, K, ext, True, le1_new=le1_new,
                     le21_nat=le21_nat)
    for name, x, dt in (("hard", hard, torch.int8), ("L", L, _F32)):
        if (x.dtype != dt or tuple(x.shape) != (B, K)
                or x.device != ls1.device or not x.is_contiguous()):
            raise ValueError(f"{name} must be contiguous ({B}, {K}) {dt} on "
                             f"{ls1.device}")
    _check_live(live, B, ls1.device, N)
    dev = ls1.device
    if dev.type == "cpu":
        return retire_outputs_plain(hard, L, ls1, le1_new, le21_nat, K, deq,
                                    ext, live, last)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _retire_launch(hard, L, ls1.contiguous(), le1_new, le21_nat, K, deq, ext,
                   live, N, last)


def _retire_launch(hard, L, ls1, le1_new, le21_nat, K: int, deq: float,
                   ext: torch.dtype, live: LivePrefix, N: int, last: bool):
    """The one launch of `retire_outputs` on contiguous tensors."""
    B = ls1.shape[1]
    rc = launch_on(ls1.device.index, _ASSEMBLE,
                   *(x.data_ptr() for x in (ls1, le1_new, le21_nat, L, hard)),
                   B, K, _build.f64_bits(deq), _CHAN_TYPES[ls1.dtype],
                   _EXT_TYPES[ext],
                   *(x.data_ptr() for x in (live.synd, live.col, live.state)),
                   int(last), N, count=("unpack_kernel",))
    if rc != 0:
        raise RuntimeError(f"retire_outputs launch failed: cudaError {rc} "
                           f"(B={B}, N={N}, K={K}, {ls1.dtype}, {ext})")


def live_compact_plain(done, iters, live: LivePrefix, moved, last: bool):
    """Plain version of `live_compact`."""
    n = int(live.state[0])
    col = live.col[:n].to(torch.long)
    ok = live.synd[:n] == 0
    iters[col] += 1
    done[col] = ok
    retire = ok | last
    stay = n - int(retire.sum())
    holes = retire[:stay].nonzero()[:, 0]
    srcs = stay + (~retire[stay:]).nonzero()[:, 0]
    for x in moved:
        if x is not None:
            x[..., holes] = x[..., srcs]
    m = len(holes)
    live.lists[0, :m] = srcs.to(torch.int32)
    live.lists[1, :m] = holes.to(torch.int32)
    live.col[holes] = live.col[srcs]
    live.synd[:n] = 0
    live.state.copy_(torch.tensor([stay, n - stay, m], dtype=torch.int32))


def live_compact(done, iters, live: LivePrefix, moved, last: bool):
    """Close one iteration of the live prefix, after `live_syndromes` (and
    `retire_outputs`): for each column j < n (n = live.state[0]),
    iters[col[j]] += 1 and done[col[j]] = (its syndrome is 0); column j
    retires where it passed, or everywhere when `last`.  The n' columns
    that stay fill the prefix: the k-th retired column below n' takes the
    k-th staying column from n' up, in every array of `moved` and in col.
    Afterwards state is (n', retired, moves), lists holds the moves
    (sources, holes) and synd is zero.

    done (B,) bool and iters (B,) int32 in the codewords' order; moved:
    (ls1, lp1, ls2, lp2, le21, ck1, ck2), the working set, all with pitch
    B: the four (KTp, B) channel streams, the (KTp, B) carried extrinsic
    (le21 itself, or le2 raw) and the two (n_win, 8, B) fp32 window tables
    (None, None in the exact contract).  On the card two launches,
    `live_close_kernel` and `compact_kernel`; nothing is allocated and the
    host reads nothing."""
    B = done.shape[0]
    dev = done.device
    if (done.dtype != torch.bool or iters.dtype != torch.int32
            or tuple(iters.shape) != (B,) or done.dim() != 1):
        raise ValueError(f"done and iters must be ({B},) bool and int32")
    _check_live(live, B, dev)
    ls1, lp1, ls2, lp2, le21, ck1, ck2 = moved
    T = ls1.shape[0]
    for name, x in (("ls1", ls1), ("lp1", lp1), ("ls2", ls2), ("lp2", lp2),
                    ("le21", le21)):
        if (tuple(x.shape) != (T, B) or x.device != dev
                or not x.is_contiguous()
                or (name != "le21" and x.dtype != ls1.dtype)):
            raise ValueError(f"{name} must be a contiguous {(T, B)} stream "
                             f"on {dev}")
    if (ck1 is None) != (ck2 is None):
        raise ValueError("the window tables come as a pair")
    for name, x in (("ck1", ck1), ("ck2", ck2)):
        if x is not None and (x.dtype != _F32 or x.dim() != 3
                              or x.shape[1:] != (8, B) or x.device != dev
                              or x.shape != ck1.shape
                              or not x.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous (n_win, 8, {B}) "
                             f"fp32 window table on {dev}")
    if dev.type == "cpu":
        return live_compact_plain(done, iters, live, moved, last)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _compact_launch(done, iters, live, moved, last)


def _compact_launch(done, iters, live: LivePrefix, moved, last: bool):
    """The two launches of `live_compact` on contiguous tensors."""
    B = done.shape[0]
    ls1, lp1, ls2, lp2, le21, ck1, ck2 = moved
    T = ls1.shape[0]
    rc = launch_on(done.device.index, _COMPACT,
                   *(x.data_ptr() for x in (done, iters, live.col, live.synd,
                                            live.state, live.lists)),
                   B, int(last), *(x.data_ptr() for x in (ls1, lp1, ls2, lp2)),
                   T, ls1.element_size(), le21.data_ptr(), le21.element_size(),
                   *((ck1.data_ptr(), ck2.data_ptr(), ck1.shape[0] * 8)
                     if ck1 is not None else (0, 0, 0)),
                   count=("live_close_kernel", "compact_kernel"))
    if rc != 0:
        raise RuntimeError(f"live_compact launch failed: cudaError {rc} "
                           f"(B={B}, KTp={T})")
