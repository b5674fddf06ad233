"""The hot loop's time-major passes outside the SISO kernels
(csrc/layout.cu): the two layout crossings, one kernel launch each, and
the CRC early exit, two launches an iteration.

`pack_streams` turns the public (B, K) fp32 channel LLRs and (B, 6) tails
into the SISO kernels' four time-major (KTp, B) streams; `assemble_outputs`
turns the loop's time-major extrinsics back into the (B, K) hard bits and
LLR L; `crc_exit` is one iteration's verdicts and freezes of the `crc`
loop.  Each sits beside its plain version (`pack_streams_plain`,
`assemble_outputs_plain`, `crc_exit_plain`): the same function in PyTorch
operations, which gives the same bytes.

On a CUDA tensor a wrapper launches its kernel, or raises for what the
kernel does not take; it takes the plain version only for tensors on the
CPU.  Each launch is counted in `_device.LAUNCHES` by its kernel's name in
layout.cu.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _build
from .._device import launch_on
from ..siso.cuda_kernel import _CHAN_TYPES, _EXT_TYPES, BIG
from .early_term import _crc_check_matrix_np, make_crc_matrix

TARGET: _build.Target = ("layout", ())
# layout.cu's kernels, by the names their launches count under
KERNELS = ("pack_kernel", "unpack_kernel", "exit_kernel", "exit_close_kernel")
# each C entry takes one pointer to its int64 arguments, the stream last,
# and the SISO library's type codes (_CHAN_TYPES, _EXT_TYPES)
_PACK = _build.PackedEntry(TARGET, "turbotpu_pack_streams_launch", 24)
_ASSEMBLE = _build.PackedEntry(TARGET, "turbotpu_assemble_outputs_launch", 11)
_EXIT = _build.PackedEntry(TARGET, "turbotpu_crc_exit_launch", 18)
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
                   _EXT_TYPES[ext], count=("unpack_kernel",))
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


def crc_exit_plain(ls1, le1, le21, le1_new, le21_nat, le21_new, done, iters,
                   K: int, deq: float, ext: torch.dtype, poly: int):
    """Plain version of `crc_exit`: hard bits, an fp32 matmul against the
    check matrix for the syndrome, and `torch.where` freezes."""
    if ls1.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the CRC syndrome needs an exact fp32 matmul: "
            "torch.backends.cuda.matmul.allow_tf32 must be False")
    # fp32 operands: sums of 0/1 up to K are exact, with TF32 off.
    G = make_crc_matrix(K, poly, ls1.device)
    hard_new = full_llr(ls1, le1_new, le21_nat, K, deq, ext) < 0
    synd = hard_new.T.to(_F32) @ G                       # (B, 24)
    newly_done = (synd % 2.0 == 0.0).all(dim=1)
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
    T, B = ls1.shape
    if K <= 0 or T < K + 3:
        raise ValueError(f"streams of {T} rows cannot hold K={K} and a tail")
    if ls1.dtype not in _CHAN_TYPES:
        raise ValueError(f"unsupported channel stream type {ls1.dtype}")
    if ext not in _EXT_TYPES:
        raise ValueError(f"unsupported extrinsic type {ext}")
    for name, x in (("le1", le1), ("le21", le21), ("le1_new", le1_new),
                    ("le21_nat", le21_nat), ("le21_new", le21_new)):
        if (tuple(x.shape) != (T, B) or x.element_size() != ext.itemsize
                or x.device != ls1.device):
            raise ValueError(f"{name} must be {(T, B)} of {ext} on "
                             f"{ls1.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
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
                   _EXT_TYPES[ext], count=("exit_kernel", "exit_close_kernel"))
    if rc != 0:
        raise RuntimeError(f"crc_exit launch failed: cudaError {rc} "
                           f"(B={B}, K={K}, KTp={T}, {ls1.dtype}, {ext})")
