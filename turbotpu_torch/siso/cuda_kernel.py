"""Fused SISO: wrappers of the hand-written CUDA kernels and their plain
PyTorch versions.

Counterpart of turbotpu/siso/pallas_kernel.py.  The kernels are in
csrc/siso.cu and replace `_make_kernel` (built by `_build_call`) in its two
non-boundary contracts:

* `siso_nii`   -- nii=True: window-start alphas inherited from the previous
  half-iteration (`ain`), fresh ones returned (`aout`);
* `siso_exact` -- nii=False: two-phase checkpoint/recompute, no
  approximation;

* `siso_nii_fold` -- the NII contract with the extrinsic interleave folded
  into the kernel's a-priori read (the reference's `fold_gather=True` call,
  `pallas_call` at `:570`): `siso_cells(..., gather_idx=idx)` reads la row t
  from row `idx[t]` of the tensor it is given, which is the other SISO's raw
  output, so no gathered copy is made between the half-iterations;

each in the three max* modes of `_mstar`/`_mstar_tree` there.  max-log keeps
the names above; the linlog and log-MAP instantiations count their
launches as `siso_nii_linlog`, `siso_exact_linlog`, `siso_nii_fold_linlog`,
`siso_nii_logmap`, `siso_exact_logmap` and `siso_nii_fold_logmap`.

Layout.  All streams are time-major `(T, B)` tensors: the same element order
at each step as the JAX package's `(cells, T, 8, 128)`, without its batch
pad to 1024.  The time pad stays: callers pad the trellis to a multiple of
the window with ls = BIG, lp = 0 (known-0 steps that only take u=0 edges,
so beta at the true trellis end is exactly e0).  la rows at t >= K_real are
ignored (masked in the kernel) but must be finite.  Window checkpoints are
`(n_win, 8, B)` fp32; slot 0 is never read and never written.

On a CUDA tensor a wrapper launches its kernel or raises; it takes the plain
version only for a tensor on the CPU.  `LAUNCHES` counts kernel launches.

The plain versions (`siso_nii_plain`, `siso_exact_plain`; the folded read is
`siso_nii_plain(..., gather_idx=idx)`, an `index_select` in front of the
same loop) are a Python loop
over steps that repeats the kernel's arithmetic in the same order (fp32
metrics, renormalisation every UNROLL steps from the window start, the same
quantisation), vectorised over the 8 states: where the kernel adds no branch
metric they add an exact 0.0.  The extrinsic is max-log's factored parity
add, or for linlog and log-MAP the per-leaf form reduced as an explicit
pairwise tree in state order (linlog's clipped correction depends on the
order).  They are what the CPU tests and the on-card comparison hold the
kernels against, and no yardstick of speed.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..spec.trellis import TRELLIS
from .maxstar import LINLOG, LOGMAP, MAXLOG, MODES, maxstar2

BIG = 1e9
UNROLL = 8           # trellis steps per block; also the renorm cadence
THREADS = 32         # codewords per thread block (one warp)

_MODE_CODES = {MAXLOG: 0, LINLOG: 1, LOGMAP: 2}


def kernel_name(nii: bool, mode: str, fold: bool = False) -> str:
    """The name a contract/mode instantiation counts its launches under."""
    if fold and not nii:
        raise ValueError("the folded read exists for the NII contract only")
    base = "siso_nii_fold" if fold else "siso_nii" if nii else "siso_exact"
    return base if mode == MAXLOG else f"{base}_{mode}"


# (nii, fold) of the three contracts
CONTRACTS = ((True, False), (False, False), (True, True))

LAUNCHES = {kernel_name(nii, mode, fold): 0
            for mode in (MAXLOG, LINLOG, LOGMAP) for nii, fold in CONTRACTS}

_CHAN_TYPES = {torch.float32: 0, torch.bfloat16: 1}
_EXT_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def window_len(KT: int) -> int:
    return 128 if KT >= 256 else _round_up(KT, UNROLL)


def _quantize_le(le: torch.Tensor, dt: torch.dtype, qscale: float) -> torch.Tensor:
    """Cast an fp32 extrinsic row to the extrinsic stream type.  int8 is
    uniform quantisation at step `qscale`, rounded half to even and
    saturated at +-127; the matching dequantisation rides the kernel's
    a-priori scale multiply."""
    if dt == torch.int8:
        return torch.clamp(torch.round(le * (1.0 / qscale)),
                           -127.0, 127.0).to(torch.int8)
    return le.to(dt)


# ----------------------------------------------------------------------
# plain PyTorch versions
# ----------------------------------------------------------------------

class _Tables:
    """Trellis tables as index tensors.  Branch metrics of one step are the
    rows g = (0, P, A, A+P); ga0/ga1 pick each edge's row."""

    def __init__(self, device):
        idx = lambda a: torch.as_tensor(a, dtype=torch.long, device=device)
        T = TRELLIS
        self.ps0, self.ps1 = idx(T.prev_state[:, 0]), idx(T.prev_state[:, 1])
        self.ga0, self.ga1 = idx(T.prev_parity[:, 0]), idx(2 + T.prev_parity[:, 1])
        self.ns0, self.ns1 = idx(T.next_state[:, 0]), idx(T.next_state[:, 1])
        self.gb0, self.gb1 = idx(T.parity[:, 0]), idx(2 + T.parity[:, 1])
        # per input bit u: successor states, each edge's parity, and the
        # edges of parity 0 / 1
        self.ns = (self.ns0, self.ns1)
        self.par = (idx(T.parity[:, 0]), idx(T.parity[:, 1]))
        self.par_rows = tuple(
            (idx((T.parity[:, u] == 0).nonzero()[0]),
             idx((T.parity[:, u] == 1).nonzero()[0])) for u in (0, 1))


def _e0(B: int, device) -> torch.Tensor:
    e = torch.full((8, B), -BIG, dtype=torch.float32, device=device)
    e[0] = 0.0
    return e


def _renorm(m: torch.Tensor) -> torch.Tensor:
    return m - m.amax(dim=0, keepdim=True)


def _alpha_step(alpha, g, tb, mode):
    return maxstar2(alpha[tb.ps0] + g[tb.ga0], alpha[tb.ps1] + g[tb.ga1], mode)


def _beta_step(beta, g, tb, mode):
    return maxstar2(beta[tb.ns0] + g[tb.gb0], beta[tb.ns1] + g[tb.gb1], mode)


def _extrinsic(alpha, beta, p_row, tb, mode):
    """max*(u=0 edges) - max*(u=1 edges) of alpha + beta[next] (+ P on the
    parity-1 edges).  max-log adds P once to the max of the parity-1 edges;
    linlog and log-MAP add it per leaf and reduce the 8 leaves pairwise in
    state order: (0,1)(2,3)(4,5)(6,7), pairs of those, the last pair."""
    side = []
    for u in (0, 1):
        x = alpha + beta[tb.ns[u]]
        if mode == MAXLOG:
            r0, r1 = tb.par_rows[u]
            side.append(torch.maximum(x[r0].amax(dim=0),
                                      x[r1].amax(dim=0) + p_row))
            continue
        x = x + torch.stack([torch.zeros_like(p_row), p_row])[tb.par[u]]
        while x.shape[0] > 1:
            x = maxstar2(x[0::2], x[1::2], mode)
        side.append(x[0])
    return side[0] - side[1]


def _siso_plain(ls, lp, la, ain, K_real, W, scale, ext_qscale, mode=MAXLOG,
                gather_idx=None):
    T, B = ls.shape
    dev = ls.device
    if gather_idx is not None:       # the folded read: la row t is la[idx[t]]
        la = la.index_select(0, gather_idx.to(torch.long))
    n_win, n_sub = T // W, W // UNROLL
    tb = _Tables(dev)
    f32 = torch.float32
    eff = scale * (ext_qscale if ext_qscale else 1.0)
    sm = torch.where(torch.arange(T, device=dev) < K_real,
                     torch.tensor(eff, dtype=f32, device=dev),
                     torch.zeros((), dtype=f32, device=dev))[:, None]
    A = -(la.to(f32) * sm + ls.to(f32))
    P = -lp.to(f32)
    G = torch.stack([torch.zeros_like(P), P, A, A + P], dim=1)   # (T, 4, B)

    if ain is None:
        # phase 1: forward alpha, one checkpoint per window start
        starts = torch.empty((n_win, 8, B), dtype=f32, device=dev)
        alpha = _e0(B, dev)
        for w in range(n_win):
            starts[w] = alpha
            for i in range(n_sub):
                for t in range(w * W + i * UNROLL, w * W + (i + 1) * UNROLL):
                    alpha = _alpha_step(alpha, G[t], tb, mode)
                alpha = _renorm(alpha)
        aout = None
    else:
        starts = ain
        aout = torch.zeros((n_win, 8, B), dtype=f32, device=dev)

    le = torch.empty((T, B), dtype=la.dtype, device=dev)
    aw = torch.empty((W, 8, B), dtype=f32, device=dev)
    beta = _e0(B, dev)
    for w in range(n_win - 1, -1, -1):
        alpha = _e0(B, dev) if (w == 0 and ain is not None) else starts[w]
        for i in range(n_sub):
            for j in range(i * UNROLL, (i + 1) * UNROLL):
                aw[j] = alpha
                alpha = _alpha_step(alpha, G[w * W + j], tb, mode)
            alpha = _renorm(alpha)
        if aout is not None and w + 1 < n_win:
            aout[w + 1] = alpha
        for i in range(n_sub):
            i0 = W - (i + 1) * UNROLL
            for j in range(i0 + UNROLL - 1, i0 - 1, -1):
                t = w * W + j
                le[t] = _quantize_le(_extrinsic(aw[j], beta, P[t], tb, mode),
                                     la.dtype, ext_qscale)
                beta = _beta_step(beta, G[t], tb, mode)
            beta = _renorm(beta)
    return le, aout


def siso_nii_plain(ls, lp, la, ain, K_real: int, W: int, scale: float = 1.0,
                   ext_qscale: float = 0.0, mode: str = MAXLOG,
                   gather_idx: torch.Tensor | None = None):
    """Plain version of the `siso_nii` kernels and, with `gather_idx` (a
    (KTp,) integer table: la row t is row gather_idx[t] of `la`), of the
    `siso_nii_fold` kernels.  Returns (le, aout); aout[0] is zero (the kernel
    leaves it unwritten)."""
    return _siso_plain(ls, lp, la, ain, K_real, W, scale, ext_qscale, mode,
                       gather_idx)


def siso_exact_plain(ls, lp, la, K_real: int, W: int, scale: float = 1.0,
                     ext_qscale: float = 0.0, mode: str = MAXLOG):
    """Plain version of the `siso_exact` kernels.  Returns le."""
    return _siso_plain(ls, lp, la, None, K_real, W, scale, ext_qscale, mode)[0]


# ----------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------

def _target(mode_code: int, chan_code: int, ext_code: int,
            fold: bool = False) -> _build.Target:
    """csrc/siso.cu compiled for one max* mode and one pair of stream types:
    each variant is a small library of its own (the NII and the exact
    kernel, or with `fold` the NII kernel with the folded read alone), built
    when first launched, so a decode builds only what it runs and the
    variants compile side by side."""
    return ("siso", (f"-DSISO_MODE={mode_code}", f"-DSISO_CHAN={chan_code}",
                     f"-DSISO_EXT={ext_code}")
            + (("-DSISO_FOLD=1",) if fold else ()))


def build_targets() -> list[_build.Target]:
    """Every variant of the kernel source, for building them all at once
    (`_build.build(build_targets())`)."""
    return [_target(m, c, e, fold) for fold in (False, True)
            for m in _MODE_CODES.values()
            for c in _CHAN_TYPES.values() for e in _EXT_TYPES.values()]


def _lib(mode: str, chan: torch.dtype, ext: torch.dtype,
         fold: bool = False) -> ctypes.CDLL:
    lib = _build.load(*_target(_MODE_CODES[mode], _CHAN_TYPES[chan],
                               _EXT_TYPES[ext], fold))
    fn = lib.turbotpu_siso_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [i, i, i, i, p, p, p, p, p, p, p, p, p, i, i, i, i, f,
                       f, i, p]
        fn.restype = ctypes.c_int
    return lib


def _launch(ls, lp, la, ain, K_real, W, eff, inv_q, mode, idx=None):
    """Launch the NII (ain given; with idx its folded form) or exact (ain
    None) kernel of `mode` on CUDA tensors."""
    T, B = ls.shape
    n_win = T // W
    dev = ls.device
    le = torch.empty_like(la)
    aw = torch.empty((W, 8, B), dtype=torch.float32, device=dev)
    # NII: the fresh window starts; exact: phase 1's checkpoints.
    ck = torch.empty((n_win, 8, B), dtype=torch.float32, device=dev)
    nii, fold = ain is not None, idx is not None
    fn = _lib(mode, ls.dtype, la.dtype, fold).turbotpu_siso_launch
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        LAUNCHES[kernel_name(nii, mode, fold)] += 1
        rc = fn(_MODE_CODES[mode], _CHAN_TYPES[ls.dtype], _EXT_TYPES[la.dtype],
                int(nii),
                ls.data_ptr(), lp.data_ptr(), la.data_ptr(),
                idx.data_ptr() if fold else None, le.data_ptr(),
                ain.data_ptr() if nii else None, ck.data_ptr() if nii else None,
                aw.data_ptr(), None if nii else ck.data_ptr(),
                B, K_real, n_win, W, eff, inv_q, THREADS, stream)
    if rc != 0:
        raise RuntimeError(
            f"siso kernel launch failed: cudaError {rc} "
            f"(T={T}, B={B}, W={W}, chan={ls.dtype}, ext={la.dtype}, "
            f"nii={nii}, fold={fold}, mode={mode})")
    return le, (ck if nii else None)


def siso_cells(ls: torch.Tensor, lp: torch.Tensor, la: torch.Tensor,
               K_real: int, mode: str, scale: float = 1.0,
               nii_ckpt: torch.Tensor | None = None, window: int = 0,
               ext_qscale: float = 0.0,
               gather_idx: torch.Tensor | None = None):
    """Kernel entry: raw LLR streams in, extrinsics out.

    ls/lp/la: contiguous (KTp, B) with KTp a multiple of the window; pad
    steps beyond the real trellis carry ls = +BIG, lp = 0.  ls and lp share
    a type (float32 or bfloat16); la, and the le that comes back, may be
    float32, bfloat16 or int8 codes of step `ext_qscale`.  The kernel forms
    A = -(scale*la*[t < K_real] + ls), P = -lp itself; le rows at
    t >= K_real are finite garbage.

    nii_ckpt: optional (n_win, 8, B) fp32 window-start alphas from the
    previous half-iteration (cold start: zeros).  With it the call returns
    (le, new_ckpt) and runs the NII kernel of `mode`; without it, le alone
    from the exact kernel of `mode`.

    gather_idx: optional (KTp,) int32 table shared by the batch, values in
    [0, KTp) (NII contract only): the a-priori row of step t is read from
    `la[gather_idx[t]]`.  The caller passes the OTHER SISO's raw extrinsic
    output and makes no gathered copy; the result equals the call without
    the option on `la.index_select(0, gather_idx)` bit for bit.  The mask
    [t < K_real] is on the step, after the read.
    """
    if mode not in MODES:
        raise ValueError(f"unknown max* mode {mode!r}")
    if ls.dim() != 2 or lp.shape != ls.shape or la.shape != ls.shape:
        raise ValueError("ls, lp, la must share one (KTp, B) shape")
    if str(la.dtype).startswith("torch.float8"):
        raise NotImplementedError("float8 extrinsic streams are not ported")
    if ls.dtype != lp.dtype or ls.dtype not in _CHAN_TYPES:
        raise TypeError(f"ls/lp must both be float32 or bfloat16, got "
                        f"{ls.dtype}, {lp.dtype}")
    if la.dtype not in _EXT_TYPES:
        raise TypeError(f"la must be float32, bfloat16 or int8, got {la.dtype}")
    if (la.dtype == torch.int8) != (ext_qscale > 0.0):
        raise ValueError("ext_qscale is the int8 quantisation step: it must "
                         "be > 0 for int8 extrinsics and 0 otherwise")
    KTp, B = ls.shape
    W = window or window_len(KTp)
    if KTp % W or W % UNROLL:
        raise ValueError(f"KTp={KTp} must be a multiple of the window {W}, "
                         f"and the window of {UNROLL}")
    tensors = [ls, lp, la]
    if nii_ckpt is not None:
        if nii_ckpt.shape != (KTp // W, 8, B) or nii_ckpt.dtype != torch.float32:
            raise ValueError(f"nii_ckpt must be fp32 of shape "
                             f"{(KTp // W, 8, B)}, got {nii_ckpt.dtype} "
                             f"{tuple(nii_ckpt.shape)}")
        tensors.append(nii_ckpt)
    if gather_idx is not None:
        if nii_ckpt is None:
            raise ValueError("gather_idx needs the NII contract (nii_ckpt)")
        if gather_idx.shape != (KTp,) or gather_idx.dtype != torch.int32:
            raise ValueError(f"gather_idx must be int32 of shape {(KTp,)}, "
                             f"got {gather_idx.dtype} "
                             f"{tuple(gather_idx.shape)}")
        tensors.append(gather_idx)
    if any(t.device != ls.device for t in tensors):
        raise ValueError("all tensors must lie on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all tensors must be contiguous")

    if ls.device.type == "cpu":
        le, ck = _siso_plain(ls, lp, la, nii_ckpt, K_real, W, scale,
                             ext_qscale, mode, gather_idx)
    elif ls.device.type == "cuda":
        eff = scale * (ext_qscale if ext_qscale else 1.0)
        inv_q = 1.0 / ext_qscale if ext_qscale else 1.0
        le, ck = _launch(ls, lp, la, nii_ckpt, K_real, W, eff, inv_q, mode,
                         gather_idx)
    else:
        raise ValueError(f"unsupported device {ls.device}")
    return le if nii_ckpt is None else (le, ck)


def siso_decode_cuda(ls: torch.Tensor, lp: torch.Tensor, la: torch.Tensor,
                     mode: str = MAXLOG) -> tuple[torch.Tensor, torch.Tensor]:
    """Drop-in replacement for siso_decode_scan (same batch-major shapes and
    semantics) through the exact kernel of `mode`."""
    B, KT = ls.shape
    K = la.shape[1]
    W = window_len(KT)
    KTp = _round_up(KT, W)
    pad = torch.nn.functional.pad
    f32 = torch.float32
    tb = lambda x: x.to(f32).T.contiguous()
    le = siso_cells(tb(pad(ls, (0, KTp - KT), value=BIG)),
                    tb(pad(lp, (0, KTp - KT))), tb(pad(la, (0, KTp - K))),
                    K, mode)
    le = le[:K].T
    return le + la + ls[:, :K], le
