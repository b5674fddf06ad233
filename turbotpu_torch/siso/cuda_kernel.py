"""Fused SISO: wrappers of the hand-written CUDA kernels and their plain
PyTorch versions.

Counterpart of turbotpu/siso/pallas_kernel.py.  The kernels are in
csrc/siso.cu and replace `_make_kernel` (built by `_build_call`) in its
contracts:

* `siso_nii`   -- nii=True: window-start alphas inherited from the previous
  half-iteration (`ain`), fresh ones returned (`aout`);
* `siso_exact` -- nii=False: no approximation;
* `siso_nii_fold` -- the NII contract with the extrinsic interleave folded
  into the kernel's a-priori read (the reference's `fold_gather=True` call,
  `pallas_call` at `:570`): `siso_cells(..., gather_idx=idx)` reads la row t
  from row `idx[t]` of the tensor it is given, which is the other SISO's raw
  output, so no gathered copy is made between the half-iterations;
* `siso_bnd_exact`, `siso_bnd_nii` -- K4, the boundary contracts
  (`boundary=True` with and without nii, `with_offset`) that the
  sequence-sharded decoder runs on each chunk of the trellis:
  `siso_cells(..., boundaries=(a0, bT))` returns `(le, aout, bout)`,
  `siso_cells(..., nii_boundaries=(ain, edge_in, bT))` returns
  `(le, aout, eout, bout)`, both with an optional `row_offset=`: the
  a-priori mask becomes `row_offset + t < K_real`, with K_real the global
  info length.  Edges are `(8, B)` fp32;

each in the three max* modes of `_mstar`/`_mstar_tree` there.  Launches are
counted in `_device.LAUNCHES` under `kernel_name`: max-log keeps the names
above; the linlog and log-MAP instantiations count theirs as
`siso_nii_linlog`, `siso_exact_linlog`, `siso_nii_fold_linlog`,
`siso_bnd_nii_linlog`, `siso_bnd_exact_linlog`, and the same with `_logmap`.
Float8 (e4m3fn) extrinsic streams are libraries of their own, eighteen of
them (three modes, two channel types, the plain, folded and boundary
forms), and each counts its launches under one name (`siso_fp8_bf16`,
`siso_fp8_fold_f32_linlog`, `siso_fp8_bnd_bf16_logmap`, ...), whichever
contract of the library ran.  Every one runs window-parallel, two launches
per call, counted once: a beta walk beside alpha walks (exact: one over the
whole trellis; NII: one per window, from its inherited start) that leave
checkpoints at segment edges, then every segment decoded alone (the
boundary forms' outgoing edges come from the first and the last segment).

Layout.  All streams are time-major `(T, B)` tensors: the same element order
at each step as the JAX package's `(cells, T, 8, 128)`, without its batch
pad to 1024.  The time pad stays: callers pad the trellis to a multiple of
the window with ls = BIG, lp = 0 (known-0 steps that only take u=0 edges,
so beta at the true trellis end is exactly e0).  la rows at t >= K_real are
ignored (masked in the kernel) but must be finite.  Window checkpoints are
`(n_win, 8, B)` fp32; slot 0 is never read and never written.

On a CUDA tensor a wrapper launches its kernel or raises; it takes the plain
version only for a tensor on the CPU.

The plain versions (`siso_nii_plain`, `siso_exact_plain`; the folded read is
`siso_nii_plain(..., gather_idx=idx)`, an `index_select` in front of the
same loop; the boundary forms `siso_bnd_exact_plain`, `siso_bnd_nii_plain`)
are a Python loop
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

import functools

import torch

from .. import _build
from .._device import launch_on
from ..spec.trellis import TRELLIS
from .maxstar import LINLOG, LOGMAP, MAXLOG, MODES, maxstar2

BIG = 1e9
UNROLL = 8           # trellis steps per block; also the renorm cadence

_MODE_CODES = {MAXLOG: 0, LINLOG: 1, LOGMAP: 2}
_CHAN_TYPES = {torch.float32: 0, torch.bfloat16: 1}
_EXT_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
              torch.float8_e4m3fn: 3}
FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0      # e4m3fn's largest finite value; it has no inf


@functools.lru_cache(maxsize=None)
def kernel_name(nii: bool, mode: str, fold: bool = False, bnd: bool = False,
                chan: torch.dtype = torch.float32,
                ext: torch.dtype = torch.float32) -> str:
    """The name a SISO call counts its launch under: its contract and mode
    (`siso_nii`, `siso_exact_linlog`, ...), or with float8 extrinsics its
    library, one name per (channel type, mode, form) for both contracts
    (`siso_fp8_bf16`, `siso_fp8_fold_f32_linlog`, ...)."""
    if fold and not nii:
        raise ValueError("the folded read exists for the NII contract only")
    if fold and bnd:
        raise ValueError("the folded read has no boundary form")
    if ext == FP8:
        form = "_fold" if fold else "_bnd" if bnd else ""
        ch = {torch.bfloat16: "bf16", torch.float32: "f32"}[chan]
        base = f"siso_fp8{form}_{ch}"
    elif bnd:
        base = "siso_bnd_nii" if nii else "siso_bnd_exact"
    else:
        base = "siso_nii_fold" if fold else "siso_nii" if nii else "siso_exact"
    return base if mode == MAXLOG else f"{base}_{mode}"


# (nii, fold) of the three non-boundary contracts
CONTRACTS = ((True, False), (False, False), (True, True))
# nii of the two boundary contracts (K4)
BND_CONTRACTS = (False, True)
# (fold, bnd) of the three libraries of each (mode, channel type)
FORMS = ((False, False), (True, False), (False, True))

# the fifteen contract/mode names and the eighteen names of the fp8 libraries
KERNEL_NAMES = (
    [kernel_name(nii, mode, fold) for mode in (MAXLOG, LINLOG, LOGMAP)
     for nii, fold in CONTRACTS]
    + [kernel_name(nii, mode, bnd=True) for mode in (MAXLOG, LINLOG, LOGMAP)
       for nii in BND_CONTRACTS])
FP8_NAMES = [kernel_name(True, mode, fold, bnd, chan, FP8)
             for fold, bnd in FORMS
             for chan in (torch.bfloat16, torch.float32)
             for mode in (MAXLOG, LINLOG, LOGMAP)]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def window_len(KT: int) -> int:
    return 128 if KT >= 256 else _round_up(KT, UNROLL)


def exact_segment(n: int) -> int:
    """The unit of the window-parallel kernels' second pass: the largest
    power of two up to 64 that divides n (a multiple of 8).  The exact
    contract cuts the padded trellis (n = T): its output does not depend on
    the window (its checkpoints sit on 8-step renorm edges), so the kernel
    decodes segments shorter than the window, for more independent threads
    and less shared memory.  The NII contract cuts each window (n = W), so
    that every segment edge is also a renorm edge of the window's alpha
    walk."""
    seg = 64
    while n % seg:
        seg //= 2
    return seg


def _quantize_le(le: torch.Tensor, dt: torch.dtype, qscale: float) -> torch.Tensor:
    """Cast an fp32 extrinsic row to the extrinsic stream type.  int8 is
    uniform quantisation at step `qscale`, rounded half to even and
    saturated at +-127; the matching dequantisation rides the kernel's
    a-priori scale multiply.  float8_e4m3fn saturates at +-448 (the format
    has no inf) and rounds to nearest even."""
    if dt == torch.int8:
        return torch.clamp(torch.round(le * (1.0 / qscale)),
                           -127.0, 127.0).to(torch.int8)
    if dt == FP8:
        return le.clamp(-FP8_MAX, FP8_MAX).to(FP8)
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
                gather_idx=None, edges=None, row_offset=0):
    """The kernels' arithmetic.  ain None: the exact contract, else NII.
    edges: None, or the boundary forms' (a_in, b_in), (8, B) fp32 each: the
    exact contract's chunk-start alpha or the NII contract's window-0 start,
    and the chunk-end beta.  Returns (le, aout, a_edge, b_edge): aout the NII
    window table (None for exact), a_edge the exact contract's alpha at the
    chunk end or the NII contract's last window end, b_edge beta at the chunk
    start (both None without edges)."""
    T, B = ls.shape
    dev = ls.device
    if gather_idx is not None:       # the folded read: la row t is la[idx[t]]
        la = la.index_select(0, gather_idx.to(torch.long))
    n_win, n_sub = T // W, W // UNROLL
    tb = _Tables(dev)
    f32 = torch.float32
    eff = scale * (ext_qscale if ext_qscale else 1.0)
    sm = torch.where(torch.arange(T, device=dev) + row_offset < K_real,
                     torch.tensor(eff, dtype=f32, device=dev),
                     torch.zeros((), dtype=f32, device=dev))[:, None]
    A = -(la.to(f32) * sm + ls.to(f32))
    P = -lp.to(f32)
    G = torch.stack([torch.zeros_like(P), P, A, A + P], dim=1)   # (T, 4, B)
    a_first = _e0(B, dev) if edges is None else edges[0]
    a_edge = b_edge = None

    if ain is None:
        # phase 1: forward alpha, one checkpoint per window start
        starts = torch.empty((n_win, 8, B), dtype=f32, device=dev)
        alpha = a_first
        for w in range(n_win):
            starts[w] = alpha
            for i in range(n_sub):
                for t in range(w * W + i * UNROLL, w * W + (i + 1) * UNROLL):
                    alpha = _alpha_step(alpha, G[t], tb, mode)
                alpha = _renorm(alpha)
        aout = None
        if edges is not None:
            a_edge = alpha
    else:
        starts = ain
        aout = torch.zeros((n_win, 8, B), dtype=f32, device=dev)

    le = torch.empty((T, B), dtype=la.dtype, device=dev)
    aw = torch.empty((W, 8, B), dtype=f32, device=dev)
    beta = _e0(B, dev) if edges is None else edges[1]
    for w in range(n_win - 1, -1, -1):
        alpha = a_first if (w == 0 and ain is not None) else starts[w]
        for i in range(n_sub):
            for j in range(i * UNROLL, (i + 1) * UNROLL):
                aw[j] = alpha
                alpha = _alpha_step(alpha, G[w * W + j], tb, mode)
            alpha = _renorm(alpha)
        if aout is not None and w + 1 < n_win:
            aout[w + 1] = alpha
        if aout is not None and edges is not None and w == n_win - 1:
            a_edge = alpha
        for i in range(n_sub):
            i0 = W - (i + 1) * UNROLL
            for j in range(i0 + UNROLL - 1, i0 - 1, -1):
                t = w * W + j
                le[t] = _quantize_le(_extrinsic(aw[j], beta, P[t], tb, mode),
                                     la.dtype, ext_qscale)
                beta = _beta_step(beta, G[t], tb, mode)
            beta = _renorm(beta)
    if edges is not None:
        b_edge = beta
    return le, aout, a_edge, b_edge


def siso_nii_plain(ls, lp, la, ain, K_real: int, W: int, scale: float = 1.0,
                   ext_qscale: float = 0.0, mode: str = MAXLOG,
                   gather_idx: torch.Tensor | None = None):
    """Plain version of the `siso_nii` kernels and, with `gather_idx` (a
    (KTp,) integer table: la row t is row gather_idx[t] of `la`), of the
    `siso_nii_fold` kernels.  Returns (le, aout); aout[0] is zero (the kernel
    leaves it unwritten)."""
    return _siso_plain(ls, lp, la, ain, K_real, W, scale, ext_qscale, mode,
                       gather_idx)[:2]


def siso_exact_plain(ls, lp, la, K_real: int, W: int, scale: float = 1.0,
                     ext_qscale: float = 0.0, mode: str = MAXLOG):
    """Plain version of the `siso_exact` kernels.  Returns le."""
    return _siso_plain(ls, lp, la, None, K_real, W, scale, ext_qscale, mode)[0]


def siso_bnd_exact_plain(ls, lp, la, a0, bT, K_real: int, W: int,
                         scale: float = 1.0, ext_qscale: float = 0.0,
                         mode: str = MAXLOG, row_offset: int = 0):
    """Plain version of the `siso_bnd_exact` kernels.  Returns (le, aout,
    bout): alpha at the chunk end, beta at the chunk start."""
    le, _, aout, bout = _siso_plain(ls, lp, la, None, K_real, W, scale,
                                    ext_qscale, mode, edges=(a0, bT),
                                    row_offset=row_offset)
    return le, aout, bout


def siso_bnd_nii_plain(ls, lp, la, ain, edge_in, bT, K_real: int, W: int,
                       scale: float = 1.0, ext_qscale: float = 0.0,
                       mode: str = MAXLOG, row_offset: int = 0):
    """Plain version of the `siso_bnd_nii` kernels.  Returns (le, aout,
    eout, bout); aout[0] is zero (the kernel leaves it unwritten)."""
    return _siso_plain(ls, lp, la, ain, K_real, W, scale, ext_qscale, mode,
                       edges=(edge_in, bT), row_offset=row_offset)


# ----------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------

def _target(mode_code: int, chan_code: int, ext_code: int,
            fold: bool = False, bnd: bool = False) -> _build.Target:
    """csrc/siso.cu compiled for one max* mode and one pair of stream types:
    each variant is a small library of its own (the NII and the exact
    kernel; with `fold` the NII kernel with the folded read alone; with
    `bnd` the two boundary forms), built when first launched, so a decode
    builds only what it runs and the variants compile side by side."""
    return ("siso", (f"-DSISO_MODE={mode_code}", f"-DSISO_CHAN={chan_code}",
                     f"-DSISO_EXT={ext_code}")
            + (("-DSISO_FOLD=1",) if fold else ())
            + (("-DSISO_BND=1",) if bnd else ()))


def build_targets() -> list[_build.Target]:
    """Every variant of the kernel source, for building them all at once
    (`_build.build(build_targets())`)."""
    return [_target(m, c, e, fold, bnd)
            for fold, bnd in ((False, False), (True, False), (False, True))
            for m in _MODE_CODES.values()
            for c in _CHAN_TYPES.values() for e in _EXT_TYPES.values()]


@functools.lru_cache(maxsize=None)
def _entry(mode: str, chan: torch.dtype, ext: torch.dtype,
           fold: bool = False, bnd: bool = False) -> _build.PackedEntry:
    """The C entry of one variant (`turbotpu_siso_launch`: one pointer to
    27 int64 arguments, the stream last)."""
    return _build.PackedEntry(
        _target(_MODE_CODES[mode], _CHAN_TYPES[chan], _EXT_TYPES[ext], fold,
                bnd), "turbotpu_siso_launch", 27)


PASS1, PASS2 = 1, 2   # the `passes` of the C entry: one of them, or both


def _scratch(T, B, W, nii, dev):
    """The kernel's window table and scratch: (aout, ck, n_win, W) with
    (n_win, W) as the kernel takes them.  NII: aout is the (n_win, 8, B)
    window table.  ck (2, n_seg, 8, B) holds the alpha and beta checkpoints
    at segment edges; the segment alphas stay on chip.  The exact contract
    is handed its segments as windows."""
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    seg = exact_segment(W if nii else T)
    ck = empty(2, T // seg, 8, B)
    if nii:
        return empty(T // W, 8, B), ck, T // W, W
    return None, ck, T // seg, seg


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def _launcher(ls, lp, la, ain, K_real, W, eff, inv_q, mode, idx=None,
              edges=None, row_offset=0, edges_out=None, live=None):
    """Allocate the outputs and scratch of one call of the NII (ain given;
    with idx its folded form) or exact (ain None) kernel of `mode` on CUDA
    tensors; with edges = (a_in, b_in) its boundary form, which writes its
    outgoing edges into edges_out where given; with live = (count, N) the
    first count columns alone, on a grid of N.  Returns (run, outputs):
    run(passes, count=()) launches the passes on them, counted under the
    names in `count` (`launch_on`), and raises if a launch fails; outputs
    is (le, aout, a_edge, b_edge) as _siso_plain returns them."""
    T, B = ls.shape
    dev = ls.device
    f32 = torch.float32
    le = torch.empty_like(la)
    nii, fold, bnd = ain is not None, idx is not None, edges is not None
    aout, ck, n_win, Wk = _scratch(T, B, W, nii, dev)
    a_edge = b_edge = None
    if bnd:
        a_edge, b_edge = edges_out or (
            torch.empty((8, B), dtype=f32, device=dev),
            torch.empty((8, B), dtype=f32, device=dev))
    entry = _entry(mode, ls.dtype, la.dtype, fold, bnd)
    head = (_MODE_CODES[mode], _CHAN_TYPES[ls.dtype], _EXT_TYPES[la.dtype],
            int(nii), ls.data_ptr(), lp.data_ptr(), la.data_ptr(), _ptr(idx),
            le.data_ptr(), _ptr(ain), _ptr(aout))
    tail = (*((edges[0].data_ptr(), edges[1].data_ptr(), a_edge.data_ptr(),
               b_edge.data_ptr()) if bnd else (0,) * 4),
            row_offset, B, K_real, n_win, Wk, _build.f64_bits(eff),
            _build.f64_bits(inv_q),
            *((live[0].data_ptr(), live[1]) if live is not None else (0, B)))

    def run(passes, count=()):
        # ck is read here, so it lives as long as run: it is no output
        rc = launch_on(dev.index, entry, passes, *head, ck.data_ptr(), *tail,
                       count=count)
        if rc != 0:
            raise RuntimeError(
                f"siso kernel launch failed (passes {passes}): cudaError {rc} "
                f"(T={T}, B={B}, W={W}, chan={ls.dtype}, ext={la.dtype}, "
                f"nii={nii}, fold={fold}, boundary={bnd}, mode={mode}, "
                f"live={live and live[1]})")
    return run, (le, aout, a_edge, b_edge)


def pass_launchers(ls, lp, la, K_real: int, mode: str, scale: float = 1.0,
                   **options):
    """The two passes of one `siso_cells` call (the same arguments, its
    keyword options included) on CUDA tensors, as two callables that launch
    one pass each on the same operands, outputs and scratch, to time them
    apart.  Both passes run once here first, so the checkpoints that pass 2
    reads hold this call's values.  These launches are a measurement, not
    the decoder's path: they are not counted in `_device.LAUNCHES`."""
    if ls.device.type != "cuda":
        raise ValueError("pass_launchers times the kernel: CUDA tensors only")
    run, _ = _launcher(*_operands(ls, lp, la, K_real, mode, scale,
                                  **options))
    run(PASS1 | PASS2)
    return (lambda: run(PASS1)), (lambda: run(PASS2))


def _operands(ls, lp, la, K_real, mode, scale=1.0, nii_ckpt=None, window=0,
              ext_qscale=0.0, gather_idx=None, boundaries=None,
              nii_boundaries=None, row_offset=0, edges_out=None, live=None):
    """Check the arguments of `siso_cells` and bring them to the kernel's
    form: (ls, lp, la, ain, K_real, W, eff, inv_q, mode, idx, edges,
    row_offset, edges_out, live), the arguments of `_launcher` and
    `_siso_plain`'s (with scale and ext_qscale in place of eff and
    inv_q)."""
    if mode not in MODES:
        raise ValueError(f"unknown max* mode {mode!r}")
    if ls.dim() != 2 or lp.shape != ls.shape or la.shape != ls.shape:
        raise ValueError("ls, lp, la must share one (KTp, B) shape")
    if ls.dtype != lp.dtype or ls.dtype not in _CHAN_TYPES:
        raise TypeError(f"ls/lp must both be float32 or bfloat16, got "
                        f"{ls.dtype}, {lp.dtype}")
    if la.dtype not in _EXT_TYPES:
        raise TypeError(f"la must be float32, bfloat16, int8 or "
                        f"float8_e4m3fn, got {la.dtype}")
    if (la.dtype == torch.int8) != (ext_qscale > 0.0):
        raise ValueError("ext_qscale is the int8 quantisation step: it must "
                         "be > 0 for int8 extrinsics and 0 otherwise")
    KTp, B = ls.shape
    W = window or window_len(KTp)
    if KTp % W or W % UNROLL:
        raise ValueError(f"KTp={KTp} must be a multiple of the window {W}, "
                         f"and the window of {UNROLL}")
    if sum(x is not None for x in (nii_ckpt, boundaries, nii_boundaries)) > 1:
        raise ValueError("nii_ckpt, boundaries and nii_boundaries are "
                         "mutually exclusive")
    if row_offset and boundaries is None and nii_boundaries is None:
        raise ValueError("row_offset needs a boundary contract")
    edges = None
    ain = nii_ckpt
    if boundaries is not None:
        edges = tuple(boundaries)
    elif nii_boundaries is not None:
        ain, *edges = nii_boundaries
        edges = tuple(edges)
    tensors = [ls, lp, la]
    if ain is not None:
        if ain.shape != (KTp // W, 8, B) or ain.dtype != torch.float32:
            name = "nii_ckpt" if nii_ckpt is not None else "the ain of nii_boundaries"
            raise ValueError(f"{name} must be fp32 of shape "
                             f"{(KTp // W, 8, B)}, got {ain.dtype} "
                             f"{tuple(ain.shape)}")
        tensors.append(ain)
    if edges is not None:
        if len(edges) != 2 or any(e.shape != (8, B) or e.dtype != torch.float32
                                  for e in edges):
            raise ValueError(f"boundary edges must be fp32 of shape {(8, B)}")
        tensors.extend(edges)
    if edges_out is not None:
        if edges is None:
            raise ValueError("edges_out needs a boundary contract")
        if len(edges_out) != 2 or any(
                e.shape != (8, B) or e.dtype != torch.float32
                for e in edges_out):
            raise ValueError(f"edges_out must be fp32 of shape {(8, B)}")
        tensors.extend(edges_out)
    if gather_idx is not None:
        if edges is not None:
            raise ValueError("gather_idx has no boundary form")
        if nii_ckpt is None:
            raise ValueError("gather_idx needs the NII contract (nii_ckpt)")
        if gather_idx.shape != (KTp,) or gather_idx.dtype != torch.int32:
            raise ValueError(f"gather_idx must be int32 of shape {(KTp,)}, "
                             f"got {gather_idx.dtype} "
                             f"{tuple(gather_idx.shape)}")
        tensors.append(gather_idx)
    if live is not None:
        count, width = live
        if edges is not None:
            raise ValueError("live has no boundary form")
        if count.dtype != torch.int32 or count.numel() != 1:
            raise ValueError(f"live's count must be one int32, got "
                             f"{count.dtype} {tuple(count.shape)}")
        if not 1 <= width <= B:
            raise ValueError(f"live's bound must be in [1, {B}], got {width}")
        tensors.append(count)
    if any(t.device != ls.device for t in tensors):
        raise ValueError("all tensors must lie on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all tensors must be contiguous")
    if ls.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {ls.device}")
    eff = scale * (ext_qscale if ext_qscale else 1.0)
    inv_q = 1.0 / ext_qscale if ext_qscale else 1.0
    return (ls, lp, la, ain, K_real, W, eff, inv_q, mode, gather_idx, edges,
            row_offset, edges_out, live)


def siso_cells(ls: torch.Tensor, lp: torch.Tensor, la: torch.Tensor,
               K_real: int, mode: str, scale: float = 1.0,
               nii_ckpt: torch.Tensor | None = None, window: int = 0,
               ext_qscale: float = 0.0,
               gather_idx: torch.Tensor | None = None,
               boundaries: tuple | None = None,
               nii_boundaries: tuple | None = None, row_offset: int = 0,
               edges_out: tuple | None = None, live: tuple | None = None):
    """Kernel entry: raw LLR streams in, extrinsics out.

    ls/lp/la: contiguous (KTp, B) with KTp a multiple of the window; pad
    steps beyond the real trellis carry ls = +BIG, lp = 0.  ls and lp share
    a type (float32 or bfloat16); la, and the le that comes back, may be
    float32, bfloat16, float8_e4m3fn or int8 codes of step `ext_qscale`.
    The kernel forms A = -(scale*la*[t < K_real] + ls), P = -lp itself; le
    rows at t >= K_real are finite garbage.

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

    boundaries: optional (a0, bT), (8, B) fp32 each (K4, exact): the
    recursions start from alpha a0 at the chunk's first row and beta bT at
    its last; returns (le, aout, bout), alpha at the chunk end and beta at
    its start, (8, B) each.

    nii_boundaries: optional (ain, edge_in, bT) (K4, NII): ain the
    (n_win, 8, B) window table this kernel wrote last half-iteration (slot 0
    is never read), edge_in the (8, B) alpha edge received from the
    neighbouring chunk (e0 on the first), bT as above; returns (le, aout,
    eout, bout): aout feeds the next call's ain as it is (slot 0 is never
    written), eout the last window's end alpha, the edge to ship.

    row_offset: with either boundary form, the chunk's first global row: the
    a-priori mask becomes [row_offset + t < K_real], K_real the global info
    length.  The three contracts (nii_ckpt, boundaries, nii_boundaries) are
    mutually exclusive.

    edges_out: optional (a_out, b_out), contiguous (8, B) fp32 tensors on
    the streams' device, with either boundary form: the outgoing edges (the
    exact contract's aout, the NII contract's eout, and bout) are written
    into them, and they are what comes back; they must not overlap any
    other operand.  The sequence-sharded decoder passes views of K6's send
    buffers, so no copy is made before an exchange.

    live: optional (count, N), without the boundary forms: count a
    one-element int32 tensor on the streams' device, N an int in [1, B]
    not below what count holds when the call runs.  The call decodes the
    first count columns alone, on a grid that spans N; B stays the pitch
    of every operand.  Those columns of le (and of the NII call's window
    table) equal the same call's on the narrowed operands, byte for byte;
    the others are left unwritten on the card and zero on the CPU.  The
    count is read on the card when the call runs, so a decoder can launch
    a call before the count it stops at is known on the host.
    """
    ops = _operands(ls, lp, la, K_real, mode, scale, nii_ckpt, window,
                    ext_qscale, gather_idx, boundaries, nii_boundaries,
                    row_offset, edges_out, live)
    ain, W, edges = ops[3], ops[5], ops[10]
    if ls.device.type == "cpu" and live is not None:
        le, ck = _siso_plain_live(ls, lp, la, ain, K_real, W, scale,
                                  ext_qscale, mode, gather_idx, live)
        return le if nii_ckpt is None else (le, ck)
    if ls.device.type == "cpu":
        le, ck, a_edge, b_edge = _siso_plain(
            ls, lp, la, ain, K_real, W, scale, ext_qscale, mode, gather_idx,
            edges, row_offset)
        if edges_out is not None:
            a_edge = edges_out[0].copy_(a_edge)
            b_edge = edges_out[1].copy_(b_edge)
    else:
        run, (le, ck, a_edge, b_edge) = _launcher(*ops)
        run(PASS1 | PASS2, (kernel_name(ain is not None, mode,
                                        gather_idx is not None,
                                        edges is not None, ls.dtype,
                                        la.dtype),))
    if boundaries is not None:
        return le, a_edge, b_edge
    if nii_boundaries is not None:
        return le, ck, a_edge, b_edge
    return le if nii_ckpt is None else (le, ck)


def _siso_plain_live(ls, lp, la, ain, K_real, W, scale, ext_qscale, mode,
                     gather_idx, live):
    """`_siso_plain` on the first min(count, N) columns, written into
    (KTp, B) outputs (and a (n_win, 8, B) window table) that are zero
    elsewhere."""
    n = min(int(live[0].reshape(())), live[1])
    narrow = lambda x: None if x is None else x[..., :n].contiguous()
    le_n, ck_n, _, _ = _siso_plain(narrow(ls), narrow(lp), narrow(la),
                                   narrow(ain), K_real, W, scale, ext_qscale,
                                   mode, gather_idx)
    le = torch.zeros_like(la)
    le[:, :n] = le_n
    ck = None
    if ain is not None:
        ck = torch.zeros_like(ain)
        ck[..., :n] = ck_n
    return le, ck


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
