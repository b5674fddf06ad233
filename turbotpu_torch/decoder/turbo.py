"""Batched turbo decode loop.

Counterpart of turbotpu/decoder/turbo.py.  `turbo_decode` is the entry
point: with `siso="cuda"` it hands over to the hot loop around the fused
kernel (turbo_cells.py); otherwise it runs the generic loop below around a
batch-major SISO function.  Converged codewords are frozen branchlessly with
per-codeword masks; the loop exits as soon as every codeword has converged,
which costs one host read per iteration.

Inputs are the canonical codeword format of golden/numpy_ref.py, batched:
ls, lp1, lp2: (B, K); tail1, tail2: (B, 6).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.profiler import record_function

from .._device import resolve_device
from ..siso.scan import siso_decode_scan
from ..spec import crc as crc_mod
from ..spec.qpp import qpp_inv, qpp_perm
from ..spec.umts import umts_inv, umts_perm
from .early_term import crc_ok_batch, make_crc_matrix

SisoFn = Callable[..., tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Static decode configuration.  Same fields and defaults as the JAX
    package's DecoderConfig, so a configuration carries over
    (convert.config_from_dict); the fused-kernel path is `siso="cuda"`
    where the JAX package says "pallas"."""
    K: int
    n_iters: int = 8
    mode: str = "logmap"            # "logmap" | "maxlog" | "linlog"
    ext_scale: float | None = None  # extrinsic scaling; None resolves to
                                    # 0.75 for maxlog, 1.0 otherwise
    interleaver: str = "lte"        # "lte" (QPP) | "umts"
    early_term: str = "none"        # "none" | "crc" | "sign"
    crc_poly: int = crc_mod.CRC24A_POLY
    siso: str = "scan"              # "scan" | "cuda" | "ascan" | "window"
    window: int = 0                 # kernel window length (0 = default)
    io_dtype: str = "float32"       # channel LLR stream type on the kernel
                                    # path ("bfloat16" halves the bytes;
                                    # metrics stay fp32)
    ext_dtype: str = ""             # extrinsic stream type (la/le) on the
                                    # kernel path; "" inherits io_dtype.
                                    # "int8" stores codes of step ext_qscale,
                                    # "float8_e4m3fn" saturates at +-448
    ext_qscale: float = 0.25        # int8 extrinsic quantisation step
                                    # (LLR units per code); range +-31.75.
                                    # Ignored unless ext_dtype == "int8"
    boundary_xch: str = "ppermute"  # sequence-parallel decoder only
    seq_groups: int = 1             # sequence-parallel decoder only
    nii: bool = False               # kernel path: skip the exact phase-1
                                    # alpha pass; window-start alphas inherit
                                    # from the previous half-iteration
                                    # (next-iteration initialisation)
    fold_gather: bool = False       # kernel path: interleave gather folded
                                    # into the kernel's la read

    def perm(self) -> np.ndarray:
        return {"lte": qpp_perm, "umts": umts_perm}[self._interleaver()](self.K)

    def inv(self) -> np.ndarray:
        return {"lte": qpp_inv, "umts": umts_inv}[self._interleaver()](self.K)

    def _interleaver(self) -> str:
        if self.interleaver not in ("lte", "umts"):
            raise ValueError(f"unknown interleaver {self.interleaver!r}")
        return self.interleaver

    def __post_init__(self):
        if self.nii and self.K >= 4096 and (self.window or 128) < 256:
            import warnings
            warnings.warn(
                f"NII with window={self.window or 128} at K={self.K} was "
                "measured at ~0.06 dB BER penalty -- OUTSIDE the 0.05 dB "
                "conformance bar (RESULTS.md NII table). Use window=256 "
                "(validated at ~0.03 dB) or disable nii.",
                stacklevel=3)

    def ext_io(self) -> tuple[str, float]:
        """(extrinsic stream type, int8 quant step or 0.0) for the kernel
        path; the quant step only applies to int8 fixed-point."""
        dt = self.ext_dtype or self.io_dtype
        return dt, (self.ext_qscale if dt == "int8" else 0.0)

    def resolved_ext_scale(self) -> float:
        """The single resolution point for extrinsic scaling."""
        if self.ext_scale is not None:
            return self.ext_scale
        return 0.75 if self.mode == "maxlog" else 1.0


def get_siso(cfg: DecoderConfig) -> SisoFn:
    if cfg.siso == "scan":
        return siso_decode_scan
    if cfg.siso == "cuda":
        from ..siso.cuda_kernel import siso_decode_cuda
        return siso_decode_cuda
    if cfg.siso == "ascan":
        from ..siso.ascan import siso_decode_ascan
        return siso_decode_ascan
    if cfg.siso == "window":
        from ..siso.windowed import make_windowed_siso
        return make_windowed_siso(cfg.window or 128)
    raise ValueError(f"unknown siso impl {cfg.siso!r}")


def turbo_decode(ls, lp1, lp2, tail1, tail2, cfg: DecoderConfig,
                 perm_b=None, inv_b=None, group_tables=None, device="cuda"
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode a batch of codewords on `device` (the card unless the caller
    asks for "cpu"; without a card "cuda" raises).

    Inputs are tensors or numpy arrays; they are moved to `device`.
    Returns (hard_bits (B, K) int8, n_iters_run (B,) int32, L (B, K) fp32),
    on `device`.

    perm_b / inv_b: optional per-codeword (B, K) interleaver tables for true
    mixed-K batches (bucketing.embedded_perm_tables): each codeword is
    gathered through its own embedded permutation, so a heterogeneous batch
    of real per-K codewords decodes in one call.  None uses the shared cfg.K
    table.

    group_tables: (perm_g (G, K), inv_g (G, K), gid (B,)) from
    bucketing.grouped_perm_tables, the same decode for a batch with few
    distinct sizes.  Mutually exclusive with perm_b/inv_b.  Both forms run
    one per-codeword gather underneath and give identical results.
    """
    dev = resolve_device(device)
    if (perm_b is None) != (inv_b is None):
        raise ValueError("perm_b and inv_b come as a pair")
    if group_tables is not None:
        if perm_b is not None:
            raise ValueError("group_tables and perm_b/inv_b are mutually "
                             "exclusive")
        perm_g, inv_g, gid = (torch.as_tensor(x).to(dev, torch.long)
                              for x in group_tables)
        perm_b, inv_b = perm_g[gid], inv_g[gid]
    elif perm_b is not None:
        perm_b, inv_b = (torch.as_tensor(x).to(dev, torch.long)
                         for x in (perm_b, inv_b))
    f32 = torch.float32
    ls, lp1, lp2, tail1, tail2 = (
        torch.as_tensor(x).to(device=dev, dtype=f32)
        for x in (ls, lp1, lp2, tail1, tail2))
    B, K = ls.shape
    if K != cfg.K:
        raise ValueError(f"ls has K={K}, the configuration K={cfg.K}")
    if perm_b is not None and (perm_b.shape != (B, K) or inv_b.shape != (B, K)):
        raise ValueError(f"per-codeword tables must be {(B, K)}, got "
                         f"{tuple(perm_b.shape)} and {tuple(inv_b.shape)}")
    with record_function("turbo.decode"):
        if cfg.siso == "cuda":
            from .turbo_cells import turbo_decode_cells
            return turbo_decode_cells(ls, lp1, lp2, tail1, tail2, cfg,
                                      perm_b=perm_b, inv_b=inv_b)
        return _decode_generic(ls, lp1, lp2, tail1, tail2, cfg, perm_b,
                               inv_b)


def _decode_generic(ls, lp1, lp2, tail1, tail2, cfg, perm_b, inv_b):
    """The loop around a batch-major SISO function (every siso but
    "cuda"), on the device the tensors lie on."""
    dev = ls.device
    B, K = ls.shape
    siso = get_siso(cfg)
    scale = cfg.resolved_ext_scale()

    if perm_b is None:
        perm = torch.from_numpy(cfg.perm()).to(dev, torch.long)
        inv = torch.from_numpy(cfg.inv()).to(dev, torch.long)
        g_perm = lambda x: x[:, perm]
        g_inv = lambda x: x[:, inv]
    else:
        g_perm = lambda x: torch.gather(x, 1, perm_b)
        g_inv = lambda x: torch.gather(x, 1, inv_b)

    ls1 = torch.cat([ls, tail1[:, 0::2]], dim=1)
    lp1f = torch.cat([lp1, tail1[:, 1::2]], dim=1)
    ls2 = torch.cat([g_perm(ls), tail2[:, 0::2]], dim=1)
    lp2f = torch.cat([lp2, tail2[:, 1::2]], dim=1)

    if cfg.early_term not in ("none", "crc", "sign"):
        raise ValueError(f"unknown early_term {cfg.early_term!r}")
    G = make_crc_matrix(K, cfg.crc_poly, dev) if cfg.early_term == "crc" \
        else None

    le21 = torch.zeros_like(ls)
    L = torch.zeros_like(ls)
    hard = torch.zeros(ls.shape, dtype=torch.int8, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    iters = torch.zeros((B,), dtype=torch.int32, device=dev)
    it = 0
    # Exits early once every codeword in the batch has converged.
    while it < cfg.n_iters and not bool(done.all()):
        _, le1 = siso(ls1, lp1f, le21, mode=cfg.mode)
        le1 = le1 * scale
        _, le2 = siso(ls2, lp2f, g_perm(le1), mode=cfg.mode)
        le2 = le2 * scale
        le21_new = g_inv(le2)
        L_new = ls + le1 + le21_new
        hard_new = (L_new < 0).to(torch.int8)

        if cfg.early_term == "crc":
            newly_done = crc_ok_batch(hard_new, G)
        elif cfg.early_term == "sign":
            newly_done = (hard_new == hard).all(dim=1)
        else:
            newly_done = torch.zeros((B,), dtype=torch.bool, device=dev)

        # Freeze converged codewords branchlessly.
        keep = done[:, None]
        le21 = torch.where(keep, le21, le21_new)
        L = torch.where(keep, L, L_new)
        hard = torch.where(keep, hard, hard_new)
        iters = iters + (~done).to(torch.int32)
        done = done | newly_done
        it += 1
    return hard, iters, L
