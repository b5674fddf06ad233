"""Device-side rate matching: gather on tx, fixed-order sum on rx.

Counterpart of turbotpu/tx/rate_match_jax.py; the functions keep its names
without the `_jax` suffix (`lte_mux`, `lte_demux`, `umts_mux`, `umts_demux`,
`rate_match`, `de_rate_match`, `de_rate_match_harq`).  The index maps come
from the host-side precompute in spec/rate_match.py.

De-rate-matching does not scatter-add: `index_add_` on a CUDA tensor adds
with atomics in no fixed order, and with three or more LLRs on a position
(heavy repetition, HARQ) the sum would change from run to run.  The selected
positions repeat with the period of one wrap of the circular buffer, so the
received LLRs are padded to whole wraps, the wraps are summed one after the
other (the order in which a sequential scatter-add meets them), and the
result is written once to the first wrap's positions, which are distinct.
`inverse_map` is the same selection read the other way, per position, for
the HARQ receiver's combine (harq.py), which gathers instead of scattering.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..spec.rate_match import select_indices


def lte_mux(sys, par1, par2, tail1, tail2) -> torch.Tensor:
    """Batched canonical -> flat LTE d-streams (B, 3*(K+4)).

    Layout [d0 | d1 | d2] with the TS 36.212 tail multiplexing of
    golden/numpy_ref.lte_mux.
    """
    d0 = torch.cat([sys, tail1[:, 0:1], tail1[:, 3:4],
                    tail2[:, 0:1], tail2[:, 3:4]], dim=1)
    d1 = torch.cat([par1, tail1[:, 1:2], tail1[:, 4:5],
                    tail2[:, 1:2], tail2[:, 4:5]], dim=1)
    d2 = torch.cat([par2, tail1[:, 2:3], tail1[:, 5:6],
                    tail2[:, 2:3], tail2[:, 5:6]], dim=1)
    return torch.cat([d0, d1, d2], dim=1)


def umts_mux(sys, par1, par2, tail1, tail2) -> torch.Tensor:
    """Batched canonical -> UMTS wire order (B, 3K+12).

    TS 25.212 section 4.2.3.1: per-bit interlace x1 z1 z'1 x2 z2 z'2 ...
    xK zK z'K, then the 12 tail bits x_K+1 z_K+1 x_K+2 z_K+2 x_K+3 z_K+3
    then encoder 2's tail.
    """
    B, K = sys.shape
    body = torch.stack([sys, par1, par2], dim=2).reshape(B, 3 * K)
    return torch.cat([body, tail1, tail2], dim=1)


def umts_demux(wire: torch.Tensor):
    """Batched UMTS wire order (B, 3K+12) -> canonical LLR parts."""
    B = wire.shape[0]
    K = (wire.shape[1] - 12) // 3
    body = wire[:, :3 * K].reshape(B, K, 3)
    return (body[:, :, 0], body[:, :, 1], body[:, :, 2],
            wire[:, 3 * K:3 * K + 6], wire[:, 3 * K + 6:])


def lte_demux(d_flat: torch.Tensor):
    """Batched flat d-streams (B, 3*(K+4)) -> canonical LLR parts."""
    D = d_flat.shape[1] // 3
    K = D - 4
    d0, d1, d2 = d_flat[:, :D], d_flat[:, D:2 * D], d_flat[:, 2 * D:]
    ls, lp1, lp2 = d0[:, :K], d1[:, :K], d2[:, :K]
    tail1 = torch.stack([d0[:, K], d1[:, K], d2[:, K],
                         d0[:, K + 1], d1[:, K + 1], d2[:, K + 1]], dim=1)
    tail2 = torch.stack([d0[:, K + 2], d1[:, K + 2], d2[:, K + 2],
                         d0[:, K + 3], d1[:, K + 3], d2[:, K + 3]], dim=1)
    return ls, lp1, lp2, tail1, tail2


@functools.lru_cache(maxsize=None)
def _sel_idx(K: int, E: int, rv: int, n_cb, F: int,
             device: torch.device) -> tuple[torch.Tensor, int]:
    """(the E selected flat-d indices on `device`, the selection's period:
    the number of distinct positions one wrap of the buffer visits)."""
    idx = select_indices(K, E, rv, n_cb, F)
    return (torch.from_numpy(idx.astype(np.int64)).to(device),
            len(np.unique(idx)))


@functools.lru_cache(maxsize=None)
def inverse_map(K: int, E: int, rv: int, F: int,
                device: torch.device) -> tuple[torch.Tensor, int]:
    """(for each of the 3D flat-d positions, the index among the first
    wrap's E selected bits of the one that lands on it, or -1 where none
    does (punctured, dummy, filler), int64 on `device`; the selection's
    period, as `_sel_idx` gives it), N_cb = K_w.  The bits of later wraps
    land on the same positions, at that index plus whole periods."""
    idx, period = _sel_idx(K, E, rv, None, F, torch.device("cpu"))
    inv = torch.full((3 * (K + 4),), -1, dtype=torch.int64)
    inv[idx[:period]] = torch.arange(period)
    return inv.to(device), period


def rate_match(d_flat: torch.Tensor, E: int, rv: int = 0,
               n_cb: int | None = None, F: int = 0) -> torch.Tensor:
    """(B, 3D) -> (B, E) transmitted soft/hard bits."""
    K = d_flat.shape[1] // 3 - 4
    idx, _ = _sel_idx(K, E, rv, n_cb, F, d_flat.device)
    return d_flat.index_select(1, idx)


def de_rate_match(llr_e: torch.Tensor, K: int, rv: int = 0,
                  n_cb: int | None = None, F: int = 0) -> torch.Tensor:
    """(B, E) received LLRs -> (B, 3D) combined stream LLRs.

    Repetition combines by addition, wrap after wrap; punctured positions
    (and filler positions when F > 0) stay 0.
    """
    B, E = llr_e.shape
    idx, period = _sel_idx(K, E, rv, n_cb, F, llr_e.device)
    n_wraps = -(-E // period)
    wraps = torch.nn.functional.pad(llr_e, (0, n_wraps * period - E)
                                    ).reshape(B, n_wraps, period)
    acc = wraps[:, 0]
    for w in range(1, n_wraps):
        acc = acc + wraps[:, w]
    out = torch.zeros((B, 3 * (K + 4)), dtype=llr_e.dtype, device=llr_e.device)
    n_first = min(E, period)
    out[:, idx[:n_first]] = acc[:, :n_first]
    return out


def de_rate_match_harq(llr_e_txs, K: int, rvs, n_cb=None,
                       F: int = 0) -> torch.Tensor:
    """HARQ incremental-redundancy combining: de-rate-match each
    retransmission (B, E_t) at its redundancy version and sum the LLRs in
    the order given (TS 36.212 s5.1.4.1.2 circular buffer, soft combining
    across rv_idx)."""
    if len(llr_e_txs) != len(rvs) or not rvs:
        raise ValueError("one redundancy version per retransmission")
    out = None
    for llr_e, rv in zip(llr_e_txs, rvs):
        d = de_rate_match(llr_e, K, rv, n_cb, F)
        out = d if out is None else out + d
    return out
