"""State carried across from the JAX package: configurations, interleaver
tables, layouts, and the loop's carried tensors.

The system has no weights.  What a caller of the JAX package holds is a
DecoderConfig, streams in the `(cells, T, 8, 128)` cell layout (1024
codewords per cell, batch b = cell*1024 + sub*128 + lane) and window
checkpoints `(cells, n_win, 8, 8, 128)`, and on the sequence-sharded path
boundary edges `(cells, 8, 8, 128)`.  These functions turn them into the
port's DecoderConfig, `(T, B)` streams, `(n_win, 8, B)` checkpoints and
`(8, B)` edges and back, on numpy arrays and plain dicts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .decoder.turbo import DecoderConfig

CELL = 1024          # codewords per cell of the JAX package's layout

# the JAX package's name of the fused-kernel path -> the port's
_SISO_NAMES = {"pallas": "cuda"}


def config_from_dict(d: dict) -> DecoderConfig:
    """`dataclasses.asdict` of the JAX package's DecoderConfig -> the port's."""
    names = {f.name for f in dataclasses.fields(DecoderConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown DecoderConfig fields {sorted(unknown)}")
    d = dict(d)
    if "siso" in d:
        d["siso"] = _SISO_NAMES.get(d["siso"], d["siso"])
    return DecoderConfig(**d)


def sim_config_from_dict(d: dict):
    """`dataclasses.asdict` of the JAX package's SimConfig -> the port's
    (harness.ber.SimConfig), its nested decoder included."""
    from .harness.ber import SimConfig
    names = {f.name for f in dataclasses.fields(SimConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown SimConfig fields {sorted(unknown)}")
    d = dict(d)
    if "decoder" in d:
        d["decoder"] = config_from_dict(d["decoder"])
    for name in ("ebn0_db_grid", "K_mix", "E_mix", "rv_sequence"):
        if name in d:
            d[name] = tuple(d[name])
    return SimConfig(**d)


def tb_config_from_dict(d: dict):
    """`dataclasses.asdict` of the JAX package's TBConfig -> the port's
    (harness.tb.TBConfig)."""
    from .harness.tb import TBConfig
    names = {f.name for f in dataclasses.fields(TBConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown TBConfig fields {sorted(unknown)}")
    d = dict(d)
    if "siso" in d:
        d["siso"] = _SISO_NAMES.get(d["siso"], d["siso"])
    for name in ("ebn0_db_grid", "rv_sequence"):
        if name in d:
            d[name] = tuple(d[name])
    return TBConfig(**d)


def tables_to_torch(tables, device="cpu") -> tuple[torch.Tensor, ...]:
    """Interleaver tables of a mixed-K batch as numpy (the per-codeword pair
    (perm_b, inv_b) of bucketing.embedded_perm_tables, or the grouped triple
    (perm_g, inv_g, gid) of grouped_perm_tables, from either package) ->
    int64 tensors on `device`, the index type torch.gather takes."""
    return tuple(torch.from_numpy(np.asarray(t).astype(np.int64)).to(device)
                 for t in tables)


def cells_to_tb(x: np.ndarray, B: int | None = None) -> np.ndarray:
    """(cells, T, 8, 128) -> (T, B); the batch pad beyond B is cut."""
    n, T = x.shape[:2]
    out = np.asarray(x).transpose(1, 0, 2, 3).reshape(T, n * CELL)
    return np.ascontiguousarray(out[:, :B])


def tb_to_cells(x: np.ndarray) -> np.ndarray:
    """(T, B) -> (cells, T, 8, 128), batch zero-padded to a multiple of 1024."""
    T, B = x.shape
    n = -(-B // CELL)
    xp = np.zeros((T, n * CELL), x.dtype)
    xp[:, :B] = x
    return np.ascontiguousarray(xp.reshape(T, n, 8, 128).transpose(1, 0, 2, 3))


def ckpt_cells_to_port(x: np.ndarray, B: int | None = None) -> np.ndarray:
    """(cells, n_win, 8, 8, 128) -> (n_win, 8, B)."""
    n, n_win = x.shape[:2]
    out = np.asarray(x).transpose(1, 2, 0, 3, 4).reshape(n_win, 8, n * CELL)
    return np.ascontiguousarray(out[:, :, :B])


def ckpt_port_to_cells(x: np.ndarray) -> np.ndarray:
    """(n_win, 8, B) -> (cells, n_win, 8, 8, 128), batch zero-padded."""
    n_win, S, B = x.shape
    n = -(-B // CELL)
    xp = np.zeros((n_win, S, n * CELL), x.dtype)
    xp[:, :, :B] = x
    return np.ascontiguousarray(
        xp.reshape(n_win, S, n, 8, 128).transpose(2, 0, 1, 3, 4))


def edge_cells_to_port(x: np.ndarray, B: int | None = None) -> np.ndarray:
    """A boundary edge (cells, 8, 8, 128) -> (8, B): state s of codeword b
    at [s, b]."""
    n = x.shape[0]
    out = np.asarray(x).transpose(1, 0, 2, 3).reshape(8, n * CELL)
    return np.ascontiguousarray(out[:, :B])


def edge_port_to_cells(x: np.ndarray) -> np.ndarray:
    """(8, B) -> (cells, 8, 8, 128), batch zero-padded."""
    S, B = x.shape
    n = -(-B // CELL)
    xp = np.zeros((S, n * CELL), x.dtype)
    xp[:, :B] = x
    return np.ascontiguousarray(xp.reshape(S, n, 8, 128).transpose(1, 0, 2, 3))
