"""Numerical-safety guards.

Counterpart of turbotpu/harness/debug.py, which wraps a decode in
jax.experimental.checkify.  Here:

- `checked(fn)`: wraps a decode (`turbo_decode`'s signature) so that an
  index table outside its range raises before the call and a non-finite
  floating output raises after it, both as ValueError on the host;
- `assert_finite(tree, name)`: the same output check on any tree of tensors
  (lists, tuples, dicts) for tests.

The kernels themselves are checked with the CUDA toolkit's compute-sanitizer
where it runs (`chip_smoke.py`'s `sanitize` phase).
"""

from __future__ import annotations

import functools

import torch


def _leaves(tree, prefix: str):
    """(path, tensor) of every tensor in a tree of lists, tuples and
    dicts."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")


def assert_finite(tree, name: str = "value") -> None:
    """Raise ValueError naming the first floating tensor of `tree` that
    holds a NaN or an infinity."""
    for path, leaf in _leaves(tree, name):
        if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
            raise ValueError(f"{path} is not finite")


def _check_table(tab, n: int, what: str) -> None:
    tab = torch.as_tensor(tab)
    if tab.numel() and (int(tab.min()) < 0 or int(tab.max()) >= n):
        raise ValueError(f"{what} holds an index outside [0, {n}): "
                         f"[{int(tab.min())}, {int(tab.max())}]")


def checked(fn):
    """Wrap a decode with `turbo_decode`'s signature (ls, lp1, lp2, tail1,
    tail2, cfg, perm_b=None, inv_b=None, group_tables=None, ...): before the
    call, the configuration's interleaver tables and any per-codeword or
    grouped tables must index inside the block (the gathers on a card would
    read out of bounds, not raise); after it, every floating output must be
    finite.  Violations raise ValueError."""

    @functools.wraps(fn)
    def wrapper(ls, lp1, lp2, tail1, tail2, cfg, *args, **kwargs):
        K = cfg.K
        _check_table(cfg.perm(), K, "cfg.perm()")
        _check_table(cfg.inv(), K, "cfg.inv()")
        names = ("perm_b", "inv_b", "group_tables")
        tables = dict(zip(names, args))
        tables.update({k: kwargs[k] for k in names if k in kwargs})
        for name in ("perm_b", "inv_b"):
            if tables.get(name) is not None:
                _check_table(tables[name], K, name)
        if tables.get("group_tables") is not None:
            perm_g, inv_g, gid = tables["group_tables"]
            _check_table(perm_g, K, "group_tables perm")
            _check_table(inv_g, K, "group_tables inv")
            _check_table(gid, len(perm_g), "group_tables gid")
        out = fn(ls, lp1, lp2, tail1, tail2, cfg, *args, **kwargs)
        assert_finite(out, "decode output")
        return out

    return wrapper
