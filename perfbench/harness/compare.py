"""The comparison that decides `correct`.

The program's outputs of the sampled units against the reference's, four
numbers, each held to its limit (perfbench/limits/<cell>.json):

* bits_differ: the share of compared hard bits that differ (a transport
  block's reassembled bits, a code block's K bits);
* iters_differ: the share of codewords whose iteration count differs;
* verdicts_differ: the share of CRC verdicts (a transport block's CRC-24A,
  or an early-terminated code block's) that differ;
* llr_gap: the largest, over codewords, of mean |L - L_ref| / mean |L_ref|
  over its positions that are not known in advance (filler bits carry
  |L| >= KNOWN).
"""

from __future__ import annotations

import torch

KNOWN = 1e8


def numbers(prog: dict, ref: dict) -> dict:
    f = lambda x: float(x.to(torch.float64).mean())
    out = {"bits_differ": f(prog["hard"].to(ref["hard"].device)
                            != ref["hard"]),
           "iters_differ": f(prog["iters"].to(ref["iters"].device)
                             != ref["iters"])}
    if ref.get("ok") is not None:
        out["verdicts_differ"] = f(prog["ok"].to(ref["ok"].device)
                                   != ref["ok"])
    Lp, Lr = prog["L"].to(ref["L"].device), ref["L"]
    free = (Lr.abs() < KNOWN).to(torch.float64)
    gap = (((Lp - Lr).abs() * free).sum(dim=1)
           / (Lr.abs() * free).sum(dim=1).clamp_min(1e-30))
    out["llr_gap"] = float(gap.max())
    return out


def units_wrong(prog: dict, ref: dict) -> int:
    """Sampled units (transport blocks or code blocks) with any bit,
    iteration count or verdict unlike the reference's."""
    dev = ref["hard"].device
    bad = (prog["hard"].to(dev) != ref["hard"]).any(dim=1)
    if ref.get("ok") is not None:
        bad |= prog["ok"].to(dev) != ref["ok"]
    # a unit's codewords are block-major over the sampled units
    it = prog["iters"].to(dev) != ref["iters"]
    bad |= it.view(-1, bad.shape[0]).any(dim=0)
    return int(bad.sum())


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}})."""
    shown = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    missing = set(limits) - set(values)
    ok = not missing and all(v <= limits[k] for k, v in values.items())
    return ok, shown
