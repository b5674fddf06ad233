"""What every program of the evidence layer shares: where records go, what
each record carries about its run, and the penalty in dB of a FER curve
against a reference curve.

A record names the card (`harness.bench.card_info`: name and power limit as
nvidia-smi prints them), the commit and the program's own argv.  The commit
comes from `git` where the checkout has its history, else from the
environment variable TURBOTPU_COMMIT (a copy of the tree without `.git`),
else it is "unknown".
"""

from __future__ import annotations

import json
import math
import os
import pathlib
import subprocess
import sys

import torch

RECORDS = pathlib.Path(__file__).resolve().parent / "records"
REPO = pathlib.Path(__file__).resolve().parents[2]


def commit() -> str:
    """HEAD's hash, with "+dirty" when the tree differs from it."""
    try:
        head = subprocess.run(["git", "rev-parse", "HEAD"], cwd=REPO,
                              check=True, capture_output=True,
                              text=True).stdout.strip()
        dirty = subprocess.run(["git", "status", "--porcelain",
                                "--untracked-files=no"], cwd=REPO, check=True,
                               capture_output=True, text=True).stdout.strip()
        return head + ("+dirty" if dirty else "")
    except (OSError, subprocess.CalledProcessError):
        return os.environ.get("TURBOTPU_COMMIT", "unknown")


def run_meta(argv, dev: torch.device) -> dict:
    """card, commit and argv of a program's run on `dev`."""
    if dev.type == "cuda":
        from ..harness.bench import card_info
        card = card_info().splitlines()[0]
    else:
        card = "cpu"
    return {"card": card, "commit": commit(),
            "argv": list(sys.argv[1:] if argv is None else argv)}


def need_card(dev: torch.device, what: str) -> None:
    if dev.type != "cuda":
        raise RuntimeError(f"{what} times with CUDA events and needs a card; "
                           "a CPU timing is not a device metric")


def out_path(out: str | None, name: str) -> pathlib.Path:
    return pathlib.Path(out) if out else RECORDS / f"{name}.json"


def write_record(rec: dict, path: pathlib.Path) -> pathlib.Path:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1) + "\n")
    print("written", path, flush=True)
    return path


def fer_slope(ref: dict, lo: float, hi: float) -> float | None:
    """Decades of FER per dB of a curve {str(ebn0): {"fer": x}} between two
    of its points; None where either FER is 0."""
    f0, f1 = ref[str(lo)]["fer"], ref[str(hi)]["fer"]
    if f0 > 0 and f1 > 0:
        return (math.log10(f0) - math.log10(f1)) / (hi - lo)
    return None


def db_penalty(curve: dict, ref: dict, points, slope: float | None) -> dict:
    """Penalty in dB of `curve` against `ref` (same frames) at each of
    `points`: the log10 FER ratio over the reference's slope.  A point where
    either FER is 0, or no slope, gives no entry."""
    pen = {}
    if slope is None:
        return pen
    for e in points:
        fc, fr = curve[str(e)]["fer"], ref[str(e)]["fer"]
        if fc > 0 and fr > 0:
            pen[str(e)] = (math.log10(fc) - math.log10(fr)) / slope
    return pen


def one_frame_db(ref: dict, points, slope: float | None) -> dict:
    """The resolution of `db_penalty` at each of `points`: the dB that one
    frame error more of `ref` (n frame errors there) moves a penalty,
    log10((n + 1) / n) / slope.  No entry where n is 0 or no slope."""
    out = {}
    if slope is None:
        return out
    for e in points:
        n = ref[str(e)]["frame_errs"]
        if n > 0:
            out[str(e)] = math.log10((n + 1) / n) / slope
    return out


def penalties(rows: dict, ref_name: str, points, lo: float, hi: float
              ) -> tuple[float | None, dict]:
    """The reference row's slope between lo and hi, and every other row's
    penalty against it at `points`."""
    slope = fer_slope(rows[ref_name], lo, hi)
    return slope, {name: db_penalty(curve, rows[ref_name], points, slope)
                   for name, curve in rows.items() if name != ref_name}
