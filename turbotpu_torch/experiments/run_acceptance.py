"""The acceptance run on the card, held to the recorded counts.

Counterpart of experiments/run_acceptance.sh of the JAX package: the BER
sweeps C1, C2, C3, C3-RM and C4 (`cli ber --config`), the C5 sharded decode
(`cli c5 --nii --window 256`, at seq=1, the mesh of the recorded run, and at
seq=2) and the transport-block sweep C6 (`cli tb --config c6`), each with
the configuration's own stopping rule, through the port's command line in
this process.  Their points go to records/h100_accept.jsonl, each with the
card, the commit and the command that made it.

Then every point is set against the same point of results/tpu_accept.jsonl:
its frame errors (transport-block errors for C6) must lie within
BAND_SIGMAS standard deviations of the difference of the two binomial rates
(`fer_band`).  The counts of that file are properties of the code and the
decoder, not of a chip; none of its times is used.  A point outside the
band fails the run, after the comparison is written to
records/run_acceptance.json; it is not re-drawn under another seed.

    python -m turbotpu_torch.experiments.run_acceptance [--configs c1 c2 ...]
        [--max-frames N]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import pathlib

from .._device import resolve_device
from .common import REPO, RECORDS, run_meta, write_record

REFERENCE = REPO / "results" / "tpu_accept.jsonl"
BAND_SIGMAS = 4.0
BER_CONFIGS = ("c1", "c2", "c3", "c3rm", "c4")
ALL_CONFIGS = BER_CONFIGS + ("c5", "c6")
C5_SEQS = (1, 2)


def fer_band(fe, n, fe_ref, n_ref, sigmas: float = BAND_SIGMAS):
    """(|FER - FER_ref|, its band): `sigmas` standard deviations of the
    difference of two binomial rates with the pooled error probability."""
    p = (fe + fe_ref) / (n + n_ref)
    sd = math.sqrt(p * (1 - p) * (1 / n + 1 / n_ref))
    return abs(fe / n - fe_ref / n_ref), sigmas * sd


def point_key(rec: dict) -> tuple:
    """(configuration, Eb/N0) of a record; C5's records have no
    configuration name and are keyed "c5"."""
    return (rec.get("config", "c5"), float(rec["ebn0_db"]))


def errors_of(rec: dict) -> tuple[int, int]:
    """(errors, trials): transport blocks for C6, frames otherwise (C5: the
    batch)."""
    if "tbs" in rec:
        return rec["tb_errs"], rec["tbs"]
    if "frames" in rec:
        return rec["frame_errs"], rec["frames"]
    return rec["frame_errs"], rec["B"]


def compare(points: list[dict], reference: list[dict]) -> list[dict]:
    """Each point against the reference point of the same key."""
    ref = {point_key(r): r for r in reference}
    rows = []
    for rec in points:
        key = point_key(rec)
        if key not in ref:
            raise KeyError(f"no reference point for {key}")
        fe, n = errors_of(rec)
        fe_ref, n_ref = errors_of(ref[key])
        diff, band = fer_band(fe, n, fe_ref, n_ref)
        rows.append({"config": key[0], "ebn0_db": key[1],
                     **({"mesh": rec["mesh"]} if "mesh" in rec else {}),
                     "errors": fe, "trials": n, "reference_errors": fe_ref,
                     "reference_trials": n_ref, "rate_diff": diff,
                     "band": band, "inside": diff <= band})
    return rows


def _cli(args: list[str]) -> str:
    """`python -m turbotpu_torch.cli <args>` in this process; its stdout."""
    from .. import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(args)
    if rc:
        raise RuntimeError(f"cli {' '.join(args)} returned {rc}")
    return buf.getvalue()


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--configs", nargs="+", default=list(ALL_CONFIGS),
                    choices=ALL_CONFIGS)
    ap.add_argument("--max-frames", type=int, default=None,
                    help="cap of the BER sweeps' frames per point (the "
                         "configurations' own stopping rule otherwise)")
    ap.add_argument("--out", default=None,
                    help="directory of h100_accept.jsonl and "
                         "run_acceptance.json (default: the records)")
    args = ap.parse_args(argv)
    dev = resolve_device(device)
    meta = run_meta(argv, dev)
    out_dir = pathlib.Path(args.out) if args.out else RECORDS
    out_dir.mkdir(parents=True, exist_ok=True)
    points_path = out_dir / "h100_accept.jsonl"
    scratch = out_dir / "h100_accept.partial.jsonl"
    points = []
    points_path.write_text("")

    def run(cmd: list[str], results: bool = True) -> None:
        scratch.unlink(missing_ok=True)
        cmd = cmd + ["--device", str(dev)]
        if results:
            _cli(cmd + ["--results", str(scratch), "--no-resume"])
            recs = [json.loads(ln) for ln in scratch.read_text().splitlines()]
            scratch.unlink()
        else:
            recs = [json.loads(_cli(cmd).strip().splitlines()[-1])]
        for rec in recs:
            rec.pop("card", None)
            points.append({**rec, **meta, "command": "cli " + " ".join(cmd)})
            with points_path.open("a") as f:           # kept if cut short
                f.write(json.dumps(points[-1]) + "\n")
            print(json.dumps(points[-1]), flush=True)

    for cfg in args.configs:
        if cfg in BER_CONFIGS:
            cap = (["--max-frames", str(args.max_frames)]
                   if args.max_frames else [])
            run(["ber", "--config", cfg] + cap)
        elif cfg == "c5":
            for seq in C5_SEQS:
                run(["c5", "--nii", "--window", "256", "--seq", str(seq)],
                    results=False)
        else:
            run(["tb", "--config", cfg])
    reference = [json.loads(ln) for ln in REFERENCE.read_text().splitlines()]
    rows = compare(points, reference)
    outside = [r for r in rows if not r["inside"]]
    rec = {**meta, "band_sigmas": BAND_SIGMAS,
           "reference": str(REFERENCE.relative_to(REPO)),
           "points": points_path.name, "configs": args.configs,
           "max_frames": args.max_frames, "rows": rows,
           "outside": len(outside)}
    write_record(rec, out_dir / "run_acceptance.json")
    if outside:
        raise AssertionError(f"{len(outside)} point(s) outside the "
                             f"{BAND_SIGMAS}-sigma band: {outside}")
    return rec


if __name__ == "__main__":
    main()
