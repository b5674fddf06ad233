"""Run one cell of the benchmark of turbotpu_torch on the card.

    python3 perfbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  Set-up makes the cell's inputs on the card
from the seed and warms the timed path on them; the window then runs the
cell's traffic for S seconds on the host clock.  With --trace 0 the last
line of standard output is the cell's end-to-end metrics, with --trace 1 its
per-layer metrics, read from a torch.profiler trace of a stretch of batches
in the middle of the window.  After the window the program's outputs of a
sample of units drawn from the seed are compared with the plain reference
(perfbench/reference/), and `correct` says whether every compared number
kept to its limit.  Exit codes: 0 a result was printed; 3 no card (or too
few); 4 a JAX module was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = {"jax", "jaxlib", "flax", "turbotpu"}
# what the program or torch may compile, kept inside the checkout
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_ext",
          "TORCHINDUCTOR_CACHE_DIR": "inductor"}


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""
    cell: object
    device_kind: str
    setup_s: float
    window_s: float
    batches: int
    latencies_ms: list
    iters: list                 # per batch, on the host
    trace: object = None        # harness.trace.Trace of the traced stretch
    traced: range = range(0)    # indices of the traced batches

    def peak(self):
        from perfbench.harness import roofline
        return roofline.peak(self.device_kind)


def forbidden_modules() -> set:
    return FORBIDDEN & {m.split(".")[0] for m in list(sys.modules)}


def metric_names(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a cell reports: with trace, the per-layer metrics whose
    `workloads` name it; else its end-to-end metrics."""
    if trace:
        return [m for m in bench["per_layer"]
                if cell in m.get("workloads", ())]
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def read_metric(root: Path, name: str, run: Run):
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def power_limit() -> str:
    """The card's power limit as nvidia-smi reports it ("" if it cannot)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.splitlines()[0].strip() if out else ""


def main(argv=None, device=None, root: Path = ROOT, breaker=None) -> int:
    """Run a cell; `device` None means the card (and its checks), a test
    passes "cpu".  breaker(fn) -> fn, where given, replaces the timed path
    (a test plants a fault with it)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from perfbench.harness.cell import Cell, load_benchmark
    bench = load_benchmark(root)
    cell = Cell.load(args.workload, root, bench)
    for var, sub in CACHES.items():
        os.environ[var] = str(root / "perfbench" / ".cache" / sub)

    import torch
    from torch.profiler import record_function
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.entry["chips"]:
            print(f"needs {cell.entry['chips']} card(s): cuda available "
                  f"{torch.cuda.is_available()}, "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                  f" found", file=sys.stderr)
            return 3
        device = "cuda"
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: None)

    from perfbench.harness import compare, trace as trace_mod
    marks = {"start": time.perf_counter() - T0}
    pool = cell.make_pool(args.seed, dev)
    sync()
    marks["inputs"] = time.perf_counter() - T0
    fn, to_host = cell.timed_path(dev)
    if breaker is not None:
        fn = breaker(fn)
    oneshot = cell.traffic["loop"] == "oneshot"
    step = (lambda b: to_host(fn(b))) if oneshot else fn
    for b in pool[:2]:                  # builds and warms every shape used
        step(b)
    sync()
    marks["warm"] = time.perf_counter() - T0
    sampled, units = cell.sample(args.seed)
    P = len(pool)

    # --- the window --------------------------------------------------------
    setup_s = time.perf_counter() - T0
    keep, iters, lat = {}, [], []
    prof = None
    traced = range(0)
    trace_lo = None
    n_trace = cell.traffic["trace_batches"]
    i = 0
    t0 = time.perf_counter()
    while True:
        if args.trace and trace_lo is None and \
                time.perf_counter() - t0 >= args.seconds / 2:
            sync()
            acts = [torch.profiler.ProfilerActivity.CPU] + (
                [torch.profiler.ProfilerActivity.CUDA] if on_card else [])
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            trace_lo = i
        p = i % P
        ts = time.perf_counter()
        with record_function("bench.batch"):
            out = step(pool[p])
        lat.append((time.perf_counter() - ts) * 1e3)
        iters.append(out["iters"])
        if p in sampled:
            keep[p] = out
        i += 1
        if prof is not None and i - trace_lo == n_trace:
            sync()
            prof.stop()
            traced = range(trace_lo, i)
        # the window closes once its time is up, the stretch traced and
        # every sampled pool batch decoded
        if time.perf_counter() - t0 >= args.seconds and \
                (not args.trace or traced) and len(keep) == len(sampled):
            break
    sync()
    window_s = time.perf_counter() - t0
    mem_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    iters = [x.cpu() for x in iters]

    tr = None
    if prof is not None:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            tr = trace_mod.Trace.load(path)
        del prof

    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    run = Run(cell, kind, setup_s, window_s, i, lat if oneshot else [],
              iters, tr, traced)
    metrics = {}
    for m in metric_names(bench, cell.name, bool(args.trace)):
        v = read_metric(root, m["name"], run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # --- the comparison, the program's state freed first -------------------
    missing = [p for p in sampled if p not in keep]
    prog = cell.select(keep, sampled, units) if not missing else None
    inputs = [pool[p] for p in sampled]
    del pool, keep, out, fn, step
    if on_card:
        torch.cuda.empty_cache()
    from perfbench.reference import turbo_ref
    if prog is not None:
        ref = cell.reference_outputs(dict(zip(sampled, inputs)), sampled,
                                     units, turbo_ref.INT8)
        values = compare.numbers(prog, ref)
        failed = compare.units_wrong(prog, ref)
        correct, shown = compare.judge(values, cell.limits)
    else:
        correct, shown, failed = False, {}, len(units) * len(missing)
        print(f"sampled pool batches {missing} never ran in the window",
              file=sys.stderr)

    found = forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {sorted(found)}",
              file=sys.stderr)
        return 4
    device_rec = {"platform": "gpu" if on_card else "cpu", "kind": kind,
                  "count": cell.entry["chips"], "memory_peak_bytes": mem_peak,
                  "power_limit": power_limit() if on_card else ""}
    if tr is not None:
        lo, hi = tr.window() if tr.n_batches else (0.0, 0.0)
        device_rec["busy_s"] = tr.busy_us([(lo, hi)]) / 1e6
        device_rec["window_s"] = (hi - lo) / 1e6
    result = {"correct": correct, "attempted": i, "failed": failed,
              "metrics": metrics, "device": device_rec}
    if tr is not None and tr.n_batches:
        result["breakdown"] = tr.breakdown()
    result["compared"] = shown
    print("set-up s at: " + json.dumps(marks), file=sys.stderr)
    if tr is not None and tr.n_batches:
        print("device ms a batch by innermost host range: "
              + json.dumps(tr.by_range()), file=sys.stderr)
    for k, v in shown.items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
