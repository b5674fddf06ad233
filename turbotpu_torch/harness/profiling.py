"""Profiling and build-observability hooks.

Counterpart of turbotpu/harness/profiling.py:

- `trace(log_dir)`: a torch.profiler trace of the block, CPU and CUDA
  activity, written to `log_dir/trace.json` (Chrome trace format).  The
  decoders name their parts with `torch.profiler.record_function` ranges
  (`turbo.siso1`, `turbo.gather_perm`, `turbo.siso2`, `turbo.gather_inv`,
  `turbo.early_exit`, and the sequence decoder's `seq.*`), which show in the
  trace beside the kernels; `device_ops`, `annotations`, `idle_gaps` and
  `read_gaps` read a written trace back;
- `kernel_ir(target)`: the PTX (or SASS) of one library of _build.py;
- `compiled_stats(target)`: registers, spills, stack and shared memory per
  kernel, from ptxas' report;
- `compile_count_guard(max_new)`: fails when _build.py builds more than
  max_new new libraries inside the block (a kernel variant that should have
  been built already).

`kernel_ir` and `compiled_stats` need the CUDA toolkit (nvcc, cuobjdump).
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
from pathlib import Path

import torch

from .. import _build
from .._device import resolve_device

TRACE_FILE = "trace.json"
# the profiler's categories of work that ran on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir, device="cuda", host: bool = True):
    """Profile the block; write the trace to `log_dir/trace.json` and yield
    the profiler (its `key_averages()` sums time by operation).  device
    "cuda" records the card's activity too and needs a card; "cpu" records
    the host's only.  host=False (a card only) records the card's activity
    alone: no host operations or ranges, and so almost none of the host
    time that recording them adds to every launch."""
    dev = resolve_device(device)
    if not host and dev.type != "cuda":
        raise ValueError("host=False records the card alone: device='cuda'")
    acts = [torch.profiler.ProfilerActivity.CPU] if host else []
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    prof.export_chrome_trace(str(out / TRACE_FILE))


def _events(path) -> list[dict]:
    with open(path) as f:
        data = json.load(f)
    return [e for e in data.get("traceEvents", data)
            if e.get("ph") == "X" and "dur" in e]


def device_ops(path) -> list[tuple[str, float, float]]:
    """(name, start us, duration us) of every kernel, copy and memset the
    card ran in a written trace, in start order."""
    return sorted(((e["name"], float(e["ts"]), float(e["dur"]))
                   for e in _events(path)
                   if e.get("cat") in DEVICE_CATEGORIES),
                  key=lambda x: x[1])


def annotations(path, prefix: str = "") -> list[tuple[str, float, float]]:
    """(name, start us, duration us) of the host's record_function ranges
    whose names start with `prefix`, in start order."""
    return sorted(((e["name"], float(e["ts"]), float(e["dur"]))
                   for e in _events(path)
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith(prefix)), key=lambda x: x[1])


def idle_gaps(ops, t0: float | None = None, t1: float | None = None,
              min_us: float = 0.0) -> list[tuple[float, float]]:
    """(start us, length us) of the spans in [t0, t1] where no op of `ops`
    (device_ops' tuples) ran on the card, longer than min_us."""
    ops = [o for o in ops if (t0 is None or o[1] + o[2] > t0)
           and (t1 is None or o[1] < t1)]
    gaps = []
    end = t0 if t0 is not None else (ops[0][1] if ops else 0.0)
    for _, start, dur in ops:
        if start - end > min_us:
            gaps.append((end, start - end))
        end = max(end, start + dur)
    if t1 is not None and t1 - end > min_us:
        gaps.append((end, t1 - end))
    return gaps


def read_gaps(ops, min_us: float = 0.0) -> list[tuple[float, float]]:
    """(start us, length us) of the idle gap that follows each device-to-host
    copy in `ops` (device_ops' tuples): where the host waited for a value
    (an early-exit flag) and the card then waited for the host's next
    launch.  A copy followed at once by more work gives no gap."""
    out = []
    for (name, start, dur), nxt in zip(ops, ops[1:]):
        end = start + dur
        if "DtoH" in name and nxt[1] - end > min_us:
            out.append((end, nxt[1] - end))
    return out


def kernel_ir(target: _build.Target, form: str = "ptx") -> str:
    """The PTX (form "ptx", compiled from the source with the library's
    flags and defines) or SASS (form "sass", cuobjdump of the built
    library) of one library of _build.py."""
    name, defines = target
    nvcc = _build.find_nvcc()
    if form == "ptx":
        out = _build.library(target).with_suffix(".ptx")
        _build.BUILD_DIR.mkdir(exist_ok=True)
        flags = [f for f in _build.NVCC_FLAGS
                 if f not in ("-shared", "-Xcompiler", "-fPIC")]
        subprocess.run([nvcc, *flags, *defines, "-ptx", "-o", str(out),
                        str(_build.CSRC / f"{name}.cu")], check=True,
                       capture_output=True, text=True)
        return out.read_text()
    if form == "sass":
        lib = _build.build((target,))[target]
        tool = Path(nvcc).with_name("cuobjdump")
        return subprocess.run([str(tool), "-sass", str(lib)], check=True,
                              capture_output=True, text=True).stdout
    raise ValueError(f"unknown form {form!r}: ptx or sass")


def _short_name(mangled: str) -> str:
    """The function's own name in an Itanium-mangled symbol (the last
    length-prefixed identifier of its nested name before the template
    arguments); the symbol itself when it is not of that form."""
    m = re.match(r"_ZN?", mangled)
    if not m:
        return mangled
    i, last = m.end(), mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        last = mangled[j:j + n]
        i = j + n
    return last


def parse_ptxas(log: str) -> list[dict]:
    """ptxas' -v report, one record per compiled entry function: function
    (short name), mangled, registers, spill_stores, spill_loads, stack and
    smem (bytes)."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"function": _short_name(m.group(1)),
                   "mangled": m.group(1), "registers": None,
                   "spill_stores": 0, "spill_loads": 0, "stack": 0,
                   "smem": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = map(
                int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(s.group(1)) if s else 0
    return out


PTXAS_FLAGS = ("-Xptxas", "-v")


def compiled_stats(target: _build.Target) -> list[dict]:
    """Registers, spills, stack and shared memory of every kernel of one
    library (`parse_ptxas` of a build with -Xptxas -v, which is a library
    of its own beside the plain build)."""
    lib = _build.build((target,), PTXAS_FLAGS)[target]
    return parse_ptxas(lib.with_suffix(".log").read_text())


@contextlib.contextmanager
def compile_count_guard(max_new: int = 0):
    """Fails (AssertionError) when _build starts more than max_new nvcc
    builds inside the block."""
    start = _build.build_count
    yield
    new = _build.build_count - start
    if new > max_new:
        raise AssertionError(f"unexpected kernel builds: {new} > {max_new}")
