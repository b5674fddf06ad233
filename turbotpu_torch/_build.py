"""Builds the package's CUDA sources with nvcc and loads them with ctypes.

A target is a source `csrc/<name>.cu` with a plain C interface plus a tuple of
`-D` defines that selects one variant of it; each target becomes
`build/lib<name>-<hash of the source, the defines and the flags>.so` beside
the package, at first use, by an nvcc process of its own (targets asked for
together are compiled together).  Nothing is built when a module is
imported.  A build that fails raises; there is no other path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

Target = tuple[str, tuple[str, ...]]     # (source name, -D defines)

_loaded: dict[Target, ctypes.CDLL] = {}
build_seconds: dict[Target, float] = {}  # seconds nvcc took (0 if cached)
build_count = 0      # nvcc processes started by this process
                     # (harness/profiling.py::compile_count_guard reads it)


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, $CUDA_PATH, $PATH and "
            "/usr/local/cuda): the CUDA kernels cannot be built")
    return found


def _paths(target: Target, extra_flags: tuple[str, ...]) -> tuple[Path, Path]:
    name, defines = target
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS + defines + extra_flags).encode())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(targets, extra_flags: tuple[str, ...] = ()) -> dict[Target, Path]:
    """Build the targets, one nvcc process each, all started together.
    Returns target -> library path.  The compiler's output (for example the
    report of -Xptxas -v) is kept beside each library, as `<library>.log`."""
    global build_count
    BUILD_DIR.mkdir(exist_ok=True)
    out, running = {}, []
    for target in targets:
        src, lib = _paths(target, extra_flags)
        out[target] = lib
        if lib.exists():
            build_seconds.setdefault(target, 0.0)
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, *target[1], *extra_flags,
               "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        build_count += 1
        running.append((target, lib, tmp, cmd, proc, time.perf_counter()))
    for target, lib, tmp, cmd, proc, t0 in running:
        log, _ = proc.communicate()
        build_seconds[target] = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) on {target[0]}.cu "
                f"{' '.join(target[1])}:\n{' '.join(cmd)}\n{log}")
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)      # atomic: a half-written library never loads
    return out


def library(target: Target, extra_flags: tuple[str, ...] = ()) -> Path:
    """Where `build` puts the library of `target` (built or not)."""
    return _paths(target, extra_flags)[1]


def load(name: str, defines: tuple[str, ...] = (),
         extra_flags: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The shared library of csrc/<name>.cu compiled with `defines`, built
    first if need be."""
    target = (name, tuple(defines))
    if target not in _loaded:
        _loaded[target] = ctypes.CDLL(
            str(build((target,), extra_flags)[target]))
    return _loaded[target]


class PackedEntry:
    """A kernel's C entry that takes one pointer to a block of int64
    arguments, resolved from its library at the first call.  A typed ctypes
    call converts every argument, which costs several microseconds a call on
    the host; one pointer costs below one.  Each thread packs into a block of
    its own (ctypes releases the GIL during the call).  Calling it returns
    the entry's int."""

    def __init__(self, target: Target, symbol: str, n_args: int):
        self._target, self._symbol = target, symbol
        self._args = struct.Struct(f"{n_args}q")
        self._fn = None
        self._blocks = threading.local()

    def __call__(self, *args: int) -> int:
        if self._fn is None:
            fn = getattr(load(*self._target), self._symbol)
            fn.restype = ctypes.c_int
            self._fn = fn
        blk = getattr(self._blocks, "blk", None)
        if blk is None:
            buf = bytearray(self._args.size)
            arr = (ctypes.c_char * self._args.size).from_buffer(buf)
            blk = self._blocks.blk = (buf, ctypes.c_void_p(
                ctypes.addressof(arr)), arr)
        self._args.pack_into(blk[0], 0, *args)
        return self._fn(blk[1])
