"""ctypes binding for the C++ golden model (cpp/golden.cc).

Counterpart of turbotpu/golden/cpp_ref.py, with its own byte-for-byte copy
of golden.cc and its Makefile under cpp/.  Builds libgolden.so beside them
on first use with make (g++); the library stays out of git.  The API
mirrors numpy_ref.py.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess

import numpy as np

_DIR = pathlib.Path(__file__).parent / "cpp"
_LIB_PATH = _DIR / "libgolden.so"
_lib = None

_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def _get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists() or _LIB_PATH.stat().st_mtime < (_DIR / "golden.cc").stat().st_mtime:
        subprocess.run(["make", "-C", str(_DIR)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.ttpu_turbo_encode.argtypes = [_i8p, ctypes.c_int, _i32p, _i8p, _i8p, _i8p, _i8p, _i8p]
    lib.ttpu_bcjr_siso.argtypes = [_f64p, _f64p, _f64p, ctypes.c_int, ctypes.c_int, _f64p, _f64p]
    lib.ttpu_turbo_decode.argtypes = [
        _f64p, _f64p, _f64p, _f64p, _f64p, _i32p, _i32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_uint32, _i8p, _f64p]
    lib.ttpu_turbo_decode.restype = ctypes.c_int
    lib.ttpu_crc_check.argtypes = [_i8p, ctypes.c_int, ctypes.c_uint32]
    lib.ttpu_crc_check.restype = ctypes.c_int
    lib.ttpu_umts_mux.argtypes = [_f64p] * 5 + [ctypes.c_int, _f64p]
    lib.ttpu_umts_demux.argtypes = [_f64p, ctypes.c_int] + [_f64p] * 5
    _lib = lib
    return lib


def turbo_encode(bits: np.ndarray, perm: np.ndarray):
    lib = _get_lib()
    bits = np.ascontiguousarray(bits, dtype=np.int8)
    perm = np.ascontiguousarray(perm, dtype=np.int32)
    K = len(bits)
    sys = np.empty(K, np.int8)
    par1 = np.empty(K, np.int8)
    par2 = np.empty(K, np.int8)
    tail1 = np.empty(6, np.int8)
    tail2 = np.empty(6, np.int8)
    lib.ttpu_turbo_encode(bits, K, perm, sys, par1, par2, tail1, tail2)
    return sys, par1, par2, tail1, tail2


def bcjr_siso(ls, lp, la, mode: str = "logmap"):
    lib = _get_lib()
    ls = np.ascontiguousarray(ls, dtype=np.float64)
    lp = np.ascontiguousarray(lp, dtype=np.float64)
    la = np.ascontiguousarray(la, dtype=np.float64)
    K = len(la)
    L = np.empty(K, np.float64)
    Le = np.empty(K, np.float64)
    lib.ttpu_bcjr_siso(ls, lp, la, K, {"logmap": 0, "maxlog": 1, "linlog": 2}[mode], L, Le)
    return L, Le


def turbo_decode(ls, lp1, lp2, tail1, tail2, perm, inv,
                 n_iters: int = 8, mode: str = "logmap",
                 ext_scale: float = 1.0, crc_poly: int | None = None):
    """Full decode; crc_poly enables CRC early termination (parity with
    numpy_ref.turbo_decode)."""
    lib = _get_lib()
    c = lambda a: np.ascontiguousarray(a, dtype=np.float64)
    K = len(ls)
    hard = np.empty(K, np.int8)
    L = np.empty(K, np.float64)
    it = lib.ttpu_turbo_decode(
        c(ls), c(lp1), c(lp2), c(tail1), c(tail2),
        np.ascontiguousarray(perm, np.int32), np.ascontiguousarray(inv, np.int32),
        K, n_iters, {"logmap": 0, "maxlog": 1, "linlog": 2}[mode], float(ext_scale),
        crc_poly or 0, hard, L)
    return hard, it, L


def crc_check(bits_with_crc: np.ndarray, poly: int) -> bool:
    lib = _get_lib()
    b = np.ascontiguousarray(bits_with_crc, np.int8)
    return bool(lib.ttpu_crc_check(b, len(b), poly))


def umts_mux(sys, par1, par2, tail1, tail2):
    """Canonical -> UMTS wire order (3K + 12), float64 (bits or LLRs)."""
    lib = _get_lib()
    c = lambda a: np.ascontiguousarray(a, dtype=np.float64)
    K = len(sys)
    wire = np.empty(3 * K + 12, np.float64)
    lib.ttpu_umts_mux(c(sys), c(par1), c(par2), c(tail1), c(tail2), K, wire)
    return wire


def umts_demux(wire):
    lib = _get_lib()
    wire = np.ascontiguousarray(wire, np.float64)
    K = (len(wire) - 12) // 3
    out = [np.empty(K, np.float64) for _ in range(3)] + \
          [np.empty(6, np.float64) for _ in range(2)]
    lib.ttpu_umts_demux(wire, K, *out)
    return tuple(out)
