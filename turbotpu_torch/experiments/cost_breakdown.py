"""What the card's fp32 pipes give the SISO kernel: dependent-operation
latency and issue rate, measured, beside the kernel's counted work.

Counterpart of the roofline part of experiments/cost_breakdown.py of the JAX
package (`OP_COUNT`, `_calibrate_vpu` and the part of `mode_roofline` that
uses it).  `issue_rate` is the calibration kernel (csrc/issue_rate.cu, in
place of the reference's Pallas kernel): per thread, `lanes` independent
chains of v = max(v + c, v).  One chain measures the latency of a dependent
fp32 operation; 8 or 16 chains what one warp can issue; the same at full
occupancy what an SM can.  `calibrate` launches it as one warp, as one warp
on every SM and at full occupancy, and `roofline` sets the max-log NII SISO
kernel's measured time per trellis step against its counted operations at
those rates.  Times come from CUDA events; the reference's machinery for
subtracting a host round trip has no counterpart here and is not ported.

    python -m turbotpu_torch.experiments.cost_breakdown [roofline] [--out FILE]

The `decode` mode is the counterpart of the reference's `mode_decode`:
where a decode's time goes, three things timed on the same streams (CUDA
events): the two SISO kernel calls of each iteration alone, the same with
the two interleave gathers (`index_select` along time), and the whole
`turbo_decode`; it writes records/cost_breakdown.json unless --out says
otherwise.

    python -m turbotpu_torch.experiments.cost_breakdown decode [--k 6144]
        [--b 1024] [--iters 6] [--out FILE]

On a CUDA tensor `issue_rate` launches its kernel or raises; it takes the
plain version only for a tensor on the CPU.  `LAUNCHES` counts launches.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from .. import _build
from .._device import resolve_device
from .common import need_card

LAUNCHES = {"issue_rate": 0}
TARGET: _build.Target = ("issue_rate", ())
UNROLL = 8           # chain steps per loop trip, as the SISO kernel's blocks
LANES = (1, 8, 16)

# fp32 operations per trellis step and codeword of the max-log NII kernel
# (alpha recompute + beta + extrinsic in one pass), counted from its
# structure.  The (u, c) = (0, 0) edge has metric 0: of each recursion's 16
# edges, 4 carry no add.
OP_COUNT = {
    "stream A/P form": 4,        # A = -(scale*la + ls): mul, add, neg; -lp
    "gamma (A+P)": 1,            # the (1,1) branch metric
    "alpha step": 12 + 8,        # 12 adds + 8 max
    "beta step": 12 + 8,
    # per u: 8 a+b adds, ONE +P on the parity-1 subtree, 7-max tree; final
    # subtract
    "extrinsic": 2 * (8 + 1 + 7) + 1,
    "renorms (every 8 steps, alpha+beta)": 2 * 15 / 8.0,
}

# Of those, the operations that depend on the previous trellis step's result
# (the serial chain one codeword cannot shorten): add -> max in each
# recursion, and per 8 steps a renormalisation (3 levels of max, 1 subtract)
# in each.  The extrinsic hangs off the chain and feeds nothing.
CHAIN_DEPTH = {
    "alpha step": 2,
    "beta step": 2,
    "renorms (every 8 steps, alpha+beta)": 2 * 4 / 8.0,
}


def chain_steps(n_ops: int, lanes: int) -> int:
    """Chain steps per lane that `n_ops` operations (2 per step and lane)
    come to, in whole loop trips of UNROLL steps."""
    return n_ops // (2 * lanes * UNROLL) * UNROLL


def issue_rate_plain(x: torch.Tensor, lanes: int = 1, n_ops: int = 4096
                     ) -> torch.Tensor:
    """Plain version of `issue_rate`: the same recurrence in eager PyTorch,
    exact in fp32.  x: (n,) fp32 -> (n, lanes) chain values."""
    x = x.to(torch.float32)
    c = x[:, None] * 0.5
    v = x[:, None] + torch.arange(lanes, dtype=torch.float32,
                                  device=x.device)[None, :]
    for _ in range(chain_steps(n_ops, lanes)):
        v = torch.maximum(v + c, v)
    return v


def _lib() -> ctypes.CDLL:
    lib = _build.load(*TARGET)
    fn = lib.turbotpu_issue_rate_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, ctypes.c_int64, i, i, i, i, p]
        fn.restype = i
    return lib


def issue_rate(x: torch.Tensor, lanes: int = 1, n_ops: int = 4096,
               threads: int = 32) -> torch.Tensor:
    """Run `lanes` chains of v = max(v + c, v), c = x / 2, starting at
    x + lane, for `chain_steps(n_ops, lanes)` steps in every thread.

    x: contiguous (n,) fp32, one element per thread; the launch is
    ceil(n / threads) blocks of `threads`.  Returns the (n, lanes) chain
    values."""
    if lanes not in LANES:
        raise ValueError(f"lanes must be one of {LANES}, got {lanes}")
    if x.dim() != 1 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (n,) float32 tensor")
    if not 1 <= threads <= 1024:
        raise ValueError(f"threads must be in 1..1024, got {threads}")
    if x.device.type == "cpu":
        return issue_rate_plain(x, lanes, n_ops)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n = x.shape[0]
    out = torch.empty((n, lanes), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    fn = _lib().turbotpu_issue_rate_launch
    with torch.cuda.device(x.device):
        LAUNCHES["issue_rate"] += 1
        rc = fn(x.data_ptr(), out.data_ptr(), n, lanes,
                chain_steps(n_ops, lanes) // UNROLL, -(-n // threads), threads,
                torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"issue_rate launch failed: cudaError {rc} "
                           f"(n={n}, lanes={lanes}, n_ops={n_ops})")
    return out


def sm_clock_mhz() -> float:
    """The SM clock as nvidia-smi reads it now."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True).stdout.split()[0])


def calibrate(device="cuda", n_ops: int = 1 << 20, n_timed: int = 5) -> dict:
    """Seconds per fp32 operation of the chain kernel in three launch
    shapes: one warp on one SM, one warp on each SM, and full occupancy
    (2048 threads on each SM), for 1, 8 and 16 chains per thread.  A launch's
    fixed cost is taken out by timing n_ops and 2 n_ops and using the
    difference.  The SM clock is read while the last shape is still warm."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("calibrate times with CUDA events and needs a "
                           "card; a CPU timing is not a device metric")
    from ..harness.bench import event_ms
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = {"one_warp": (32, 32), "warp_per_sm": (32 * n_sm, 32),
              "full": (2048 * n_sm, 1024)}
    rec = {"n_ops": n_ops, "sms": n_sm, "shapes": {}}
    for name, (n, threads) in shapes.items():
        x = torch.ones((n,), dtype=torch.float32, device=dev)
        per = {}
        for lanes in LANES:
            t1 = event_ms(lambda: issue_rate(x, lanes, n_ops, threads),
                           n_timed)
            t2 = event_ms(lambda: issue_rate(x, lanes, 2 * n_ops, threads),
                           n_timed)
            ops = 2 * lanes * chain_steps(n_ops, lanes)   # per thread
            per[lanes] = {"ms": t1, "ms_at_twice_the_ops": t2,
                          "ns_per_op_per_thread": (t2 - t1) * 1e6 / ops}
        rec["shapes"][name] = per
    mhz = sm_clock_mhz()
    rec["sm_clock_mhz"] = mhz
    cyc = lambda ns: ns * mhz * 1e-3
    lat = rec["shapes"]["one_warp"][1]["ns_per_op_per_thread"]
    warp = min(rec["shapes"]["one_warp"][l]["ns_per_op_per_thread"]
               for l in (8, 16))
    full = min(rec["shapes"]["full"][l]["ns_per_op_per_thread"]
               for l in LANES)
    rec.update({
        "dependent_op_ns": lat, "dependent_op_cycles": cyc(lat),
        # one warp: a warp instruction per this many ns and cycles
        "one_warp_issue_ns": warp, "one_warp_issue_cycles": cyc(warp),
        # full occupancy: 2048 threads each take ns_per_op per operation
        "fp32_instr_per_s_per_sm": 2048 / (full * 1e-9),
        "fp32_instr_per_s_card": n_sm * 2048 / (full * 1e-9),
        "spread_over_sms_ratio":
            rec["shapes"]["warp_per_sm"][1]["ns_per_op_per_thread"] / lat,
    })
    return rec


def roofline(device="cuda", B: int = 1024, cal: dict | None = None) -> dict:
    """The max-log NII kernel's measured time per trellis step at the
    flagship shape (K=6144, window 256, bf16 + int8 streams, B codewords:
    one warp per SM up to B = 32 x SMs) against its counted operations at
    the calibrated rates: the serial chain at the dependent-operation
    latency, and all operations at what one warp can issue."""
    from .gather_inkernel import siso_ns_per_row
    dev = resolve_device(device)
    cal = cal or calibrate(dev)
    T, K, W = 6400, 6144, 256
    ns_step = siso_ns_per_row(T, B, K, W, dev)
    total, chain = sum(OP_COUNT.values()), sum(CHAIN_DEPTH.values())
    mhz = cal["sm_clock_mhz"]
    chain_ns = chain * cal["dependent_op_ns"]
    issue_ns = total * cal["one_warp_issue_ns"]
    return {
        "K": K, "B": B, "W": W, "ops_per_step": total,
        "chain_ops_per_step": chain,
        "measured_ns_per_step": ns_step,
        "measured_cycles_per_step": ns_step * mhz * 1e-3,
        "chain_bound_ns_per_step": chain_ns,
        "one_warp_issue_bound_ns_per_step": issue_ns,
        "measured_over_chain_bound": ns_step / chain_ns,
        "measured_over_issue_bound": ns_step / issue_ns,
        # the datasheet bound's rate beside the calibrated one
        "calibrated_over_datasheet_fp32_instr_rate":
            cal["fp32_instr_per_s_card"] / (67e12 / 2),
    }


def mode_decode(K: int = 6144, B: int = 1024, iters: int = 6,
                io_dtype: str = "bfloat16", nii: bool = True, window: int = 256,
                device="cuda", n_timed: int = 8) -> dict:
    """ms per decode of (a) the SISO kernel calls alone (two per iteration,
    the second reading the first's le), (b) the same with the two interleave
    gathers between them, (c) the whole lean `turbo_decode` (max-log, scale
    0.75, extrinsics of the channel streams' type); the kernels take the NII
    contract when `nii`, as the decode does.  Streams: numpy seed 0, x 4."""
    import numpy as np
    from ..decoder.turbo import DecoderConfig, turbo_decode
    from ..harness.bench import event_ms, make_decode_inputs
    from ..siso.cuda_kernel import _round_up, siso_cells, window_len
    from ..spec.qpp import qpp_inv, qpp_perm
    dev = resolve_device(device)
    need_card(dev, "mode_decode")
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[io_dtype]
    KT = K + 3
    W = window or window_len(KT)
    KTp = _round_up(KT, W)
    rng = np.random.default_rng(0)
    mk = lambda: torch.from_numpy((rng.normal(size=(KTp, B)) * 4).astype(
        np.float32)).to(dev, dt)
    ls1, lp1, ls2, lp2 = (mk() for _ in range(4))
    ext = np.arange(K, KTp)
    perm_e = torch.from_numpy(np.concatenate([qpp_perm(K), ext])).to(dev)
    inv_e = torch.from_numpy(np.concatenate([qpp_inv(K), ext])).to(dev)
    ck = {s: torch.zeros((KTp // W, 8, B), device=dev) for s in (1, 2)}

    def siso(ls, lp, la, s):
        if not nii:
            return siso_cells(ls, lp, la, K, "maxlog", 0.75, window=W)
        le, ck[s] = siso_cells(ls, lp, la, K, "maxlog", 0.75,
                               nii_ckpt=ck[s], window=W)
        return le

    def kernels(gathers: bool):
        def run():
            la = torch.zeros_like(ls1)
            for _ in range(iters):
                le1 = siso(ls1, lp1, la, 1)
                le2 = siso(ls2, lp2, le1.index_select(0, perm_e)
                           if gathers else le1, 2)
                la = le2.index_select(0, inv_e) if gathers else le2
        return run

    cfg = DecoderConfig(K=K, n_iters=iters, mode="maxlog", ext_scale=0.75,
                        siso="cuda", io_dtype=io_dtype, nii=nii, window=window)
    full_in = tuple(x.to(dev) for x in make_decode_inputs(K, B))
    t = {"kernels_ms": event_ms(kernels(False), n_timed),
         "kernels_gathers_ms": event_ms(kernels(True), n_timed),
         "full_decode_ms": event_ms(
             lambda: turbo_decode(*full_in, cfg, device=dev), n_timed)}
    t.update({
        "K": K, "B": B, "iters": iters, "io_dtype": io_dtype, "nii": nii,
        "window": W, "timed_reps": n_timed,
        "gathers_ms": t["kernels_gathers_ms"] - t["kernels_ms"],
        "loop_overhead_pct": 100 * (t["full_decode_ms"]
                                    - t["kernels_gathers_ms"])
        / t["full_decode_ms"],
        **{k.replace("_ms", "_gbit_per_s"): B * K / t[k] / 1e6
           for k in ("kernels_ms", "kernels_gathers_ms", "full_decode_ms")}})
    return t


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", default="roofline",
                    choices=["roofline", "decode"])
    ap.add_argument("--k", type=int, default=6144, help="decode mode")
    ap.add_argument("--b", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=6, help="decode mode")
    ap.add_argument("--out", default=None, help="write the record here")
    args = ap.parse_args(argv)
    from ..harness.bench import card_info
    if args.mode == "decode":
        from .common import out_path, run_meta, write_record
        dev = resolve_device("cuda")
        rec = {**run_meta(argv, dev),
               "decode": mode_decode(args.k, args.b, args.iters, device=dev)}
        print(json.dumps(rec["decode"]), flush=True)
        write_record(rec, out_path(args.out, "cost_breakdown"))
        return rec
    cal = calibrate()
    rec = {"card": card_info(), "calibration": cal,
           "roofline": roofline(B=args.b, cal=cal)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


if __name__ == "__main__":
    print(json.dumps(main()))
