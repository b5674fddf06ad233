#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port still starts on the GPU.

    python3 chip_smoke.py [--ptxas] [--phases kernels,decode,...]

Needs one NVIDIA card, nvcc and no network.  It builds the port's CUDA
kernels from turbotpu_torch/csrc, holds each against its plain PyTorch
version on the card, and drives the port's two entry points:

* `turbotpu_torch.turbo_decode` on the flagship configuration (LTE K=6144,
  1024 codewords, max-log, 6 iterations, NII window 256, bf16 channel
  streams, int8 extrinsics), checked and timed (phases `decode`, `bench`);
* `turbotpu_torch.harness.ber.simulate_point`, the Monte-Carlo BER/FER sweep,
  on the acceptance configurations C1, C2, C3, C3-RM and both C4s at full
  width with a frame cap each, the frame-error rate held to the recorded
  counts of results/tpu_accept.jsonl (phase `ber`), plus a small mixed-K
  decode against the same decode on the CPU (phase `mixed`), the two
  candidate forms of the mixed-K extrinsic exchange (phase `gather`) and the
  encoder's time per batch (phase `encoder`).

Each phase prints one JSON line; any failure is an exception and a non-zero
exit.  The last line is {"ok": true, "device": {...}}.  --ptxas also prints
the compiler's register and spill report.  --phases runs a subset (for
iterating on one phase); the closing lines are printed only by a full run.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks of one H100 SXM (NVIDIA data sheet): device memory rate,
# and fp32 outside the tensor cores.  The 67 TFLOP/s count an FMA as two
# operations; the kernels here do adds, maxes and subtracts, one result per
# instruction, so their issue peak is half of it.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_INSTR_PER_S = 67e12 / 2

MODES = ("maxlog", "linlog", "logmap")
_PALLAS = "turbotpu/siso/pallas_kernel.py"
KERNEL_SOURCE = "turbotpu_torch/csrc/siso.cu"
ALL_PHASES = ("kernels", "decode", "bench", "mixed", "gather", "encoder", "ber")

# kernel vs plain version on the card.  max-log and linlog: the same fp32
# operations in the same order, so codes, le and checkpoints must be equal.
# log-MAP: expf/log1pf of the CUDA math library in the kernel against eager
# PyTorch's; both are the full-precision functions, a difference of a few
# ulp in a correction is allowed to grow through the recursion up to 1e-4 on
# fp32 le and window starts, and int8 codes and bf16 values may land on the
# neighbouring value at a rounding tie (those are counted).
TOLERANCE = {"maxlog": 0.0, "linlog": 0.0, "logmap": 1e-4}

# Frame-error counts of the same grid points in results/tpu_accept.jsonl
# (frame errors, frames).  They are properties of the code and the decoder,
# not of a chip; no time or rate of that file is used.
REFERENCE_FER = {
    ("c4_rm_punctured", 1.4): (33, 3072),
    ("c4_rm_repeated", 0.6): (120, 1024),
    ("c3_umts_mixed", 0.5): (97, 1024),
    ("c3rm_mixed_rate_matched", 1.2): (75, 768),
    ("c2_lte_k6144", 0.6): (34, 512),
    ("c1_lte_k40", 2.0): (30, 544),
}
BAND_SIGMAS = 4.0


def emit(phase: str, **rec) -> None:
    print(json.dumps({"phase": phase, **rec}), flush=True)


def replaces(nii: bool, mode: str) -> str:
    base = (f"{_PALLAS}:505 (_build_call nii={nii}, pallas_call at :576)")
    if mode == "maxlog":
        return base
    return (f"{_PALLAS}:57 (_mstar/_mstar_tree, per-leaf _extrinsic :134, "
            f"mode={mode}) inside {base}")


def siso_bound_ms(T, B, n_win, chan_bytes, ext_bytes, nii, int8_out,
                  mode="maxlog"):
    """Least time the card could take for one SISO call: the larger of bytes
    moved (each input read once, each output written once) over the memory
    rate and fp32 instructions over their issue rate.

    Instructions per max*, from csrc/siso.cu: max-log 1 (max); linlog 6
    (max, sub, mul, sub, max with 0, add; the absolute value is an operand
    modifier); log-MAP 3 (max, sub, add) plus expf and log1pf of the CUDA
    math library, estimated at 30 fp32 instructions for the pair (about 10
    and 20: range reduction, polynomial, fix-ups; not counted from SASS)."""
    nbytes = B * (T * (2 * chan_bytes + 2 * ext_bytes)
                  + (2 * n_win * 32 if nii else 0))
    mstar = {"maxlog": 1, "linlog": 6, "logmap": 33}[mode]
    rows = 4                      # la*sm, +ls, negate, negate lp
    step = 1 + 12 + 8 * mstar     # A+P; 12 edge adds; 8 max*
    if mode == "maxlog":          # alpha+beta; per side 6 max, +P, max; sub
        ext = 16 + 2 * (6 + 1 + 1) + 1
    else:                         # 16 leaves, 8 parity adds, 14 max*, sub
        ext = 16 + 8 + 14 * mstar + 1
    quant = 4 if int8_out else 0  # scale, round, two clips
    renorm = (7 + 8) / 8          # every 8 steps: 7 maxes, 8 subtracts
    per_step = (rows + step + renorm) + (rows + step + renorm + ext + quant)
    if not nii:
        per_step += rows + step + renorm      # phase 1
    ops = B * T * per_step
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_INSTR_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def make_streams(inputs, K, W, dt, dev, perm=None):
    """The four (KTp, B) channel streams of a decode, as turbo_cells builds
    them: time pad with ls = BIG, lp = 0.  `perm` defaults to the LTE table."""
    from turbotpu_torch.siso.cuda_kernel import BIG, _round_up
    from turbotpu_torch.spec.qpp import qpp_perm
    ls, lp1, lp2, t1, t2 = (x.to(dev) for x in inputs)
    KTp = _round_up(K + 3, W)
    perm = torch.from_numpy(
        (qpp_perm(K) if perm is None else perm).astype(np.int64)).to(dev)

    def stream(body, tail, pad_val):
        full = torch.cat([body, tail], dim=1)
        full = torch.nn.functional.pad(full, (0, KTp - K - 3), value=pad_val)
        return full.to(dt).T.contiguous()

    return (stream(ls, t1[:, 0::2], BIG), stream(lp1, t1[:, 1::2], 0.0),
            stream(ls[:, perm], t2[:, 0::2], BIG), stream(lp2, t2[:, 1::2], 0.0))


def time_launches(fn, n):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def le_error(got, want, tol):
    """(error, tolerance) of a kernel's le against its plain version's.  With
    tol == 0 and for fp32 streams: the largest absolute difference against
    tol.  With tol > 0 a rounded stream may land on the neighbouring value
    where the fp32 extrinsic sits at a rounding tie: int8 codes may differ
    by one step, bf16 values by one bf16 step (relative 2^-7)."""
    a, b = got.to(torch.float32), want.to(torch.float32)
    d = (a - b).abs()
    if tol and got.dtype == torch.bfloat16:
        scale = torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)
        return float((d / scale).max()), 2.0 ** -7
    if tol and got.dtype == torch.int8:
        return float(d.max()), 1.0
    return float(d.max()), tol


def umts_frames(K, B, dev, seed=1, ebn0_db=1.0):
    """One homogeneous batch of UMTS-interleaved frames at K through the
    port's transmit chain on the card: the five decoder LLR streams."""
    from turbotpu_torch.decoder.turbo import DecoderConfig
    from turbotpu_torch.harness import ber
    cfg = ber.SimConfig(name="frames", K=K, B=B, seed=seed, decoder=DecoderConfig(
        K=K, interleaver="umts"))
    step = ber.make_step(cfg, dev)
    streams, _ = step.gen(ber.point_generator(cfg, ebn0_db, dev),
                          float(ber._ebn0_to_esn0_db(cfg, ebn0_db)))
    return streams


def check_kernels(dev, results):
    """Phase `kernels`: each kernel against its plain version on the card."""
    from turbotpu_torch.harness.bench import make_decode_inputs
    from turbotpu_torch.siso import cuda_kernel as ck
    from turbotpu_torch.spec.umts import umts_perm

    types = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "int8": torch.int8}
    combos = (("bfloat16", "int8"), ("bfloat16", "bfloat16"),
              ("float32", "float32"))
    f32 = ("float32", "float32")
    # (K, W, B): the small shape for every mode and type pair; the flagship
    # shape for max-log (all pairs) and linlog (its own pair); the shape of
    # C3's batch (fp32 streams; window 128 exact, 256 NII) for the corrected
    # modes, which is where the sweep launches them.
    shapes = {
        "maxlog": [((168, 32, 64), combos), ((6144, 256, 1024), combos)],
        "linlog": [((168, 32, 64), combos), ((5114, 128, 128), (f32,)),
                   ((5114, 256, 128), (f32,)),
                   ((6144, 256, 1024), (combos[0],))],
        "logmap": [((168, 32, 64), combos), ((5114, 128, 128), (f32,)),
                   ((5114, 256, 128), (f32,))],
    }
    worst = {name: 0.0 for name in results}
    ties = {name: 0 for name in results}
    cases, other_shapes = [], []
    lte_inputs, umts_inputs = {}, {}
    for mode in MODES:
        scale = 0.75 if mode == "maxlog" else 1.0
        tol = TOLERANCE[mode]
        for (K, W, B), pairs in shapes[mode]:
            if K == 5114:
                if B not in umts_inputs:
                    umts_inputs[B] = umts_frames(K, B, dev)
                inputs, perm = umts_inputs[B], umts_perm(K)
            else:
                if (K, B) not in lte_inputs:
                    lte_inputs[K, B] = make_decode_inputs(K, B, seed=1,
                                                          ebn0_db=1.0)
                inputs, perm = lte_inputs[K, B], None
            for chan, ext in pairs:
                dt, dte = types[chan], types[ext]
                qs = 0.25 if ext == "int8" else 0.0
                ls1, lp1, ls2, lp2 = make_streams(inputs, K, W, dt, dev, perm)
                T = ls1.shape[0]
                n_win = T // W
                la0 = torch.zeros((T, B), dtype=dte, device=dev)
                a0 = torch.zeros((n_win, 8, B), dtype=torch.float32, device=dev)
                # a first (cold) call makes a real a-priori stream and real
                # window starts for the calls that are compared
                la, ain = ck.siso_cells(ls1, lp1, la0, K, mode, scale,
                                        nii_ckpt=a0, window=W, ext_qscale=qs)
                le_k, aout_k = ck.siso_cells(ls2, lp2, la, K, mode, scale,
                                             nii_ckpt=ain, window=W,
                                             ext_qscale=qs)
                le_x = ck.siso_cells(ls2, lp2, la, K, mode, scale,
                                     window=W, ext_qscale=qs)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                le_p, aout_p = ck.siso_nii_plain(ls2, lp2, la, ain, K, W,
                                                 scale, qs, mode)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                le_xp = ck.siso_exact_plain(ls2, lp2, la, K, W, scale, qs, mode)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                shape = {"mode": mode, "K": K, "W": W, "B": B, "chan": chan,
                         "ext": ext}
                case = dict(shape)
                for name, got, want, ck_got, ck_want in (
                        (ck.kernel_name(True, mode), le_k, le_p, aout_k[1:],
                         aout_p[1:]),
                        (ck.kernel_name(False, mode), le_x, le_xp, None, None)):
                    e_le, le_tol = le_error(got, want, tol)
                    e_ck = (0.0 if ck_got is None
                            else float((ck_got - ck_want).abs().max()))
                    n_diff = int((got != want).sum())
                    if not (np.isfinite(e_le) and np.isfinite(e_ck)
                            and e_le <= le_tol and e_ck <= tol):
                        raise AssertionError(
                            f"{name} disagrees with its plain version: le "
                            f"{e_le} (tolerance {le_tol}), window starts "
                            f"{e_ck} (tolerance {tol}) at K={K} W={W} B={B} "
                            f"{chan}+{ext}")
                    if tol and ext != "float32":
                        ties[name] += n_diff
                    else:
                        worst[name] = max(worst[name], e_le)
                    worst[name] = max(worst[name], e_ck)
                    case[name] = {"le_err": e_le, "ckpt_max_abs_err": e_ck,
                                  "values_differing": n_diff}
                cases.append(case)

                # Times.  The shape each kernel is reported at is the one its
                # main path gives it: the flagship decode for max-log; C3's
                # batch for the corrected modes (exact at window 128, NII at
                # window 256).  linlog is also timed at the flagship shape.
                args = ((ls1, lp1), (ls2, lp2))
                state = {"i": 0}

                def one(nii):
                    # alternate the two SISOs' streams as a decode does
                    s = args[state["i"] % 2]
                    state["i"] += 1
                    ck.siso_cells(*s, la, K, mode, scale,
                                  nii_ckpt=ain if nii else None, window=W,
                                  ext_qscale=qs)
                flagship = (K, chan, ext) == (6144, "bfloat16", "int8")
                for nii, plain_s in ((True, t1 - t0), (False, t2 - t1)):
                    name = ck.kernel_name(nii, mode)
                    main = (flagship if mode == "maxlog" else
                            (K, W) == (5114, 256 if nii else 128))
                    if not (main or (flagship and mode == "linlog")):
                        continue
                    bound, by = siso_bound_ms(
                        T, B, n_win, ls1.element_size(), la.element_size(),
                        nii, ext == "int8", mode)
                    timing = dict(
                        ms=time_launches(lambda: one(nii), 20),
                        plain_ms=plain_s * 1e3, bound_ms=bound, bound_by=by)
                    if main:
                        results[name].update(timing, shape=shape)
                    else:
                        other_shapes.append({"name": name, **shape, **timing})
    for name in worst:
        results[name]["max_abs_err"] = worst[name]
        results[name]["rounded_values_differing"] = ties[name]
    emit("kernels", tolerance=TOLERANCE, cases=cases,
         kernels={k: {kk: v.get(kk) for kk in (
             "max_abs_err", "rounded_values_differing", "ms", "plain_ms",
             "bound_ms", "bound_by")} for k, v in results.items()},
         other_shapes=other_shapes)


def count_launches(results, fn):
    """Run `fn` with every launch count set to 0 just before and read just
    after; add what it launched to the main path's totals."""
    from turbotpu_torch.siso import cuda_kernel as ck
    for name in ck.LAUNCHES:
        ck.LAUNCHES[name] = 0
    out = fn()
    torch.cuda.synchronize()
    launched = dict(ck.LAUNCHES)
    for name, n in launched.items():
        results[name]["launches"] = results[name].get("launches", 0) + n
    return out, launched


def check_decode(dev, results):
    """Phase `decode`: the main path, with launch counts."""
    from turbotpu_torch import turbo_decode
    from turbotpu_torch.harness.bench import flagship_config, make_decode_inputs

    K, B, ebn0 = 6144, 1024, 2.0
    inputs, bits = make_decode_inputs(K, B, seed=2, ebn0_db=ebn0,
                                      with_crc=True, return_bits=True)
    inputs = tuple(x.to(dev) for x in inputs)
    bits = torch.from_numpy(bits).to(dev)
    rec = {"K": K, "B": B, "ebn0_db": ebn0}

    def only(launched, **expected):
        return all(n == expected.get(name, 0) for name, n in launched.items())

    (hard, iters, L), launched = count_launches(
        results, lambda: turbo_decode(*inputs, flagship_config()))
    if not only(launched, siso_nii=12):
        raise AssertionError(f"lean decode: 12 siso_nii launches expected, "
                             f"counted {launched}")
    if hard.shape != (B, K) or L.shape != (B, K) or iters.shape != (B,):
        raise AssertionError("decode outputs have the wrong shape")
    if not bool(torch.isfinite(L).all()):
        raise AssertionError("lean decode: L is not finite")
    rec["lean_bit_errors"] = int((hard != bits).sum())
    rec["lean_iters"] = int(iters.max())

    (hard_c, iters_c, _), launched_c = count_launches(
        results,
        lambda: turbo_decode(*inputs, flagship_config(early_term="crc")))
    rec["crc_bit_errors"] = int((hard_c != bits).sum())
    rec["crc_max_iters"] = int(iters_c.max())
    rec["crc_mean_iters"] = float(iters_c.float().mean())

    (hard_x, _, _), launched_x = count_launches(
        results, lambda: turbo_decode(*inputs, flagship_config(nii=False)))
    rec["exact_bit_errors"] = int((hard_x != bits).sum())
    rec["launches"] = {"lean": launched, "crc": launched_c,
                       "exact": launched_x}
    if not (only(launched_x, siso_exact=12)
            and only(launched_c, siso_nii=2 * rec["crc_max_iters"])):
        raise AssertionError(f"unexpected launch counts {rec['launches']}")
    if rec["lean_bit_errors"] or rec["crc_bit_errors"] or rec["exact_bit_errors"]:
        raise AssertionError(f"decoded bits differ from the transmitted: {rec}")
    if rec["crc_max_iters"] >= 6:
        raise AssertionError(f"CRC early termination did not fire: {rec}")

    # a small decode on the card against the same decode through the plain
    # versions on the CPU: hard bits and iteration counts identical
    Ks, Bs = 168, 64
    small = make_decode_inputs(Ks, Bs, seed=3, ebn0_db=1.5, with_crc=True)
    cfg_s = flagship_config(K=Ks, window=32, early_term="crc")
    got = turbo_decode(*small, cfg_s)
    ref = turbo_decode(*small, cfg_s, device="cpu")
    rec["small_vs_cpu_L_max_abs_diff"] = float(
        (got[2].cpu() - ref[2]).abs().max())
    if not (torch.equal(got[0].cpu(), ref[0]) and torch.equal(got[1].cpu(), ref[1])
            and rec["small_vs_cpu_L_max_abs_diff"] <= 1e-4):
        raise AssertionError(f"small decode differs from the CPU reference: {rec}")
    emit("decode", **rec)


def run_bench(dev, card, results):
    """Phase `bench`: decoded Mbit/s of the flagship configuration."""
    from turbotpu_torch.harness.bench import (bench_decode, flagship_config,
                                              make_decode_inputs)
    K, B = 6144, 1024
    lean = bench_decode(flagship_config(), B, n_timed=8, ebn0_db=1.0)
    crc = bench_decode(flagship_config(early_term="crc"), B, n_timed=8,
                       ebn0_db=1.0)
    # 1024 codewords are 32 warps at one thread per codeword: they cannot fill
    # 132 SMs.  One more line at 16 times the batch (the same 1024 noisy
    # frames tiled: a fixed-iteration decode's time does not depend on data).
    big_B = 16 * B
    tiled = tuple(x.repeat(16, 1)
                  for x in make_decode_inputs(K, B, seed=0, ebn0_db=1.0))
    big = bench_decode(flagship_config(), big_B, n_timed=2, inputs=tiled)
    emit("bench", card=card, lean=lean, crc=crc, lean_large_batch=big,
         kernel_ms_per_launch={k: v.get("ms") for k, v in results.items()})


def check_mixed(dev):
    """Phase `mixed`: a small mixed-K decode (bucket 320, sizes 40/168/320,
    48 codewords, linlog, CRC early termination) through the kernels on the
    card against the same decode through the plain versions on the CPU."""
    from turbotpu_torch.decoder.turbo import DecoderConfig
    from turbotpu_torch.harness import ber
    cfg = ber.SimConfig(
        name="mixed_small", K=320, K_mix=(40, 168, 320), B=48, seed=4,
        decoder=DecoderConfig(K=320, n_iters=8, mode="linlog", siso="cuda",
                              early_term="crc"))
    ebn0 = 1.5
    on_card, on_cpu = ber.make_step(cfg, dev), ber.make_step(cfg, "cpu")
    streams, bits = on_card.gen(ber.point_generator(cfg, ebn0, dev),
                                float(ber._ebn0_to_esn0_db(cfg, ebn0)))
    hard, iters = on_card.decode(streams)
    hard_c, iters_c = on_cpu.decode(tuple(x.cpu() for x in streams))
    rec = {"K": cfg.K, "K_mix": list(cfg.K_mix), "B": cfg.B, "ebn0_db": ebn0,
           "counters_card": on_card.count(streams, bits).tolist(),
           "counters_cpu": on_cpu.count(tuple(x.cpu() for x in streams),
                                        bits.cpu()).tolist(),
           "iters_max": int(iters.max()), "iters_min": int(iters.min())}
    if not (torch.equal(hard.cpu(), hard_c) and torch.equal(iters.cpu(), iters_c)
            and rec["counters_card"] == rec["counters_cpu"]):
        raise AssertionError(f"mixed-K decode on the card differs from the "
                             f"CPU decode: {rec}")
    if not 1 <= rec["iters_min"] <= rec["iters_max"] <= 8:
        raise AssertionError(f"mixed-K decode: iteration counts {rec}")
    emit("mixed", **rec)


def time_gathers(dev, card):
    """Phase `gather`: the two candidate forms of the mixed-K extrinsic
    exchange on a (KTp, B) fp32 stream, equal by construction: one
    torch.gather along time through a per-codeword (KTp, B) index (the form
    decoder/turbo_cells.py uses), against G row gathers through the shared
    tables merged by group id (the JAX package's form)."""
    from turbotpu_torch.decoder.bucketing import grouped_perm_tables
    from turbotpu_torch.decoder.turbo_cells import time_major_index
    out = []
    for K, sizes, interleaver, KTp, B in (
            (5114, (320, 1280, 5114), "umts", 5120, 128),
            (6144, (512, 2048, 6144), "lte", 6400, 1024)):
        Ks = [sizes[i % 3] for i in range(B)]
        perm_g, _, gid = (torch.from_numpy(t.astype(np.int64)).to(dev)
                          for t in grouped_perm_tables(Ks, K, interleaver))
        index = time_major_index(perm_g[gid], KTp)
        ext = torch.arange(K, KTp, device=dev)
        rows = [torch.cat([p, ext]) for p in perm_g]
        x = torch.randn((KTp, B), device=dev)

        def per_codeword():
            return torch.gather(x, 0, index)

        def grouped():
            y = x.index_select(0, rows[0])
            for g in range(1, len(rows)):
                y = torch.where((gid == g)[None, :],
                                x.index_select(0, rows[g]), y)
            return y

        if not torch.equal(per_codeword(), grouped()):
            raise AssertionError("the two exchange forms disagree")
        out.append({"KTp": KTp, "B": B, "G": len(rows), "dtype": "float32",
                    "per_codeword_gather_ms": time_launches(per_codeword, 50),
                    "grouped_gathers_ms": time_launches(grouped, 50)})
    emit("gather", card=card, shapes=out)


def time_encoder(dev, card):
    """Phase `encoder`: turbo_encode's time per batch (the feedback matrix
    is built by the warm-up call and cached)."""
    from turbotpu_torch.spec.qpp import qpp_perm
    from turbotpu_torch.spec.umts import umts_perm
    from turbotpu_torch.tx import chain
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = []
    for K, B, perm in ((6144, 64, qpp_perm(6144)), (5114, 43, umts_perm(5114)),
                       (1024, 128, qpp_perm(1024))):
        bits = chain.gen_payload(gen, B, K)
        t0 = time.perf_counter()
        chain.turbo_encode(bits, perm)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        out.append({"K": K, "B": B, "first_call_s": first,
                    "ms_per_batch": time_launches(
                        lambda: chain.turbo_encode(bits, perm), 10)})
    emit("encoder", card=card, shapes=out)


def fer_band(fe, n, fe_ref, n_ref):
    """|FER - FER_ref| against BAND_SIGMAS standard deviations of the
    difference of two binomial rates with the pooled error probability."""
    p = (fe + fe_ref) / (n + n_ref)
    sd = math.sqrt(p * (1 - p) * (1 / n + 1 / n_ref))
    return abs(fe / n - fe_ref / n_ref), BAND_SIGMAS * sd


def stage_times(step, cfg, esn0, dev):
    """ms per batch of the sweep's stages, CUDA-event timed: encode (payload,
    CRC, encoder, mux), channel (rate match, modulate, noise, demap,
    de-rate-match, embed: generation minus encode), decode, count (the error
    counters from the decoder's outputs)."""
    from turbotpu_torch.harness import ber
    gen = ber.point_generator(cfg, 0.0, dev)
    streams, bits = step.gen(gen, esn0)
    n = 3
    enc = time_launches(lambda: step.encode(gen), n)
    both = time_launches(lambda: step.gen(gen, esn0), n)
    dec = time_launches(lambda: step.decode(streams), n)
    hard, iters = step.decode(streams)
    cnt = time_launches(lambda: step.tally(hard, iters, bits), n)
    return {"encode_ms": enc, "channel_ms": both - enc, "decode_ms": dec,
            "count_ms": cnt}


def run_ber(dev, card, results):
    """Phase `ber`: the sweep's entry point on the acceptance configurations
    at full width, a frame cap each."""
    from turbotpu_torch.configs import acceptance as acc
    from turbotpu_torch.harness import ber
    from turbotpu_torch.siso.cuda_kernel import kernel_name

    def variant(cfg, tag, **dec):
        return dataclasses.replace(
            cfg, name=f"{cfg.name}+{tag}", steps_per_check=2,
            decoder=dataclasses.replace(cfg.decoder, **dec))

    # (configuration, Eb/N0, frames, the kernel it must launch, the key of
    # its reference count).  After the six acceptance points, three variants
    # of C3 run the other three corrected instantiations through the same
    # entry point (`cli ber --mode logmap --nii` and the like); log-MAP exact
    # is held to C3's band (linlog is a log-MAP approximation), the NII
    # variants to a frame-error rate below 0.25.
    c3 = ("c3_umts_mixed", 0.5)
    points = [
        (acc.C4_PUNCTURED, 1.4, 3072, kernel_name(False, "linlog"), None),
        (acc.C4_REPEATED, 0.6, 1024, kernel_name(False, "linlog"), None),
        (acc.C3, 0.5, 1024, kernel_name(False, "linlog"), None),
        (acc.C3_RM, 1.2, 768, kernel_name(False, "linlog"), None),
        (acc.C2, 0.6, 512, kernel_name(False, "maxlog"), None),
        (acc.C1, 2.0, 544, None, None),
        (variant(acc.C3, "logmap", mode="logmap"), 0.5, 256,
         kernel_name(False, "logmap"), c3),
        (variant(acc.C3, "linlog_nii", nii=True, window=256), 0.5, 256,
         kernel_name(True, "linlog"), "loose"),
        (variant(acc.C3, "logmap_nii", mode="logmap", nii=True, window=256),
         0.5, 256, kernel_name(True, "logmap"), "loose"),
    ]
    recs = []
    for cfg, ebn0, frames, kernel, ref_key in points:
        cfg = dataclasses.replace(cfg, max_frames=frames,
                                  min_frame_errors=10 ** 9)
        step = ber.make_step(cfg, dev)
        esn0 = float(ber._ebn0_to_esn0_db(cfg, ebn0))
        # warm-up outside the timed point: kernels' build, encoder matrices
        step.count(*step.gen(ber.point_generator(cfg, -1.0, dev), esn0))
        rec, launched = count_launches(
            results, lambda: ber.simulate_point(cfg, ebn0, step))
        rec["launches"] = {k: v for k, v in launched.items() if v}
        rec["card"] = card
        for key in ("frames", "bit_errs", "frame_errs", "ber", "fer",
                    "avg_iters", "wall_s", "mbit_per_s"):
            if not np.isfinite(rec[key]):
                raise AssertionError(f"{cfg.name}: {key} is not finite: {rec}")
        if rec["frames"] != frames or rec["frames"] <= 0:
            raise AssertionError(f"{cfg.name}: ran {rec['frames']} frames, "
                                 f"{frames} expected")
        # every half-iteration of every batch went through the one kernel
        # that the configuration names, and so none through a plain version
        expected = {kernel: 2 * rec["iter_batches"]} if kernel else {}
        if rec["launches"] != expected:
            raise AssertionError(f"{cfg.name}: launches {rec['launches']}, "
                                 f"expected {expected}")
        if ref_key == "loose":
            rec["fer_limit"] = 0.25
            if rec["fer"] >= 0.25:
                raise AssertionError(f"{cfg.name}: FER {rec['fer']} >= 0.25")
        else:
            fe_ref, n_ref = REFERENCE_FER[ref_key or (cfg.name, ebn0)]
            diff, band = fer_band(rec["frame_errs"], frames, fe_ref, n_ref)
            rec.update(reference_frame_errs=fe_ref, reference_frames=n_ref,
                       fer_diff=diff, fer_band=band)
            if diff > band:
                raise AssertionError(
                    f"{cfg.name} at {ebn0} dB: FER {rec['fer']:.4f} "
                    f"({rec['frame_errs']}/{frames}) is outside +-{band:.4f} "
                    f"({BAND_SIGMAS} sigma) of the recorded {fe_ref}/{n_ref}")
        if cfg.B > 1:
            rec["stage_ms_per_batch"] = stage_times(step, cfg, esn0, dev)
        recs.append(rec)
        emit("ber_point", **rec)
    emit("ber", card=card, points=len(recs),
         frames=sum(r["frames"] for r in recs),
         seconds=sum(r["wall_s"] for r in recs))


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    from turbotpu_torch import _build
    from turbotpu_torch.harness.bench import card_info
    from turbotpu_torch.siso.cuda_kernel import build_targets, kernel_name

    phases = ALL_PHASES
    if "--phases" in argv:
        phases = tuple(argv[argv.index("--phases") + 1].split(","))
        unknown = set(phases) - set(ALL_PHASES)
        if unknown:
            raise SystemExit(f"unknown phases {sorted(unknown)}")

    dev = torch.device("cuda", 0)
    card = card_info().splitlines()[0]
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    release = next((ln.split("release")[1].strip() for ln in nvcc.splitlines()
                    if "release" in ln), "unknown")
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    emit("env", card=card, torch=torch.__version__, cuda=torch.version.cuda,
         nvcc_release=release, triton=triton_version,
         python=sys.version.split()[0])

    t0 = time.perf_counter()
    flags = ("-Xptxas", "-v") if "--ptxas" in argv else ()
    libs = _build.build(build_targets(), flags)
    for name, defines in libs:
        _build.load(name, defines, flags)
    emit("build", seconds=time.perf_counter() - t0, libraries=len(libs),
         nvcc_seconds={" ".join(t[1]): s
                       for t, s in _build.build_seconds.items()},
         directory=str(_build.BUILD_DIR.relative_to(
             _build.BUILD_DIR.parent.parent)))

    results = {kernel_name(nii, mode): {
        "name": kernel_name(nii, mode), "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": replaces(nii, mode),
        "library_ms": None} for mode in MODES for nii in (True, False)}
    run = {"kernels": lambda: check_kernels(dev, results),
           "decode": lambda: check_decode(dev, results),
           "bench": lambda: run_bench(dev, card, results),
           "mixed": lambda: check_mixed(dev),
           "gather": lambda: time_gathers(dev, card),
           "encoder": lambda: time_encoder(dev, card),
           "ber": lambda: run_ber(dev, card, results)}
    for phase in ALL_PHASES:
        if phase in phases:
            t0 = time.perf_counter()
            run[phase]()
            emit("phase_seconds", name=phase,
                 seconds=time.perf_counter() - t0)
    if phases != ALL_PHASES:
        emit("partial", phases=list(phases))
        return 0

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for r in results.values():
        if r["launches"] < 1:
            raise AssertionError(f"the main paths never launched {r['name']}")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in results.values()]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
