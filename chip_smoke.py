#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port still starts on the GPU.

    python3 chip_smoke.py [--ptxas] [--phases kernels,decode,...]

Phases: kernels, decode, bench, mixed, gather, encoder, fold, calibrate, tb,
harq, seq, fp8, dist, compact, ber, profile, variants, harness, experiments.

Needs one NVIDIA card, nvcc and no network. It builds the port's CUDA kernels
from turbotpu_torch/csrc (siso.cu in all its 72 variants, row_gather.cu,
issue_rate.cu, ring_xch.cu, layout.cu, harq.cu), holds each against its plain
PyTorch version on the card (every SISO kernel, exact, NII, folded and
boundary, at difference 0 in every mode, also at batches that are not a
multiple of their blocks, in one window or one segment and with masked rows;
the two passes of the exact, NII, folded and boundary kernels timed apart),
and drives the port's entry points:

* `turbotpu_torch.turbo_decode` on the flagship configuration (LTE K=6144,
  1024 codewords, max-log, 6 iterations, NII window 256, bf16 channel
  streams, int8 extrinsics), checked and timed (phases `decode`, `bench`),
  with one launch of each layout kernel of layout.cu, which are held byte
  for byte against their plain versions and timed against them at the
  chained benchmark cells' shapes (B=16384, K=6144 with the shared table;
  B=6656, K=5824 with per-codeword tables; phase `decode`), and in a crc
  decode with a shared table the live prefix's four kernels once an
  iteration, with per-codeword tables the freezing exit's two (both also
  at the transport-block cells' size, where the two decodes must agree),
  each held byte for byte against its plain version and timed against it
  at those cells' shape, beside a SISO call on a live count held against
  the same call on the narrowed columns (phase `decode`),
  and the same decode with `fold_gather=True`, which must give the same bits,
  iteration counts and L through the folded kernel alone (phase `fold`, with
  the row-gather experiment, timed back to back and as a CUDA graph against
  torch.index_select, and the corrected modes' folded kernels);
* `turbotpu_torch.harness.ber.simulate_point`, the Monte-Carlo BER/FER sweep,
  on the acceptance configurations C1, C2, C3, C3-RM and both C4s at full
  width with a frame cap each, the frame-error rate held to the recorded
  counts of results/tpu_accept.jsonl (phase `ber`), plus a small mixed-K
  decode against the same decode on the CPU (phase `mixed`), the two
  candidate forms of the mixed-K extrinsic exchange (phase `gather`) and the
  encoder's time per batch (phase `encoder`);
* `turbotpu_torch.harness.tb.simulate_tb_point`, the transport-block sweep,
  on C6 (A=12000, two code blocks, rate 1/2) at two grid points held to the
  recorded counts, and `transport.decode_transport_block` on one block made
  on the host (phase `tb`);
* `turbotpu_torch.harq`, the HARQ receiver: the combine kernel of harq.cu
  against its plain version byte for byte at the PUSCH HARQ cell's shapes
  (K=5824, E 6642 and 6648, 512 slots, rows of all four redundancy
  versions, new and retransmitted), timed against it and against its byte
  bound at the cell's mix, a receiver on the card against the same on
  the CPU over TTIs of two processes, with its counts, and a receiver at
  the cell's size whose TTIs each launch one combine a run of blocks and
  the decode's kernels, nothing else (phase `harq`);
* `turbotpu_torch.harness.c5.run_c5` (`cli c5`), the sequence-sharded decode
  of C5 (K=6144, 4096 codewords, max-log, 6 iterations, bf16 streams, CRC
  early termination at 0.8 dB) on a local mesh of the one card, seq=2 exact
  and NII window 256 and seq=4, through K4 (`siso_bnd_*`, checked against its
  plain version at C5's chunk shape, and with e0 edges against the exact and
  NII kernels); `dist.seq_parallel.decode_seq_sharded` at seq=1 against the
  monolithic decode bit for bit, with the K6 exchange (`boundary_xch="dma"`)
  against the ring shift bit for bit, at seq=2 against the monolithic decode
  of the same frames, and small against the CPU (phase `seq`); K6 (`ring_xch`)
  against its plain version over 100 exchanges, timed back to back and as a
  CUDA graph against two torch.roll calls, its error flag raising at the end
  of a sequence decode, and `dist.data_parallel` through NCCL with a world
  of one (phase `dist`);
* `turbotpu_torch.harness.compact.bench_compaction` and the compacted sweeps
  (`simulate_point(compact_stage1=, compact_flush=)`), whose counts must
  equal the plain ones on the same frames (phase `compact`);
* `turbotpu_torch.experiments.cost_breakdown`, the issue-rate calibration
  (phase `calibrate`);
* float8_e4m3fn extrinsic streams: the eighteen fp8 libraries of siso.cu
  (three modes, two channel types, plain, folded and boundary forms)
  against their plain versions at difference 0 and timed at the int8 and
  bf16 rows' shapes, the flagship decode with fp8 extrinsics (lean and
  crc, bits, launches, against its plain path on a small batch, beside
  int8 in turns), every fp8 library through the entry points, and
  `cli c5 --ext-dtype float8_e4m3fn` (phase `fp8`);
* `cli bench --profile` on the flagship and a trace of C5: the SISO kernels
  in the trace, the top device operations, the device's idle share and the
  idle gaps at the early-exit host reads (phase `profile`);
* `siso="window"` against the same frames on the CPU and `siso="ascan"`
  against `siso="scan"`, one K=6144 decode each (phase `variants`);
* `cli scaling --devices 1`, `cli supervise -- ber --config c1` with a frame
  cap, and `harness.debug.checked` around the flagship decode (phase
  `harness`);
* every program of the evidence layer (turbotpu_torch/experiments/: the
  acceptance run and the twelve studies, the decode mode of cost_breakdown)
  through its `main` at a capped size, its record checked, and `fer_run` on
  the card against the CPU (phase `experiments`).

Each phase prints one JSON line; any failure is an exception and a non-zero
exit.  The last line is {"ok": true, "device": {...}}.  --ptxas also prints
every kernel's registers, spills, stack and shared memory
(`harness.profiling.compiled_stats`).  --phases runs a subset (for
iterating on one phase); the closing lines are printed only by a full run.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

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
ALL_PHASES = ("kernels", "decode", "bench", "mixed", "gather", "encoder",
              "fold", "calibrate", "tb", "harq", "seq", "fp8", "dist",
              "compact", "ber", "profile", "variants", "harness",
              "experiments")

# kernel vs plain version on the card: difference 0 in every mode.  The
# kernels and the plain versions do the same fp32 operations in the same
# order, and log-MAP's expf/log1pf are the CUDA math library's on both sides,
# so codes, le, window starts and edges must be equal.

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


def emit(phase: str, **rec) -> None:
    print(json.dumps({"phase": phase, **rec}), flush=True)


def replaces(nii: bool, mode: str, fold: bool = False) -> str:
    base = (f"{_PALLAS}:505 (_build_call nii={nii}, fold_gather=True, "
            f"pallas_call at :570)" if fold else
            f"{_PALLAS}:505 (_build_call nii={nii}, pallas_call at :576)")
    if mode == "maxlog":
        return base
    return (f"{_PALLAS}:57 (_mstar/_mstar_tree, per-leaf _extrinsic :134, "
            f"mode={mode}) inside {base}")


def bnd_replaces(nii: bool, mode: str) -> str:
    base = (f"{_PALLAS}:167 (_make_kernel boundary=True, nii={nii}, "
            f"with_offset; specs :532-539, pallas_call at :576)")
    if mode == "maxlog":
        return base
    return f"{_PALLAS}:57 (_mstar/_mstar_tree, mode={mode}) inside {base}"


def siso_bound_ms(T, B, n_win, chan_bytes, ext_bytes, nii, int8_out,
                  mode="maxlog", fold=False, bnd=False):
    """Least time the card could take for one SISO call: the larger of bytes
    moved (each input read once, each output written once) over the memory
    rate and fp32 instructions over their issue rate.  The boundary forms
    (bnd) also read two (8, B) fp32 edges and write two.

    Instructions per max*, from csrc/siso.cu: max-log 1 (max); linlog 6
    (max, sub, mul, sub, max with 0, add; the absolute value is an operand
    modifier); log-MAP 3 (max, sub, add) plus expf and log1pf of the CUDA
    math library, estimated at 30 fp32 instructions for the pair (about 10
    and 20: range reduction, polynomial, fix-ups; not counted from SASS)."""
    nbytes = B * (T * (2 * chan_bytes + 2 * ext_bytes)
                  + (2 * n_win * 32 if nii else 0))
    if fold:
        nbytes += 4 * T           # the gather table, shared by the batch
    if bnd:
        nbytes += B * 4 * 32      # edges: two in, two out
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


def make_streams(inputs, K, W, dt, dev, perm=None, KTp=None):
    """The four (KTp, B) channel streams of a decode, as turbo_cells builds
    them: time pad with ls = BIG, lp = 0.  `perm` defaults to the LTE table;
    KTp to K + 3 rounded up to the window."""
    from turbotpu_torch.siso.cuda_kernel import BIG, _round_up
    from turbotpu_torch.spec.qpp import qpp_perm
    ls, lp1, lp2, t1, t2 = (x.to(dev) for x in inputs)
    KTp = KTp or _round_up(K + 3, W)
    perm = torch.from_numpy(
        (qpp_perm(K) if perm is None else perm).astype(np.int64)).to(dev)

    def stream(body, tail, pad_val):
        full = torch.cat([body, tail], dim=1)
        full = torch.nn.functional.pad(full, (0, KTp - K - 3), value=pad_val)
        return full.to(dt).T.contiguous()

    return (stream(ls, t1[:, 0::2], BIG), stream(lp1, t1[:, 1::2], 0.0),
            stream(ls[:, perm], t2[:, 0::2], BIG), stream(lp2, t2[:, 1::2], 0.0))


def time_launches(fn, n):
    """ms per call over n calls between two CUDA events, after a warm-up."""
    from turbotpu_torch.harness.bench import event_ms
    return event_ms(fn, n)


def max_diff(got, want) -> float:
    """The largest absolute difference of two tensors (0 for empty ones)."""
    if not got.numel():
        return 0.0
    return float((got.to(torch.float32) - want.to(torch.float32)).abs().max())


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
    from turbotpu_torch.spec.qpp import qpp_perm
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
    worst = {ck.kernel_name(nii, mode, fold): 0.0
             for mode in MODES for nii, fold in ck.CONTRACTS}
    cases, other_shapes = [], []
    lte_inputs, umts_inputs = {}, {}
    for mode in MODES:
        scale = 0.75 if mode == "maxlog" else 1.0
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
                t2 = t2p = time.perf_counter()
                shape = {"mode": mode, "K": K, "W": W, "B": B, "chan": chan,
                         "ext": ext}
                case = dict(shape)
                compared = [
                    (ck.kernel_name(True, mode), le_k, le_p, aout_k[1:],
                     aout_p[1:]),
                    (ck.kernel_name(False, mode), le_x, le_xp, None, None)]

                # The folded read: la is the other SISO's raw output, read
                # through the interleaver table.  Held against its plain
                # version like the others, and against the NII kernel on the
                # materialised gather, where every mode must give equal bits
                # (the arithmetic is the same code).
                flagship = (K, chan, ext) == (6144, "bfloat16", "int8")
                fold_here = (K == 168 or (K, W) == (5114, 256)
                             or (mode == "maxlog" and flagship))
                t3 = t2
                if fold_here:
                    table = np.concatenate([
                        qpp_perm(K) if perm is None else perm,
                        np.arange(K, T)])
                    idx = torch.from_numpy(table.astype(np.int32)).to(dev)
                    fold_name = ck.kernel_name(True, mode, fold=True)
                    le_f, aout_f = ck.siso_cells(
                        ls2, lp2, la, K, mode, scale, nii_ckpt=ain, window=W,
                        ext_qscale=qs, gather_idx=idx)
                    le_m, aout_m = ck.siso_cells(
                        ls2, lp2, la.index_select(0, idx.long()), K, mode,
                        scale, nii_ckpt=ain, window=W, ext_qscale=qs)
                    if not (torch.equal(le_f, le_m)
                            and torch.equal(aout_f[1:], aout_m[1:])):
                        raise AssertionError(
                            f"{fold_name} differs from "
                            f"{ck.kernel_name(True, mode)} on the "
                            f"materialised gather at K={K} W={W} B={B} "
                            f"{chan}+{ext}")
                    torch.cuda.synchronize()
                    t2 = time.perf_counter()
                    le_fp, aout_fp = ck.siso_nii_plain(
                        ls2, lp2, la, ain, K, W, scale, qs, mode,
                        gather_idx=idx)
                    torch.cuda.synchronize()
                    t3 = time.perf_counter()
                    compared.append((fold_name, le_f, le_fp, aout_f[1:],
                                     aout_fp[1:]))
                    case["fold_vs_materialised_max_abs_diff"] = 0.0
                for name, got, want, ck_got, ck_want in compared:
                    e_le = max_diff(got, want)
                    e_ck = 0.0 if ck_got is None else max_diff(ck_got, ck_want)
                    if not (torch.equal(got, want) and (
                            ck_got is None or torch.equal(ck_got, ck_want))):
                        raise AssertionError(
                            f"{name} differs from its plain version: le "
                            f"{e_le}, window starts {e_ck} at K={K} W={W} "
                            f"B={B} {chan}+{ext}")
                    worst[name] = max(worst[name], e_le, e_ck)
                    case[name] = {"le_err": e_le, "ckpt_max_abs_err": e_ck}
                cases.append(case)

                # Times.  The shape each kernel is reported at is the one its
                # main path gives it: the flagship decode for max-log; C3's
                # batch for the corrected modes (exact at window 128, NII at
                # window 256).  linlog is also timed at the flagship shape.
                args = ((ls1, lp1), (ls2, lp2))
                state = {"i": 0}

                def one(nii, fold=False):
                    # alternate the two SISOs' streams as a decode does
                    s = args[state["i"] % 2]
                    state["i"] += 1
                    ck.siso_cells(*s, la, K, mode, scale,
                                  nii_ckpt=ain if nii else None, window=W,
                                  ext_qscale=qs,
                                  gather_idx=idx if fold else None)
                plain_s = {(True, False): t1 - t0, (False, False): t2p - t1,
                           (True, True): t3 - t2}
                for nii, fold in ck.CONTRACTS:
                    if fold and not fold_here:
                        continue
                    name = ck.kernel_name(nii, mode, fold)
                    main = (flagship if mode == "maxlog" else
                            (K, W) == (5114, 256 if nii else 128))
                    if not (main or (flagship and mode == "linlog")):
                        continue
                    bound, by = siso_bound_ms(
                        T, B, n_win, ls1.element_size(), la.element_size(),
                        nii, ext == "int8", mode, fold)
                    timing = dict(
                        ms=time_launches(lambda: one(nii, fold), 20),
                        plain_ms=plain_s[nii, fold] * 1e3, bound_ms=bound,
                        bound_by=by)
                    if main:
                        results[name].update(timing, shape=shape)
                    else:
                        other_shapes.append({"name": name, **shape, **timing})

                # The two passes of the NII, exact and folded kernels timed
                # apart at the flagship shape, one pass a launch between
                # CUDA events (these launches are not counted).
                if mode == "maxlog" and flagship:
                    for nii, fold in ck.CONTRACTS:
                        p1, p2 = ck.pass_launchers(
                            ls2, lp2, la, K, mode, scale,
                            nii_ckpt=ain if nii else None, window=W,
                            ext_qscale=qs, gather_idx=idx if fold else None)
                        results[ck.kernel_name(nii, mode, fold)]["pass_ms"] = {
                            "pass1": time_launches(p1, 20),
                            "pass2": time_launches(p2, 20)}

                # The folded kernel through the identity table: the same
                # code reading rows in order, which separates what the
                # scattered rows cost from what the indexed address costs.
                if mode == "maxlog" and flagship:
                    ident = torch.arange(T, dtype=torch.int32, device=dev)
                    bound, by = siso_bound_ms(
                        T, B, n_win, ls1.element_size(), la.element_size(),
                        True, True, mode, True)
                    other_shapes.append({
                        "name": ck.kernel_name(True, mode, True), **shape,
                        "table": "identity", "ms": time_launches(
                            lambda: ck.siso_cells(
                                ls2, lp2, la, K, mode, scale, nii_ckpt=ain,
                                window=W, ext_qscale=qs, gather_idx=ident),
                            20),
                        "plain_ms": None, "bound_ms": bound, "bound_by": by})

                # The folded read where the stream no longer fits the L2
                # cache: the flagship streams tiled to 16 times the batch
                # (int8 stream 105 MB), the NII kernel beside it in turns.
                if mode == "maxlog" and flagship:
                    wide = [x.repeat(1, 16) for x in (ls2, lp2, la)]
                    ain_w = ain.repeat(1, 1, 16)
                    Bw = wide[0].shape[1]

                    def one_wide(fold):
                        ck.siso_cells(*wide, K, mode, scale, nii_ckpt=ain_w,
                                      window=W, ext_qscale=qs,
                                      gather_idx=idx if fold else None)
                    ms_w = [time_launches(lambda: one_wide(f), 5)
                            for f in (False, True, True, False)]
                    for f, ms in ((False, (ms_w[0] + ms_w[3]) / 2),
                                  (True, (ms_w[1] + ms_w[2]) / 2)):
                        bound, by = siso_bound_ms(
                            T, Bw, n_win, ls1.element_size(),
                            la.element_size(), True, True, mode, f)
                        other_shapes.append({
                            "name": ck.kernel_name(True, mode, f), **shape,
                            "B": Bw, "ms": ms, "plain_ms": None,
                            "bound_ms": bound, "bound_by": by})
                    del wide, ain_w
    parallel_cases = check_parallel_edges(dev, worst)
    for name in worst:
        results[name]["max_abs_err"] = worst[name]
    emit("kernels", tolerance=0.0, cases=cases,
         parallel_cases=parallel_cases,
         kernels={k: {kk: results[k].get(kk) for kk in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "pass_ms")} for k in worst},
         other_shapes=other_shapes)


def check_parallel_edges(dev, worst):
    """The exact, NII and folded kernels at the shapes their blocks and
    passes single out, every mode and stream pair, difference 0 (NII and
    folded: le and the window starts aout[1:]; folded through a random
    permutation of the rows): B not a multiple of the 4-codeword warps of
    pass 1 (70, 37, 45: the register path) or of the 32-codeword blocks (and
    1000 at the flagship shape), one window (K=40 in W=48, three segments of
    16; in W=64, one segment: no first pass), K_real below the trellis' K
    (masked rows).  NII takes real window starts from a cold call."""
    from turbotpu_torch.harness.bench import make_decode_inputs
    from turbotpu_torch.siso import cuda_kernel as ck
    types = {"float32": torch.float32, "bfloat16": torch.bfloat16,
             "int8": torch.int8}
    small = ((168, 32, 70, 168), (40, 48, 37, 40), (40, 64, 37, 40),
             (168, 32, 45, 150))
    out = []
    for mode in MODES:
        scale = 0.75 if mode == "maxlog" else 1.0
        shapes = [(shape, pair) for shape in small
                  for pair in (("bfloat16", "int8"), ("bfloat16", "bfloat16"),
                               ("float32", "float32"))]
        if mode == "maxlog":
            shapes.append(((6144, 256, 1000, 6144), ("bfloat16", "int8")))
        for (K, W, B, K_real), (chan, ext) in shapes:
            qs = 0.25 if ext == "int8" else 0.0
            inputs = make_decode_inputs(K, B, seed=9, ebn0_db=1.0)
            ls, lp, _, _ = make_streams(inputs, K, W, types[chan], dev)
            T = ls.shape[0]
            la, ain = ck.siso_cells(
                ls, lp, torch.zeros((T, B), dtype=types[ext], device=dev),
                K_real, mode, scale, window=W, ext_qscale=qs,
                nii_ckpt=torch.zeros((T // W, 8, B), device=dev))
            idx = torch.from_numpy(np.random.default_rng(T + B).permutation(
                T).astype(np.int32)).to(dev)
            for nii, fold in ck.CONTRACTS:
                name = ck.kernel_name(nii, mode, fold)
                gather = idx if fold else None
                if nii:
                    got, aout = ck.siso_cells(ls, lp, la, K_real, mode, scale,
                                              window=W, ext_qscale=qs,
                                              nii_ckpt=ain, gather_idx=gather)
                    want, aout_p = ck.siso_nii_plain(ls, lp, la, ain, K_real,
                                                     W, scale, qs, mode,
                                                     gather_idx=gather)
                    e_ck = max_diff(aout[1:], aout_p[1:])
                    same = torch.equal(aout[1:], aout_p[1:])
                    seg = ck.exact_segment(W)
                else:
                    got = ck.siso_cells(ls, lp, la, K_real, mode, scale,
                                        window=W, ext_qscale=qs)
                    want = ck.siso_exact_plain(ls, lp, la, K_real, W, scale,
                                               qs, mode)
                    e_ck, same, seg = 0.0, True, ck.exact_segment(T)
                err = max_diff(got, want)
                if not (same and torch.equal(got, want)):
                    raise AssertionError(
                        f"{name} differs from its plain version: le {err}, "
                        f"window starts {e_ck} at K={K} K_real={K_real} "
                        f"W={W} B={B} {chan}+{ext}")
                worst[name] = max(worst[name], err, e_ck)
                out.append({"name": name, "K": K, "K_real": K_real, "W": W,
                            "B": B, "n_win": T // W, "segments": T // seg,
                            "staged": B % 4 == 0, "chan": chan, "ext": ext,
                            "max_abs_err": max(err, e_ck)})
    return out


# the SISO columns the decoder counts beside its launches
SISO_COLUMNS = ("siso_columns.run", "siso_columns.full")


def count_launches(results, fn):
    """Run `fn` with the port's one launch count (`_device.LAUNCHES`) set to
    0 just before and read just after; add what it launched, but for the
    layout kernels (`layout.KERNELS`, which the callers of a decode read
    themselves through `layout_launches`), to the main path's totals.  Returns
    (fn's result, launches by kernel less the SISO1 calls the early-exit
    loop launched ahead of a read and dropped, `turbo_cells.DROPPED`: the
    launches that did an iteration's work, which the callers check).  The
    SISO columns the decoder counts beside its launches (`siso_columns.*`)
    are left out."""
    from turbotpu_torch import _device
    from turbotpu_torch.decoder import layout, turbo_cells
    turbo_cells.DROPPED.clear()
    _device.LAUNCHES.clear()
    out = fn()
    torch.cuda.synchronize()
    launched = collections.Counter({
        k: v for k, v in _device.LAUNCHES.items()
        if k not in layout.KERNELS and k not in SISO_COLUMNS})
    for name, n in launched.items():
        results[name]["launches"] = results[name].get("launches", 0) + n
    return out, collections.Counter(
        {k: v - turbo_cells.DROPPED.get(k, 0) for k, v in launched.items()})


def crc_layout(n_iters):
    """The layout kernels of a decode with a shared table that ran n_iters
    iterations in `crc` mode (0: a lean decode): one `pack_kernel`; each
    iteration the live prefix's syndromes (`exit_kernel`), the unpack of
    the codewords that retire, its close and its moves; a lean decode one
    unpack."""
    return {"pack_kernel": 1, "unpack_kernel": n_iters or 1,
            "exit_kernel": n_iters, "exit_close_kernel": 0,
            "live_close_kernel": n_iters, "compact_kernel": n_iters}


def layout_launches(results):
    """The layout kernels' launches in the last `count_launches` call, each
    of `layout.KERNELS` (0 where none), added to the main path's totals."""
    from turbotpu_torch import _device
    from turbotpu_torch.decoder import layout
    lay = {name: _device.LAUNCHES[name] for name in layout.KERNELS}
    for name, n in lay.items():
        results[name]["launches"] = results[name].get("launches", 0) + n
    return lay


def only(launched, **expected):
    """Whether exactly the expected kernels were launched, each as often as
    expected."""
    return all(launched.get(name, 0) == expected.get(name, 0)
               for name in {*launched, *expected})


def small_decode_vs_cpu(cfg):
    """A small decode (64 codewords) on the card against the same decode
    through the plain versions on the CPU: hard bits and iteration counts
    identical, L within 1e-4.  Returns L's largest difference."""
    from turbotpu_torch import turbo_decode
    from turbotpu_torch.harness.bench import make_decode_inputs
    small = make_decode_inputs(cfg.K, 64, seed=3, ebn0_db=1.5, with_crc=True)
    got = turbo_decode(*small, cfg)
    ref = turbo_decode(*small, cfg, device="cpu")
    diff = float((got[2].cpu() - ref[2]).abs().max())
    if not (torch.equal(got[0].cpu(), ref[0])
            and torch.equal(got[1].cpu(), ref[1]) and diff <= 1e-4):
        raise AssertionError(f"small decode (fold_gather={cfg.fold_gather}) "
                             f"differs from the CPU reference: L {diff}")
    return diff


def layout_bytes(B, K, KTp, chan_bytes, ext_bytes, idx_bytes):
    """Least bytes each layout pass must move: pack_kernel (three fp32 (B, K)
    inputs and the tails read; ls1, lp1s, lp2s and ls2's tail and pad rows
    written), ls2's row gather (ls1's K rows read and written, its index
    read) and unpack_kernel (rows [0, K) of ls1, le1, le21 read; L fp32 and
    hard int8 written)."""
    pack = 3 * B * K * 4 + 2 * B * 6 * 4 + (4 * KTp - K) * B * chan_bytes
    gather = 2 * K * B * chan_bytes + idx_bytes
    unpack = K * B * (chan_bytes + 2 * ext_bytes) + B * K * (4 + 1)
    return pack, gather, unpack


# the chained cells' layout crossings: cell, B, K, KTp, interleaver table
LAYOUT_SHAPES = (("cb6144-b16384-lean", 16384, 6144, 6400, "shared"),
                 ("tb75376-n512-crc", 6656, 5824, 5888, "per_codeword"))


def check_layout(dev, results, shapes=LAYOUT_SHAPES):
    """The two layout kernels of csrc/layout.cu at the chained cells'
    shapes, as the main path calls them (bf16 streams, int8 extrinsics):
    `cb6144-b16384-lean` (B=16384, K=6144, KTp=6400, the shared QPP table)
    and `tb75376-n512-crc` (B=6656, K=5824, KTp=5888, time-major
    per-codeword tables).  Each wrapper's outputs against its plain version
    on the same card tensors, byte for byte; each timed against its plain
    chain with CUDA events (pack: the kernel, then ls2's row gather); bound
    by the bytes it must move at PEAK_BYTES_PER_S.  Returns the record of
    each shape; `results` takes the first shape's."""
    from turbotpu_torch.decoder import layout
    from turbotpu_torch.spec.qpp import qpp_perm

    def same_bytes(a, b):
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        as_int = {1: torch.int8, 2: torch.int16, 4: torch.int32}[
            a.element_size()]
        return torch.equal(a.view(as_int), b.view(as_int))

    dt, ext, deq = torch.bfloat16, torch.int8, 0.75 * 0.25
    out = []
    for cell, B, K, KTp, table in shapes:
        g = torch.Generator(device=dev).manual_seed(B + K)
        ls, lp1, lp2 = (torch.randn((B, K), generator=g, device=dev) * 8
                        for _ in range(3))
        t1, t2 = (torch.randn((B, 6), generator=g, device=dev) * 8
                  for _ in range(2))
        perm = torch.from_numpy(qpp_perm(K).astype(np.int64)).to(dev)
        if table == "per_codeword":     # every block of cell 3 has one K
            perm = perm[:, None].expand(K, B).contiguous()
        got = layout.pack_streams(ls, lp1, lp2, t1, t2, KTp, dt, perm)
        want = layout.pack_streams_plain(ls, lp1, lp2, t1, t2, KTp, dt, perm)
        if not all(same_bytes(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"pack_streams differs from its plain "
                                 f"version at {cell}'s shape")
        del want
        ls1, _, ls2, _ = got
        le1, le21 = (torch.randint(-127, 128, (KTp, B), generator=g,
                                   device=dev, dtype=ext) for _ in range(2))
        hard, L = layout.assemble_outputs(ls1, le1, le21, K, deq, ext)
        want_hard, want_L = layout.assemble_outputs_plain(ls1, le1, le21, K,
                                                          deq, ext)
        if not (same_bytes(L, want_L) and same_bytes(hard, want_hard)):
            raise AssertionError(f"assemble_outputs differs from its plain "
                                 f"version at {cell}'s shape")
        del hard, L, want_hard, want_L

        if perm.dim() == 1:
            row_gather = lambda: torch.index_select(ls1, 0, perm,
                                                    out=ls2[:K])
        else:
            row_gather = lambda: torch.gather(ls1, 0, perm, out=ls2[:K])
        pack_b, gather_b, unpack_b = layout_bytes(
            B, K, KTp, dt.itemsize, ext.itemsize, perm.numel() * 8)
        rec = {"cell": cell, "B": B, "K": K, "KTp": KTp, "table": table,
               "chan": "bfloat16", "ext": "int8", "equal": True,
               "pack_ms": time_launches(lambda: layout.pack_streams(
                   ls, lp1, lp2, t1, t2, KTp, dt, perm), 20),
               "pack_kernel_ms": time_launches(lambda: layout._pack_launch(
                   ls, lp1, lp2, t1, t2, KTp, dt), 20),
               "ls2_gather_ms": time_launches(row_gather, 20),
               "pack_plain_ms": time_launches(
                   lambda: layout.pack_streams_plain(
                       ls, lp1, lp2, t1, t2, KTp, dt, perm), 20),
               "pack_bound_ms": (pack_b + gather_b) / PEAK_BYTES_PER_S * 1e3,
               "unpack_ms": time_launches(lambda: layout.assemble_outputs(
                   ls1, le1, le21, K, deq, ext), 20),
               "unpack_plain_ms": time_launches(
                   lambda: layout.assemble_outputs_plain(
                       ls1, le1, le21, K, deq, ext), 20),
               "unpack_bound_ms": unpack_b / PEAK_BYTES_PER_S * 1e3}
        out.append(rec)
        del got, ls1, ls2, le1, le21, ls, lp1, lp2, perm
        torch.cuda.empty_cache()

    first = out[0]
    shape = {k: first[k] for k in ("cell", "B", "K", "KTp", "table", "chan",
                                   "ext")}
    results["pack_kernel"].update(
        max_abs_err=0.0, ms=first["pack_ms"], plain_ms=first["pack_plain_ms"],
        bound_ms=first["pack_bound_ms"], bound_by="bytes", shape=shape,
        pass_ms={"pack_kernel": first["pack_kernel_ms"],
                 "ls2_gather": first["ls2_gather_ms"]})
    results["unpack_kernel"].update(
        max_abs_err=0.0, ms=first["unpack_ms"],
        plain_ms=first["unpack_plain_ms"], bound_ms=first["unpack_bound_ms"],
        bound_by="bytes", shape=shape)
    return out


def exit_bytes(B, K, KTp, chan_bytes, ext_bytes, n_done):
    """Least bytes one call of the CRC early exit must move: rows [0, K) of
    ls1, le1 and le21 read for each live codeword, both carries read and
    written on all KTp rows for each codeword done before, the check masks
    read, done, iters and the syndrome read and written."""
    live = B - n_done
    return (live * K * (chan_bytes + 2 * ext_bytes)
            + n_done * KTp * 4 * ext_bytes + K * 4 + 2 * B * (1 + 4 + 4))


# both transport-block cells decode 512 TBs of 13 blocks of K=5824 a batch
# (B=6656, KTp=5888 at W=256, bf16 channel, int8 extrinsics, CRC-24B); the
# shares of codewords done before an iteration at which the exit is timed
EXIT_SHAPE = (6656, 5824, 5888)
EXIT_DONE = (0.0, 0.5, 0.9)


def check_exit(dev, results, shape=EXIT_SHAPE, shares=EXIT_DONE):
    """The CRC early exit of csrc/layout.cu (`exit_kernel`, then
    `exit_close_kernel`) at the transport-block cells' shape, as the main
    path calls it: for each share of codewords done before the call, the
    wrapper's carries, done, iters and flag against the plain version's on
    the same card tensors, byte for byte, both with the natural carry (one
    tensor as le21_nat and le21_new) and the folded one; each timed against
    the plain chain over 20 calls between CUDA events (and its two launches
    without the wrapper's checks), beside its byte bound at
    PEAK_BYTES_PER_S.  Returns the record of each share; `results` takes
    the first (every codeword live: the first iteration)."""
    from turbotpu_torch.decoder import layout
    from turbotpu_torch.harness.profiling import compiled_stats
    from turbotpu_torch.spec.crc import CRC24B_POLY

    B, K, KTp = shape
    dt, ext, deq, poly = torch.bfloat16, torch.int8, 0.75 * 0.25, CRC24B_POLY
    g = torch.Generator(device=dev).manual_seed(B + K)
    ls1 = (torch.randn((KTp, B), generator=g, device=dev) * 8).to(dt)
    le1, le21, le1n, le2 = (torch.randint(-127, 128, (KTp, B), generator=g,
                                          device=dev, dtype=ext)
                            for _ in range(4))
    # a third of the codewords have the all-zero word's L (which passes)
    ls1[:, ::3] = 1.0
    le1n[:, ::3] = 0
    le2[:, ::3] = 0
    le2_nat = le2.flip(0)               # a de-interleave, for the fold case
    scratch = layout.crc_exit_scratch(B, dev)
    out = []
    for share in shares:
        done = torch.rand((B,), generator=g, device=dev) < share
        iters = torch.randint(0, 6, (B,), generator=g, device=dev,
                              dtype=torch.int32)
        for carry in ("natural", "fold"):
            nat = le2 if carry == "natural" else le2_nat
            want = layout.crc_exit_plain(ls1, le1, le21, le1n, nat, le2,
                                         done, iters, K, deq, ext, poly)
            a1, a2, d, it = (x.clone() for x in (le1n, le2, done, iters))
            got = layout.crc_exit(ls1, le1, le21, a1,
                                  a2 if carry == "natural" else nat, a2, d,
                                  it, K, deq, ext, poly, scratch)
            if not all(same(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"crc_exit differs from its plain "
                                     f"version at {share:.0%} done "
                                     f"({carry} carry)")
            if bool(scratch[0].any()):
                raise AssertionError("crc_exit left its syndrome non-zero")
        # the state after the call, in place on the card; random bits fail
        # the CRC, so repeated calls keep it
        a1, a2, d, it = got[:4]
        n_done = int(d.sum())
        rec = {"B": B, "K": K, "KTp": KTp, "chan": "bfloat16", "ext": "int8",
               "done_share": share, "done": n_done,
               "passed_now": n_done - int(done.sum()), "equal": True,
               "ms": time_launches(lambda: layout.crc_exit(
                   ls1, le1, le21, a1, a2, a2, d, it, K, deq, ext, poly,
                   scratch), 20),
               "launch_ms": time_launches(lambda: layout._exit_launch(
                   ls1, le1, le21, a1, a2, a2, d, it,
                   layout._masks_on(K, poly, dev), *scratch, K, deq, ext),
                   20),
               "plain_ms": time_launches(lambda: layout.crc_exit_plain(
                   ls1, le1, le21, le1n, le2, le2, done, iters, K, deq, ext,
                   poly), 20),
               "bound_ms": exit_bytes(B, K, KTp, dt.itemsize, ext.itemsize,
                                      n_done) / PEAK_BYTES_PER_S * 1e3}
        out.append(rec)
    del ls1, le1, le21, le1n, le2, le2_nat, a1, a2, want, got
    torch.cuda.empty_cache()
    stats = [{k: f[k] for k in ("function", "registers", "spill_stores",
                                "spill_loads", "stack", "smem")}
             for f in compiled_stats(layout.TARGET)
             if "exit" in f["function"]]
    first = out[0]
    shape_rec = {k: first[k] for k in ("B", "K", "KTp", "chan", "ext")}
    results["exit_kernel"].update(
        max_abs_err=0.0, ms=first["ms"], plain_ms=first["plain_ms"],
        bound_ms=first["bound_ms"], bound_by="bytes", shape=shape_rec,
        at_done_share={r["done_share"]: {k: r[k] for k in (
            "ms", "launch_ms", "plain_ms", "bound_ms")} for r in out},
        ptxas=stats)
    results["exit_close_kernel"].update(
        max_abs_err=0.0, ms=None, plain_ms=None, bound_ms=None,
        bound_by="bytes", shape=shape_rec)
    return out


def compact_bytes(src, hole, KTp, n_win, chan_bytes, ext_bytes):
    """Least bytes one `compact_kernel` call moves for the (source, hole)
    pairs: one element a row of every working array (the four channel
    streams and the carry of KTp rows, the two window tables of n_win x 8)
    read at each source and written at each hole, and the pairs read; and
    the bytes of the 32-byte sectors those elements lie in (each row's
    sectors that hold a source read once, those that hold a hole written
    once), which the scattered columns cost at least."""
    rows = ((4 * KTp, chan_bytes), (KTp, ext_bytes), (2 * n_win * 8, 4))
    least = len(src) * (2 * sum(r * b for r, b in rows) + 8)
    sectors = sum(r * 32 * sum(len(torch.unique(c // (32 // b)))
                              for c in (src, hole)) for r, b in rows)
    return least, sectors + 8 * len(src)


# the live prefix at the cells' shape: n0 = 6/7 of the columns live, of
# which these shares pass the CRC, and the last iteration (every one
# retires) at the middle share
LIVE_CASES = ((0.0, False), (0.33, False), (0.9, False), (0.33, True))


def check_live(dev, results, shape=EXIT_SHAPE, cases=LIVE_CASES):
    """The live prefix of the `crc` loop with a shared table (csrc/
    layout.cu: `exit_kernel` with a count, `unpack_kernel` over the
    prefix, `live_close_kernel`, `compact_kernel`) at the transport-block
    cells' shape (bf16 channel, int8 extrinsics, NII windows of 256), as
    the loop calls them: a prefix of n0 = 6/7 B columns holding a random
    choice of codewords, of which about `share` have channel LLRs of the
    all-zero word that outweigh the extrinsics (they pass).  For each case
    `live_syndromes`, `retire_outputs` and `live_compact` against their
    plain versions on copies of the same card tensors, byte for byte (the
    syndromes, the retired codewords' rows of hard and L and the rest
    untouched, done, iters, col, the state, the moves, every working
    array); each kernel's device time from a trace of 20 calls on the same
    operands, beside the plain chain's time (CUDA events) and the byte
    bound at PEAK_BYTES_PER_S.  Then a SISO call on a live count below its
    grid's bound against the same call on the narrowed columns, byte for
    byte, in both contracts, and its time at three counts.  Returns the records; `results` takes the 33% case's."""
    import tempfile

    from turbotpu_torch import _device
    from turbotpu_torch.decoder import layout
    from turbotpu_torch.harness import profiling
    from turbotpu_torch.harness.profiling import compiled_stats
    from turbotpu_torch.siso.cuda_kernel import siso_cells
    from turbotpu_torch.spec.crc import CRC24B_POLY

    B, K, KTp = shape
    W = 256
    n_win = KTp // W
    dt, ext, deq, poly = torch.bfloat16, torch.int8, 0.75 * 0.25, CRC24B_POLY
    n0 = B - B // 7
    g = torch.Generator(device=dev).manual_seed(B + K + 25)
    chan = lambda: (torch.randn((KTp, B), generator=g, device=dev) * 8).to(dt)
    codes = lambda: torch.randint(-127, 128, (KTp, B), generator=g,
                                  device=dev, dtype=ext)
    table = lambda: torch.randn((n_win, 8, B), generator=g, device=dev)
    base = (chan(), chan(), chan(), chan(), codes(), table(), table())
    le1 = codes()
    out = []
    for share, last in cases:
        col = torch.randperm(B, generator=g, device=dev).to(torch.int32)
        passing = (torch.rand((n0,), generator=g, device=dev)
                   < share).nonzero()[:, 0]      # working columns
        moved0 = tuple(x.clone() for x in base)
        moved0[0][:K, passing] = 4096.0     # outweighs the extrinsics
        done0 = torch.ones((B,), dtype=torch.bool, device=dev)
        done0[col[:n0].long()] = False
        iters0 = torch.randint(0, 6, (B,), generator=g, device=dev,
                               dtype=torch.int32)
        live0 = layout.live_prefix(B, dev)
        live0.col.copy_(col)
        live0.state[0] = n0
        outs0 = (torch.zeros((B, K), dtype=torch.int8, device=dev),
                 torch.full((B, K), -1.0, device=dev))

        def fresh():
            moved = tuple(x.clone() for x in moved0)
            return (moved, done0.clone(), iters0.clone(),
                    layout.LivePrefix(*(x.clone() for x in live0)),
                    tuple(x.clone() for x in outs0))

        def run(state, plain):
            moved, done, iters, live, (hard, L) = state
            ls1, le21 = moved[0], moved[4]
            if plain:
                layout.live_syndromes_plain(ls1, le1, le21, K, deq, ext,
                                            poly, live)
                synd = live.synd.clone()
                layout.retire_outputs_plain(hard, L, ls1, le1, le21, K, deq,
                                            ext, live, last)
                layout.live_compact_plain(done, iters, live, moved, last)
            else:
                layout.live_syndromes(ls1, le1, le21, K, deq, ext, poly,
                                      live, n0)
                synd = live.synd.clone()
                layout.retire_outputs(hard, L, ls1, le1, le21, K, deq, ext,
                                      live, n0, last)
                layout.live_compact(done, iters, live, moved, last)
            return synd

        want, got = fresh(), fresh()
        synd_w = run(want, True)
        before = collections.Counter(_device.LAUNCHES)
        synd_g = run(got, False)
        torch.cuda.synchronize()
        launched = {k: _device.LAUNCHES[k] - before[k]
                    for k in layout.KERNELS}
        if launched != {"pack_kernel": 0, "unpack_kernel": 1,
                        "exit_kernel": 1, "exit_close_kernel": 0,
                        "live_close_kernel": 1, "compact_kernel": 1}:
            raise AssertionError(f"the live prefix's passes launched "
                                 f"{launched}")
        stay, n_ret, n_mv = (int(x) for x in want[3].state)
        pairs = [want[0], got[0]]
        checks = {
            "syndromes": same(synd_g[:n0], synd_w[:n0]),
            "state": same(got[3].state, want[3].state),
            "done": same(got[1], want[1]), "iters": same(got[2], want[2]),
            "col": same(got[3].col[:stay], want[3].col[:stay]),
            "moves": same(got[3].lists[:, :n_mv], want[3].lists[:, :n_mv]),
            "synd_zero": not bool(got[3].synd.any()),
            "hard": same(got[4][0], want[4][0]),
            "L": same(got[4][1].view(torch.int32), want[4][1].view(
                torch.int32)),
            "working_set": all(same(a.view(torch.uint8), b.view(torch.uint8))
                               for a, b in zip(*pairs))}
        n_pass = int((synd_w[:n0] == 0).sum())
        if not all(checks.values()) or n_ret != (n0 if last else n_pass) \
                or stay != n0 - n_ret or (not last and n_pass < len(passing)):
            raise AssertionError(f"the live prefix differs from its plain "
                                 f"version at {share:.0%} passing (last "
                                 f"{last}): {checks}, state "
                                 f"{(stay, n_ret, n_mv)}, {n_pass} pass")

        # device time of each kernel: 20 calls, the operands restored
        # before each (so each call does the same work), the restores left
        # out by kernel name
        state = fresh()
        moved, done, iters, live, (hard, L) = state

        def restore():
            for x, x0 in zip(moved, moved0):
                x.copy_(x0)
            for x, x0 in zip(live, live0):
                x.copy_(x0)

        def once():
            restore()
            run(state, False)

        once()
        with tempfile.TemporaryDirectory() as tmp:
            with profiling.trace(tmp, host=False):
                for _ in range(20):
                    once()
            ops = profiling.device_ops(Path(tmp) / profiling.TRACE_FILE)
        dev_ms = collections.Counter()
        for name, _, dur in ops:
            dev_ms[kernel_id(name)] += dur / 1e3 / 20

        def plain_once():
            restore()
            run(state, True)

        src, hole = (x[:n_mv].long() for x in want[3].lists)
        least, sector = compact_bytes(src, hole, KTp, n_win, dt.itemsize,
                                      ext.itemsize)
        rec = {"B": B, "K": K, "KTp": KTp, "chan": "bfloat16",
               "ext": "int8", "share": share, "last": last, "n": n0,
               "passed": n_pass, "stay": stay, "retired": n_ret,
               "moves": n_mv, "equal": True,
               "ms": {k: dev_ms[k] for k in ("exit_kernel", "unpack_kernel",
                                             "live_close_kernel",
                                             "compact_kernel")},
               "plain_ms": time_launches(plain_once, 5)
               - time_launches(restore, 5),
               "bound_ms": {
                   "exit_kernel": exit_bytes(n0, K, KTp, dt.itemsize,
                                             ext.itemsize, 0)
                   / PEAK_BYTES_PER_S * 1e3,
                   "unpack_kernel": n_ret * K * (dt.itemsize
                                                 + 2 * ext.itemsize + 5)
                   / PEAK_BYTES_PER_S * 1e3,
                   "live_close_kernel": (n0 * (4 + 4 + 4 + 8 + 1)
                                         + n_mv * 16)
                   / PEAK_BYTES_PER_S * 1e3,
                   "compact_kernel": least / PEAK_BYTES_PER_S * 1e3},
               "compact_sector_bound_ms": sector / PEAK_BYTES_PER_S * 1e3}
        out.append(rec)
        del moved0, done0, iters0, live0, outs0, want, got, pairs, state
        del moved, done, iters, live, hard, L
        torch.cuda.empty_cache()
    del base, le1

    # a SISO call on a live count n below its grid's bound N against the
    # same call on the n narrowed columns, in both contracts
    ls, lp = chan(), chan()
    la = codes()
    ain = table()
    siso = []
    for nii in (True, False):
        kw = dict(window=W, ext_qscale=0.25, nii_ckpt=ain if nii else None)
        for count, N in ((n0 * 45 // 100, n0), (17, B)):
            cnt = torch.tensor([count], dtype=torch.int32, device=dev)
            got = siso_cells(ls, lp, la, K, "maxlog", 0.75, live=(cnt, N),
                             **kw)
            narrow = lambda x: x[..., :count].contiguous()
            want = siso_cells(narrow(ls), narrow(lp), narrow(la), K,
                              "maxlog", 0.75, **dict(
                                  kw, nii_ckpt=narrow(ain) if nii else None))
            got, want = (x if nii else (x, None) for x in (got, want))
            if not (same(got[0][:, :count], want[0]) and (
                    not nii or same(got[1][1:, :, :count], want[1][1:]))):
                raise AssertionError(f"a SISO call on a live count of "
                                     f"{count} (grid {N}, nii {nii}) "
                                     f"differs from the narrowed call")
        ms = {}
        for count in (B, B * 45 // 100, B // 10):
            cnt = torch.tensor([count], dtype=torch.int32, device=dev)
            ms[count] = time_launches(lambda: siso_cells(
                ls, lp, la, K, "maxlog", 0.75, live=(cnt, count), **kw), 20)
        siso.append({"nii": nii, "equal": True, "ms_at_count": ms})
    del ls, lp, la, ain
    torch.cuda.empty_cache()

    stats = [{k: f[k] for k in ("function", "registers", "spill_stores",
                                "spill_loads", "stack", "smem")}
             for f in compiled_stats(layout.TARGET)
             if f["function"] in ("live_close_kernel", "compact_kernel")]
    mid = out[1]
    shape_rec = {k: mid[k] for k in ("B", "K", "KTp", "chan", "ext", "n",
                                     "share", "moves")}
    for name in ("live_close_kernel", "compact_kernel"):
        results[name].update(
            max_abs_err=0.0, ms=mid["ms"][name], plain_ms=mid["plain_ms"],
            bound_ms=mid["bound_ms"][name], bound_by="bytes",
            shape=shape_rec,
            at_share={f"{r['share']}{' last' if r['last'] else ''}": {
                "ms": r["ms"][name], "bound_ms": r["bound_ms"][name],
                "moves": r["moves"]} for r in out},
            ptxas=[f for f in stats if f["function"] == name])
    results["compact_kernel"]["sector_bound_ms"] = \
        mid["compact_sector_bound_ms"]
    return {"prefix": out, "siso": siso}


def check_decode(dev, results):
    """Phase `decode`: the main path, with launch counts, and the layout
    kernels at the chained cells' shapes (`check_layout`)."""
    from turbotpu_torch import _device, turbo_decode
    from turbotpu_torch.harness.bench import flagship_config, make_decode_inputs

    K, B, ebn0 = 6144, 1024, 2.0
    inputs, bits = make_decode_inputs(K, B, seed=2, ebn0_db=ebn0,
                                      with_crc=True, return_bits=True)
    inputs = tuple(x.to(dev) for x in inputs)
    bits = torch.from_numpy(bits).to(dev)
    rec = {"K": K, "B": B, "ebn0_db": ebn0}

    (hard, iters, L), launched = count_launches(
        results, lambda: turbo_decode(*inputs, flagship_config()))
    rec["layout_launches"] = layout_launches(results)
    if not only(launched, siso_nii=12):
        raise AssertionError(f"lean decode: 12 siso_nii launches expected, "
                             f"counted {launched}")
    if rec["layout_launches"] != crc_layout(0):
        raise AssertionError(f"lean decode: one launch of each layout "
                             f"crossing and no exit expected, counted "
                             f"{rec['layout_launches']}")
    if hard.shape != (B, K) or L.shape != (B, K) or iters.shape != (B,):
        raise AssertionError("decode outputs have the wrong shape")
    if not bool(torch.isfinite(L).all()):
        raise AssertionError("lean decode: L is not finite")
    rec["lean_bit_errors"] = int((hard != bits).sum())
    rec["lean_iters"] = int(iters.max())

    (hard_c, iters_c, _), launched_c = count_launches(
        results, lambda: turbo_decode(*inputs,
                                      flagship_config(early_term="crc")))
    lay_c = layout_launches(results)
    rec["crc_bit_errors"] = int((hard_c != bits).sum())
    rec["crc_max_iters"] = int(iters_c.max())
    rec["crc_mean_iters"] = float(iters_c.float().mean())
    rec["crc_layout_launches"] = lay_c
    if lay_c != crc_layout(rec["crc_max_iters"]):
        raise AssertionError(f"crc decode: the live prefix's kernels once "
                             f"an iteration expected, counted {lay_c}")

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

    rec["small_vs_cpu_L_max_abs_diff"] = small_decode_vs_cpu(
        flagship_config(K=168, window=32, early_term="crc"))
    rec["small_exact_vs_cpu_L_max_abs_diff"] = small_decode_vs_cpu(
        flagship_config(K=168, window=32, early_term="crc", nii=False))
    del inputs, bits, hard, iters, L, hard_c, iters_c, hard_x
    torch.cuda.empty_cache()

    # a crc decode at the transport-block cells' size: the live prefix's
    # kernels once an iteration run, and nothing of the PyTorch chain; the
    # same decode on the same tables in per-codeword form runs the freezing
    # loop (the exit's two kernels once an iteration) to the same bytes
    B3, K3 = EXIT_SHAPE[:2]
    cfg3 = flagship_config(K=K3, early_term="crc")
    inputs3 = tuple(x.to(dev) for x in make_decode_inputs(
        K3, B3, seed=5, ebn0_db=1.0, with_crc=True))
    got3, launched3 = count_launches(
        results, lambda: turbo_decode(*inputs3, cfg3))
    lay3 = layout_launches(results)
    cols = {k: _device.LAUNCHES[k] for k in SISO_COLUMNS}
    iters3 = got3[1]
    n3 = int(iters3.max())
    per_cw = {name: torch.from_numpy(t.astype(np.int64)).expand(B3, -1)
              .to(dev) for name, t in (("perm_b", cfg3.perm()),
                                       ("inv_b", cfg3.inv()))}
    want3, launched_f = count_launches(
        results, lambda: turbo_decode(*inputs3, cfg3, **per_cw))
    lay_f = layout_launches(results)
    rec["cell_size_crc"] = {"K": K3, "B": B3, "max_iters": n3,
                            "mean_iters": float(iters3.float().mean()),
                            "launches": {k: v for k, v in launched3.items()
                                         if v},
                            "layout_launches": lay3, "siso_columns": cols,
                            "per_codeword_launches": {
                                k: v for k, v in launched_f.items() if v},
                            "per_codeword_layout_launches": lay_f}
    if not only(launched3, siso_nii=2 * n3) or lay3 != crc_layout(n3):
        raise AssertionError(f"crc decode at the cells' size: "
                             f"{rec['cell_size_crc']}")
    if not only(launched_f, siso_nii=2 * n3) or lay_f != {
            "pack_kernel": 1, "unpack_kernel": 1, "exit_kernel": n3,
            "exit_close_kernel": n3, "live_close_kernel": 0,
            "compact_kernel": 0}:
        raise AssertionError(f"crc decode with per-codeword tables at the "
                             f"cells' size: the exit's two kernels once an "
                             f"iteration expected: {rec['cell_size_crc']}")
    if not all(same(a, b) for a, b in zip(got3, want3)):
        raise AssertionError("crc decode at the cells' size: the live "
                             "prefix and the freezing loop differ")
    del inputs3, iters3, got3, want3, per_cw
    torch.cuda.empty_cache()
    rec["layout"] = check_layout(dev, results)
    rec["exit"] = check_exit(dev, results)
    rec["live"] = check_live(dev, results)
    emit("decode", **rec)


def run_bench(dev, card, results):
    """Phase `bench`: decoded Mbit/s of the flagship configuration."""
    from turbotpu_torch.harness.bench import (bench_decode, flagship_config,
                                              make_decode_inputs)
    K, B = 6144, 1024
    lean = bench_decode(flagship_config(), B, n_timed=8, ebn0_db=1.0)
    crc = bench_decode(flagship_config(early_term="crc"), B, n_timed=8,
                       ebn0_db=1.0)
    # the exact contract's decode: 12 launches of the window-parallel kernel
    exact = bench_decode(flagship_config(nii=False), B, n_timed=8, ebn0_db=1.0)
    # 1024 codewords are 32 warps at one thread per codeword: they cannot fill
    # 132 SMs.  One more line at 16 times the batch (the same 1024 noisy
    # frames tiled: a fixed-iteration decode's time does not depend on data).
    big_B = 16 * B
    tiled = tuple(x.repeat(16, 1)
                  for x in make_decode_inputs(K, B, seed=0, ebn0_db=1.0))
    big = bench_decode(flagship_config(), big_B, n_timed=2, inputs=tiled)
    emit("bench", card=card, lean=lean, crc=crc, lean_exact=exact,
         lean_large_batch=big,
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


def check_fold(dev, card, results):
    """Phase `fold`: the flagship decode with the interleave folded into the
    kernel (`DecoderConfig(fold_gather=True)`) against the same decode with
    the materialised gathers; both timed in turns; the row gather alone
    against `torch.index_select` (experiments/gather_inkernel.py); the
    corrected modes' folded kernels through the sweep."""
    from turbotpu_torch import turbo_decode
    from turbotpu_torch.decoder.turbo import DecoderConfig
    from turbotpu_torch.experiments import gather_inkernel as gi
    from turbotpu_torch.harness import ber
    from turbotpu_torch.harness.bench import (bench_decode, flagship_config,
                                              make_decode_inputs)
    from turbotpu_torch.siso.cuda_kernel import kernel_name
    from turbotpu_torch.spec.qpp import qpp_perm

    K, B, ebn0 = 6144, 1024, 1.0
    inputs = tuple(x.to(dev) for x in make_decode_inputs(
        K, B, seed=5, ebn0_db=ebn0, with_crc=True))
    rec = {"K": K, "B": B, "ebn0_db": ebn0, "card": card}
    for early in ("none", "crc"):
        ref = turbo_decode(*inputs, flagship_config(early_term=early))
        got, launched = count_launches(results, lambda: turbo_decode(
            *inputs, flagship_config(early_term=early, fold_gather=True)))
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(
                f"fold_gather=True changed the {early} decode: hard bits "
                f"{int((got[0] != ref[0]).sum())} differ, iterations "
                f"{int((got[1] != ref[1]).sum())}, L max abs diff "
                f"{float((got[2] - ref[2]).abs().max())}")
        n_it = 6 if early == "none" else int(got[1].max())
        if not only(launched, siso_nii_fold=2 * n_it):
            raise AssertionError(
                f"{early} decode with fold_gather: {2 * n_it} siso_nii_fold "
                f"launches and no other expected, counted {launched}")
        rec[f"{early}_launches"] = {k: v for k, v in launched.items() if v}
        rec[f"{early}_iters_max"] = n_it

    # Both variants timed in turns within this one call: plain, fold, fold,
    # plain.  The wide batch is the same 1024 noisy frames tiled 16 times.
    def timed(early, B_, n_timed, inp=None):
        out = {}
        for fold in (False, True, True, False):
            r = bench_decode(flagship_config(early_term=early,
                                             fold_gather=fold),
                             B_, n_timed=n_timed, ebn0_db=ebn0, inputs=inp)
            out.setdefault("fold" if fold else "materialised", []).append(
                r["wall_s_per_batch"] * 1e3)
        return {k: {"ms_per_batch": v, "mbit_per_s":
                    B_ * K / (sum(v) / len(v)) / 1e3} for k, v in out.items()}
    rec["bench"] = {"lean": timed("none", B, 8), "crc": timed("crc", B, 8)}
    tiled = tuple(x.repeat(16, 1)
                  for x in make_decode_inputs(K, B, seed=0, ebn0_db=ebn0))
    rec["bench"]["lean_large_batch"] = timed("none", 16 * B, 2, tiled)
    del tiled

    # K7 alone, as the comparison experiments/gather_inkernel.py makes (back
    # to back and as a CUDA graph, in turns)
    gather, launched = count_launches(results, lambda: gi.main([]))
    if not only(launched, siso_nii=launched["siso_nii"],
                row_gather=launched["row_gather"]) or not launched["row_gather"]:
        raise AssertionError(f"gather_inkernel launched {launched}")
    rec["gather_inkernel"] = gather
    T = gather["T"]
    main_row = next(r for r in gather["rows"] if (r["B"], r["dtype"], r["index"])
                    == (B, "int8", "qpp6144"))
    src = torch.randint(-127, 128, (T, B), device=dev, dtype=torch.int8)
    idx = torch.from_numpy(np.concatenate(
        [qpp_perm(K), np.arange(K, T)]).astype(np.int32)).to(dev)
    want = gi.row_gather_plain(src, idx)
    err = float((gi.row_gather(src, idx).float() - want.float()).abs().max())
    if err != 0.0:
        raise AssertionError(f"row_gather differs from its plain version: {err}")
    results["row_gather"].update(
        max_abs_err=err, ms=main_row["kernel_ms"],
        library_ms=main_row["index_select_ms"],
        device_ms=main_row["kernel_device_ms"],
        library_device_ms=main_row["index_select_device_ms"],
        plain_ms=time_launches(lambda: gi.row_gather_plain(src, idx), 20),
        bound_ms=(2 * T * B + 4 * T) / PEAK_BYTES_PER_S * 1e3,
        bound_by="bytes", shape={"T": T, "B": B, "dtype": "int8"})

    rec["small_vs_cpu_L_max_abs_diff"] = small_decode_vs_cpu(
        flagship_config(K=168, window=32, early_term="crc", fold_gather=True))

    # The corrected modes' folded kernels through the sweep's entry point: a
    # homogeneous UMTS K=5114 batch (the shape they are timed at), NII window
    # 256, fp32 streams, one batch of 128 frames at 1.0 dB.
    rec["sweep"] = []
    for mode in ("linlog", "logmap"):
        cfg = ber.SimConfig(
            name=f"umts5114_{mode}_nii_fold", K=5114, B=128, seed=6,
            max_frames=128, min_frame_errors=10 ** 9,
            decoder=DecoderConfig(
                K=5114, n_iters=8, mode=mode, interleaver="umts",
                early_term="crc", siso="cuda", nii=True, window=256,
                fold_gather=True))
        step = ber.make_step(cfg, dev)
        point, launched = count_launches(
            results, lambda: ber.simulate_point(cfg, 1.0, step))
        name = kernel_name(True, mode, fold=True)
        if not only(launched, **{name: 2 * point["iter_batches"]}):
            raise AssertionError(f"{cfg.name}: launches {launched}")
        if not (np.isfinite(point["fer"]) and point["fer"] < 0.25):
            raise AssertionError(f"{cfg.name}: FER {point['fer']} >= 0.25")
        rec["sweep"].append({k: point[k] for k in (
            "config", "frames", "frame_errs", "fer", "avg_iters",
            "iter_batches")})
    emit("fold", **rec)


def check_calibrate(dev, card, results):
    """Phase `calibrate`: the issue-rate kernel against its plain version,
    and the figures experiments/cost_breakdown.py makes of it."""
    from turbotpu_torch.experiments import cost_breakdown as cb
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    x = torch.rand((4 * 32,), generator=gen, device=dev) + 0.5
    worst = 0.0
    for lanes in cb.LANES:
        got = cb.issue_rate(x, lanes, 4096)
        want = cb.issue_rate_plain(x, lanes, 4096)
        worst = max(worst, float((got - want).abs().max()))
    if worst != 0.0:
        raise AssertionError(f"issue_rate differs from its plain version: "
                             f"{worst}")
    rec, launched = count_launches(results, lambda: cb.main([]))
    if not launched["issue_rate"]:
        raise AssertionError(f"cost_breakdown launched {launched}")
    # the kernel's line: full occupancy, 8 chains, at the size calibrated
    cal = rec["calibration"]
    n, lanes, n_ops = 2048 * cal["sms"], 8, cal["n_ops"]
    x = torch.ones((n,), dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    want = cb.issue_rate_plain(x, lanes, n_ops)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = float((cb.issue_rate(x, lanes, n_ops, threads=1024) - want
                 ).abs().max())
    if max(err, worst) != 0.0:
        raise AssertionError(f"issue_rate differs from its plain version at "
                             f"the calibrated size: {err}")
    ops = n * 2 * lanes * cb.chain_steps(n_ops, lanes)
    results["issue_rate"].update(
        max_abs_err=max(err, worst), ms=cal["shapes"]["full"][lanes]["ms"],
        plain_ms=plain_ms, bound_ms=ops / PEAK_FP32_INSTR_PER_S * 1e3,
        bound_by="operations",
        shape={"threads": n, "lanes": lanes, "n_ops": n_ops})
    emit("calibrate", **rec)


def stage_times(step, gen, esn0):
    """ms per batch of a sweep's stages, CUDA-event timed, for a step of
    harness.ber or harness.tb: encode (payload, CRC, segmentation, encoder,
    mux), channel (rate match, modulate, noise, demap, de-rate-match, embed:
    generation minus encode), decode, count (the error counters from the
    decoder's outputs)."""
    streams, sent = step.gen(gen, esn0)
    n = 3
    enc = time_launches(lambda: step.encode(gen), n)
    both = time_launches(lambda: step.gen(gen, esn0), n)
    dec = time_launches(lambda: step.decode(streams), n)
    hard, iters = step.decode(streams)
    cnt = time_launches(lambda: step.tally(hard, iters, sent), n)
    return {"encode_ms": enc, "channel_ms": both - enc, "decode_ms": dec,
            "count_ms": cnt}


# Transport-block error counts of the same grid points of C6 in
# results/tpu_accept.jsonl (TB errors, transport blocks).
REFERENCE_TBLER = {1.2: (21, 416), 1.4: (0, 4096)}


def run_tb(dev, card, results):
    """Phase `tb`: the transport-block sweep's entry point on C6 at full
    width (A=12000, two code blocks 6016/6080, G=24000, 32 blocks per batch),
    a cap each, and the host-side pipeline on one block."""
    from turbotpu_torch.experiments.run_acceptance import BAND_SIGMAS, fer_band
    from turbotpu_torch import transport
    from turbotpu_torch.configs.acceptance import C6_TB
    from turbotpu_torch.harness import tb

    step = tb.make_tb_step(C6_TB, dev)
    recs = []
    for ebn0, cap in ((1.2, 416), (1.4, 1024)):
        cfg = dataclasses.replace(C6_TB, max_tbs=cap, min_tb_errors=10 ** 9)
        esn0 = tb.tb_esn0_db(cfg, ebn0)
        # warm-up outside the timed point: encoder matrices, tables
        step.count(*step.gen(tb.point_generator(cfg, -1.0, dev), esn0))
        rec, launched = count_launches(
            results, lambda: tb.simulate_tb_point(cfg, ebn0, step))
        rec["launches"] = {k: v for k, v in launched.items() if v}
        rec["card"] = card
        # each batch combines its one transmission of each block: one
        # launch a block (C6's two blocks differ in K)
        combines = rec["tbs"] // C6_TB.n_tb * rec["C"] * len(rec["rvs"])
        for key in ("ber", "tbler", "avg_iters", "mbit_per_s", "wall_s"):
            if not np.isfinite(rec[key]):
                raise AssertionError(f"C6: {key} is not finite: {rec}")
        if rec["tbs"] != cap:
            raise AssertionError(f"C6: ran {rec['tbs']} transport blocks, "
                                 f"{cap} expected")
        if rec["launches"] != {"siso_exact": 2 * rec["iter_batches"],
                               "combine_kernel": combines}:
            raise AssertionError(f"C6: launches {rec['launches']} for "
                                 f"{rec['iter_batches']} batch-iterations")
        te_ref, n_ref = REFERENCE_TBLER[ebn0]
        diff, band = fer_band(rec["tb_errs"], cap, te_ref, n_ref)
        rec.update(reference_tb_errs=te_ref, reference_tbs=n_ref,
                   tbler_diff=diff, tbler_band=band)
        if diff > band:
            raise AssertionError(
                f"C6 at {ebn0} dB: TBLER {rec['tbler']:.4f} "
                f"({rec['tb_errs']}/{cap}) is outside +-{band:.4f} "
                f"({BAND_SIGMAS} sigma) of the recorded {te_ref}/{n_ref}")
        rec["stage_ms_per_batch"] = stage_times(
            step, tb.point_generator(cfg, 0.0, dev), esn0)
        recs.append(rec)
        emit("tb_point", **rec)

    # the host-side pipeline on one block made on the host: fp32 streams,
    # one decode per block size on the card
    A, G = C6_TB.A, C6_TB.G
    info = np.random.default_rng(8).integers(0, 2, A).astype(np.int8)
    llr, seg = transport.transmit_transport_block(info, 2.0, seed=8, G=G)
    (got, crc_ok, detail), launched = count_launches(
        results, lambda: transport.decode_transport_block(
            llr, seg.B, n_iters=C6_TB.n_iters, mode=C6_TB.mode, siso="cuda",
            rate_matched=True))
    host = {"A": A, "G": G, "crc_ok": crc_ok,
            "block_crc_ok": detail["block_crc_ok"],
            "iters": detail["iters"].tolist(),
            "bit_errors": int((got != info).sum()),
            "launches": {k: v for k, v in launched.items() if v}}
    if not (crc_ok and host["bit_errors"] == 0 and all(host["block_crc_ok"])
            and host["launches"] == {"siso_exact": 2 * sum(host["iters"])}):
        raise AssertionError(f"decode_transport_block: {host}")
    emit("tb", card=card, points=len(recs),
         tbs=sum(r["tbs"] for r in recs), host_pipeline=host)


# the PUSCH HARQ cell (tb75376-harq8-n512): transport block, slots a TTI,
# and the shares of the transmission indices of its slots
HARQ_CELL = dict(A=75376, G=86400, Qm=6, slots=512)
HARQ_MIX = (0.602, 0.367, 0.024, 0.006)


def harq_bytes(K, E, F, blocks, rv, new) -> float:
    """Least bytes of one combine of `blocks` blocks of (K, E, F) at each
    slot's redundancy version and new-data flag: the benchmark's count,
    perfbench/metrics/harq_combine_roofline.py::combine_bytes."""
    import importlib.util
    path = Path(__file__).resolve().parent / "perfbench" / "metrics" \
        / "harq_combine_roofline.py"
    spec = importlib.util.spec_from_file_location("harq_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.combine_bytes([(K, E, F)] * blocks, rv.cpu().numpy(),
                             new.cpu().numpy())


def check_harq(dev, card, results):
    """Phase `harq`: the combine kernel of csrc/harq.cu against its plain
    version on the same card tensors, byte for byte, at the PUSCH HARQ
    cell's two runs of blocks (K=5824, E=6642 x 4 blocks and 6648 x 9, 512
    slots), with rows of every redundancy version, new and retransmitted;
    timed at the cell's mix of transmissions against the plain version and
    the bound of its bytes; a receiver on the card over TTIs of two
    processes against the same receiver on the CPU (hard bits, verdicts,
    iterations and L equal), and its counts; then a receiver at the cell's
    size over TTIs of the cell's mix, each counted alone: one combine launch
    a run of blocks, the decode's SISO and layout launches, nothing else."""
    from turbotpu_torch import harq
    from turbotpu_torch.decoder.turbo import DecoderConfig
    from turbotpu_torch.harness.profiling import compiled_stats
    from turbotpu_torch.siso.cuda_kernel import kernel_name
    from turbotpu_torch.spec.crc import CRC24A_POLY, CRC24B_POLY
    from turbotpu_torch.spec.segmentation import segment_params

    def same_bytes(a, b):
        return torch.equal(a.view(torch.int32), b.view(torch.int32))

    def decoder(K, W, poly):
        return DecoderConfig(K=K, n_iters=6, mode="maxlog", ext_scale=0.75,
                             siso="cuda", io_dtype="bfloat16",
                             ext_dtype="int8", ext_qscale=0.25, nii=True,
                             window=W, early_term="crc", crc_poly=poly)

    A, G, Qm, n = (HARQ_CELL[k] for k in ("A", "G", "Qm", "slots"))
    bucket = max(segment_params(A + 24).sizes)
    cell_cfg = decoder(bucket, 256, CRC24B_POLY)
    # the cell's runs of blocks and tables, from one process's receiver
    cell_rx = harq.HarqReceiver(A, G, Qm, n, cell_cfg, processes=1,
                                device=dev)
    g = torch.Generator(device=dev).manual_seed(19)
    rvs = torch.tensor((0, 2, 3, 1), device=dev)
    shapes = []
    for (r0, r1, (K, E, F)), (table, period) in zip(cell_rx.runs,
                                                     cell_rx.tables):
        rows = (r1 - r0) * n
        llr = torch.randn((rows, E), generator=g, device=dev) * 4
        start = [torch.randn((rows, w), generator=g, device=dev)
                 for w in (bucket,) * 3 + (6, 6)]
        # every redundancy version, new and retransmitted, in one call
        rv = torch.arange(n, device=dev) % 4
        new = (torch.arange(n, device=dev) // 4) % 2 == 0
        got = tuple(x.clone() for x in start)
        want = tuple(x.clone() for x in start)
        harq.combine(got, llr, table, period, rv, new)
        harq.combine_plain(want, llr, table, period, rv, new)
        if not all(same_bytes(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"the combine kernel differs from its "
                                 f"plain version at K={K}, E={E}")
        # the cell's mix: transmission index i with share HARQ_MIX[i]
        k = torch.multinomial(torch.tensor(HARQ_MIX, device=dev), n,
                              replacement=True, generator=g)
        rv, new = rvs[k], k == 0
        nbytes = harq_bytes(K, E, F, r1 - r0, rv, new)
        rec = {"K": K, "E": E, "F": F, "rows": rows, "period": period,
               "equal": True, "new_share": float(new.float().mean()),
               "ms": time_launches(lambda: harq.combine(
                   got, llr, table, period, rv, new), 20),
               "plain_ms": time_launches(lambda: harq.combine_plain(
                   want, llr, table, period, rv, new), 5),
               "bytes": nbytes,
               "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3}
        rec["roofline_pct"] = 100 * rec["bound_ms"] / rec["ms"]
        shapes.append(rec)
        del llr, start, got, want
    del cell_rx
    torch.cuda.empty_cache()

    # a receiver on the card against one on the CPU: two processes, TTIs
    # of every redundancy version, one block of K=280 with 6 fillers
    cfg = decoder(280, 64, CRC24A_POLY)
    card_rx = harq.HarqReceiver(250, 600, 2, 16, cfg, processes=2,
                                device=dev)
    cpu_rx = harq.HarqReceiver(250, 600, 2, 16, cfg, processes=2,
                               device="cpu")
    gc = torch.Generator().manual_seed(23)
    for tti in range(8):
        llr = [torch.randn(16, 600, generator=gc) * 1.5 + 1.0]
        rv = rvs.cpu()[torch.arange(16) % 4 if tti >= 2 else
                       torch.zeros(16, dtype=torch.long)]
        new = (torch.arange(16) + tti) % 3 == 0 if tti >= 2 else \
            torch.ones(16, dtype=torch.bool)
        x = card_rx.receive(tti % 2, [llr[0].to(dev)], rv.to(dev),
                            new.to(dev))
        y = cpu_rx.receive(tti % 2, llr, rv, new)
        diff = max_diff(x["L"].cpu(), y["L"])
        for key in ("hard", "ok", "iters", "n_tx"):
            if not torch.equal(x[key].cpu(), y[key]) or diff > 1e-4:
                raise AssertionError(f"the receiver on the card differs from "
                                     f"the CPU's in {key} at TTI {tti} (L "
                                     f"{diff})")
    if card_rx.counts() != cpu_rx.counts():
        raise AssertionError(f"counts {card_rx.counts()} on the card, "
                             f"{cpu_rx.counts()} on the CPU")
    small_counts = card_rx.counts()
    del card_rx, cpu_rx

    # the main path at the cell's size: two processes, a TTI of new data on
    # each, a TTI of retransmissions at rv 2 on each, then two of the cell's
    # mix; the all-zero transport block (its CRCs are zero) sent as BPSK
    # LLRs at Es/N0 0 dB (mean 4, variance 8): a first transmission runs to
    # the cap, a buffer of two stops early.  Each TTI's launches counted
    # alone.
    rx = harq.HarqReceiver(A, G, Qm, n, cell_cfg, processes=2, device=dev)
    siso = kernel_name(True, "maxlog")
    per_tti = []
    for tti in range(6):
        k = (torch.full((n,), tti // 2, dtype=torch.long, device=dev)
             if tti < 4 else
             torch.multinomial(torch.tensor(HARQ_MIX, device=dev), n,
                               replacement=True, generator=g))
        rv, new = rvs[k], k == 0
        llr = [torch.randn(((r1 - r0) * n, E), generator=g, device=dev)
               * math.sqrt(8) + 4 for r0, r1, (_, E, _) in rx.runs]
        torch.cuda.synchronize()
        out, launched = count_launches(
            results, lambda: rx.receive(tti % 2, llr, rv, new))
        iters = int(out["iters"].max())
        want = {"combine_kernel": len(rx.runs), siso: 2 * iters}
        lay = layout_launches(results)
        per_tti.append({"tti": tti, "retx_share": float((~new).float().mean()),
                        "max_iters": iters, "ok_share": float(
                            out["ok"].float().mean()),
                        "launches": {k_: v for k_, v in launched.items() if v},
                        "layout_launches": lay})
        if not only(launched, **want) or lay != crc_layout(iters):
            raise AssertionError(f"the receiver at the cell's size, TTI "
                                 f"{tti}: {want}, one launch of each layout "
                                 f"crossing and the live prefix's kernels "
                                 f"an iteration expected, counted "
                                 f"{per_tti[-1]}")
    cell_counts = rx.counts()
    del rx, llr, out
    torch.cuda.empty_cache()
    stats = [{k: f[k] for k in ("function", "registers", "spill_stores",
                                "spill_loads", "stack", "smem")}
             for f in compiled_stats(harq.TARGET)]
    first = shapes[-1]
    results["combine_kernel"].update(
        max_abs_err=0.0, ms=first["ms"], plain_ms=first["plain_ms"],
        bound_ms=first["bound_ms"], bound_by="bytes")
    emit("harq", card=card, shapes=shapes, receiver_equal=True,
         counts=small_counts, cell_ttis=per_tti, cell_counts=cell_counts,
         ptxas=stats)


# C5 on the card: the reference's run_c5 defaults (K=6144, 4096 codewords,
# max-log, 6 iterations, bf16 streams, CRC early termination at 0.8 dB).
C5_K, C5_B, C5_EBN0 = 6144, 4096, 0.8


def check_k4(dev, results, inputs):
    """K4 against its plain version at difference 0 (le, the window table's
    slots 1.., the outgoing edges), in both contracts: every mode at C5's
    chunk shape (the last chunk of seq=2, bf16 channel and extrinsic
    streams; row offset C, so the mask cuts it at global row K; exact C=3200
    W=128, NII C=3328 W=256), with an alpha edge made by a call on the first
    chunk and a beta edge and an a-priori stream made by a cold call on the
    last, timed, max-log's two passes timed apart; max-log at the last chunk
    of seq=4 (C=1664, W=128), timed; every mode and stream pair at B=70
    (K=168, seq=2: chunks of 88 steps in eleven segments of 8; the register
    path) and at a chunk of one segment (K=120, seq=2: 64 steps, no first
    pass; the mask inside it).  Then the two e0 identities on the whole
    trellis at the flagship shape."""
    from turbotpu_torch.dist.seq_parallel import chunk_sizing
    from turbotpu_torch.harness.bench import flagship_config, make_decode_inputs
    from turbotpu_torch.siso import cuda_kernel as ck

    bf16, f32 = torch.bfloat16, torch.float32
    types = {"float32": f32, "bfloat16": bf16, "int8": torch.int8}

    def compare(nii, mode, ls, lp, K, n_seq, window, chan, ext, j=None):
        """Chunk j (the last by default) of ls/lp against its plain version;
        returns (errors, the call, its keyword arguments, plain seconds)."""
        C, W, n_win, KTp = chunk_sizing(K + 3, n_seq, window)
        j = n_seq - 1 if j is None else j
        B = ls.shape[1]
        scale = 0.75 if mode == "maxlog" else 1.0
        qs = 0.25 if ext == "int8" else 0.0
        first, cur = (ls[:C], lp[:C]), (ls[j * C:(j + 1) * C],
                                        lp[j * C:(j + 1) * C])
        uni = torch.zeros((8, B), dtype=f32, device=dev)
        z = torch.zeros((C, B), dtype=types[ext], device=dev)
        opt = dict(window=W, row_offset=j * C, ext_qscale=qs)
        _, a_edge, _ = ck.siso_cells(*first, z, K, mode, scale,
                                     boundaries=(ck._e0(B, dev), uni),
                                     window=W, ext_qscale=qs)
        la, _, b_edge = ck.siso_cells(*cur, z, K, mode, scale,
                                      boundaries=(uni, uni), **opt)
        if nii:
            tbl = ck.siso_cells(*cur, z, K, mode, scale, nii_boundaries=(
                torch.zeros((n_win, 8, B), device=dev), uni, uni), **opt)[1]
            kw = dict(opt, nii_boundaries=(tbl, a_edge, b_edge))
        else:
            kw = dict(opt, boundaries=(a_edge, b_edge))
        got = ck.siso_cells(*cur, la, K, mode, scale, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if nii:
            want = ck.siso_bnd_nii_plain(*cur, la, tbl, a_edge, b_edge, K, W,
                                         scale, qs, mode, row_offset=j * C)
        else:
            want = ck.siso_bnd_exact_plain(*cur, la, a_edge, b_edge, K, W,
                                           scale, qs, mode, row_offset=j * C)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        outs = ("le", "aout", "eout", "bout") if nii else ("le", "aout",
                                                           "bout")
        errs, same = {}, True
        for key, a, b in zip(outs, got, want):
            if key == "aout" and nii:
                a, b = a[1:], b[1:]     # slot 0 is never written
            errs[key] = max_diff(a, b)
            same = same and torch.equal(a, b)
        name = ck.kernel_name(nii, mode, bnd=True)
        if not same:
            raise AssertionError(
                f"{name} differs from its plain version at K={K} C={C} "
                f"W={W} B={B} offset={j * C} {chan}+{ext}: {errs}")
        case = {"name": name, "K": K, "C": C, "W": W, "B": B,
                "row_offset": j * C, "segments": C // ck.exact_segment(
                    W if nii else C), "chan": chan, "ext": ext, **errs}
        call = (lambda: ck.siso_cells(*cur, la, K, mode, scale, **kw))
        return case, (cur, la, K, mode, scale, kw), call, plain_s

    cases, other_shapes = [], []
    K, B = C5_K, C5_B
    for nii, window in ((False, 0), (True, 256)):
        C, W, n_win, KTp = chunk_sizing(K + 3, 2, window)
        ls1, lp1, _, _ = make_streams(inputs, K, W, bf16, dev, KTp=KTp)
        for mode in MODES:
            name = ck.kernel_name(nii, mode, bnd=True)
            case, args, call, plain_s = compare(nii, mode, ls1, lp1, K, 2,
                                                window, "bfloat16", "bfloat16")
            cases.append(case)
            results[name]["max_abs_err"] = max(
                results[name].get("max_abs_err", 0.0),
                *(v for k, v in case.items() if k in ("le", "aout", "eout",
                                                      "bout")))
            bound, by = siso_bound_ms(C, B, n_win, 2, 2, nii, False, mode,
                                      bnd=True)
            results[name].update(
                ms=time_launches(call, 10), plain_ms=plain_s * 1e3,
                bound_ms=bound, bound_by=by,
                shape={"K": K, "C": C, "W": W, "B": B, "chan": "bfloat16",
                       "ext": "bfloat16", "row_offset": C})
            if mode == "maxlog":
                cur, la, K_, mode_, scale, kw = args
                p1, p2 = ck.pass_launchers(*cur, la, K_, mode_, scale, **kw)
                results[name]["pass_ms"] = {"pass1": time_launches(p1, 10),
                                            "pass2": time_launches(p2, 10)}
    # the last chunk of seq=4, max-log exact
    C, W, n_win, KTp = chunk_sizing(K + 3, 4)
    ls1, lp1, _, _ = make_streams(inputs, K, W, bf16, dev, KTp=KTp)
    case, _, call, plain_s = compare(False, "maxlog", ls1, lp1, K, 4, 0,
                                     "bfloat16", "bfloat16")
    cases.append(case)
    bound, by = siso_bound_ms(C, B, n_win, 2, 2, False, False, bnd=True)
    other_shapes.append({**case, "ms": time_launches(call, 10),
                         "plain_ms": plain_s * 1e3, "bound_ms": bound,
                         "bound_by": by})
    # small shapes, every mode and stream pair, both contracts
    for K_s, B_s in ((168, 70), (120, 37)):
        C, W, n_win, KTp = chunk_sizing(K_s + 3, 2)
        small = make_decode_inputs(K_s, B_s, seed=13, ebn0_db=1.0)
        for chan, ext in (("bfloat16", "int8"), ("bfloat16", "bfloat16"),
                          ("float32", "float32")):
            ls1, lp1, _, _ = make_streams(small, K_s, W, types[chan], dev,
                                          KTp=KTp)
            for mode in MODES:
                for nii in (False, True):
                    for j in (0, 1):
                        case = compare(nii, mode, ls1, lp1, K_s, 2, 0, chan,
                                       ext, j)[0]
                        cases.append(case)
                        name = case["name"]
                        results[name]["max_abs_err"] = max(
                            results[name].get("max_abs_err", 0.0),
                            *(v for k, v in case.items()
                              if k in ("le", "aout", "eout", "bout")))

    # e0 edges, offset 0, the whole trellis: the exact and NII kernels
    K, W = flagship_config().K, flagship_config().window
    flag = make_decode_inputs(K, 1024, seed=1, ebn0_db=1.0)
    B = flag[0].shape[0]
    identities = []
    for ext in (torch.int8, bf16):
        qs = 0.25 if ext == torch.int8 else 0.0
        ls1, lp1, _, _ = make_streams(flag, K, W, bf16, dev)
        T = ls1.shape[0]
        e0 = ck._e0(B, dev)
        for mode in MODES:
            scale = 0.75 if mode == "maxlog" else 1.0
            z = torch.zeros((T, B), dtype=ext, device=dev)
            tbl0 = torch.zeros((T // W, 8, B), device=dev)
            la, tbl = ck.siso_cells(ls1, lp1, z, K, mode, scale, window=W,
                                    nii_ckpt=tbl0, ext_qscale=qs)
            x = ck.siso_cells(ls1, lp1, la, K, mode, scale, window=W,
                              ext_qscale=qs)
            xb = ck.siso_cells(ls1, lp1, la, K, mode, scale, window=W,
                               ext_qscale=qs, boundaries=(e0, e0))[0]
            n, n_tbl = ck.siso_cells(ls1, lp1, la, K, mode, scale, window=W,
                                     ext_qscale=qs, nii_ckpt=tbl)
            nb, nb_tbl, _, _ = ck.siso_cells(
                ls1, lp1, la, K, mode, scale, window=W, ext_qscale=qs,
                nii_boundaries=(tbl, e0, e0))
            if not (torch.equal(x, xb) and torch.equal(n, nb)
                    and torch.equal(n_tbl[1:], nb_tbl[1:])):
                raise AssertionError(f"the e0 identities fail for {mode} "
                                     f"with {ext} extrinsics")
            identities.append(f"{mode}+{str(ext)[6:]}")
    return {"cases": cases, "other_shapes": other_shapes,
            "e0_identities_bit_equal": identities,
            "kernels": {ck.kernel_name(nii, mode, bnd=True): {
                k: results[ck.kernel_name(nii, mode, bnd=True)].get(k)
                for k in ("max_abs_err", "ms", "pass_ms", "plain_ms",
                          "bound_ms", "bound_by")}
                for mode in MODES for nii in ck.BND_CONTRACTS}}


def check_seq(dev, card, results):
    """Phase `seq`: K4 against its plain version; the sharded decode at
    seq=1 against the monolithic one bit for bit; run_c5 at full width
    (seq=2 exact and NII window 256, seq=4); the K6 exchange against the
    ring shift; seq=2 against the monolithic decode of the same frames; a
    small decode against the CPU; the corrected modes through the same
    entry point; where a C5 iteration's time goes."""
    from turbotpu_torch.experiments.run_acceptance import fer_band
    from turbotpu_torch import turbo_decode
    from turbotpu_torch.dist.dma import boundary_exchange_dma
    from turbotpu_torch.dist.mesh import make_mesh
    from turbotpu_torch.dist.seq_parallel import (_chunked_crc_matrix,
                                                  decode_seq_sharded)
    from turbotpu_torch.experiments import seq_glue
    from turbotpu_torch.harness import c5
    from turbotpu_torch.harness.bench import flagship_config, make_decode_inputs
    from turbotpu_torch.siso import cuda_kernel as ck

    K, B = C5_K, C5_B
    bits_np, noisy = c5.make_batch(K, B, C5_EBN0, seed=0)
    inputs = tuple(torch.from_numpy(x).to(dev) for x in noisy)
    bits = torch.from_numpy(bits_np).to(dev)
    rec = {"card": card, "k4": check_k4(dev, results, inputs)}
    emit("seq_kernels", **rec["k4"])

    # seq=1 is the monolithic decode, bit for bit, at the flagship shape
    flag = tuple(x.to(dev) for x in make_decode_inputs(
        flagship_config().K, 1024, seed=2, ebn0_db=1.0, with_crc=True))
    one = make_mesh(1, 1, device=dev)
    rec["seq1_vs_monolithic"] = {}
    for early in ("none", "crc"):
        cfg = flagship_config(early_term=early)
        want = turbo_decode(*flag, cfg, device=dev)
        got, launched = count_launches(
            results, lambda: decode_seq_sharded(one, cfg)(*flag))
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"seq=1 {early} decode differs from the "
                                 f"monolithic one")
        n_it = int(got[1].max())
        if not only(launched, siso_bnd_nii=2 * n_it):
            raise AssertionError(f"seq=1 {early}: launches {launched}")
        rec["seq1_vs_monolithic"][early] = {"bit_equal": True,
                                            "iters_max": n_it}

    # run_c5 at full width: the entry point a user calls
    rec["run_c5"] = []
    for kw in (dict(seq=2), dict(seq=2, nii=True, window=256), dict(seq=4)):
        r, launched = count_launches(results, lambda: c5.run_c5(
            **kw, n_timed=4, verbose=False))
        name = ck.kernel_name(kw.get("nii", False), "maxlog", bnd=True)
        if set(k for k, v in launched.items() if v) != {name}:
            raise AssertionError(f"run_c5 {kw}: launches {launched}")
        for key in ("ber", "fer", "wall_s", "mbit_per_s"):
            if not np.isfinite(r[key]):
                raise AssertionError(f"run_c5 {kw}: {key} = {r[key]}")
        if r["mesh"] != {"data": 1, "seq": kw["seq"]} or r["fer"] >= 0.5:
            raise AssertionError(f"run_c5 {kw}: {r}")
        r["launches"] = {name: launched[name]}
        rec["run_c5"].append(r)
        emit("c5", **r)

    # the K6 exchange against the ring shift, on the same frames; seq=2
    # against the monolithic decode of them
    mesh = make_mesh(1, 2, device=dev)
    rec["dma_vs_ppermute"] = {}
    outs = {}
    for nii in (False, True):
        cfg = c5.c5_config(nii=nii, window=256 if nii else 0)
        ref = decode_seq_sharded(mesh, cfg)(*inputs)
        got, launched = count_launches(results, lambda: decode_seq_sharded(
            mesh, dataclasses.replace(cfg, boundary_xch="dma"))(*inputs))
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"dma and ppermute decodes differ "
                                 f"(nii={nii})")
        n_it = int(got[1].max())
        if launched["ring_xch"] != n_it:
            raise AssertionError(f"dma decode: {launched['ring_xch']} "
                                 f"ring_xch launches for {n_it} iterations")
        rec["dma_vs_ppermute"]["nii" if nii else "exact"] = {
            "bit_equal": True, "ring_xch_launches": launched["ring_xch"]}
        outs[nii] = ref
    # times per batch of the same frames, in turns within this call: the
    # sharded decode with the ring shift, with K6, and the monolithic decode
    rec["ms_per_batch"] = {}
    for nii in (False, True):
        cfg = c5.c5_config(nii=nii, window=256 if nii else 0)
        decs = {"seq2": decode_seq_sharded(mesh, cfg),
                "seq2_dma": decode_seq_sharded(
                    mesh, dataclasses.replace(cfg, boundary_xch="dma")),
                "monolithic": lambda *a: turbo_decode(*a, cfg, device=dev)}
        ms = {k: [] for k in decs}
        for k in ("seq2", "seq2_dma", "monolithic", "monolithic", "seq2_dma",
                  "seq2"):
            ms[k].append(time_launches(lambda: decs[k](*inputs), 5))
        rec["ms_per_batch"]["nii" if nii else "exact"] = ms
    mono = turbo_decode(*inputs, c5.c5_config(), device=dev)
    hard = outs[False][0]
    agree = float((hard == mono[0]).float().mean())
    fe = int((hard != bits).any(dim=1).sum())
    fe_m = int((mono[0] != bits).any(dim=1).sum())
    diff, band = fer_band(fe, B, fe_m, B)
    rec["seq2_vs_monolithic"] = {
        "hard_bit_agreement": agree, "frame_errs": fe,
        "frame_errs_monolithic": fe_m, "bit_errs": int((hard != bits).sum()),
        "bit_errs_monolithic": int((mono[0] != bits).sum()),
        "fer_diff": diff, "fer_band": band,
        "mean_iters": float(outs[False][1].float().mean()),
        "mean_iters_monolithic": float(mono[1].float().mean())}
    if not (agree > 0.99 and diff <= band):
        raise AssertionError(f"seq=2 against the monolithic decode: "
                             f"{rec['seq2_vs_monolithic']}")

    # small seq=2 decodes on the card against the same on the CPU
    small = make_decode_inputs(168, 64, seed=3, ebn0_db=1.5, with_crc=True)
    rec["small_vs_cpu_L_max_abs_diff"] = {}
    for nii in (False, True):
        cfg = flagship_config(K=168, window=16 if nii else 0, nii=nii,
                              early_term="crc")
        got = decode_seq_sharded(mesh, cfg)(*small)
        want = decode_seq_sharded(make_mesh(1, 2, device="cpu"), cfg)(*small)
        d = float((got[2].cpu() - want[2]).abs().max())
        if not (torch.equal(got[0].cpu(), want[0])
                and torch.equal(got[1].cpu(), want[1]) and d <= 1e-4):
            raise AssertionError(f"small seq=2 decode (nii={nii}) differs "
                                 f"from the CPU: L {d}")
        rec["small_vs_cpu_L_max_abs_diff"]["nii" if nii else "exact"] = d

    # the corrected modes through the same entry point: 256 of the frames,
    # two fixed iterations
    rec["modes"] = {}
    part = tuple(x[:256] for x in inputs)
    for mode in ("linlog", "logmap"):
        for nii in (False, True):
            cfg = dataclasses.replace(
                c5.c5_config(nii=nii, window=256 if nii else 0,
                             early_term="none", n_iters=2), mode=mode,
                ext_scale=None)
            (h, _, L), launched = count_launches(
                results, lambda: decode_seq_sharded(mesh, cfg)(*part))
            name = ck.kernel_name(nii, mode, bnd=True)
            if not only(launched, **{name: 8}) or not bool(
                    torch.isfinite(L).all()):
                raise AssertionError(f"{name} through the seq decode: "
                                     f"{launched}")
            rec["modes"][name] = {"bit_errs": int((h != bits[:256]).sum())}

    # where a C5 iteration's time goes (seq=2, exact, crc): each part timed
    # alone at the decode's shapes
    # the production pieces seq_glue times per shard
    pieces = seq_glue.shard_setup(K, 2, dev)
    C, cfg, xch = pieces.C, pieces.cfg, pieces.xch
    le = [torch.randn((C, B), device=dev).to(torch.bfloat16) for _ in range(2)]
    ls_c = [torch.randn((C, B), device=dev).to(torch.bfloat16)
            for _ in range(2)]
    G = torch.from_numpy(_chunked_crc_matrix(K, cfg.crc_poly, C, 2)).to(dev)
    edges = [torch.randn((8, B), device=dev) for _ in range(2)]
    payload = [torch.randn((2, 8, B), device=dev) for _ in range(2)]

    def syndrome():
        hard = [(x.float() + 0.75 * (a.float() + b.float())) < 0
                for x, a, b in zip(ls_c, le, le)]
        synd = mesh.seq_sum([h.T.float() @ G[j] for j, h in enumerate(hard)])
        return [(x % 2.0 == 0.0).all(dim=1) for x in synd]

    k4 = results[ck.kernel_name(False, "maxlog", bnd=True)]["ms"]
    split = {"k4_launch_ms": k4, "k4_launches": 4,
             "exchange_ms": time_launches(lambda: xch(le), 20),
             "exchanges": 2,
             "edge_ring_shift_ms": time_launches(
                 lambda: mesh.seq_ring(edges, edges), 20),
             # the K6 path: payloads copied into the send buffers, one
             # launch (the error flag is read once per decode, not here)
             "edge_ring_xch_ms": time_launches(
                 lambda: boundary_exchange_dma(payload, payload, mesh), 20),
             "syndrome_reduce_ms": time_launches(syndrome, 20)}
    split["sum_per_iteration_ms"] = (
        4 * k4 + 2 * split["exchange_ms"] + split["edge_ring_shift_ms"]
        + split["syndrome_reduce_ms"])
    r = rec["run_c5"][0]
    split["measured_per_iteration_ms"] = r["wall_s"] * 1e3 / r["max_iters"]
    rec["iteration_split"] = split
    emit("seq", **{k: v for k, v in rec.items() if k != "k4"})


def check_dist(dev, card, results):
    """Phase `dist`: K6 against its plain version and two torch.roll calls
    at C5's edge shape over 100 exchanges, the flags after them; K6 and the
    two torch.roll calls timed back to back and as CUDA graphs; a set error
    flag raising at the end of a sequence decode; the data-parallel decode
    and counts through NCCL with a world of one."""
    import os
    import tempfile

    import torch.distributed as tdist
    from turbotpu_torch import _device
    from turbotpu_torch.dist import dma
    from turbotpu_torch.dist.data_parallel import (count_errors_sharded,
                                                   decode_batch_sharded)
    from turbotpu_torch.dist.mesh import make_mesh
    from turbotpu_torch.dist.seq_parallel import decode_seq_sharded
    from turbotpu_torch.experiments.gather_inkernel import graph_ms
    from turbotpu_torch.harness.bench import flagship_config, make_decode_inputs

    rec = {"card": card}
    B, epochs = C5_B, 100
    shape = (2, 8, B)               # both SISOs' edges of one shard
    worst = 0.0
    for data, n_seq, n_ep in ((1, 2, epochs), (2, 4, 10)):
        mesh = make_mesh(data, n_seq, device=dev)   # fresh flags
        n = data * n_seq
        gen = torch.Generator(device=dev)
        gen.manual_seed(n)
        for epoch in range(n_ep):
            fwd = [torch.randn(shape, generator=gen, device=dev)
                   for _ in range(n)]
            bwd = [torch.randn(shape, generator=gen, device=dev)
                   for _ in range(n)]
            got = dma.boundary_exchange_dma(fwd, bwd, mesh)
            want = dma.boundary_exchange_plain(fwd, bwd, n_seq)
            # and the library's form: torch.roll within each data row
            rolled = [list(torch.roll(torch.stack(x).view(data, n_seq, *shape),
                                      k, 1).view(n, *shape))
                      for x, k in ((fwd, 1), (bwd, -1))]
            for a, b, c in zip(got[0] + got[1], want[0] + want[1],
                               rolled[0] + rolled[1]):
                worst = max(worst, float((a - b).abs().max()),
                            float((a - c).abs().max()))
        ring = dma.ring_buffers(mesh, n, shape, torch.float32)
        flags = ring.flags.tolist()
        # ready, arrivals, the error flag, every CTA's exchange count
        if (flags[:n] != [2 * n_ep] * n
                or flags[n:2 * n] != [2 * ring.ctas * n_ep] * n
                or flags[2 * n] != 0
                or flags[2 * n + 1:] != [n_ep] * (n * ring.ctas)):
            raise AssertionError(f"ring_xch flags after {n_ep} exchanges on "
                                 f"{data}x{n_seq}: {flags}")
        dma.check(mesh)
        rec[f"flags_{data}x{n_seq}"] = {"exchanges": n_ep, "ready": flags[:n],
                                        "arrived": flags[n:2 * n],
                                        "ctas_per_shard": ring.ctas}
    if worst != 0.0:
        raise AssertionError(f"ring_xch differs from its plain version: "
                             f"{worst}")

    # timed at C5's shape (one data row, seq=2), in turns: the launch alone
    # and two torch.roll calls on the stacked payloads, back to back (what a
    # caller waits, the host's enqueue included) and as a CUDA graph of 20
    # calls (the device's time alone; the graph's replays make real
    # exchanges, each CTA counting its own on the device); the plain
    # rotation on the host.
    mesh = make_mesh(1, 2, device=dev)
    ring = dma.ring_buffers(mesh, 2, shape, torch.float32)
    stacked = torch.randn((2,) + shape, device=dev)
    kernel = lambda: dma.launch(ring, 2)
    library = lambda: (torch.roll(stacked, 1, 0), torch.roll(stacked, -1, 0))
    turns = {"kernel": [], "library": [], "kernel_device": [],
             "library_device": []}
    for who, fn in (("kernel", kernel), ("library", library),
                    ("library", library), ("kernel", kernel)):
        turns[who].append(time_launches(fn, 100))
        turns[f"{who}_device"].append(
            graph_ms(fn, 20))
    ring_flags = ring.flags.tolist()
    made = ring_flags[2 * 2 + 1]
    if ring_flags[:2] != [2 * made] * 2 or ring_flags[2 * 2] != 0:
        raise AssertionError(f"ring_xch flags after the timing: {ring_flags}")
    dma.check(mesh)
    fwd, bwd = list(stacked), list(-stacked)
    t0 = time.perf_counter()
    for _ in range(100):
        dma.boundary_exchange_plain(fwd, bwd, 2)
    plain_ms = (time.perf_counter() - t0) * 10.0
    mean = lambda v: sum(v) / len(v)
    nbytes = 2 * 2 * 2 * stacked[0].numel() * 4   # 2 shards x 2 dirs, r + w
    results["ring_xch"].update(
        max_abs_err=worst, ms=mean(turns["kernel"]), plain_ms=plain_ms,
        library_ms=mean(turns["library"]),
        device_ms=mean(turns["kernel_device"]),
        library_device_ms=mean(turns["library_device"]),
        bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes",
        shape={"data": 1, "seq": 2, "payload": list(shape),
               "dtype": "float32", "ctas_per_shard": ring.ctas})
    rec["ring_xch_turns_ms"] = turns
    rec["ring_xch_exchanges_timed"] = made

    # a fault in an exchange is reported at the end of the decode that made
    # it: the error flag set by hand before a lean seq=2 decode with K6 (a
    # fresh mesh), which must run all its exchanges and then raise
    mesh = make_mesh(1, 2, device=dev)
    small = tuple(x.to(dev) for x in make_decode_inputs(168, 64, seed=8,
                                                        ebn0_db=1.5))
    cfg = flagship_config(K=168, window=0, nii=False, boundary_xch="dma")
    dma.ring_buffers(mesh, 2, (2, 8, 64), torch.float32).error.fill_(2)
    _device.LAUNCHES["ring_xch"] = 0
    try:
        decode_seq_sharded(mesh, cfg)(*small)
    except RuntimeError as e:
        raised = str(e)
    else:
        raise AssertionError("a set ring_xch error flag did not raise at the "
                             "end of the sequence decode")
    torch.cuda.synchronize()
    n_xch = _device.LAUNCHES["ring_xch"]
    if n_xch != cfg.n_iters or "never landed" not in raised:
        raise AssertionError(f"the error flag raised after {n_xch} of "
                             f"{cfg.n_iters} exchanges: {raised}")
    rec["error_flag_raises_at_decode_end"] = {
        "exchanges_before": n_xch, "message": raised}

    # data_parallel through NCCL with a world of one: a FileStore in a
    # temporary directory, no network
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    cfg = flagship_config(early_term="crc")
    inputs, bits = make_decode_inputs(cfg.K, 1024, seed=6, ebn0_db=0.6,
                                      with_crc=True, return_bits=True)
    local = make_mesh(1, 1, device=dev)
    want = decode_batch_sharded(local, cfg)(*inputs)
    want_counts = [int(x) for x in count_errors_sharded(local)(want[0], bits)]
    with tempfile.TemporaryDirectory() as tmp:
        tdist.init_process_group(
            "nccl", store=tdist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            pmesh = make_mesh(1, 1, backend="process", device=dev)
            got, launched = count_launches(results, lambda: decode_batch_sharded(
                pmesh, cfg)(*inputs))
            counts = [int(x) for x in count_errors_sharded(pmesh)(got[0], bits)]
        finally:
            tdist.destroy_process_group()
    if not (all(torch.equal(a, b) for a, b in zip(got, want))
            and counts == want_counts):
        raise AssertionError(f"data_parallel over NCCL: counts {counts}, "
                             f"local {want_counts}")
    rec["data_parallel_nccl"] = {"world": 1, "bit_errs": counts[0],
                                 "frame_errs": counts[1],
                                 "launches": {k: v for k, v in
                                              launched.items() if v}}
    emit("dist", **rec)


def run_compact(dev, card, results):
    """Phase `compact`: convergence compaction against the single-stage
    decode on the same frames (flagship configuration with CRC early
    termination, 8 batches of 1024, stage 1 capped at 3 iterations, at two
    operating points), and one point of C2 through the plain, the compacted
    and the flushing sweep."""
    from turbotpu_torch.configs import acceptance as acc
    from turbotpu_torch.harness import ber
    from turbotpu_torch.harness.bench import flagship_config
    from turbotpu_torch.harness.compact import bench_compaction

    # 1.0 dB with stage 1 capped at 3: the flagship's operating point, where
    # most frames need a fourth iteration.  1.6 dB with the same cap: few
    # frames are deferred, which is where the schedule is meant to save work.
    for ebn0 in (1.0, 1.6):
        rec, launched = count_launches(results, lambda: bench_compaction(
            flagship_config(early_term="crc"), 1024, ebn0, n_super=8,
            stage1_iters=3))
        rec["launches"] = {k: v for k, v in launched.items() if v}
        rec["card"] = card
        # the contract: the same frames give the same counts
        if (rec["bit_errs"], rec["frame_errs"]) != (rec["bit_errs_single"],
                                                    rec["frame_errs_single"]):
            raise AssertionError(f"compaction changed the counts: {rec}")
        if set(rec["launches"]) != {"siso_nii"}:
            raise AssertionError(f"compaction launched {rec['launches']}")
        for key in ("wall_compacted_s", "wall_single_s",
                    "mbit_per_s_compacted", "mbit_per_s_single"):
            if not (np.isfinite(rec[key]) and rec[key] > 0):
                raise AssertionError(f"compaction: {key} = {rec[key]}")
        rec["compaction_saves_batch_iterations"] = (
            rec["iter_batches_compacted"] < rec["iter_batches_single"])
        emit("compact_bench", **rec)

    # C2 at 0.8 dB, 1024 frames: three sweeps, one frame budget
    cfg = dataclasses.replace(acc.C2, max_frames=1024,
                              min_frame_errors=10 ** 9)
    step = ber.make_step(cfg, dev)
    sweeps = {}
    for name, kw in (("plain", {}), ("compact", dict(compact_stage1=3)),
                     ("compact_flush", dict(compact_stage1=3,
                                            compact_flush=4))):
        point, launched = count_launches(
            results, lambda: ber.simulate_point(cfg, 0.8, step, **kw))
        if launched["siso_exact"] != 2 * point["iter_batches"] and not kw:
            raise AssertionError(f"C2 {name}: launches {launched}")
        if not launched["siso_exact"]:
            raise AssertionError(f"C2 {name}: no kernel launched")
        sweeps[name] = {k: point.get(k) for k in (
            "frames", "bit_errs", "frame_errs", "avg_iters", "iter_batches",
            "n_stage2_batches", "deferred_frac", "wall_s", "mbit_per_s")}
        sweeps[name]["siso_exact_launches"] = launched["siso_exact"]
    counts = lambda r: (r["frames"], r["bit_errs"], r["frame_errs"])
    if not (counts(sweeps["plain"]) == counts(sweeps["compact"])
            == counts(sweeps["compact_flush"])):
        raise AssertionError(f"the three sweeps' counts differ: {sweeps}")
    emit("compact", card=card, config=cfg.name, ebn0_db=0.8, sweeps=sweeps)


def run_ber(dev, card, results):
    """Phase `ber`: the sweep's entry point on the acceptance configurations
    at full width, a frame cap each."""
    from turbotpu_torch.experiments.run_acceptance import BAND_SIGMAS, fer_band
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
        (acc.C1, 2.0, 256, None, None),
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
            rec["stage_ms_per_batch"] = stage_times(
                step, ber.point_generator(cfg, 0.0, dev), esn0)
        recs.append(rec)
        emit("ber_point", **rec)
    emit("ber", card=card, points=len(recs),
         frames=sum(r["frames"] for r in recs),
         seconds=sum(r["wall_s"] for r in recs))


# ---------------------------------------------------------------------------
# fp8 extrinsics, the profile, the SISO variants, the harness, the sanitizer
# ---------------------------------------------------------------------------

FP8 = torch.float8_e4m3fn
CHANS = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# (K, window, B) of the flagship decode and of C3's batch (fp32 streams,
# UMTS K=5114, NII window 256), as the phases below use them
FLAG = (6144, 256, 1024)
C3_SHAPE = (5114, 256, 128)


def same(a, b) -> bool:
    """Bit equality; a float8 tensor compares as its bytes."""
    if a.dtype == FP8:
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    return torch.equal(a, b)


def fp8_replaces(mode: str, fold: bool, bnd: bool) -> str:
    """The TPU kernel an fp8 library replaces: _make_kernel with float8
    extrinsic streams (_quantize_le :148-165 on the le store)."""
    if bnd:
        base = (f"{_PALLAS}:167 (_make_kernel boundary=True, nii=False and "
                f"True, with_offset; specs :532-539, pallas_call at :576)")
    elif fold:
        base = (f"{_PALLAS}:505 (_build_call nii=True, fold_gather=True, "
                f"pallas_call at :570)")
    else:
        base = (f"{_PALLAS}:505 (_build_call nii=True and False, pallas_call "
                f"at :576)")
    base += (" with ext_dtype=float8_e4m3fn (_quantize_le :148-165)")
    if mode == "maxlog":
        return base
    return f"{_PALLAS}:57 (_mstar/_mstar_tree, mode={mode}) inside {base}"


def fp8_libraries():
    """(name, chan, mode, fold, bnd) of the eighteen fp8 libraries."""
    from turbotpu_torch.siso import cuda_kernel as ck
    return [(ck.kernel_name(True, mode, fold, bnd, dt, ck.FP8), chan, mode,
             fold, bnd) for fold, bnd in ck.FORMS for chan, dt in CHANS.items()
            for mode in MODES]


def check_fp8(dev, card, results):
    """Phase `fp8`: the eighteen float8-extrinsic libraries of siso.cu
    against their plain versions at difference 0 (le codes, window starts,
    edges) at the shapes the int8 and bf16 rows use (K1/K5 bf16 at the
    flagship shape, the f32 libraries at C3's, K4 at C5's seq=2 chunks),
    timed there; at B=70 and 45, in one window and one segment, with masked
    rows, and K4 at a chunk of one segment.  Then the main paths: the
    flagship decode with fp8 extrinsics (lean and crc, bits and launches,
    equal to its plain path on a small batch, timed beside int8 in turns),
    every library through the entry points (turbo_decode NII, exact and
    fold_gather; decode_seq_sharded seq=2 exact and NII) and one `cli c5
    --ext-dtype float8_e4m3fn` run held to the bf16 run's frame errors."""
    from turbotpu_torch.experiments.run_acceptance import fer_band
    import contextlib
    import io

    from turbotpu_torch import cli, turbo_decode
    from turbotpu_torch.decoder.turbo import DecoderConfig
    from turbotpu_torch.dist.mesh import make_mesh
    from turbotpu_torch.dist.seq_parallel import (chunk_sizing,
                                                  decode_seq_sharded)
    from turbotpu_torch.harness import c5
    from turbotpu_torch.harness.bench import (bench_decode, flagship_config,
                                              make_decode_inputs)
    from turbotpu_torch.siso import cuda_kernel as ck
    from turbotpu_torch.spec.qpp import qpp_perm
    from turbotpu_torch.spec.umts import umts_perm

    worst = {name: 0.0 for name, *_ in fp8_libraries()}
    cases = []

    def hold(name, got, want, **shape):
        """Every tensor of `got` equal to `want`'s; record the case."""
        errs = [max_diff(g, w) for g, w in zip(got, want)]
        if not all(same(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name} differs from its plain version at "
                                 f"{shape}: {errs}")
        worst[name] = max(worst[name], *errs)
        cases.append({"name": name, **shape, "max_abs_err": max(errs)})

    def timed_plain(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def cold(ls, lp, K, mode, scale, W, B):
        """A real fp8 a-priori stream and real window starts."""
        T = ls.shape[0]
        return ck.siso_cells(ls, lp, torch.zeros((T, B), dtype=FP8,
                                                 device=dev),
                             K, mode, scale, window=W, nii_ckpt=torch.zeros(
                                 (T // W, 8, B), device=dev))

    # K1/K2/K3/K5 forms: bf16 channels at the flagship shape, f32 at C3's
    lte = make_decode_inputs(FLAG[0], FLAG[2], seed=1, ebn0_db=1.0)
    umts = umts_frames(C3_SHAPE[0], C3_SHAPE[2], dev)
    for chan, dt in CHANS.items():
        K, W, B = FLAG if chan == "bfloat16" else C3_SHAPE
        inputs, perm = ((lte, qpp_perm(K)) if chan == "bfloat16" else
                        (umts, umts_perm(K)))
        ls1, lp1, ls2, lp2 = make_streams(inputs, K, W, dt, dev, perm)
        T = ls1.shape[0]
        n_win = T // W
        idx = torch.from_numpy(np.concatenate([perm, np.arange(K, T)]).astype(
            np.int32)).to(dev)
        shape = {"K": K, "W": W, "B": B, "chan": chan, "ext": "float8_e4m3fn"}
        for mode in MODES:
            scale = 0.75 if mode == "maxlog" else 1.0
            la, ain = cold(ls1, lp1, K, mode, scale, W, B)
            for fold in (False, True):
                name = ck.kernel_name(True, mode, fold, False, dt, ck.FP8)
                gather = idx if fold else None

                def call():
                    return ck.siso_cells(ls2, lp2, la, K, mode, scale,
                                         nii_ckpt=ain, window=W,
                                         gather_idx=gather)
                got = call()
                want, plain_ms = timed_plain(lambda: ck.siso_nii_plain(
                    ls2, lp2, la, ain, K, W, scale, 0.0, mode,
                    gather_idx=gather))
                hold(name, (got[0], got[1][1:]), (want[0], want[1][1:]),
                     contract="nii", mode=mode, **shape)
                if fold:       # and equal to K1 on the materialised gather
                    mat = ck.siso_cells(ls2, lp2, la.index_select(0, idx.long()), K, mode,
                                        scale, nii_ckpt=ain, window=W)
                    if not (same(got[0], mat[0])
                            and same(got[1][1:], mat[1][1:])):
                        raise AssertionError(f"{name} differs from the NII "
                                             "kernel on the gathered stream")
                bound, by = siso_bound_ms(T, B, n_win, dt.itemsize, 1, True,
                                          False, mode, fold)
                results[name].update(ms=time_launches(call, 20),
                                     plain_ms=plain_ms, bound_ms=bound,
                                     bound_by=by,
                                     shape={**shape, "contract": "nii"})
            # the exact contract of the plain library, at the same shape
            got = ck.siso_cells(ls2, lp2, la, K, mode, scale, window=W)
            want = ck.siso_exact_plain(ls2, lp2, la, K, W, scale, 0.0, mode)
            hold(ck.kernel_name(False, mode, chan=dt, ext=ck.FP8), (got,),
                 (want,), contract="exact", mode=mode, **shape)

    # K4: both boundary contracts at C5's seq=2 chunks (the last chunk, row
    # offset C), edges from calls on the first and the last chunk
    _, noisy = c5.make_batch(C5_K, C5_B, C5_EBN0, seed=0)
    c5_inputs = tuple(torch.from_numpy(x).to(dev) for x in noisy)

    def bnd_case(nii, mode, ls, lp, K, window, j, dt, shape, time_it=False):
        C, W, n_win, KTp = chunk_sizing(K + 3, 2, window)
        B = ls.shape[1]
        scale = 0.75 if mode == "maxlog" else 1.0
        first = (ls[:C], lp[:C])
        cur = (ls[j * C:(j + 1) * C], lp[j * C:(j + 1) * C])
        uni = torch.zeros((8, B), device=dev)
        z = torch.zeros((C, B), dtype=FP8, device=dev)
        opt = dict(window=W, row_offset=j * C)
        _, a_edge, _ = ck.siso_cells(*first, z, K, mode, scale,
                                     boundaries=(ck._e0(B, dev), uni),
                                     window=W)
        la, _, b_edge = ck.siso_cells(*cur, z, K, mode, scale,
                                      boundaries=(uni, uni), **opt)
        if nii:
            tbl = ck.siso_cells(*cur, z, K, mode, scale, nii_boundaries=(
                torch.zeros((n_win, 8, B), device=dev), uni, uni), **opt)[1]
            kw = dict(opt, nii_boundaries=(tbl, a_edge, b_edge))
            plain = lambda: ck.siso_bnd_nii_plain(
                *cur, la, tbl, a_edge, b_edge, K, W, scale, 0.0, mode,
                row_offset=j * C)
        else:
            kw = dict(opt, boundaries=(a_edge, b_edge))
            plain = lambda: ck.siso_bnd_exact_plain(
                *cur, la, a_edge, b_edge, K, W, scale, 0.0, mode,
                row_offset=j * C)
        call = lambda: ck.siso_cells(*cur, la, K, mode, scale, **kw)
        got = list(call())
        want, plain_ms = timed_plain(plain)
        want = list(want)
        if nii:                      # slot 0 of the table is never written
            got[1], want[1] = got[1][1:], want[1][1:]
        name = ck.kernel_name(nii, mode, False, True, dt, ck.FP8)
        hold(name, got, want, contract="bnd_nii" if nii else "bnd_exact",
             mode=mode, C=C, W=W, row_offset=j * C, **shape)
        if time_it:
            bound, by = siso_bound_ms(C, B, n_win, dt.itemsize, 1, nii,
                                      False, mode, bnd=True)
            results[name].update(
                ms=time_launches(call, 10), plain_ms=plain_ms,
                bound_ms=bound, bound_by=by,
                shape={**shape, "C": C, "W": W, "row_offset": j * C,
                       "contract": "bnd_exact"})

    for chan, dt in CHANS.items():
        for nii, window in ((False, 0), (True, 256)):
            C, W, _, KTp = chunk_sizing(C5_K + 3, 2, window)
            ls, lp, _, _ = make_streams(c5_inputs, C5_K, W, dt, dev, KTp=KTp)
            for mode in MODES:
                bnd_case(nii, mode, ls, lp, C5_K, window, 1, dt,
                         {"K": C5_K, "B": C5_B, "chan": chan},
                         time_it=not nii)

    # small shapes: every library and contract, every mode and channel type
    small = ((168, 32, 70, 168), (40, 48, 37, 40), (40, 64, 37, 40),
             (168, 32, 45, 150))
    for chan, dt in CHANS.items():
        for mode in MODES:
            scale = 0.75 if mode == "maxlog" else 1.0
            for K, W, B, K_real in small:
                inputs = make_decode_inputs(K, B, seed=9, ebn0_db=1.0)
                ls, lp, _, _ = make_streams(inputs, K, W, dt, dev)
                T = ls.shape[0]
                la, ain = cold(ls, lp, K_real, mode, scale, W, B)
                idx = torch.from_numpy(np.random.default_rng(T + B).permutation(
                    T).astype(np.int32)).to(dev)
                shape = {"K": K, "K_real": K_real, "W": W, "B": B,
                         "chan": chan, "mode": mode}
                for fold in (False, True):
                    gather = idx if fold else None
                    got = ck.siso_cells(ls, lp, la, K_real, mode, scale,
                                        window=W, nii_ckpt=ain,
                                        gather_idx=gather)
                    want = ck.siso_nii_plain(ls, lp, la, ain, K_real, W,
                                             scale, 0.0, mode,
                                             gather_idx=gather)
                    hold(ck.kernel_name(True, mode, fold, False, dt, ck.FP8),
                         (got[0], got[1][1:]),
                         (want[0], want[1][1:]), contract="nii", **shape)
                got = ck.siso_cells(ls, lp, la, K_real, mode, scale, window=W)
                want = ck.siso_exact_plain(ls, lp, la, K_real, W, scale, 0.0,
                                           mode)
                hold(ck.kernel_name(False, mode, chan=dt, ext=ck.FP8), (got,),
                     (want,), contract="exact", **shape)
            # K4 at B=70 (chunks of 88 steps) and a chunk of one segment
            for K_s, B_s in ((168, 70), (120, 37)):
                C, W, _, KTp = chunk_sizing(K_s + 3, 2)
                inputs = make_decode_inputs(K_s, B_s, seed=13, ebn0_db=1.0)
                ls, lp, _, _ = make_streams(inputs, K_s, W, dt, dev, KTp=KTp)
                for nii in (False, True):
                    for j in (0, 1):
                        bnd_case(nii, mode, ls, lp, K_s, 0, j, dt,
                                 {"K": K_s, "B": B_s, "chan": chan})
    for name in worst:
        results[name]["max_abs_err"] = worst[name]
    rec = {"card": card, "tolerance": 0.0, "cases": len(cases),
           "kernels": {name: {k: results[name].get(k) for k in (
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "shape")} for name in worst}}

    # main path: the flagship decode with fp8 extrinsics, full width
    fp8_cfg = lambda **kw: flagship_config(**{
        "K": FLAG[0], "window": FLAG[1], "ext_dtype": "float8_e4m3fn", **kw})
    flag, bits = make_decode_inputs(FLAG[0], FLAG[2], seed=2, ebn0_db=2.0,
                                    with_crc=True, return_bits=True)
    flag = tuple(x.to(dev) for x in flag)
    bits = torch.from_numpy(bits).to(dev)
    name = ck.kernel_name(True, "maxlog", chan=torch.bfloat16, ext=ck.FP8)
    for early in ("none", "crc"):
        (hard, iters, L), launched = count_launches(
            results, lambda: turbo_decode(*flag, fp8_cfg(early_term=early)))
        want = 12 if early == "none" else 2 * int(iters.max())
        if not only(launched, **{name: want}):
            raise AssertionError(f"fp8 {early} decode: {want} launches of "
                                 f"{name} expected, counted {launched}")
        if not bool(torch.isfinite(L).all()):
            raise AssertionError("fp8 decode: L is not finite")
        rec[f"flagship_{early}"] = {
            "bit_errors": int((hard != bits).sum()),
            "max_iters": int(iters.max()),
            "mean_iters": float(iters.float().mean())}
        if rec[f"flagship_{early}"]["bit_errors"]:
            raise AssertionError(f"fp8 {early} decode at 2.0 dB: {rec}")
        rec[f"small_{early}_vs_cpu_L_max_abs_diff"] = small_decode_vs_cpu(
            fp8_cfg(K=168, window=32, early_term=early))
    # ms per batch beside int8, in turns (int8, fp8, fp8, int8) at 1.0 dB
    rec["ms_per_batch"] = {}
    for early in ("none", "crc"):
        runs = [bench_decode(fp8_cfg(early_term=early, ext_dtype=e),
                             FLAG[2], n_timed=8, ebn0_db=1.0)
                for e in ("int8", "float8_e4m3fn", "float8_e4m3fn", "int8")]
        rec["ms_per_batch"][early] = {
            "int8": [runs[0]["wall_s_per_batch"] * 1e3,
                     runs[3]["wall_s_per_batch"] * 1e3],
            "float8_e4m3fn": [runs[1]["wall_s_per_batch"] * 1e3,
                              runs[2]["wall_s_per_batch"] * 1e3]}

    # every library through the entry points, counts read after each
    frames, fbits = make_decode_inputs(168, 64, seed=4, ebn0_db=4.0,
                                       with_crc=True, return_bits=True)
    frames = tuple(x.to(dev) for x in frames)
    fbits = torch.from_numpy(fbits).to(dev)
    paths = {}
    for lib, chan, mode, fold, bnd in fp8_libraries():
        base = DecoderConfig(K=168, n_iters=6, mode=mode, siso="cuda",
                             io_dtype=chan, ext_dtype="float8_e4m3fn",
                             window=32, early_term="crc")
        if bnd:
            runs = [lambda c=dataclasses.replace(base, nii=nii):
                    decode_seq_sharded(make_mesh(1, 2, device=dev), c)(
                        *frames) for nii in (False, True)]
        elif fold:
            runs = [lambda c=dataclasses.replace(base, nii=True,
                                                 fold_gather=True):
                    turbo_decode(*frames, c)]
        else:
            runs = [lambda c=dataclasses.replace(base, nii=nii):
                    turbo_decode(*frames, c) for nii in (False, True)]
        for run_one in runs:
            (hard, _, _), launched = count_launches(results, run_one)
            if not (launched[lib] > 0 and only(launched, **{lib: launched[lib]})):
                raise AssertionError(f"{lib}: its entry-point decode "
                                     f"launched {launched}")
            if int((hard != fbits).sum()):
                raise AssertionError(f"{lib}: bit errors at 4.0 dB")
            paths[lib] = paths.get(lib, 0) + launched[lib]
    rec["entry_point_launches"] = paths

    # cli c5 --ext-dtype float8_e4m3fn, seq=2, full width, beside bf16
    c5_recs = {}
    for ext in ("bfloat16", "float8_e4m3fn"):
        buf = io.StringIO()

        def run_cli():
            with contextlib.redirect_stdout(buf):
                cli.main(["c5", "--k", str(C5_K), "--batch", str(C5_B),
                          "--seq", "2", "--ext-dtype", ext, "--reps", "2"])
        _, launched = count_launches(results, run_cli)
        c5_recs[ext] = json.loads(buf.getvalue().strip().splitlines()[-1])
        c5_recs[ext]["launches"] = {k: v for k, v in launched.items() if v}
    fe, n = c5_recs["float8_e4m3fn"]["frame_errs"], C5_B
    fe_ref = c5_recs["bfloat16"]["frame_errs"]
    diff, band = fer_band(fe, n, fe_ref, n)
    if not (c5_recs["float8_e4m3fn"]["launches"].get(
            ck.kernel_name(True, "maxlog", bnd=True, chan=torch.bfloat16,
                           ext=ck.FP8), 0) > 0
            and diff <= band):
        raise AssertionError(f"cli c5 fp8: {c5_recs}")
    rec["c5"] = {ext: {k: r[k] for k in ("wall_s", "mbit_per_s", "ber",
                                         "fer", "frame_errs", "mean_iters",
                                         "max_iters", "launches")}
                 for ext, r in c5_recs.items()}
    emit("fp8", **rec)


def kernel_id(name: str) -> str:
    """A kernel's own name in a profiler event's demangled signature
    ("void (anonymous namespace)::nii_pass1<0, true, ...>(...)" ->
    "nii_pass1")."""
    import re
    m = re.search(r"(\w+)\s*[<(]", name.replace("(anonymous namespace)::",
                                                 ""))
    return m.group(1) if m else name[:60]


def trace_summary(path, exit_range: str, decode_range: str | None = None
                  ) -> dict:
    """What a trace of decodes shows.  The device's window is each decode's
    device operations (those starting between its `decode_range` host
    range's start and the next decode's), or all of them; in it: the busy
    time and the idle share; at each early-exit host read (the end of an
    `exit_range` host range) the idle gap it falls into, split at the
    read's return into the wait before it (the card finishing, the host
    waking) and the host's work after it until the next launch starts; the
    largest gaps and the device operations that took the most time."""
    from turbotpu_torch.harness import profiling
    ops = profiling.device_ops(path)
    if not ops:
        raise AssertionError(f"the trace {path} holds no device activity")
    starts = ([a[1] for a in profiling.annotations(path, decode_range)]
              if decode_range else [])
    bounds = list(zip(starts, starts[1:] + [math.inf])) or [
        (-math.inf, math.inf)]
    span = busy = 0.0
    gaps = []
    for lo, hi in bounds:
        mine = [o for o in ops if lo <= o[1] < hi]
        if not mine:
            continue
        t0, t1 = mine[0][1], max(s + d for _, s, d in mine)
        g = profiling.idle_gaps(mine)
        span += t1 - t0
        busy += t1 - t0 - sum(x for _, x in g)
        gaps += g
    waits, after = [], []
    for _, ts, dur in profiling.annotations(path, exit_range):
        end = ts + dur
        hit = next(((s, g) for s, g in gaps if s <= end <= s + g), None)
        if hit:
            waits.append(end - hit[0])
            after.append(hit[0] + hit[1] - end)
    by_name = {}
    for name, _, dur in ops:
        n, total = by_name.get(kernel_id(name), (0, 0.0))
        by_name[kernel_id(name)] = (n + 1, total + dur)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    med = lambda xs: sorted(xs)[len(xs) // 2] if xs else None
    return {
        "decodes": len(starts), "span_ms": span / 1e3,
        "device_busy_ms": busy / 1e3, "idle_share": 1 - busy / span,
        "exit_reads": len(waits),
        "exit_gap_us": [w + a for w, a in zip(waits, after)],
        "exit_gap_share": sum(waits + after) / span,
        "exit_gap_median_us": {"before_read_returns": med(waits),
                               "host_after_read": med(after)},
        "largest_gaps_us": sorted((g for _, g in gaps), reverse=True)[:10],
        "top_device_ops": [{"name": k, "count": n, "ms": tot / 1e3}
                           for k, (n, tot) in top],
        "siso_kernels": sorted({kernel_id(n) for n, _, _ in ops
                                if "pass" in n}),
    }


def device_summary(path, n_decodes: int) -> dict:
    """What a device-only trace (no host activity recorded, so the host's
    pace is the program's own) of `n_decodes` back-to-back decodes shows:
    the span from the first device operation to the last, the busy time,
    the idle share, and the idle gaps that follow the device-to-host copies
    of the early-exit reads (`profiling.read_gaps`), per read and in all."""
    from turbotpu_torch.harness import profiling
    ops = profiling.device_ops(path)
    if not ops:
        raise AssertionError(f"the trace {path} holds no device activity")
    t0, t1 = ops[0][1], max(s + d for _, s, d in ops)
    idle = sum(g for _, g in profiling.idle_gaps(ops))
    reads = [g for _, g in profiling.read_gaps(ops)]
    return {"decodes": n_decodes, "span_ms": (t1 - t0) / 1e3,
            "span_ms_per_decode": (t1 - t0) / 1e3 / n_decodes,
            "device_busy_ms_per_decode": (t1 - t0 - idle) / 1e3 / n_decodes,
            "idle_share": idle / (t1 - t0), "reads": len(reads),
            "read_gap_us": reads,
            "read_gap_ms_per_decode": sum(reads) / 1e3 / n_decodes,
            "read_gap_share": sum(reads) / (t1 - t0),
            "other_idle_share": (idle - sum(reads)) / (t1 - t0)}


def run_profile(dev, card):
    """Phase `profile`: `cli bench --profile` on the flagship (crc at 1.0
    dB, and lean), which must write a trace that names the SISO kernels; the
    top device operations, the idle share and the gaps at the early-exit
    host reads, split at the read's return (host ranges recorded); then the
    same decodes, and two C5 seq=2 exact decodes, under a device-only trace,
    where the read gaps are the program's own (F3's measurement), beside
    their CUDA-event time unprofiled."""
    import contextlib
    import io
    import tempfile

    from turbotpu_torch import cli, turbo_decode
    from turbotpu_torch.dist.mesh import make_mesh
    from turbotpu_torch.dist.seq_parallel import decode_seq_sharded
    from turbotpu_torch.harness import c5, profiling
    from turbotpu_torch.harness.bench import (event_ms, flagship_config,
                                              make_decode_inputs)

    rec = {"card": card}
    n = 4                          # decodes in each device-only trace
    with tempfile.TemporaryDirectory() as tmp:
        for early in ("crc", "none"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.main(["bench", "--k", str(FLAG[0]), "--batch",
                          str(FLAG[2]), "--siso", "cuda", "--nii",
                          "--window", str(FLAG[1]),
                          "--io-dtype", "bfloat16", "--ext-dtype", "int8",
                          "--early-term", early, "--ebn0", "1.0",
                          "--profile", f"{tmp}/{early}"])
            bench = json.loads(buf.getvalue().strip().splitlines()[-1])
            summary = trace_summary(bench["trace"], "turbo.exit_read",
                                    "turbo.decode")
            if not any("pass1" in k for k in summary["siso_kernels"]):
                raise AssertionError(f"the trace names no SISO kernel: "
                                     f"{summary['siso_kernels']}")
            cfg = flagship_config(K=FLAG[0], window=FLAG[1],
                                  early_term=early)
            inputs = tuple(x.to(dev) for x in make_decode_inputs(
                FLAG[0], FLAG[2], seed=0, ebn0_db=1.0,
                with_crc=early == "crc"))
            run = lambda: turbo_decode(*inputs, cfg)
            ms = event_ms(run, n)
            with profiling.trace(f"{tmp}/{early}_device", host=False):
                for _ in range(n):
                    iters = run()[1]
            rec[f"flagship_{early}"] = {
                "max_iters": int(iters.max()), "ms_per_batch": ms,
                "traced": summary,
                "device_only": device_summary(
                    f"{tmp}/{early}_device/{profiling.TRACE_FILE}", n)}
        _, noisy = c5.make_batch(C5_K, C5_B, C5_EBN0, seed=0)
        args = [torch.from_numpy(x).to(dev) for x in noisy]
        decode = decode_seq_sharded(make_mesh(1, 2, device=dev),
                                    c5.c5_config(K=C5_K))
        ms = event_ms(lambda: decode(*args), 2)
        with profiling.trace(f"{tmp}/c5"):
            for _ in range(2):
                iters = decode(*args)[1]
        with profiling.trace(f"{tmp}/c5_device", host=False):
            for _ in range(2):
                decode(*args)
        rec["c5_seq2_exact"] = {
            "max_iters": int(iters.max()), "ms_per_batch": ms,
            "traced": trace_summary(f"{tmp}/c5/{profiling.TRACE_FILE}",
                                    "seq.exit_read"),
            "device_only": device_summary(
                f"{tmp}/c5_device/{profiling.TRACE_FILE}", 2)}
    emit("profile", **rec)


def check_variants(dev, card):
    """Phase `variants`: the windowed SISO (`siso="window"`, W=128, Q=32)
    and the associative-scan SISO (`siso="ascan"`) in one flagship-width
    decode each (K=6144, max-log, scale 0.75): window on the card against
    the same frames on the CPU, ascan against `siso="scan"` on the card;
    hard bits and iteration counts equal, L within 1e-4; ms per batch."""
    from turbotpu_torch import turbo_decode
    from turbotpu_torch.decoder.turbo import DecoderConfig
    from turbotpu_torch.harness.bench import event_ms, make_decode_inputs

    rec = {"card": card}
    for siso, ref, B, n_iters in (("window", "cpu", 8, 6),
                                  ("ascan", "scan", 4, 2)):
        cfg = DecoderConfig(K=FLAG[0], n_iters=n_iters, mode="maxlog",
                            ext_scale=0.75, siso=siso, early_term="crc")
        inputs, bits = make_decode_inputs(FLAG[0], B, seed=5, ebn0_db=1.0,
                                          with_crc=True, return_bits=True)
        got = turbo_decode(*inputs, cfg)
        want = (turbo_decode(*inputs, cfg, device="cpu") if ref == "cpu" else
                turbo_decode(*inputs, dataclasses.replace(cfg, siso="scan")))
        diff = float((got[2].cpu() - want[2].cpu()).abs().max())
        if not (torch.equal(got[0].cpu(), want[0].cpu())
                and torch.equal(got[1].cpu(), want[1].cpu())
                and diff <= 1e-4):
            raise AssertionError(f"siso={siso} differs from {ref}: L {diff}")
        dev_in = tuple(x.to(dev) for x in inputs)
        rec[siso] = {"B": B, "n_iters": n_iters, "against": ref,
                     "L_max_abs_diff": diff,
                     "bit_errors": int((got[0].cpu().numpy() != bits).sum()),
                     "iters": got[1].tolist(),
                     "ms_per_batch": event_ms(
                         lambda: turbo_decode(*dev_in, cfg), 2)}
    emit("variants", **rec)


def run_harness(dev, card):
    """Phase `harness`: `cli scaling --devices 1` (one card: data=1 is the
    measurement), `cli supervise -- ber --config c1` with a frame cap (the
    child on the card), and `harness.debug.checked` around the flagship
    decode (passes) and around one whose input holds a NaN (raises)."""
    import contextlib
    import io
    import tempfile

    from turbotpu_torch import cli, turbo_decode
    from turbotpu_torch.harness import debug
    from turbotpu_torch.harness.bench import flagship_config, make_decode_inputs

    rec = {"card": card}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["scaling", "--k", str(FLAG[0]), "--per-device-batch",
                  str(FLAG[2]), "--devices", "1", "--reps", "4"])
    rec["scaling"] = [json.loads(x) for x in buf.getvalue().splitlines()]
    if not (len(rec["scaling"]) == 1
            and rec["scaling"][0]["rows_equal_one_device"]
            and rec["scaling"][0]["mbit_per_s"] > 0):
        raise AssertionError(f"cli scaling: {rec['scaling']}")
    with tempfile.TemporaryDirectory() as tmp:
        res = f"{tmp}/c1.jsonl"
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(["supervise", "--results", res, "--", "ber", "--config",
                      "c1", "--max-frames", "8", "--results", res])
        out = json.loads(buf.getvalue().strip().splitlines()[-1])
        points = [json.loads(x) for x in open(res).read().splitlines()]
    if not (out == {"restarts": 0, "ok": True} and len(points) == 4
            and all(p["frames"] >= 8 for p in points)):
        raise AssertionError(f"cli supervise: {out}, {points}")
    rec["supervise"] = {"restarts": out["restarts"], "points": len(points),
                        "frames": [p["frames"] for p in points],
                        "seconds": time.perf_counter() - t0}
    cfg = flagship_config(K=FLAG[0], window=FLAG[1])
    inputs = tuple(x.to(dev) for x in make_decode_inputs(FLAG[0], FLAG[2],
                                                         seed=2))
    debug.checked(turbo_decode)(*inputs, cfg)
    bad = inputs[0].clone()
    bad[3, 7] = float("nan")
    try:
        debug.checked(turbo_decode)(bad, *inputs[1:], cfg)
    except ValueError as e:
        rec["checked_nan"] = str(e)
    else:
        raise AssertionError("checked() let a non-finite decode through")
    emit("harness", **rec)


# (program, argv) of phase `experiments`, in this order: flagship_tuning and
# seq_glue before the programs that read their records, comm_model before
# latency.  "{d}" is the phase's record directory.  One batch and one Eb/N0
# each, K <= 1024 but where the program is about K=6144.
EXPERIMENTS = (
    ("run_acceptance", ["--configs", "c4", "--max-frames", "128"]),
    ("flagship_tuning", ["--batches", "1024", "--ab-rounds", "1", "--runs",
                         "2", "--timed", "2"]),
    ("nii_window_sweep", ["--windows", "256", "--ebn0", "0.8",
                          "--n-batches", "1", "--batch", "256", "--timed",
                          "2"]),
    ("ext_dtype_ber", ["--ebn0", "0.8", "--n-batches", "1", "--batch",
                       "256"]),
    ("map_variant_ber", ["--ebn0", "0.6", "--n-batches", "1", "--batch",
                         "256", "--tuning", "{d}/flagship_tuning.json"]),
    ("map_variant_umts", ["--ebn0", "1.0", "--frames", "128"]),
    ("k_sweep", ["--ks", "1024", "--mixed-batches", "128", "--timed", "2"]),
    ("siso_shapes", ["--ks", "104", "--bs", "8", "--target-ms", "5"]),
    ("cost_breakdown", ["decode", "--k", "1024", "--b", "256"]),
    ("seq_gap", ["--reps", "4", "--timed", "2"]),
    ("seq_glue", ["--seqs", "1", "2", "--batches", "1024", "--k", "1024",
                  "--reps", "4"]),
    ("seq_nii_ber", ["--k", "1024", "--n-seq", "2", "--b", "256", "--ebn0",
                     "0.8", "--max-frames", "256"]),
    ("comm_model", ["--k", "1024", "--seqs", "2", "--tuning",
                    "{d}/flagship_tuning.json", "--glue",
                    "{d}/seq_glue.json"]),
    ("latency", ["--batches", "1", "64", "--timed", "2", "--oneshot", "4",
                 "--comm-model", "{d}/comm_model.json"]),
)


def finite_numbers(x, where="") -> int:
    """Count the numbers in a record, raising at one that is not finite
    (None, a field a program leaves empty by its stated rule, passes)."""
    if isinstance(x, dict):
        return sum(finite_numbers(v, f"{where}.{k}") for k, v in x.items())
    if isinstance(x, list):
        return sum(finite_numbers(v, f"{where}[{i}]") for i, v in enumerate(x))
    if isinstance(x, bool) or not isinstance(x, (int, float)):
        return 0
    if not math.isfinite(x):
        raise AssertionError(f"record field {where} = {x}")
    return 1


def run_experiments(dev, card):
    """Phase `experiments`: every program of the evidence layer
    (turbotpu_torch/experiments/) through its `main`, capped (EXPERIMENTS),
    its records written to a temporary directory and checked: they name
    the card, carry the program's argv and only finite numbers; then
    `nii_window_sweep.fer_run` on the card against the same frames on the
    CPU (plain versions): equal counts."""
    import importlib
    import tempfile
    from turbotpu_torch.decoder.turbo import DecoderConfig
    from turbotpu_torch.experiments import nii_window_sweep

    rec = {"card": card, "programs": {}}
    with tempfile.TemporaryDirectory() as d:
        for name, argv in EXPERIMENTS:
            argv = [a.format(d=d) for a in argv]
            out = ["--out", d if name == "run_acceptance"
                   else f"{d}/{name}.json"]
            mod = importlib.import_module(f"turbotpu_torch.experiments.{name}")
            t0 = time.perf_counter()
            mod.main(argv + out)
            path = f"{d}/{name}.json"
            with open(path) as f:
                r = json.load(f)
            if r["card"] != card or r["argv"] != argv + out:
                raise AssertionError(f"{name}: record names {r['card']!r}, "
                                     f"argv {r['argv']}")
            rec["programs"][name] = {"seconds": time.perf_counter() - t0,
                                     "numbers": finite_numbers(r, name)}
        with open(f"{d}/h100_accept.jsonl") as f:
            points = [json.loads(ln) for ln in f]
        rows = rec["programs"]["run_acceptance"]
        if not points or any(p["card"] != card for p in points):
            raise AssertionError(f"run_acceptance: {len(points)} points")
        rows["numbers"] += finite_numbers(points)

    # fer_run on the card against the CPU: the same frames, equal counts
    cfg = DecoderConfig(K=168, n_iters=6, mode="maxlog", ext_scale=0.75,
                        siso="cuda", io_dtype="bfloat16", nii=True, window=32,
                        ext_dtype="int8")
    got = nii_window_sweep.fer_run(cfg, 168, 64, 0.5, 1, 777, dev)
    want = nii_window_sweep.fer_run(cfg, 168, 64, 0.5, 1, 777, "cpu")
    if got != want or got[0] == 0:
        raise AssertionError(f"fer_run on the card {got}, on the CPU {want}")
    rec["fer_run_card_vs_cpu"] = {"bit_errs": got[0], "frame_errs": got[1],
                                  "equal": True}
    emit("experiments", **rec)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    from turbotpu_torch import _build
    from turbotpu_torch.decoder import layout
    from turbotpu_torch import harq
    from turbotpu_torch.dist import dma
    from turbotpu_torch.experiments import cost_breakdown, gather_inkernel
    from turbotpu_torch.harness.bench import card_info
    from turbotpu_torch.harness.profiling import PTXAS_FLAGS as PTXAS
    from turbotpu_torch.siso.cuda_kernel import (BND_CONTRACTS, CONTRACTS,
                                                 build_targets, kernel_name)

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

    # every kernel of the port, one nvcc process each, all started together
    t0 = time.perf_counter()
    targets = build_targets() + [gather_inkernel.TARGET,
                                 cost_breakdown.TARGET, dma.TARGET,
                                 layout.TARGET, harq.TARGET]
    libs = _build.build(targets)
    for name, defines in libs:
        _build.load(name, defines)
    emit("build", seconds=time.perf_counter() - t0, libraries=len(libs),
         nvcc_seconds={" ".join((t[0],) + t[1]): s
                       for t, s in _build.build_seconds.items()},
         directory=str(_build.BUILD_DIR.relative_to(
             _build.BUILD_DIR.parent.parent)))
    if "--ptxas" in argv:
        # registers, spills, stack and shared memory of every kernel
        from turbotpu_torch.harness.profiling import compiled_stats
        _build.build(targets, PTXAS)       # all side by side first
        emit("ptxas", libraries={" ".join((t[0],) + t[1]): [
            {k: f[k] for k in ("function", "registers", "spill_stores",
                               "spill_loads", "stack", "smem")}
            for f in compiled_stats(t)] for t in targets})

    results = {kernel_name(nii, mode, fold): {
        "name": kernel_name(nii, mode, fold), "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": replaces(nii, mode, fold),
        "library_ms": None} for mode in MODES for nii, fold in CONTRACTS}
    results.update({kernel_name(nii, mode, bnd=True): {
        "name": kernel_name(nii, mode, bnd=True), "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": bnd_replaces(nii, mode),
        "library_ms": None} for mode in MODES for nii in BND_CONTRACTS})
    results.update({name: {
        "name": name, "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": fp8_replaces(mode, fold, bnd), "library_ms": None}
        for name, _, mode, fold, bnd in fp8_libraries()})
    results["row_gather"] = {
        "name": "row_gather", "route": "cuda",
        "source": "turbotpu_torch/csrc/row_gather.cu",
        "replaces": "experiments/gather_inkernel.py:69 (row_gather_pallas, "
                    "pallas_call at :112)"}
    results["issue_rate"] = {
        "name": "issue_rate", "route": "cuda",
        "source": "turbotpu_torch/csrc/issue_rate.cu",
        "replaces": "experiments/cost_breakdown.py:201 (_calibrate_vpu, "
                    "pallas_call at :230)", "library_ms": None}
    results["ring_xch"] = {
        "name": "ring_xch", "route": "cuda",
        "source": "turbotpu_torch/csrc/ring_xch.cu",
        "replaces": "turbotpu/dist/dma.py:94 (boundary_exchange_dma, "
                    "pallas_call at :119, body _xch_kernel :56)"}
    for name, what in (("pack_kernel", ":120 stream"),
                       ("unpack_kernel", ":186 full_llr")):
        results[name] = {
            "name": name, "route": "cuda",
            "source": "turbotpu_torch/csrc/layout.cu",
            "replaces": f"none: XLA fuses turbotpu/decoder/turbo_cells.py"
                        f"{what}", "library_ms": None}
    for name in ("exit_kernel", "exit_close_kernel"):
        results[name] = {
            "name": name, "route": "cuda",
            "source": "turbotpu_torch/csrc/layout.cu",
            "replaces": "none: XLA fuses turbotpu/decoder/turbo_cells.py"
                        ":251-267 (the dot_general syndrome and the "
                        "freezes)", "library_ms": None}
    for name in ("live_close_kernel", "compact_kernel"):
        results[name] = {
            "name": name, "route": "cuda",
            "source": "turbotpu_torch/csrc/layout.cu",
            "replaces": "none: the JAX loop (turbotpu/decoder/"
                        "turbo_cells.py:251-267) runs every codeword to the "
                        "end", "library_ms": None}
    results["combine_kernel"] = {
        "name": "combine_kernel", "route": "cuda",
        "source": "turbotpu_torch/csrc/harq.cu",
        "replaces": "none: turbotpu/tx/rate_match_jax.py:95 "
                    "de_rate_match_harq_jax sums whole transmissions, "
                    "nothing kept", "library_ms": None}
    run = {"kernels": lambda: check_kernels(dev, results),
           "decode": lambda: check_decode(dev, results),
           "bench": lambda: run_bench(dev, card, results),
           "mixed": lambda: check_mixed(dev),
           "gather": lambda: time_gathers(dev, card),
           "encoder": lambda: time_encoder(dev, card),
           "fold": lambda: check_fold(dev, card, results),
           "calibrate": lambda: check_calibrate(dev, card, results),
           "tb": lambda: run_tb(dev, card, results),
           "harq": lambda: check_harq(dev, card, results),
           "seq": lambda: check_seq(dev, card, results),
           "fp8": lambda: check_fp8(dev, card, results),
           "dist": lambda: check_dist(dev, card, results),
           "compact": lambda: run_compact(dev, card, results),
           "ber": lambda: run_ber(dev, card, results),
           "profile": lambda: run_profile(dev, card),
           "variants": lambda: check_variants(dev, card),
           "harness": lambda: run_harness(dev, card),
           "experiments": lambda: run_experiments(dev, card)}
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
    # where measured: device time as a CUDA graph (K6, K7), the two passes
    # of the window-parallel kernels timed apart (K1, K2)
    extra = ("device_ms", "library_device_ms", "pass_ms")
    for r in results.values():
        if r.get("launches", 0) < 1:
            raise AssertionError(f"the main paths never launched {r['name']}")
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys}, **{k: r[k] for k in extra if k in r}}
        for r in results.values()]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
