"""Sweep-level convergence compaction.

Counterpart of turbotpu/harness/compact.py.  At a CRC-early-termination
operating point the batched decode loop exits when the LAST of B i.i.d.
frames converges, so batch cost is the MAX iteration count over the batch
while the MEAN is well below it.  The fix is host-side re-batching between
sweep steps: decode every super-batch with a small iteration cap first, then
gather the frames whose CRC still fails across all super-batches into dense
full-size batches and finish them at the full cap.

Output equivalence (exact, not statistical): a frame that passes CRC
within the stage-1 cap is frozen with the same hard decision the
single-stage decoder would freeze; a deferred frame is re-decoded from
scratch at the full cap, which is the same computation the single-stage
decoder performs on it (the turbo iteration has no state other than the
extrinsics it rebuilds deterministically, and per-frame freezing is
branchless).  So compaction returns bit-identical hard decisions to
`turbo_decode` at the full cap while spending mean-not-max iterations on the
converged majority.

Host reads: ONE per super-batch (three int64 counters and the (B,) undone
mask in one int64 vector: nothing is cast or bit-cast into a float) plus one
per stage-2 batch.  `bench_compaction` reports the measured wall time of both
schedules, CUDA-event timed, host reads included.  The JAX package's record
also carries `*_tunnel` and `projected_*_at_10us_dispatch` fields, which
correct for its TPU host link; they have no meaning here and are not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device
from ..decoder.early_term import crc_ok_batch, make_crc_matrix
from ..decoder.turbo import DecoderConfig, turbo_decode
from ..golden import numpy_ref as npr
from ..spec.crc import CRC24A_POLY, crc_attach
from ..spec.qpp import qpp_perm
from .bench import event_ms


def _counters(hard, iters, bits_ref, keep):
    """(bit errors, frame errors, iteration total) over the rows `keep`
    selects, as int64 scalars on the device."""
    errs = (hard != bits_ref) & keep[:, None]
    return [errs.sum(), errs.any(dim=1).sum(),
            (iters.to(torch.int64) * keep).sum()]


def _stage_fns(cfg1: DecoderConfig, cfg2: DecoderConfig, device):
    """The capped first pass and the full-cap finish on `device`."""
    dev = resolve_device(device)
    G = make_crc_matrix(cfg1.K, cfg1.crc_poly, dev)

    def stage1(inputs, bits_ref):
        """Counters of the frames that converged within the cap, and the
        undone mask, in ONE int64 vector so the host pays a single read per
        super-batch.  Layout: [bitc, framec, it1, undone(B)...]."""
        hard, iters, _ = turbo_decode(*inputs, cfg1, device=dev)
        undone = ~crc_ok_batch(hard, G)
        packed = torch.cat([torch.stack(_counters(hard, iters, bits_ref,
                                                  ~undone)),
                            undone.to(torch.int64)])
        return packed, hard

    def stage2(flat_inputs, idx, valid, flat_bits):
        gathered = tuple(x.index_select(0, idx) for x in flat_inputs)
        hard, iters, _ = turbo_decode(*gathered, cfg2, device=dev)
        return torch.stack(_counters(hard, iters,
                                     flat_bits.index_select(0, idx),
                                     valid)), hard

    return stage1, stage2


def decode_compacted(inputs_list, bits_list, cfg: DecoderConfig,
                     stage1_iters: int = 3, flat=None, keep_hard=False,
                     device="cuda"):
    """Decode a list of (ls, lp1, lp2, t1, t2) batches (tensors on `device`)
    with two-stage convergence compaction.

    flat: optional precomputed (flat_inputs, flat_bits) -- the
    super-batches concatenated along dim 0 -- so repeated benchmark
    passes do not re-copy the LLRs each run.
    keep_hard: read back and merge hard decisions (the equivalence-test
    path; costs a (B, K) transfer per batch, so benchmarks leave it off).

    Returns (bit_errs, frame_errs, converged_iters_total,
    n_stage2_batches, hard_list | None, n_deferred)."""
    if cfg.early_term != "crc":
        raise ValueError("compaction needs CRC early termination")
    dev = resolve_device(device)
    cfg1 = dataclasses.replace(cfg, n_iters=stage1_iters)
    stage1, stage2 = _stage_fns(cfg1, cfg, dev)
    B = inputs_list[0][0].shape[0]

    bit_t = frame_t = iters_t = 0
    deferred = []          # flat row indices into the stacked super-batch
    hards = [] if keep_hard else None
    for i, (inp, bits) in enumerate(zip(inputs_list, bits_list)):
        packed, hard = stage1(inp, bits)
        p = packed.cpu().numpy()                # ONE read per super-batch
        bit_t += int(p[0])
        frame_t += int(p[1])
        iters_t += int(p[2])
        deferred.extend(i * B + j for j in np.nonzero(p[3:])[0])
        if keep_hard:
            hards.append(hard.cpu().numpy().copy())   # stage 2 merges

    n2 = 0
    if deferred:
        if flat is None:
            flat = (tuple(torch.cat([inp[k] for inp in inputs_list], dim=0)
                          for k in range(5)),
                    torch.cat(bits_list, dim=0))
        flat_inputs, flat_bits = flat
        rows = np.asarray(deferred, np.int64)
        n2 = -(-len(rows) // B)
        n_pad = n2 * B - len(rows)
        idx_all = np.concatenate([rows, np.zeros(n_pad, np.int64)])
        valid_all = np.concatenate([np.ones(len(rows), bool),
                                    np.zeros(n_pad, bool)])
        for b in range(n2):
            idx = torch.from_numpy(idx_all[b * B:(b + 1) * B]).to(dev)
            valid = torch.from_numpy(valid_all[b * B:(b + 1) * B]).to(dev)
            packed2, hard2 = stage2(flat_inputs, idx, valid, flat_bits)
            p2 = packed2.cpu().numpy()          # ONE read per stage-2 batch
            bit_t += int(p2[0])
            frame_t += int(p2[1])
            iters_t += int(p2[2])
            if keep_hard:
                h2 = hard2.cpu().numpy()
                for r in range(B):
                    if valid_all[b * B + r]:
                        g = int(idx_all[b * B + r])
                        hards[g // B][g % B] = h2[r]
    return bit_t, frame_t, iters_t, n2, hards, len(deferred)


def make_crc_batches(K: int, B: int, n_super: int, ebn0_db: float,
                     seed: int = 0, n_base: int = 64, device="cuda"):
    """n_super batches of CRC-attached frames on `device`, made from `seed`
    with numpy; unique payloads tiled to B with i.i.d. noise drawn AFTER
    tiling (harness.bench methodology).  The same frames per seed as the JAX
    package's function."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    perm = qpp_perm(K)
    base_bits, base_parts = [], [[] for _ in range(5)]
    for _ in range(min(B, n_base)):
        row = crc_attach(rng.integers(0, 2, K - 24).astype(np.int8),
                         CRC24A_POLY)
        base_bits.append(row)
        for k, x in enumerate(npr.turbo_encode(row, perm)):
            base_parts[k].append(x)
    sigma = np.sqrt(1 / (2 * 10 ** (ebn0_db / 10) / 3))
    reps = -(-B // len(base_bits))
    inputs_list, bits_list = [], []
    bits_np = np.tile(np.stack(base_bits), (reps, 1))[:B]
    for _ in range(n_super):
        out = []
        for p in base_parts:
            a = np.tile(np.stack(p).astype(np.float64), (reps, 1))[:B]
            y = (1 - 2 * a) + sigma * rng.normal(size=a.shape)
            out.append(torch.from_numpy(
                (2 * y / sigma ** 2).astype(np.float32)).to(dev))
        inputs_list.append(tuple(out))
        bits_list.append(torch.from_numpy(bits_np).to(dev))
    return inputs_list, bits_list


def bench_compaction(cfg: DecoderConfig, B: int, ebn0_db: float,
                     n_super: int = 8, stage1_iters: int = 3,
                     seed: int = 0, device="cuda") -> dict:
    """Effective-throughput benchmark: compaction vs single-stage early
    termination on the same frames, both as measured wall time (CUDA events,
    least of three passes after a warm-up) and as batch-iterations."""
    if cfg.early_term != "crc":
        raise ValueError(
            "convergence compaction re-batches on CRC failure, so it "
            "requires early_term='crc' (got "
            f"{cfg.early_term!r}); use --early-term crc")
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("bench_compaction times with CUDA events and "
                           "needs a card; a CPU timing is not a device "
                           "metric")
    inputs_list, bits_list = make_crc_batches(cfg.K, B, n_super, ebn0_db,
                                              seed, device=dev)
    flat = (tuple(torch.cat([inp[k] for inp in inputs_list], dim=0)
                  for k in range(5)),
            torch.cat(bits_list, dim=0))

    def run_compact():
        return decode_compacted(inputs_list, bits_list, cfg, stage1_iters,
                                flat=flat, device=dev)

    # each pass reads back to the host, so the events bracket finished work
    least_s = lambda fn: min(event_ms(fn, 1, 0) for _ in range(3)) / 1e3
    res = run_compact()                      # warm-up at real shapes
    wall_c = least_s(run_compact)

    # Single-stage baseline on the same frames, one host read per batch
    # (the structure of a sweep step): [bit errors, frame errors, largest
    # iteration count], so the batch's REAL trip count is known.
    def run_single():
        tot = np.zeros(3, np.int64)
        for inp, bits in zip(inputs_list, bits_list):
            hard, iters, _ = turbo_decode(*inp, cfg, device=dev)
            errs = hard != bits
            v = torch.stack([errs.sum(), errs.any(dim=1).sum(),
                             iters.max().to(torch.int64)]).cpu().numpy()
            tot += v
        return tot

    single = run_single()
    wall_s = least_s(run_single)
    # Realized single-stage device work: the batch loop runs until its
    # slowest frame converges (or the cap), i.e. max(iters) trips.
    units_single = int(single[2])
    # Stage 1 runs its cap (or fewer, if a whole batch passes early: the cap
    # is what is charged); each stage-2 batch is charged the full cap.
    units_compact = n_super * stage1_iters + res[3] * cfg.n_iters
    info_bits = n_super * B * cfg.K
    return {
        "K": cfg.K, "B": B, "n_super": n_super, "ebn0_db": ebn0_db,
        "stage1_iters": stage1_iters, "full_iters": cfg.n_iters,
        "siso": cfg.siso, "io_dtype": cfg.io_dtype, "nii": cfg.nii,
        "n_stage2_batches": res[3],
        "deferred_frac": round(res[5] / (n_super * B), 4),
        "iter_batches_compacted": units_compact,
        "iter_batches_single": units_single,
        "device_work_speedup": units_single / units_compact,
        "wall_compacted_s": wall_c, "wall_single_s": wall_s,
        "wall_speedup": wall_s / wall_c,
        "mbit_per_s_compacted": info_bits / wall_c / 1e6,
        "mbit_per_s_single": info_bits / wall_s / 1e6,
        "n_host_reads": n_super + res[3],
        "bit_errs": res[0], "frame_errs": res[1],
        "bit_errs_single": int(single[0]),
        "frame_errs_single": int(single[1]),
        "device": torch.cuda.get_device_name(dev),
    }
