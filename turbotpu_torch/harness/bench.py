"""Throughput benchmark harness.

Counterpart of turbotpu/harness/bench.py: decoded information Mbit/s of
`turbo_decode` on one card, timed with CUDA events, warm-up (and with it the
kernels' build) excluded.  Run as

    python -m turbotpu_torch.harness.bench [--batch B] [--ebn0 DB]

for the flagship configuration (LTE K=6144, max-log, 6 iterations, NII
window 256, bf16 channel streams, int8 extrinsics), fixed-iteration and
with CRC early termination.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from .._device import resolve_device
from ..decoder.turbo import DecoderConfig, turbo_decode
from ..golden import numpy_ref as npr
from ..spec.crc import CRC24A_POLY, crc_attach
from ..spec.qpp import qpp_perm


def flagship_config(**overrides) -> DecoderConfig:
    base = dict(K=6144, n_iters=6, mode="maxlog", ext_scale=0.75, siso="cuda",
                io_dtype="bfloat16", nii=True, window=256, ext_dtype="int8")
    base.update(overrides)
    return DecoderConfig(**base)


def make_decode_inputs(K: int, B: int, seed: int = 0, ebn0_db: float = 1.0,
                       with_crc: bool = False, n_unique: int = 64,
                       return_bits: bool = False):
    """Host-side: one noisy encoded batch as five CPU float32 tensors
    (ls, lp1, lp2, tail1, tail2), made from `seed` with numpy.

    Encoding cost is bounded by tiling n_unique distinct payloads to B,
    but noise is drawn AFTER tiling, so every row is an i.i.d. channel
    realization: with early termination the loop's exit then depends on the
    convergence tail of B independent frames.  with_crc attaches CRC-24A so
    CRC early termination has real frames.  With return_bits the (B, K)
    transmitted bits come back too."""
    rng = np.random.default_rng(seed)
    n_base = min(B, n_unique)
    parts = [[] for _ in range(5)]
    perm = qpp_perm(K)
    for _ in range(n_base):
        if with_crc:
            bits = crc_attach(rng.integers(0, 2, K - 24).astype(np.int8),
                              CRC24A_POLY)
        else:
            bits = rng.integers(0, 2, K).astype(np.int8)
        for i, x in enumerate(npr.turbo_encode(bits, perm)):
            parts[i].append(x)
    # Mother-rate (1/3) by construction: the full 3K+12 streams.
    sigma = np.sqrt(1 / (2 * 10 ** (ebn0_db / 10) / 3))
    reps = -(-B // n_base)
    out = []
    for p in parts:
        a = np.tile(np.stack(p).astype(np.float64), (reps, 1))[:B]
        y = (1 - 2 * a) + sigma * rng.normal(size=a.shape)
        out.append(torch.from_numpy((2 * y / sigma ** 2).astype(np.float32)))
    if return_bits:
        bits = np.tile(np.stack(parts[0]), (reps, 1))[:B].astype(np.int8)
        return tuple(out), bits
    return tuple(out)


def card_info() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def event_ms(fn, n: int, n_warmup: int = 1) -> float:
    """ms per call of `fn` over `n` calls between two CUDA events, after
    `n_warmup` untimed calls."""
    for _ in range(n_warmup):
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


def bench_decode(cfg: DecoderConfig, B: int, n_timed: int = 16,
                 n_warmup: int = 1, seed: int = 0, ebn0_db: float = 1.0,
                 device="cuda", inputs=None) -> dict:
    """Time turbo_decode on one card: `n_timed` decodes between two CUDA
    events, after `n_warmup` untimed ones.

    With cfg.early_term enabled, inputs carry CRC frames at ebn0_db and the
    measurement is EFFECTIVE throughput at that operating point (early exit
    included) rather than fixed-iteration throughput.  `inputs` replaces the
    generated batch (five tensors)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("bench_decode times with CUDA events and needs a "
                           "card; a CPU timing is not a device metric")
    if inputs is None:
        inputs = make_decode_inputs(cfg.K, B, seed, ebn0_db,
                                    with_crc=cfg.early_term == "crc")
    inputs = tuple(x.to(dev) for x in inputs)
    last = {}

    def decode():
        last["iters"] = turbo_decode(*inputs, cfg, device=dev)[1]
    wall = event_ms(decode, n_timed, max(n_warmup, 1)) / 1e3
    iters = last["iters"]
    info_bits = B * cfg.K
    return {
        "K": cfg.K, "B": B, "iters": cfg.n_iters, "mode": cfg.mode,
        "siso": cfg.siso, "nii": cfg.nii, "window": cfg.window,
        "io_dtype": cfg.io_dtype, "ext_dtype": cfg.ext_dtype,
        "early_term": cfg.early_term,
        **({"ebn0_db": ebn0_db, "mean_iters": float(iters.float().mean()),
            "max_iters": int(iters.max())}
           if cfg.early_term != "none" else {}),
        "wall_s_per_batch": wall, "timed_reps": n_timed,
        "mbit_per_s": info_bits / wall / 1e6,
        "device": torch.cuda.get_device_name(dev),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--ebn0", type=float, default=1.0)
    ap.add_argument("--timed", type=int, default=16)
    args = ap.parse_args(argv)
    resolve_device("cuda")
    card = card_info()
    for early in ("none", "crc"):
        rec = bench_decode(flagship_config(early_term=early), args.batch,
                           n_timed=args.timed, ebn0_db=args.ebn0)
        print(json.dumps({**rec, "card": card}), flush=True)


if __name__ == "__main__":
    main()
