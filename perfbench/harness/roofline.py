"""The work a max-log SISO has to do, counted from the algorithm, and the
card's peaks.

Operations per trellis step and codeword of one max-log BCJR half-iteration
with 8 states, whatever implements it (renormalisation, layout and padding
are an implementation's and not counted):

* branch metrics 3: the a-priori scaled (1 multiply), plus the systematic
  LLR (1 add), plus the parity LLR for the (u=1, p=1) edge (1 add);
* forward recursion 24: 8 states x (2 adds + 1 max);
* backward recursion 24: the same;
* extrinsic 33: for each input bit, 8 adds of alpha and beta, the largest
  of the 4 parity-0 and of the 4 parity-1 edges (6 maxes), the parity LLR
  added to the latter (1 add) and the larger of the two (1 max); then one
  subtraction.

Bytes per step and codeword: the two channel streams and the a-priori read
once, the extrinsic written once, in the configuration's stream types.
"""

from __future__ import annotations

import json
from pathlib import Path

OPS_PER_STEP = 3 + 24 + 24 + 33          # 84
STREAM_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1, "float8_e4m3fn": 1}
PEAKS = Path(__file__).with_name("peaks.json")


def siso_work(codeword_iters: int, K: int, decoder: dict
              ) -> tuple[float, float]:
    """(operations, bytes) of `codeword_iters` iterations summed over
    codewords (each iteration two SISO half-iterations) of a K-bit trellis
    (K + 3 steps with the termination).  A codeword counts the iterations it
    needed, not those its batch ran while it waited for a slower one."""
    steps = (K + 3) * 2 * codeword_iters
    chan = STREAM_BYTES[decoder["io_dtype"]]
    ext = STREAM_BYTES[decoder["ext_dtype"] or decoder["io_dtype"]]
    return float(OPS_PER_STEP * steps), float((2 * chan + 2 * ext) * steps)


def peak(device_kind: str) -> dict | None:
    """The data sheet's peaks of a card, or None for a card not in the
    table."""
    return json.loads(PEAKS.read_text()).get(device_kind)


def least_seconds(ops: float, nbytes: float, pk: dict) -> float:
    """The least time the card could take: the larger of operations over
    its peak rate and bytes over its memory bandwidth."""
    return max(ops / pk["fp32_ops_per_s"], nbytes / pk["hbm_bytes_per_s"])
