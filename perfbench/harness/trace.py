"""Reading a torch.profiler trace (Chrome format) into what the per-layer
metrics need.

Every operation the card ran (kernel, copy, memset) is tied to the host's
launch of it by the profiler's correlation id, and through the launch's time
and thread to the host ranges (`record_function`) open around it: the
program's own (`turbo.decode`, `turbo.siso1`, ...) and the benchmark's
(`bench.batch` around each batch, `bench.rx.*` around the receive chain).
So a device operation belongs to a layer by who launched it, not by its
kernel's name.  The arithmetic of busy time and idle gaps follows
turbotpu_torch/harness/profiling.py (`device_ops`, `idle_gaps`).
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import re

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
BATCH = "bench.batch"


@dataclasses.dataclass
class Op:
    name: str
    start: float                 # us
    dur: float                   # us
    ranges: tuple[str, ...]      # host ranges open at its launch, outer first
    batch: int | None            # index of its bench.batch range


def kernel_id(name: str) -> str:
    """A device operation's short name: a kernel's own function name
    ("void (anonymous namespace)::nii_pass1<0, ...>(...)" -> "nii_pass1"),
    a copy's or memset's name as it is."""
    m = re.search(r"(\w+)\s*[<(]", name.replace("(anonymous namespace)::",
                                                 ""))
    return m.group(1) if m else name


class Trace:
    def __init__(self, events: list[dict]):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        host = [e for e in xs if e.get("cat") == "user_annotation"]
        self.ranges = sorted(((e["name"], float(e["ts"]),
                               float(e["ts"]) + float(e["dur"]), e.get("tid"))
                              for e in host), key=lambda r: (r[1], -r[2]))
        self._batch_index = {i: j for j, i in enumerate(
            i for i, r in enumerate(self.ranges) if r[0] == BATCH)}
        self.batches = [r for r in self.ranges if r[0] == BATCH]
        self.main_tid = self.batches[0][3] if self.batches else None
        launch = {}
        for e in xs:
            if e.get("cat") in LAUNCH_CATEGORIES:
                c = (e.get("args") or {}).get("correlation")
                if c is not None:
                    launch[c] = (float(e["ts"]), e.get("tid"))
        dev = sorted((e for e in xs if e.get("cat") in DEVICE_CATEGORIES),
                     key=lambda e: float(e["ts"]))
        at = [launch.get((e.get("args") or {}).get("correlation"))
              for e in dev]
        opened = self._enclosing([a for a in at if a is not None])
        it = iter(opened)
        self.ops = []
        for e, a in zip(dev, at):
            rs = next(it) if a is not None else ()
            self.ops.append(Op(
                e["name"], float(e["ts"]), float(e["dur"]),
                tuple(self.ranges[i][0] for i in rs),
                next((self._batch_index[i] for i in rs
                      if i in self._batch_index), None)))
        self._busy = _union((o.start, o.start + o.dur) for o in self.ops)

    @classmethod
    def load(cls, path) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data.get("traceEvents", data) if isinstance(data, dict)
                   else data)

    def _enclosing(self, queries) -> list[list[int]]:
        """For each (ts, tid) of `queries`, the indices of the host ranges
        of that thread open at ts, outer first (ranges of a thread nest)."""
        order = sorted(range(len(queries)), key=lambda q: queries[q][0])
        out = [None] * len(queries)
        stacks: dict = {}
        i = 0
        for q in order:
            ts, tid = queries[q]
            while i < len(self.ranges) and self.ranges[i][1] <= ts:
                r = self.ranges[i]
                st = stacks.setdefault(r[3], [])
                while st and self.ranges[st[-1]][2] <= r[1]:
                    st.pop()
                st.append(i)
                i += 1
            st = stacks.get(tid, [])
            while st and self.ranges[st[-1]][2] <= ts:
                st.pop()
            out[q] = [j for j in st if self.ranges[j][2] > ts]
        return out

    # --- queries -----------------------------------------------------------

    @property
    def n_batches(self) -> int:
        return len(self.batches)

    def in_batches(self) -> list[Op]:
        return [o for o in self.ops if o.batch is not None]

    def device_us(self, where) -> float:
        """Device time of the batches' operations launched under a host
        range for which where(ranges) holds."""
        return sum(o.dur for o in self.in_batches() if where(o.ranges))

    def window(self) -> tuple[float, float]:
        """From the first batch's start to the last batch's or device
        operation's end."""
        ends = [self.batches[-1][2]] + [o.start + o.dur
                                        for o in self.in_batches()]
        return self.batches[0][1], max(ends)

    def busy_us(self, spans) -> float:
        """Time within `spans` [(start, end)] in which some operation ran."""
        total = 0.0
        for lo, hi in spans:
            j = bisect.bisect_left(self._busy, (lo, lo))
            for s, e in self._busy[max(0, j - 1):]:
                if s >= hi:
                    break
                total += max(0.0, min(e, hi) - max(s, lo))
        return total

    def batch_spans(self) -> list[tuple[float, float]]:
        return [(b[1], b[2]) for b in self.batches]

    def idle_gaps(self, lo: float, hi: float) -> list[tuple[float, float]]:
        """(start, length) of the spans in [lo, hi] with no operation."""
        gaps, end = [], lo
        for s, e in self._busy:
            if e <= lo or s >= hi:
                continue
            if s > end:
                gaps.append((end, s - end))
            end = max(end, e)
        if hi > end:
            gaps.append((end, hi - end))
        return gaps

    def by_range(self) -> dict:
        """Device ms per batch by the innermost host range open at each
        operation's launch."""
        out = {}
        for o in self.in_batches():
            k = o.ranges[-1] if o.ranges else "host (no range)"
            out[k] = out.get(k, 0.0) + o.dur / 1e3 / self.n_batches
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time of
        the window by the host range open in the middle of each gap."""
        by_op, by_gap = {}, {}
        for o in self.in_batches():
            k = kernel_id(o.name)
            by_op[k] = by_op.get(k, 0.0) + o.dur / 1e6
        lo, hi = self.window()
        gaps = self.idle_gaps(lo, hi)
        # the innermost host range of the main thread open mid-gap
        opened = self._enclosing([(s + g / 2, self.main_tid)
                                  for s, g in gaps])
        for (_, g), rs in zip(gaps, opened):
            k = self.ranges[rs[-1]][0] if rs else "host (no range)"
            by_gap[k] = by_gap.get(k, 0.0) + g / 1e6
        srt = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                    key=lambda kv: -kv[1])][:top]
        return {"device_ops": srt(by_op), "idle_gaps": srt(by_gap)}


def _union(intervals) -> list[tuple[float, float]]:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out
