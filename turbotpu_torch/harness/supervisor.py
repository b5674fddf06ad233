"""Failure detection and sweep re-launch.

Counterpart of turbotpu/harness/supervisor.py.  Long BER sweeps are
restartable by construction (JSONL checkpoint, harness/ber.py); this module
is the driver side: launch the sweep's process group, fail fast when any
member dies or the results file stalls, kill the survivors by exact PID
(never by pattern), and re-launch the whole group -- completed grid points
resume from the checkpoint, so a crash costs at most one in-flight point.

Multi-process scope: a torch.distributed process group cannot re-admit a
single restarted member mid-job, so recovery is group-granular -- one
supervisor per host wraps that host's process, and any member death
triggers a whole-group relaunch.  On one host the supervisor owns the
entire group directly.  `cli supervise -- <command>` wraps one
`python -m turbotpu_torch.cli <command>` child.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys
import time


def _size(path) -> int:
    try:
        return pathlib.Path(path).stat().st_size
    except OSError:
        return -1


def supervise(worker_argvs: list[list[str]], *, max_restarts: int = 3,
              stall_timeout_s: float | None = None,
              results_path: str | None = None,
              env: dict | None = None, poll_s: float = 0.2,
              verbose: bool = True) -> int:
    """Run the worker process group to completion with re-launch.

    worker_argvs: one argv per group member (one on a single host).
    Failure = any member exits nonzero, or (with stall_timeout_s and
    results_path) the results file makes no progress for that long --
    the watchdog that catches hangs no exit code ever reports (e.g. a
    collective deadlocked on a lost peer).  On failure the remaining
    members are killed by their exact Popen PIDs and the group restarts;
    sweeps resume from the JSONL checkpoint.  Returns the number of
    restarts used; raises RuntimeError once max_restarts is exhausted.
    """
    restarts = 0
    while True:
        procs = [subprocess.Popen(argv, env=env) for argv in worker_argvs]
        failed = False
        last_progress = time.monotonic()
        last_size = _size(results_path) if results_path else -1
        while True:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes):
                return restarts
            if any(c not in (None, 0) for c in codes):
                failed = True
                break
            if stall_timeout_s is not None and results_path is not None:
                size = _size(results_path)
                if size != last_size:
                    last_size = size
                    last_progress = time.monotonic()
                elif time.monotonic() - last_progress > stall_timeout_s:
                    failed = True
                    break
            time.sleep(poll_s)
        for p in procs:
            if p.poll() is None:
                p.kill()          # exact PID of a child we spawned
        for p in procs:
            p.wait()
        if not failed:
            return restarts
        restarts += 1
        if restarts > max_restarts:
            raise RuntimeError(
                f"sweep failed {restarts} times (max_restarts="
                f"{max_restarts}); see the JSONL checkpoint for the last "
                "completed grid point")
        if verbose:
            print(f"[supervisor] group failure; relaunch {restarts}/"
                  f"{max_restarts} (resuming from checkpoint)",
                  file=sys.stderr, flush=True)
