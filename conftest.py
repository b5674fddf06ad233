"""Suite-wide guards of the test run: `tpu` tests skip off a TPU, and every
test has a time limit that fails a stalled test once, by name.

This file imports no JAX, so a throwaway suite can load `TimeLimit` alone.
`tests/conftest.py` still pins JAX to the CPU and registers the markers.
"""

import faulthandler
import hashlib
import os
import tempfile
import time
from pathlib import Path

import pytest

# Seconds a test may take, setup and teardown included.  Under the tier-1
# command (-n 6 --dist loadfile, 8 cores) the slowest test,
# test_torch_seq.py::test_seq_groups_split_equals_unsplit, took 125-129 s
# with a cold compile cache (103 s warm).  The limit is 3.5x that, and one
# stall adds at most 450 s to a cold run of 630-695 s, inside the run's
# 1470 s clock.
TEST_LIMIT_S = 450


class TimeLimit:
    """Fail, by name, a test that runs past `limit_s`, and let its file go on.

    faulthandler's watchdog is a C thread: it fires even while the test
    holds the GIL inside compiled code, where no signal handler would run.
    It prints every thread's stack and exits the process; xdist reports the
    running test as failed and starts a new worker.  Under --dist loadfile
    that worker is handed the rest of the file, the stalled test first, so
    each test leaves a record on disk while it runs, and a test that finds
    its own record, left by a dead worker of the same run, skips at once.
    """

    def __init__(self, limit_s):
        self.limit_s = limit_s
        # Taken before any test runs: during a test fd 2 is pytest's
        # capture file, which dies with the process unread.
        self.stderr = os.dup(2)

    def pytest_unconfigure(self, config):
        os.close(self.stderr)

    @pytest.hookimpl(wrapper=True)
    def pytest_runtest_protocol(self, item):
        run = os.environ.get("PYTEST_XDIST_TESTRUNUID", str(os.getpid()))
        key = hashlib.sha1(item.nodeid.encode()).hexdigest()[:16]
        record = Path(tempfile.gettempdir(), f"pytest-{run}-{key}.running")
        if record.exists():
            age = time.time() - record.stat().st_mtime
            item.add_marker(pytest.mark.skip(reason=(
                f"started {age:.0f} s ago on a worker of this run that died "
                f"(time limit {self.limit_s} s); xdist counted it as failed "
                f"there")))
        else:
            record.touch()
        faulthandler.dump_traceback_later(self.limit_s, exit=True,
                                          file=self.stderr)
        try:
            return (yield)
        finally:
            faulthandler.cancel_dump_traceback_later()
            record.unlink(missing_ok=True)


def pytest_configure(config):
    config.pluginmanager.register(TimeLimit(TEST_LIMIT_S))


def pytest_collection_modifyitems(config, items):
    # pytest.ini deselects `tpu`, but a caller's own -m replaces addopts'.
    skip = pytest.mark.skip(
        reason="needs a TPU; tests/conftest.py pins JAX to the CPU")
    for item in items:
        if item.get_closest_marker("tpu"):
            item.add_marker(skip)
