"""Guards of the tier-1 command itself: `tpu` tests skip off a TPU whatever
`-m` the caller passes, and a test that stalls fails once, by name, while
the rest of its file and of the run goes on."""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

TESTS = Path(__file__).resolve().parent
ROOT_CONFTEST = TESTS.parent / "conftest.py"


def run_pytest(args, cwd):
    # A run of its own: an xdist worker's run id would share the records
    # that the root conftest's TimeLimit keys by it.
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_XDIST_")}
    # The tier-1 command's -m, which replaces the one in pytest.ini's addopts.
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-m", "not slow", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=60)


def test_tpu_test_skips_under_tier1_marks():
    node = "tests/perf/test_perf_guards.py::test_throughput_floor_tpu"
    out = run_pytest(["-rs", node], cwd=TESTS.parent)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "1 skipped" in out.stdout, out.stdout
    assert "needs a TPU; tests/conftest.py pins JAX to the CPU" in out.stdout


def test_stalled_test_fails_once_and_its_file_goes_on(tmp_path):
    (tmp_path / "pytest.ini").write_text("[pytest]\n")
    (tmp_path / "conftest.py").write_text(textwrap.dedent(f"""
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "repo_conftest", {str(ROOT_CONFTEST)!r})
        repo_conftest = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(repo_conftest)


        def pytest_configure(config):
            config.pluginmanager.register(repo_conftest.TimeLimit(2))
    """))
    (tmp_path / "test_stall.py").write_text(textwrap.dedent("""
        import ctypes


        def test_before():
            pass


        def test_blocks_in_c():
            # libc sleep through PyDLL keeps the GIL for the whole call.
            ctypes.PyDLL(None).sleep(600)


        def test_after():
            pass
    """))
    (tmp_path / "test_other.py").write_text(textwrap.dedent("""
        def test_one():
            pass


        def test_two():
            pass
    """))
    out = run_pytest(["-n", "2", "--dist", "loadfile", "-rfEs"], cwd=tmp_path)
    text = out.stdout + out.stderr
    assert out.returncode != 0, text
    assert len(re.findall(r"^FAILED test_stall\.py::test_blocks_in_c\b",
                          out.stdout, re.M)) == 1, text
    assert re.search(r"\b1 failed, 4 passed, 1 skipped\b", out.stdout), text
    # The watchdog's stack dump reaches the run's stderr and names the test.
    assert re.search(r'test_stall\.py", line \d+ in test_blocks_in_c',
                     out.stderr), text
