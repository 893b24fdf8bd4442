"""Limits of the suite under ``tests/``: fail any of its tests not marked
slow whose setup or body runs past ``LIMIT`` seconds, and mark slow the JAX
reference's tests that cannot stay under the two limits pytest.ini's
``slow`` marker states (300 s and 8 GB alone on a cold compile cache).
Each cost is an XLA:CPU compile of ``msm_device``, of the device prover or
of the sharded step, not the test's size: the smallest ``msm_device``
program (2 points, chunk 16) alone takes 170 s and 6.8 GB, and the
tail-split test at chunk 32, the least that keeps both of its branches,
ran past 300 s and 10 GB in a whole run with six workers.  Other tests,
such as the benchmark's own under ``benchmark/tests``, get no limit from
here.  Where jax is not installed, the test files that need it are not
collected (``pytest_ignore_collect``)."""

import ast
import contextlib
import faulthandler
import importlib.util
import pathlib
import signal
import sys
import threading

import pytest

# Seconds any one test may run before it fails with a stack dump.  Tests
# marked slow are exempt: they run only under `-m slow`, where one XLA:CPU
# compile may take longer.  A C++ compile is not interrupted by SIGALRM
# (the handler runs when control returns to Python), so the faulthandler
# dump is what shows where such a test is stuck.
LIMIT = 300
SUITE = pathlib.Path(__file__).parent / "tests"
# Top-level packages that need jax: the JAX package and its tools
JAX_ROOTS = {"jax", "jaxlib", "polymath_tpu", "tools"}
JAX_INSTALLED = importlib.util.find_spec("jax") is not None

# Node id -> what it took alone, in its own process, on an empty compile
# cache (cold) and on the cache that run left (warm); 8 cores, 62 GB host.
SLOW = {
    "tests/test_e2e_device.py::test_device_backend_dummy_e2e":
        "cold over 310 s at 4.4 GB; warm past 10 GB at 222 s",
    "tests/test_e2e_device.py::test_device_backend_mimc_reduced_e2e":
        "cold over 310 s at 5.6 GB; warm over 311 s at 7.2 GB",
    "tests/test_e2e_device.py::test_device_backend_corrupt_witness_raises":
        "cold 304.7 s at 4.4 GB; warm 169 s at 5.4 GB",
    "tests/test_e2e_device.py::test_msm_device_vs_host_oracle_2_12":
        "cold past 10 GB at 148 s; warm past 10 GB at 140 s",
    "tests/test_e2e_device.py::test_msm_tiny_tail_split_vs_host_oracle":
        "cold past 10 GB at 216 s; warm past 10 GB at 191 s",
    "tests/test_e2e_device.py::test_msm_fast_mode_flags_collisions":
        "cold over 310 s at 8.7 GB; warm past 10 GB at 43 s",
    "tests/test_sharded_ops.py::test_sharded_ntt_and_msm_vs_host_oracles":
        "cold past 10 GB at 196 s; warm past 10 GB at 119 s",
    "tests/test_sharded_ops.py::test_sharded_msm_2_10_points":
        "cold over 310 s at 4.6 GB; warm over 310 s at 6.9 GB",
}


def pytest_ignore_collect(collection_path):
    """Where jax is not installed (the CUDA card's machine), leave out the
    test files that import jax, the JAX package or its tools: they cannot
    be imported there, and without them ``pytest -m cuda tests/``
    collects the card tests."""
    if collection_path.suffix != ".py" or JAX_INSTALLED:
        return None
    body = ast.parse(collection_path.read_text(), str(collection_path)).body
    names = [a.name for n in body if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in body
              if isinstance(n, ast.ImportFrom) and n.level == 0 and n.module]
    return True if {n.split(".")[0] for n in names} & JAX_ROOTS else None


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    # tryfirst: the mark must be on the item before `-m` deselects
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)


@contextlib.contextmanager
def time_limit(seconds):
    """Fail the running test if its body outlasts ``seconds``.

    Arms a SIGALRM that raises pytest's failure and a faulthandler dump of
    every thread's stack to the process's own stderr at the same moment;
    disarms both on exit (the alarm then reads 0, so limits do not nest).
    Signals reach only the main thread, so elsewhere this does nothing."""
    if threading.current_thread() is not threading.main_thread():
        yield
        return

    def expire(signum, frame):
        pytest.fail(f"test ran past its {seconds} s limit")

    # sys.__stderr__, not sys.stderr: under --capture=sys the latter has
    # no file descriptor for faulthandler to write to
    faulthandler.dump_traceback_later(seconds, exit=False,
                                      file=sys.__stderr__)
    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
        faulthandler.cancel_dump_traceback_later()


@pytest.fixture(name="time_limit")
def _time_limit():
    """The context manager itself, for the tests of the limit."""
    return time_limit


def _limited(item):
    if SUITE not in item.path.parents or item.get_closest_marker("slow"):
        yield
        return
    with time_limit(LIMIT):
        yield


# Setup has a limit of its own, so a fixture that stalls fails its test too
@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    yield from _limited(item)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    yield from _limited(item)
