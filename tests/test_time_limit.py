"""The per-test time limit of the repo's root ``conftest.py``: a stalled
body fails with pytest's failure, a quick one passes, and the alarm is
disarmed."""

import io
import signal
import sys
import time

import pytest


def test_time_limit_fails_a_stalled_body(time_limit):
    t0 = time.monotonic()
    with pytest.raises(pytest.fail.Exception, match="0.5 s limit"):
        with time_limit(0.5):
            time.sleep(2)
    assert time.monotonic() - t0 < 1.5
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)


def test_time_limit_passes_a_quick_body(time_limit):
    with time_limit(0.5):
        total = sum(range(1000))
    assert total == 499500
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)
    time.sleep(0.7)  # past the limit: nothing may fire once disarmed


def test_time_limit_without_a_stderr_descriptor(time_limit, monkeypatch):
    """Under --capture=sys, sys.stderr is an in-memory stream with no file
    descriptor; arming the stack dump must not fail on it."""
    monkeypatch.setattr(sys, "stderr", io.StringIO())
    with pytest.raises(pytest.fail.Exception, match="0.5 s limit"):
        with time_limit(0.5):
            time.sleep(2)
    assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0)
