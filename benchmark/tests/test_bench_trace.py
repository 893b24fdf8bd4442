"""The trace reduction on hand-made Chrome-trace events."""

import pytest

from benchmark.harness import trace


def ev(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "ph": "X"}


def test_reduce_events():
    events = [
        ev("user_annotation", trace.WINDOW, 100, 1000),
        ev("user_annotation", "prover::h2d assignment", 100, 300),
        ev("user_annotation", "prover::msm d_g1 (~10n)", 400, 600),
        ev("kernel", "k_before_window", 0, 150),           # clipped: 100-150
        ev("kernel", "g1_madd_scan_kernel", 450, 200),
        ev("kernel", "g1_madd_scan_kernel", 600, 100),     # overlaps
        ev("gpu_memcpy", "Memcpy HtoD", 800, 100),
        ev("gpu_user_annotation", "prover::x", 100, 1000),  # not work
        ev("cpu_op", "aten::cat", 100, 1000),
    ]
    out = trace.reduce_events(events)
    assert out["window_s"] == pytest.approx(1000e-6)
    assert out["busy_s"] == pytest.approx((50 + 250 + 100) * 1e-6)
    assert out["kernel_s"]["g1_madd_scan_kernel"] == pytest.approx(300e-6)
    assert out["kernel_s"]["k_before_window"] == pytest.approx(50e-6)
    # gaps 150-450, 700-800, 900-1100, each by the phase under its midpoint
    assert out["idle_s"] == pytest.approx({
        "prover::h2d assignment": 300e-6,
        "prover::msm d_g1 (~10n)": 100e-6,
        trace.OUTSIDE: 200e-6})
    assert trace.top(out["kernel_s"], 1) == [
        ["g1_madd_scan_kernel", pytest.approx(300e-6)]]


def test_no_window_no_reading():
    assert trace.reduce_events([ev("kernel", "k", 0, 1)]) is None


class _Old:
    """A profiler event as older PyTorch gives it: no ``activity_type``,
    times in us."""

    def __init__(self, name, device, start_us, dur_us):
        self._n, self._d, self._s, self._u = name, device, start_us, dur_us

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_us(self):
        return self._s

    def duration_us(self):
        return self._u


def test_kineto_events_without_activity_type():
    from torch.autograd import DeviceType

    class Results:
        def events(self):
            return [_Old(trace.WINDOW, DeviceType.CPU, 100, 1000),
                    _Old("prover::stage1", DeviceType.CPU, 100, 500),
                    _Old("aten::cat", DeviceType.CPU, 120, 10),
                    _Old("prover::stage1", DeviceType.CUDA, 110, 490),
                    _Old("ntt_local_kernel", DeviceType.CUDA, 200, 100)]

    events = trace.kineto_events(Results())
    assert [(e["cat"], e["name"]) for e in events] == [
        ("user_annotation", trace.WINDOW),
        ("user_annotation", "prover::stage1"),
        ("kernel", "ntt_local_kernel")]
    out = trace.reduce_events(events)
    assert out["busy_s"] == pytest.approx(100e-6)


def test_profiled_on_the_cpu():
    import torch
    with trace.profiled("cpu") as prof:
        with torch.profiler.record_function(trace.WINDOW):
            with torch.profiler.record_function("prover::x"):
                torch.ones(4).sum()
    names = {e["name"] for e in prof["events"]}
    assert names == {trace.WINDOW, "prover::x"}
    assert trace.reduce_events(prof["events"])["busy_s"] == 0
