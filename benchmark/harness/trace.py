"""The traced run's device timeline: a ``torch.profiler`` trace of the
window (kernels, copies and fills on the card; the prover's phases as
host annotations), reduced to busy time, idle gaps by host phase, and
device time by kernel.

``reduce_events`` takes the events alone, so that the reduction is
tested on the CPU with events made by hand.
"""

from __future__ import annotations

import bisect
import contextlib

#: Chrome-trace categories of work on the card
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CAT = "user_annotation"
WINDOW = "bench::window"
PHASES = "prover::"
OUTSIDE = "between prover phases"


def _ns(e, what: str) -> float:
    """An event's start or duration in ns (``start_ns`` in recent PyTorch,
    ``start_us`` in older)."""
    if hasattr(e, f"{what}_ns"):
        return getattr(e, f"{what}_ns")()
    return getattr(e, f"{what}_us")() * 1e3


def _category(e, prefix: str) -> str:
    """The event's Chrome-trace category: ``activity_type`` where the
    event has it; else work on the card unless it is one of the
    harness's annotations mirrored there, and host annotations by name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    from torch.autograd import DeviceType
    ours = e.name() == WINDOW or e.name().startswith(prefix)
    if e.device_type() == DeviceType.CUDA:
        return "gpu_user_annotation" if ours else "kernel"
    return HOST_CAT if ours else "cpu_op"


def kineto_events(results, prefix: str = PHASES) -> list:
    """The events ``reduce_events`` reads, from the profiler's results in
    memory, in Chrome-trace form (times in us)."""
    events = []
    for e in results.events():
        cat = _category(e, prefix)
        if cat in DEVICE_CATS or cat == HOST_CAT:
            events.append({"cat": cat, "name": e.name(),
                           "ts": _ns(e, "start") * 1e-3,
                           "dur": _ns(e, "duration") * 1e-3})
    return events


@contextlib.contextmanager
def profiled(device):
    """Profile the block (CPU and, on a card, CUDA activity); yields a
    dict whose ``events`` are then the events of the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out = {}
    with profile(activities=acts) as prof:
        yield out
    out["events"] = kineto_events(prof.profiler.kineto_results)


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_events(events, prefix: str = PHASES) -> dict | None:
    """From the trace's events: ``window_s``, ``busy_s`` (the union of
    device work inside the window), ``kernel_s`` (device seconds by
    kernel name), ``idle_s`` (idle seconds by the host phase under each
    gap's midpoint; phases are the host annotations whose name starts
    with ``prefix``).  None when the trace holds no window."""
    win = [e for e in events if e.get("cat") == HOST_CAT
           and e.get("name") == WINDOW]
    if not win:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, kernel_s = [], {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        dev.append((a, b))
        kernel_s[e["name"]] = kernel_s.get(e["name"], 0.0) + (b - a) * 1e-6
    busy = _union(dev)
    phases = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in events
                    if e.get("cat") == HOST_CAT
                    and str(e.get("name", "")).startswith(prefix))
    starts = [p[0] for p in phases]
    idle_s, t = {}, w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            mid = (t + a) / 2
            i = bisect.bisect_right(starts, mid) - 1
            label = phases[i][2] if i >= 0 and mid < phases[i][1] else OUTSIDE
            idle_s[label] = idle_s.get(label, 0.0) + (a - t) * 1e-6
        t = max(t, b)
    return {"window_s": (w1 - w0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "kernel_s": kernel_s, "idle_s": idle_s}


def short(name: str, width: int = 120) -> str:
    """A kernel's name without ``void `` and cut to ``width`` characters
    (templated library kernels run to hundreds)."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= width else name[:width - 3] + "..."


def top(seconds: dict, k: int = 10) -> list:
    """The ``k`` largest entries as [short name, seconds], largest first."""
    return [[short(name), s] for name, s in
            sorted(seconds.items(), key=lambda kv: -kv[1])[:k]]
