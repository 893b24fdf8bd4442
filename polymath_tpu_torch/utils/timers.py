"""Phase-scoped wall-clock timers (ark-std start_timer!/end_timer! analogue).

Same contract as the reference's timers: printing is off unless the env
var POLYMATH_TRACE is set (to any non-empty value other than 0/off/false).
With tracing on, ``sync`` waits for the card so a phase measures device
execution, and each phase also opens an NVTX range so it shows up as a
named span in a CUDA profiler trace.

Each callable in ``HOOKS`` is called with the label and entered as a
context manager around every phase: the benchmark's traced run times each
phase so, and the card tests count each phase's kernel launches.

Usage::

    with phase("prover::ntt u,w"):
        ...
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import sys
import time

from .config import device_sync

_DEPTH = contextvars.ContextVar("polymath_phase_depth", default=0)

#: hook(label) -> context manager, entered around every phase
HOOKS: list = []


def trace_enabled() -> bool:
    return os.environ.get("POLYMATH_TRACE", "") not in ("", "0", "off",
                                                        "false")


def sync(x):
    """Wait for the card when tracing, so phase() scopes measure device
    execution.  Returns its argument."""
    if trace_enabled():
        device_sync()
    return x


@contextlib.contextmanager
def _nvtx(label: str):
    import torch
    if torch.cuda.is_available():
        torch.cuda.nvtx.range_push(label)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()
    else:
        yield


@contextlib.contextmanager
def phase(label: str):
    tracing = trace_enabled()
    depth = _DEPTH.get()
    indent = "  " * depth
    if tracing:
        print(f"{indent}Start: {label}", file=sys.stderr)
    tok = _DEPTH.set(depth + 1)
    t0 = time.time()
    try:
        with _nvtx(label), contextlib.ExitStack() as hooks:
            for hook in HOOKS:
                hooks.enter_context(hook(label))
            yield
    finally:
        _DEPTH.reset(tok)
        dt = time.time() - t0
        if tracing:
            human = f"{dt*1e3:.3f}ms" if dt < 1 else f"{dt:.3f}s"
            print(f"{indent}End:   {label} {human}", file=sys.stderr)
