"""One run of one cell: set-up, the closed-loop window, the metrics, and
the check.

Set-up: the kernel libraries are built (first run in a checkout) and
loaded, the key is made (first run) or loaded, a pool of statements is
made where the configuration keeps one, and the cell's warm-up proves run
on its own shapes.  The window starts at the first timed prove, proves
one statement after the other (a closed loop of one prover: each request
waits for the one before) until ``seconds`` have passed, and ends when
the prove in flight ends.  Then the device's peak is read, the program's
state is freed, and the reference judges the key and every proof.

With ``trace``, each prover phase (``POLYMATH_TRACE=1``, so each ends in
a device sync) is timed through a hook in ``utils.timers.HOOKS`` and
marked in a ``torch.profiler`` trace of the window.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import importlib
import math
import pkgutil
import random
import sys
import time
import traceback

from . import check, keystore, spec, trace as tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "polymath_tpu")
#: a window stops after this many proves in a row that raised
MAX_FAILED_IN_A_ROW = 3


class Run:
    """What the metric readers (``metrics/<name>.py``) read."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.setup_s = None
        self.key_load_s = None
        self.warm_prove_s = None
        self.warm_s = []           # seconds of each warm-up prove
        self.window_s = None
        self.latencies = []        # seconds of each completed window prove
        self.phase_s = collections.Counter()   # traced: label -> seconds
        self.launches = {}         # kernel launches in the window, by kernel
        self.device = None         # traced: trace.reduce_events' dict
        self.dims = None           # key: n, m0, m, n_r

    @property
    def proofs(self) -> int:
        return len(self.latencies)

    def per_proof(self, seconds: float) -> float | None:
        return seconds / self.proofs if self.proofs else None


class Statements:
    """Statement i of a run, drawn from the seed: a fresh one each proof, or
    the configuration's pool (made in set-up) in turn."""

    def __init__(self, kind, cfg, seed: int):
        self.kind, self.cfg = kind, cfg
        self.rng = random.Random(f"statements-{seed}")
        size = int(cfg.get("statement_pool", 0))
        self.pool = [self._draw() for _ in range(size)]

    def _draw(self):
        st = self.kind.draw_statement(self.cfg, self.rng)
        return st, self.kind.prepare(self.cfg, st)

    def get(self, i: int):
        """(key, statement, prepared): proofs with one key share a
        statement."""
        if self.pool:
            k = i % len(self.pool)
            return (k,) + self.pool[k]
        return (i,) + self._draw()


def launch_counts() -> dict:
    """Every kernel wrapper's ``LAUNCHES`` counter in the program's ops."""
    from polymath_tpu_torch import ops
    out = {}
    for info in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"{ops.__name__}.{info.name}")
        out.update(getattr(mod, "LAUNCHES", {}))
    return dict(out)


def _load_kernels(dev) -> None:
    if dev.type != "cuda":
        return
    from polymath_tpu_torch.ops import _build
    _build.build_all(_build.PATH_SOURCES)
    for name in _build.PATH_SOURCES:
        _build.lib(name)


@contextlib.contextmanager
def _phase_hook(run: Run):
    import torch
    from polymath_tpu_torch.utils import timers

    @contextlib.contextmanager
    def hook(label):
        t0 = time.perf_counter()
        with torch.profiler.record_function(label):
            yield
        run.phase_s[label] += time.perf_counter() - t0

    timers.HOOKS.append(hook)
    try:
        yield
    finally:
        timers.HOOKS.remove(hook)


def _transcript(name: str):
    from polymath_tpu_torch import transcript
    return {t.name: t for t in transcript.ALL_TRANSCRIPTS}[name]


def execute(cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, keys_dir: str = keystore.KEYS):
    """The run: (Run, device dict, check numbers, proves attempted, proves
    that raised).  The warm-up proves count as attempted: the reference
    judges them too."""
    import torch
    from polymath_tpu_torch.protocol import Polymath, Rng

    cfg = cell.cfg
    if cell.loop["loop"] != "closed" or cell.loop["provers"] != 1:
        raise ValueError(f"{cell.name}: this harness runs a closed loop of "
                         f"one prover")
    dev = torch.device(device)
    run = Run(cfg)
    _load_kernels(dev)
    kind = spec.circuit_kind(cfg)
    digest = keystore.source_hash([cell.config_path, kind.__file__])
    path = keystore.key_dir(cell.config_name, cfg["setup_seed"], digest,
                            keys_dir)
    pm = Polymath(transcript=_transcript(cfg["transcript"]), device=dev)

    def make():
        return pm.setup(kind.setup_circuit(cfg), Rng(cfg["setup_seed"]))[0]

    pk, run.key_load_s, made = keystore.load_or_make(path, make, dev)
    if made and dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    m0, m, n_r = pk.sap_matrices.m0_m_n()
    run.dims = {"n": pk.vk.n, "m0": m0, "m": m, "n_r": n_r}
    vk_bytes = pk.vk.to_bytes()

    statements = Statements(kind, cfg, seed)
    prover_rng = Rng(seed)
    proofs = []

    def prove(i: int) -> None:
        key, st, prepared = statements.get(i)
        proof = pm.prove(pk, kind.prove_circuit(cfg, prepared), prover_rng)
        keystore.sync(dev)
        proofs.append((key, st, proof.to_bytes()))

    warm = int(cell.loop["warm_proves"])
    for i in range(warm):
        t0 = time.perf_counter()
        prove(i)
        run.warm_s.append(time.perf_counter() - t0)
    run.warm_prove_s = run.warm_s[0] if run.warm_s else None

    failed = in_a_row = 0
    profile = {}
    with contextlib.ExitStack() as stack:
        if trace:
            profile = stack.enter_context(tracing.profiled(dev))
            stack.enter_context(_phase_hook(run))
        before = launch_counts()
        gc.collect()
        gc.freeze()
        keystore.sync(dev)
        t0 = time.perf_counter()
        run.setup_s = t0 - t_start
        with torch.profiler.record_function(tracing.WINDOW):
            i = warm
            while True:
                a = time.perf_counter()
                try:
                    prove(i)
                    run.latencies.append(time.perf_counter() - a)
                    in_a_row = 0
                except Exception:
                    failed += 1
                    in_a_row += 1
                    traceback.print_exc(file=sys.stderr)
                i += 1
                if (time.perf_counter() - t0 >= seconds
                        or in_a_row >= MAX_FAILED_IN_A_ROW):
                    break
            run.window_s = time.perf_counter() - t0
        gc.unfreeze()
        after = launch_counts()
    run.launches = {k: after[k] - before.get(k, 0) for k in after}
    attempted = i

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del pk, pm, statements
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else dev.type),
            "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace:
        run.device = tracing.reduce_events(profile["events"])
        if run.device is not None:
            info["busy_s"] = run.device["busy_s"]
            info["window_s"] = run.device["window_s"]

    numbers = check.judge(cfg, vk_bytes, proofs, failed, seed)
    return run, info, numbers, attempted, failed


def nearest_rank(values, q: float) -> float:
    """The q-quantile of ``values`` by nearest rank."""
    s = sorted(values)
    return s[max(math.ceil(q * len(s)), 1) - 1]


def forbidden_modules() -> list:
    """Top-level names of loaded modules that this process must not hold:
    JAX and the JAX package, compared by whole top-level name."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def result(cell, run: Run, info: dict, numbers: dict, attempted: int,
           failed: int, trace: bool) -> dict:
    """The result line: the cell's end-to-end metrics, or with ``trace``
    its per-layer metrics, each from its reader; readers that find nothing
    are left out."""
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": check.correct(numbers), "attempted": attempted,
            "failed": failed + numbers["proofs_rejected"][0],
            "metrics": metrics, "device": info}
    if trace and run.device is not None:
        line["breakdown"] = {
            "device_ops": tracing.top(run.device["kernel_s"]),
            "idle_gaps": tracing.top(run.device["idle_s"])}
    line["check"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in numbers.items()}
    return line
