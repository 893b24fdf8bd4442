"""End-to-end prover benchmark of the port (counterpart of the reference's
bench.py and its benches/bench.rs workload).

    python3 -m polymath_tpu_torch.bench [--device {cuda,cpu}]
        [--cache-dir DIR]

Workload: BenchCircuit (a*b = c replicated) at 2^20 - 100 R1CS
constraints, BLS12-381, Merlin transcript, ``Rng(0)``, a and b drawn
first, as the reference.  The reference's env overrides hold:
``POLYMATH_BENCH_CONSTRAINTS`` / ``_VARIABLES`` (default: the
constraints), ``_REPS`` (3), ``_VERIFY_REPS`` (50) and ``_SKIP_SAVE``
(``1``/``true``: a key made by setup is not written).

The proving key is cached in ``--cache-dir`` (default ``<repo>/.bench_cache``,
gitignored) as the dir ``torch_pk_<constraints>_<seed>.dir``
(``protocol/keys.py``): loaded when it is there, else made by setup and
written (to a temporary name, renamed when whole).  With a loaded key,
setup draws nothing from the Rng, so the proofs differ from those of a run
that made the key, as in the reference.

One warm prove, then ``reps`` steady split proves and ``reps`` fused-scan
proves (``POLYMATH_MSM_FUSED=1``; the least of each), then
``verify_reps`` timed verifies.  Every proof must verify, and the first
fused proof, made from a deep copy of the Rng state that the first split
rep started from, must equal that split proof byte for byte; otherwise
the entry raises (exit code 1).

Prints ONE JSON line on stdout, in the reference's shape:
``{"metric": "prove_ns_per_constraint", "value": ..., "unit":
"ns/constraint", "vs_baseline": ..., "detail": {...}}``, the value from
the steady split prove; ``vs_baseline`` > 1 is faster than the
reference's documented arkworks-class CPU estimate of 25 s at 2^20
constraints.  The phase timers go to stderr (``POLYMATH_TRACE``, on by
default here).  ``main(argv=None) -> dict`` returns the line.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import shutil
import sys
import time

import torch

#: the reference's documented estimate (bench.py:32), ns per constraint
BASELINE_NS_PER_CONSTRAINT = 25e9 / (1 << 20)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 0


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _clock(dev: torch.device) -> float:
    """Host seconds, after the card has finished what was queued."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def _load_kernels(dev: torch.device) -> float:
    """Seconds to build (when stale) and load the path's kernel
    libraries; 0 on the CPU, which runs the plain versions."""
    if dev.type != "cuda":
        return 0.0
    from .ops import _build
    t0 = time.perf_counter()
    _build.build_all(_build.PATH_SOURCES)
    for name in _build.PATH_SOURCES:
        _build.lib(name)
    return time.perf_counter() - t0


def _prove(pm, pk, circuit, rng, fused: bool):
    """One prove in the split or fused-scan configuration (the env var is
    read at each MSM call)."""
    from .utils.config import environ
    with environ(POLYMATH_MSM_FUSED="1" if fused else "0"):
        return pm.prove(pk, circuit, rng)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a card) or cpu "
                         "(the kernels' plain versions)")
    ap.add_argument("--cache-dir", default=os.path.join(REPO, ".bench_cache"))
    args = ap.parse_args(argv)
    os.environ.setdefault("POLYMATH_TRACE", "1")

    from .circuits import BenchCircuit
    from .hostmath.bls12_381 import R
    from .protocol import Polymath, Rng, keys
    from .transcript import MerlinFieldTranscript
    from .utils.config import nvidia_smi_line

    num_constraints = _env_int("POLYMATH_BENCH_CONSTRAINTS", (1 << 20) - 100)
    num_variables = _env_int("POLYMATH_BENCH_VARIABLES", num_constraints)
    reps = _env_int("POLYMATH_BENCH_REPS", 3)
    verify_reps = _env_int("POLYMATH_BENCH_VERIFY_REPS", 50)
    skip_save = os.environ.get("POLYMATH_BENCH_SKIP_SAVE", "") in ("1",
                                                                   "true")
    if reps < 1:
        raise ValueError("POLYMATH_BENCH_REPS must be at least 1")

    rng = Rng(SEED)
    a, b = rng.randrange(R), rng.randrange(R)
    public = [a * b % R]

    def circuit():
        return BenchCircuit(a, b, num_variables=num_variables,
                            num_constraints=num_constraints)

    pm = Polymath(transcript=MerlinFieldTranscript,
                  device=None if args.device == "cuda" else "cpu")
    dev = pm.device
    device_name = nvidia_smi_line() if dev.type == "cuda" else "cpu"
    kernel_build_s = _load_kernels(dev)

    pk_dir = os.path.join(args.cache_dir,
                          f"torch_pk_{num_constraints}_{SEED}.dir")
    setup_s = pk_load_s = 0.0
    if os.path.isdir(pk_dir):
        t0 = _clock(dev)
        pk = keys.load_dir(pk_dir, dev)
        pk_load_s = _clock(dev) - t0
        print(f"# setup: loaded {pk_dir} in {pk_load_s:.3f} s "
              f"(n={pk.vk.n})", file=sys.stderr)
    else:
        t0 = _clock(dev)
        pk, _ = pm.setup(circuit(), rng)
        setup_s = _clock(dev) - t0
        print(f"# setup: {setup_s:.3f} s (n={pk.vk.n})", file=sys.stderr)
        if not skip_save:
            t0 = time.perf_counter()
            tmp = f"{pk_dir}.{os.getpid()}.tmp"
            keys.save_dir(pk, tmp)
            try:
                os.rename(tmp, pk_dir)
            except OSError:        # another run wrote the dir meanwhile
                shutil.rmtree(tmp)
            print(f"# setup: key written to {pk_dir} in "
                  f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    vk = pk.vk

    proofs = []
    t0 = _clock(dev)
    proofs.append(_prove(pm, pk, circuit(), rng, fused=False))
    warm_s = _clock(dev) - t0
    print(f"# warm prove: {warm_s:.3f} s", file=sys.stderr)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    # the first split rep and the first fused prove start from one Rng
    # state: the fused one from a deep copy taken before the split reps
    twin_rng = copy.deepcopy(rng)
    times = {False: [], True: []}
    for fused in (False, True):
        for i in range(reps):
            t0 = _clock(dev)
            proofs.append(_prove(pm, pk, circuit(),
                                 twin_rng if fused and i == 0 else rng,
                                 fused))
            times[fused].append(_clock(dev) - t0)
    fused_equals_split = proofs[1].to_bytes() == proofs[1 + reps].to_bytes()
    peak_gib = (torch.cuda.max_memory_allocated(dev) / 2**30
                if dev.type == "cuda" else None)
    prove_s, fused_s = min(times[False]), min(times[True])

    rejected = [i for i, p in enumerate(proofs)
                if not pm.verify(vk, public, p)]
    t0 = time.perf_counter()
    ok = all([pm.verify(vk, public, proofs[-1]) for _ in range(verify_reps)])
    verify_s = (time.perf_counter() - t0) / max(verify_reps, 1)
    if rejected or not ok:
        raise RuntimeError(f"bench proofs {rejected} failed to verify")
    if not fused_equals_split:
        raise RuntimeError("the fused-scan proof differs from the split "
                           "proof made from the same Rng state")
    print(f"# steady prove: {prove_s:.3f} s, fused {fused_s:.3f} s; verify "
          f"{verify_s * 1e3:.3f} ms ({verify_reps} reps)", file=sys.stderr)

    ns_per_constraint = prove_s * 1e9 / num_constraints
    line = {
        "metric": "prove_ns_per_constraint",
        "value": ns_per_constraint,
        "unit": "ns/constraint",
        "vs_baseline": BASELINE_NS_PER_CONSTRAINT / ns_per_constraint,
        "detail": {
            "num_constraints": num_constraints,
            "prove_seconds": prove_s,
            "fused_prove_seconds": fused_s,
            "warm_prove_seconds": warm_s,
            "setup_seconds": setup_s,
            "pk_load_seconds": pk_load_s,
            "kernel_build_seconds": kernel_build_s,
            "verify_ms": verify_s * 1e3,
            "verify_reps": verify_reps,
            "reps": reps,
            "peak_gib": peak_gib,
            "domain_n": vk.n,
            "verify": True,
            "fused_equals_split": fused_equals_split,
            "device": device_name,
            "baseline": "arkworks-class CPU estimate, 25 s at 2^20 "
                        "constraints (the reference's bench.py; no "
                        "published reference numbers)",
        },
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
