"""One run of one cell of BENCHMARK.json on the card it is started on.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Prints the cell's end-to-end metrics (``--trace 0``) or its per-layer
metrics (``--trace 1``) as one JSON line, the last of standard output,
and the numbers of the correctness check, each beside its limit, as the
last lines of standard error.  Exits with 2, printing no result, when the
card or cards the cell asks for are not visible, and with 3 when the
process holds JAX or the JAX package once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "benchmark", ".cache")


def _environment(trace: bool) -> None:
    """The default MSM configuration (no ``POLYMATH_*`` override), the
    phase syncs only when tracing, no JAX pulled in by a library, and every
    kernel cache the program could use (CUDA's JIT cache, Triton's, PyTorch
    extensions') at a fixed path inside the checkout, so that only a
    checkout's first run builds."""
    for k in [k for k in os.environ if k.startswith("POLYMATH_")]:
        del os.environ[k]
    if trace:
        os.environ["POLYMATH_TRACE"] = "1"
    os.environ["USE_FLAX"] = "0"
    for var, sub in (("CUDA_CACHE_PATH", "nv"), ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = os.path.join(CACHE, sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment(bool(args.trace))
    sys.path.insert(0, ROOT)
    from benchmark.harness import cell as harness
    from benchmark.harness import spec

    c = spec.Cell.from_benchmark(spec.benchmark(ROOT), args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        print(f"{args.workload} needs {c.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    run, info, numbers, attempted, failed = harness.execute(
        c, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the process holds {', '.join(bad)} after the window",
              file=sys.stderr)
        return 3
    line = harness.result(c, run, info, numbers, attempted, failed,
                          bool(args.trace))
    print(f"# key load {run.key_load_s:.3f} s; warm-up proves "
          f"{[round(s, 3) for s in run.warm_s]} s; window {run.window_s:.3f} s,"
          f" proves {[round(s, 3) for s in run.latencies]} s", file=sys.stderr)
    for name, (value, limit) in numbers.items():
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
