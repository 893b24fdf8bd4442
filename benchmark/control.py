"""The check's readings on the card: a cell run on several seeds in one
process, sound or with a fault planted under the timed path
(``faults.py``), each run's compared numbers printed beside their limits.
The benchmark's own runs never run this.

    python3 benchmark/control.py --workload NAME --seconds S \\
        [--fault control|stale|half|altered] --seeds N[,N...]

Prints one JSON line a seed: ``{"seed", "fault", "correct", "attempted",
"numbers": {name: [value, limit]}}``.
"""

import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmark.run import _environment
    _environment(trace=False)
    from benchmark import faults
    from benchmark.harness import cell as harness
    from benchmark.harness import check, spec

    c = spec.Cell.from_benchmark(spec.benchmark(ROOT), args.workload, ROOT)
    for seed in [int(s) for s in args.seeds.split(",")]:
        plant = (faults.planted(args.fault) if args.fault
                 else contextlib.nullcontext())
        with plant:
            run, _, numbers, attempted, _ = harness.execute(
                c, seed, args.seconds, False, "cuda", time.perf_counter())
        print(json.dumps({"seed": seed, "fault": args.fault,
                          "correct": check.correct(numbers),
                          "attempted": attempted,
                          "median_prove_s": harness.nearest_rank(
                              run.latencies, 0.5) if run.latencies else None,
                          "numbers": numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
