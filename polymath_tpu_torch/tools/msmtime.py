"""MSM shape sweep: one point set, many (chunk, c[, seq]) configurations
(counterpart of the reference's tools/msmtime.py).

    python3 -m polymath_tpu_torch.tools.msmtime [--device cpu] [--n N]
        [--configs "chunk:c[:seq];..."] [--reps R] [--seed 0]

N distinct points k_i G are made once on the device by
``ops/fixed_base.py:fixed_base_mul`` from random canonical k_i, with
random canonical scalars (numpy default_rng(seed)).  Each configuration
sets ``POLYMATH_MSM_CHUNK``, ``POLYMATH_MSM_C`` and ``POLYMATH_MSM_SEQ``
(unset without a seq: the default scan length) and times
``ops/msm.py:msm_device(fast=True)`` in this process, as the reference's
sweep does: the first call (cold) and the least of ``--reps`` more
(steady), host clock around the call and a device sync.  The overrides
are restored afterwards.  Every configuration's point must equal the
first one's, or the sweep raises.

Defaults are the reference's (its env N, CONFIGS, REPS are read the same
way): N = 2^21, REPS 2, and its four configurations, here with six more
(chunk 2^19 at c = 12 and 13, seq 128 and 512, and chunk 2^20 at c = 13
and 14), so that the sweep brackets the port's default (chunk 2^19,
c = 13, seq 256) in chunk, c and seq.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from . import describe, parser, pick_device, wall_s
from ..ops import msm as M
from ..ops.fixed_base import fixed_base_mul
from ..utils.config import environ
from .fusedprof import random_scalars

REFERENCE_CONFIGS = "262144:14;262144:13;262144:12;524288:14"
CONFIGS = REFERENCE_CONFIGS + (";524288:13;524288:12;524288:13:128;"
                               "524288:13:512;1048576:13;1048576:14")


def parse_configs(text: str) -> list:
    """"chunk:c[:seq];..." -> [(chunk, c, seq or None)]."""
    out = []
    for cfg in text.split(";"):
        parts = [int(p) for p in cfg.split(":")]
        if len(parts) not in (2, 3):
            raise ValueError(f"config {cfg!r}: want chunk:c[:seq]")
        out.append((parts[0], parts[1], parts[2] if len(parts) > 2 else None))
    return out


def main(argv=None) -> dict:
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=int(os.environ.get("N", 1 << 21)))
    ap.add_argument("--configs", default=os.environ.get("CONFIGS", CONFIGS))
    ap.add_argument("--reps", type=int,
                    default=int(os.environ.get("REPS", 2)))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = pick_device(args.device)
    configs = parse_configs(args.configs)
    rng = np.random.default_rng(args.seed)
    bases, gen_s = wall_s(
        lambda: fixed_base_mul(random_scalars(rng, args.n, dev)), dev)
    print(f"# {args.n} distinct points in {gen_s:.1f} s", file=sys.stderr)
    sc = random_scalars(rng, args.n, dev)
    rows, ref = [], None
    for chunk, c, seq in configs:
        with environ(POLYMATH_MSM_CHUNK=str(chunk), POLYMATH_MSM_C=str(c),
                     POLYMATH_MSM_SEQ=None if seq is None else str(seq)):
            eff = M.choose_chunk(args.n)

            def run():
                return M.msm_device(bases, sc, fast=True)

            point, cold = wall_s(run, dev)
            steady = min(wall_s(run, dev)[1] for _ in range(args.reps))
            label = f"{chunk}:{c}" + ("" if seq is None else f":{seq}")
            row = {"config": label, "chunk": eff, "c": c,
                   "windows": M.window_params(eff)[1],
                   "seq": M.scan_seq(eff), "cold_s": cold,
                   "steady_ms": steady * 1e3,
                   "mpts_per_s": args.n / steady / 1e6}
            rows.append(row)
            print(f"# chunk=2^{eff.bit_length() - 1} c={c} W={row['windows']}"
                  f" seq={row['seq']}: cold {cold:.3f} s steady "
                  f"{steady * 1e3:.3f} ms = {row['mpts_per_s']:.3f} Mpts/s",
                  file=sys.stderr, flush=True)
        if ref is None:
            ref = point
        elif point != ref:
            raise AssertionError(f"config {label}: the MSM differs from "
                                 f"config {rows[0]['config']}'s")
    fastest = min(rows, key=lambda r: r["steady_ms"])["config"]
    res = {**describe(dev), "n": args.n, "reps": args.reps,
           "points_s": gen_s, "configs": rows, "fastest": fastest,
           "same_point": True}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
