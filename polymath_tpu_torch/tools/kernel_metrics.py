"""North-star kernel metrics of the port (counterpart of kernel_metrics.py):
NTT elements/s at 2^20 and 2^22, MSM points/s at 2^20.

    python3 -m polymath_tpu_torch.tools.kernel_metrics [--device cpu]
        [--log-n 20] [--reps 3] [--out FILE]

* NTT: ``ops/ntt.py:ntt`` of 2^log_n (and 2^(log_n + 2) when log_n is 20)
  Montgomery elements from default_rng(5) values below 2^30.
* MSM: ``ops/msm.py:msm_device(fast=True)`` over 2^log_n distinct points
  k_i G made on the device by ``ops/fixed_base.py:fixed_base_mul``, with
  the k_i and then the scalars s_i drawn from random.Random(7) as the
  reference tool draws them.

Each gives the first call and the steady time (the minimum over ``--reps``
calls, host clock around the call and a device sync) and its rate.  The
MSM is checked against the host oracle: sum_i s_i (k_i G) = (sum_i s_i
k_i mod r) G, one hostmath scalar multiplication, for the whole MSM and
for the 2^10 prefix run again in the safe form; a mismatch raises.  It
prints the JSON and writes it only to ``--out``.
"""

from __future__ import annotations

import json
import random

import numpy as np
import torch

from . import describe, parser, pick_device, wall_s
from ..hostmath import bls12_381 as bls
from ..hostmath.bls12_381 import R
from ..ops.field import fr_to_mont
from ..ops.fixed_base import fixed_base_mul
from ..ops.limbs import FR_SPEC, ints_to_words
from ..ops.msm import msm_device
from ..ops.ntt import ntt

ORACLE_PREFIX = 1 << 10


def _words(values, dev) -> torch.Tensor:
    return torch.from_numpy(ints_to_words(values, FR_SPEC.L)).to(dev)


def _timed(fn, dev, reps: int) -> dict:
    _, first = wall_s(fn, dev)
    steady = min(wall_s(fn, dev)[1] for _ in range(reps))
    return {"first_call_s": first, "steady_s": steady}


def oracle(pt_scalars, scalars):
    """sum_i s_i (k_i G) on the host, as one scalar multiplication."""
    k = sum(p * s for p, s in zip(pt_scalars, scalars)) % R
    return bls.G1.mul(bls.G1.gen, k) if k else None


def main(argv=None) -> dict:
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None,
                    help="also write the JSON to this file")
    args = ap.parse_args(argv)
    dev = pick_device(args.device)
    reps = max(1, args.reps)
    log_n = args.log_n
    out = {**describe(dev), "log_n": log_n, "kernels": {}}

    for ln in [log_n] + ([log_n + 2] if log_n == 20 else []):
        n = 1 << ln
        vals = np.random.default_rng(5).integers(0, 1 << 30, size=n,
                                                 dtype=np.int64)
        raw = torch.zeros((FR_SPEC.W, n), dtype=torch.int32)
        raw[0] = torch.from_numpy(vals.astype(np.int32))
        a = fr_to_mont(raw.to(dev))
        k = _timed(lambda: ntt(a), dev, reps)
        k["elems_per_s"] = n / k["steady_s"]
        out["kernels"][f"ntt_2^{ln}"] = k
        print(f"# ntt_2^{ln}: first {k['first_call_s']:.3f} s steady "
              f"{k['steady_s'] * 1e3:.3f} ms ({k['elems_per_s'] / 1e6:.1f} "
              f"M elements/s)", flush=True)
        del a, raw

    n = 1 << log_n
    rng = random.Random(7)
    pt_scalars = [rng.randrange(1, R) for _ in range(n)]
    bases, gen_s = wall_s(lambda: fixed_base_mul(_words(pt_scalars, dev)),
                          dev)
    scalars = [rng.randrange(R) for _ in range(n)]
    sc = _words(scalars, dev)
    results = []

    def run():
        results.append(msm_device(bases, sc, fast=True))

    k = _timed(run, dev, reps)
    k["points_per_s"] = n / k["steady_s"]
    k["point_generation_s"] = gen_s
    out["kernels"][f"msm_2^{log_n}"] = k
    print(f"# msm_2^{log_n}: first {k['first_call_s']:.3f} s steady "
          f"{k['steady_s'] * 1e3:.3f} ms ({k['points_per_s'] / 1e6:.2f} "
          f"M points/s); points made in {gen_s:.3f} s", flush=True)

    want = oracle(pt_scalars, scalars)
    if any(r != want for r in results):
        raise AssertionError(f"device MSM of 2^{log_n} points differs from "
                             f"the host oracle")
    p = min(ORACLE_PREFIX, n)
    got = msm_device(bases[:p], sc[:, :p])
    if got != oracle(pt_scalars[:p], scalars[:p]):
        raise AssertionError(f"device MSM differs from the host oracle on "
                             f"the 2^{p.bit_length() - 1} prefix")
    out["msm_oracle_check"] = (f"ok (all {n} points and the {p}-point prefix "
                               f"vs the host oracle)")
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return out


if __name__ == "__main__":
    main()
