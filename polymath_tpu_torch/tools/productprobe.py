"""What one Montgomery product costs on the card, through kernels that the
prover already runs.

    python3 -m polymath_tpu_torch.tools.productprobe [--device cpu]
        [--lanes 40960,1048576] [--reps 5] [--seed 0]

* Latency and throughput: ``to_affine`` (csrc/g1.cu) inverts Z by Fermat,
  a chain of 617 dependent Fq operations a lane (385 squares, 232
  products: q - 2 has 384 bits, 229 of them set, then three products and
  a square).  At 40,960 lanes (one MSM chunk's lanes, the occupancy of
  the scans) the card holds every lane at once and the time is about the
  chain's latency; at 2^20 lanes it is filled, and the time is about its
  throughput.  Reported: ms per call (least of ``--reps`` by CUDA events
  after a warm-up), ns per chain step (ms / 617) and Fq operations per
  second (617 x lanes / time).  The lanes are random canonical Jacobian
  words (numpy default_rng(seed)); the result is checked against the
  plain version on the first 64 lanes.
* Instructions: a probe source that includes csrc/fields.cuh is compiled
  for sm_90a (``nvcc -cubin``) and disassembled (``cuobjdump -sass``);
  for each field, the SASS instructions (NOPs not counted) of a kernel
  that loads two elements, applies one inlined product (or square) and
  stores it, less those of the same kernel with an XOR in its place, and
  how many of them are IMAD instructions.

With ``--device cpu`` the plain version runs (host clock, never a device
time) and the SASS count is not taken (no nvcc).  Only ``fields.cuh``'s
product names and ``cuda_curve.to_affine`` are used, so the tool measures
any tree of the port that has them.
"""

from __future__ import annotations

import json
import os
import re
import subprocess

import numpy as np
import torch

from . import describe, parser, pick_device, timed_ms
from ..ops import _build
from ..ops.cuda_curve import to_affine
from ..ops.limbs import FQ_SPEC, ints_to_words

#: dependent Fq squares and products of one to_affine lane
CHAIN = 617

PROBE = r"""
#include "fields.cuh"
template <class F, int OP>
__device__ __forceinline__ void probe(const uint32_t* a, const uint32_t* b,
                                      uint32_t* c) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  Fe<F> x = fe_load<F>(a, 1 << 20, i), y = fe_load<F>(b, 1 << 20, i), r;
  if (OP == 0) {
    for (int k = 0; k < F::N; ++k) r.w[k] = x.w[k] ^ y.w[k];
  } else if (OP == 1) {
    r = fe_mul<F>(x, y);
  } else {
    r = fe_sqr<F>(x);
  }
  fe_store<F>(c, 1 << 20, i, r);
}
#define PROBE_KERNEL(name, F, OP)                                         \
  extern "C" __global__ void name(const uint32_t* a, const uint32_t* b,   \
                                  uint32_t* c) { probe<F, OP>(a, b, c); }
PROBE_KERNEL(fq_base, FqP, 0)
PROBE_KERNEL(fq_mul, FqP, 1)
PROBE_KERNEL(fq_sqr, FqP, 2)
PROBE_KERNEL(fr_base, FrP, 0)
PROBE_KERNEL(fr_mul, FrP, 1)
PROBE_KERNEL(fr_sqr, FrP, 2)
"""


def jacobian_lanes(lanes: int, seed: int, dev) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    q = FQ_SPEC.modulus
    words = [ints_to_words([int.from_bytes(rng.bytes(56), "little") % q
                            for _ in range(min(lanes, 4096))], FQ_SPEC.L)
             for _ in range(3)]
    base = torch.from_numpy(np.concatenate(words))
    reps = -(-lanes // base.shape[1])
    return base.repeat(1, reps)[:, :lanes].contiguous().to(dev)


def sass_counts() -> dict:
    """{kernel: (instructions, IMAD instructions)} of the probe source."""
    out_dir = os.path.join(_build.BUILD, "productprobe")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "probe.cu")
    cubin = os.path.join(out_dir, "probe.cubin")
    with open(src, "w") as f:
        f.write(PROBE)
    subprocess.run([_build.cuda_tool("nvcc"), "-cubin", "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-I", _build.CSRC, "-o", cubin, src], check=True,
                   capture_output=True, text=True)
    sass = subprocess.run([_build.cuda_tool("cuobjdump"), "-sass", cubin],
                          check=True, capture_output=True, text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = m.group(1)
            counts[name] = [0, 0]
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                      line)
        if name and m and not m.group(1).startswith("NOP"):
            counts[name][0] += 1
            counts[name][1] += m.group(1).startswith("IMAD")
    return counts


def main(argv=None) -> dict:
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--lanes", default="40960,1048576",
                    help="comma-separated lane counts for to_affine")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = pick_device(args.device)
    res = {**describe(dev), "chain": CHAIN, "to_affine": {}, "sass": None}
    for lanes in (int(x) for x in args.lanes.split(",")):
        pts = jacobian_lanes(lanes, args.seed, dev)
        to_affine(pts)
        best = None
        for _ in range(args.reps):
            got, ms = timed_ms(lambda: to_affine(pts), dev)
            best = ms if best is None else min(best, ms)
        want = to_affine(pts[:, :64].cpu())
        if not torch.equal(got[:, :64].cpu(), want):
            raise AssertionError(f"to_affine at {lanes} lanes differs from "
                                 f"its plain version")
        res["to_affine"][str(lanes)] = {
            "ms": best, "ns_per_step": best * 1e6 / CHAIN,
            "fq_ops_per_s": CHAIN * lanes / (best * 1e-3)}
        del pts, got
    if dev.type == "cuda":
        c = sass_counts()
        res["sass"] = {
            f"{f}_{op}": {"instructions": c[f"{f}_{op}"][0]
                          - c[f"{f}_base"][0],
                          "imad": c[f"{f}_{op}"][1] - c[f"{f}_base"][1]}
            for f in ("fq", "fr") for op in ("mul", "sqr")}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
