"""The NTT kernels' share of their bound, in %: the least time of a proof's
transforms at the card's rates over the device time of the kernels of
``csrc/ntt.cu``, from the traced window.

The work is counted here, not by the program: the five transforms of a
proof (ops/prover.py ``_stage1``: the inverse transforms of u, w and the
witness-only u, size n, and the size-2n squaring's forward and inverse
transforms), each of N points at (N/2) log2 N butterflies of one Fr
Montgomery product (``FR_MUL_OPS`` 32-bit operations; the additions are
left out), and two passes over memory, each reading and writing N Fr
elements of 32 bytes.  The twiddle products of the Bailey split run in
the shared ``fr_mul`` kernel, so they are in neither the work nor the
time.  The kernels (``ntt_local_kernel``) are matched by name in the
trace.
"""

from benchmark.harness import peaks

#: 32-bit operations of one 8-word Fr Montgomery product (CIOS: 64
#: 32x32->64 products at two each, 64 reduction products at two each, 8
#: reduction digits)
FR_MUL_OPS = 2 * (64 + 64) + 8
FR_BYTES = 32
KERNELS = ("ntt_local_kernel",)


def transform_bound_s(points: int) -> float:
    """Bound of one transform of ``points`` points."""
    butterflies = points // 2 * (points.bit_length() - 1)
    return peaks.bound_s(2 * 2 * points * FR_BYTES, butterflies * FR_MUL_OPS)


def proof_bound_s(n: int) -> float:
    """Bound of a proof's five transforms at domain size n."""
    return 3 * transform_bound_s(n) + 2 * transform_bound_s(2 * n)


def read(run):
    if run.device is None or not run.proofs:
        return None
    seconds = sum(s for name, s in run.device["kernel_s"].items()
                  if any(k in name for k in KERNELS))
    if not seconds:
        return None
    return 100.0 * proof_bound_s(run.dims["n"]) * run.proofs / seconds
