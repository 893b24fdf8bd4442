"""The yardstick for roofline shares: the card's rates and the operation
counts of the MSM's bucket additions, frozen here so that a change to the
program cannot move them.

Rates of one NVIDIA H100 SXM at its 700 W limit: HBM3 at 3.35e12 bytes/s
(the data sheet), and 16.7e12 32-bit integer multiply-adds/s, derived as
64 INT32 lanes an SM (half the fp32 lanes) x 132 SMs x 1.98 GHz (not a
data-sheet number).  Operation counts: 32-bit multiply-adds of one
Montgomery product with 32-bit words (CIOS; a 32x32->64 product counts
two, each reduction digit one), and madd-2007-bl for one mixed addition.
"""

from __future__ import annotations

MEM_RATE = 3.35e12
INT_OPS_RATE = 16.7e12

FQ_MUL_OPS = 2 * (144 + 144) + 12
FQ_SQR_OPS = 2 * (78 + 144) + 12
MADD_OPS = 8 * FQ_MUL_OPS + 3 * FQ_SQR_OPS
#: bytes a point of an MSM costs at least: its affine base (96) and its
#: scalar (32), each read once
POINT_BYTES = 96 + 32
SCALAR_BITS = 255


def bound_s(nbytes: float, ops: float) -> float:
    """The least time for work that moves ``nbytes`` and does ``ops``
    32-bit operations: the larger of the two at the card's rates."""
    return max(nbytes / MEM_RATE, ops / INT_OPS_RATE)


def prove_msm_points(n: int, m0: int, m: int, n_r: int) -> list:
    """The points of the five bulk MSMs of one proof, from the key's
    dimensions (ops/prover.py): A and r over the x powers (n and n + 1
    scalars), c_w over the SAP's 2 m0 + m + n_r columns less the m0
    instance columns, c_h over the n - 1 top quotient coefficients, and d
    over the 2 (n - 1) + 8 sigma numerator coefficients (sigma = n + 3)."""
    cols = 2 * m0 + m + n_r
    sigma = n + 3
    return [n, n + 1, cols - m0, n - 1, 2 * (n - 1) + 8 * sigma]


def scan_bound_s(points: int, c: int) -> float:
    """Bound of the bucket scan over ``points`` points at window width c:
    one mixed addition a point a window, whatever the scan's layout."""
    windows = -(-SCALAR_BITS // c)
    return bound_s(points * POINT_BYTES, points * windows * MADD_OPS)
