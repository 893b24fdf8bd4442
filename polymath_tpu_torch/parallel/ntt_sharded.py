"""Multi-device NTT: the Bailey 4-step split over a process group
(counterpart of parallel/ntt_sharded.py).

n = n1 n2, j = j2 + n2 j1, k = k1 + n1 k2, w = w_n (the reference's
derivation):

    evals[k1 + n1 k2]
      = sum_j2 w^(j2 k1) w_n2^(j2 k2) [sum_j1 a[j2 + n2 j1] w_n1^(j1 k1)]

so (1) NTTs of n1 points over j1; (2) the outer twiddle w^(j2 k1), with
n^-1 folded in for the inverse as in ops/ntt.py; (3) NTTs of n2 points
over j2; (4) the output transpose.  n1 is the reference's choice (the
smaller half of log2 n, raised to hold d) and both n1 and n2 must be
multiples of the d ranks; every local transform is at most MAX_LOCAL =
2048 points, so n <= 2^22.

Layouts of a distributed (8, n) vector of Fr words on d ranks:

* **block**: rank r holds natural-order entries [r n/d, (r+1) n/d) as
  (8, n/d).  Every sharded vector between steps is in this layout:
  ``ntt_sharded`` returns it, and a rank's block of an MSM's scalars
  pairs with the same block of its points.
* **columns**: rank r holds a[j2 + n2 j1] for j2 in [r n2/d, (r+1) n2/d)
  and every j1, as the rows of the (n2/d, n1) matrix [j2, j1], flattened
  to (8, n/d): the reference's input sharding.  ``ntt_sharded`` takes
  it.  ``columns_of`` cuts it from a vector every rank holds (no
  collective); ``to_columns`` makes it from the block layout (one
  all_to_all).

Both views are row shardings of a matrix, (n1, n2) [j1, j2] for the block
layout and (n2, n1) [j2, j1] for the columns, so every all_to_all here is
one transpose of a row-sharded matrix (``_transpose``): the reference's
first all_to_all (:82) is the transpose [j2, k1] -> [k1, j2] after the
twiddle, its second (:87) the transpose [k1, k2] -> [k2, k1] that leaves
natural order in blocks.  A transform is 2 all_to_all from the columns,
3 from the block layout; ``gather`` (one all_gather) makes a block-layout
vector whole on every rank.
"""

from __future__ import annotations

import torch

from ..ops.cuda_field import fr_mul
from ..ops.limbs import FR_SPEC
from ..ops.ntt import MAX_LOCAL, ntt_local_batched, outer_twiddles

W = FR_SPEC.W


def bailey_split(n: int, d: int) -> tuple:
    """(n1, n2) for an n-point transform on d ranks; raises when n is not
    a power of two, a factor is not a multiple of d, or a local transform
    would pass MAX_LOCAL."""
    log_n = n.bit_length() - 1
    if n < 1 or n != 1 << log_n:
        raise ValueError(f"ntt_sharded: n = {n} is not a power of two")
    n1 = 1 << max(log_n // 2, (d - 1).bit_length())
    n2 = n // n1
    if n1 * n2 != n or n1 % d or n2 % d:
        raise ValueError(f"ntt_sharded: n = {n} splits as n1 = {n1} x n2 = "
                         f"{n2}; both must be multiples of the {d} ranks")
    if n1 > MAX_LOCAL or n2 > MAX_LOCAL:
        raise ValueError(f"ntt_sharded: n = {n} needs local transforms of "
                         f"{n1} and {n2} points; each is at most MAX_LOCAL "
                         f"= {MAX_LOCAL}, so n <= 2^22")
    return n1, n2


def _transpose(x: torch.Tensor, rows: int, cols: int, mesh) -> torch.Tensor:
    """The global (rows, cols) matrix whose rows [r a, (r+1) a) rank r
    holds as (8, a, cols) -> its transpose, rank r holding rows
    [r b, (r+1) b) as (8, b, rows); a = rows / d, b = cols / d.  One
    all_to_all."""
    d = mesh.size
    a, b = rows // d, cols // d
    send = x.reshape(W, a, d, b).permute(2, 0, 1, 3)     # [s] -> rank s
    recv = mesh.all_to_all(send)          # [s, :, i, j] = M[s a + i, r b + j]
    return recv.permute(1, 3, 0, 2).reshape(W, b, rows)


def columns_of(full: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's column layout of an (8, n) vector that every rank holds:
    (8, n / d), no collective."""
    n = full.shape[1]
    n1, n2 = bailey_split(n, mesh.size)
    b = n2 // mesh.size
    cols = full.reshape(W, n1, n2)[:, :, mesh.rank * b:(mesh.rank + 1) * b]
    return cols.transpose(1, 2).reshape(W, n // mesh.size)


def to_columns(block: torch.Tensor, mesh) -> torch.Tensor:
    """Block layout -> column layout of the same (8, n) vector: one
    all_to_all."""
    n = block.shape[1] * mesh.size
    n1, n2 = bailey_split(n, mesh.size)
    x = _transpose(block.reshape(W, n1 // mesh.size, n2), n1, n2, mesh)
    return x.reshape(W, n // mesh.size)


def gather(block: torch.Tensor, mesh) -> torch.Tensor:
    """Block layout -> the whole (8, n) vector on every rank: one
    all_gather."""
    parts = mesh.all_gather(block)                       # (d, 8, n / d)
    return parts.transpose(0, 1).reshape(W, -1)


def ntt_sharded(cols: torch.Tensor, mesh, inverse: bool = False):
    """NTT (inverse NTT, scaled by n^-1) of the (8, n) Montgomery vector
    whose column layout this rank holds, n = d x cols.shape[1]; returns
    this rank's block of the result.  Two all_to_all; the words equal
    ops/ntt.py:ntt's."""
    d = mesh.size
    n = cols.shape[1] * d
    n1, n2 = bailey_split(n, d)
    rows = range(mesh.rank * (n2 // d), (mesh.rank + 1) * (n2 // d))
    tw = outer_twiddles(n, n1, inverse, cols.device, rows)
    x = ntt_local_batched(cols.reshape(W, n2 // d, n1), inverse,
                          scaled=False)                  # [j2, k1]
    del cols           # a temporary of the caller's is freed here
    x = fr_mul(x, tw)
    x = _transpose(x, n2, n1, mesh)                      # [k1, j2]
    x = ntt_local_batched(x, inverse, scaled=False)      # [k1, k2]
    x = _transpose(x, n1, n2, mesh)                      # [k2, k1]
    return x.reshape(W, n // d)
