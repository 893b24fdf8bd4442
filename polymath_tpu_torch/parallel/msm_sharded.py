"""Multi-device MSM: a block of points a rank, window sums gathered and
folded with the group law (counterpart of parallel/msm_sharded.py).

Every rank passes the same (8, M) scalars and holds the whole (N, 24)
base table, as each rank holds the whole key.  Of the m points that take
part (as ``msm_device`` counts them), rank r takes the block
[r b, (r+1) b), b = ceil(m / d), and runs the single-device
``msm_device`` over it, deferred.  Then one all_gather of a few
kilobytes a rank brings every rank's parts to every rank, on the card:

* the (36, windows) Jacobian window sums, added with the group law (a
  psum cannot add group elements) by one ``sum_sets`` launch over the
  (d, 36, windows) gathered sums (ops/cuda_tree.py; none for d = 1);
* the fast-mode collision flag, so every rank sees every rank's flag and
  all raise together (the prover then reruns the MSM safe on every rank;
  a rank that reran alone would leave the others waiting in the gather);
* the peeled host tail (``POLYMATH_MSM_TAIL``, at most TAIL_MAX points a
  rank), padded with zero scalars to TAIL_MAX rows, so every rank adds
  every rank's tail on the host.

One chunk size holds on every rank: chunk = choose_chunk(b), and so one
(c, windows) (``window_params(chunk)``), even for the shorter last block,
which ``msm_device`` pads with zero scalars.  The window Horner and the
tails then run on the host of every rank (``MsmPending.result``), which
returns the same point everywhere.
"""

from __future__ import annotations

import torch

from ..ops.cuda_tree import sum_sets
from ..ops.curve import AFF, JAC, jac_identity_words
from ..ops.limbs import FR_SPEC
from ..ops.msm import (MsmPending, TAIL_MAX, choose_chunk, msm_device,
                       window_params)

W = FR_SPEC.W


def _payload(part, windows: int, device) -> torch.Tensor:
    """This rank's parts as one int32 vector: window sums, flag, tail rows,
    tail scalars."""
    if part is None:                      # no points on this rank
        wsums = jac_identity_words((windows,), device)
        err, tail = None, None
    else:
        wsums, err, tail = part.wsums, part.err, part.tail
    rows = torch.zeros((TAIL_MAX, AFF), dtype=torch.int32, device=device)
    scalars = torch.zeros((W, TAIL_MAX), dtype=torch.int32, device=device)
    if tail is not None:
        t = tail[0].shape[0]
        rows[:t] = tail[0]
        scalars[:, :t] = tail[1]
    flag = torch.zeros((1,), dtype=torch.int32, device=device) \
        if err is None else err.reshape(1).to(torch.int32)
    return torch.cat([wsums.reshape(-1), flag, rows.reshape(-1),
                      scalars.reshape(-1)])


def msm_sharded(bases: torch.Tensor, scalars: torch.Tensor, mesh,
                n_eff: int | None = None, fast: bool = False,
                mont: bool = False, defer: bool = False,
                fused: bool | None = None):
    """``msm_device(bases, scalars, ...)`` over the group (see the module
    docstring): the same point on every rank, ``None`` for the identity,
    or an ``MsmPending`` with ``defer=True`` whose launches and gather are
    queued on the card."""
    n = bases.shape[0] if n_eff is None else n_eff
    m = min(scalars.shape[-1], n, bases.shape[0])
    if m == 0:
        return None
    d, dev = mesh.size, mesh.device
    block = -(-m // d)
    chunk = choose_chunk(block)
    c, windows = window_params(chunk)
    lo, hi = min(m, mesh.rank * block), min(m, (mesh.rank + 1) * block)
    part = msm_device(bases[lo:hi], scalars[:, lo:hi], chunk=chunk,
                      fast=fast, mont=mont, defer=True, fused=fused) \
        if hi > lo else None
    got = mesh.all_gather(_payload(part, windows, dev))   # (d, K)
    nw = JAC * windows
    sums = got[:, :nw].reshape(d, JAC, windows)
    wsums = sum_sets(sums) if d > 1 else sums[0]
    err = (got[:, nw] != 0).any() if fast else None
    rows = got[:, nw + 1:nw + 1 + TAIL_MAX * AFF].reshape(d * TAIL_MAX, AFF)
    tail_sc = got[:, nw + 1 + TAIL_MAX * AFF:].reshape(d, W, TAIL_MAX)
    tail = (rows, tail_sc.transpose(0, 1).reshape(W, d * TAIL_MAX))
    pending = MsmPending(wsums.contiguous(), err, c, windows, tail)
    return pending if defer else pending.result()

