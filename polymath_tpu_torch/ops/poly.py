"""Polynomial helpers: affine first-order recurrences and synthetic
division by (X - x1) (counterpart of poly_jax.py).

The quotient step p_k = c_k + m * p_(k-1) over ~10n coefficients runs as
a blocked recurrence: rows of 64 are scanned in lock step (64 launches of
one ``fr_mul`` each, over all rows at once), the row totals recurse with
multiplier m^64, and one broadcast ``fr_mul`` adds each row's carry-in.
O(D) work; the launch count grows with log_64(D), not with D.
"""

from __future__ import annotations

import torch

from .cuda_field import fr_mul
from .field import fr_add
from .limbs import FR_SPEC
from .ntt import powers_of

W = FR_SPEC.W
_SEQ = 64


def affine_scan(c: torch.Tensor, mult: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of p_k = c_k + mult * p_(k-1) over the trailing axis.

    c: (8, ..., N) Montgomery words; mult: (8, 1) Montgomery scalar.
    Returns (8, ..., N)."""
    n = c.shape[-1]
    lead = tuple(c.shape[1:-1])
    mult_b = mult.reshape((W,) + (1,) * (len(lead) + 1))
    if n <= _SEQ:
        acc = torch.zeros((W,) + lead + (1,), dtype=torch.int32,
                          device=c.device)
        outs = []
        for k in range(n):
            acc = fr_add(fr_mul(acc, mult_b), c[..., k:k + 1])
            outs.append(acc)
        return torch.cat(outs, dim=-1)
    pad = (-n) % _SEQ
    if pad:
        c = torch.cat([c, torch.zeros(c.shape[:-1] + (pad,),
                                      dtype=c.dtype, device=c.device)], -1)
    npad = c.shape[-1]
    rows = npad // _SEQ
    cr = c.reshape((W,) + lead + (rows, _SEQ))
    local = torch.empty_like(cr)
    acc = torch.zeros((W,) + lead + (rows,), dtype=torch.int32,
                      device=c.device)
    mult_r = mult.reshape((W,) + (1,) * (len(lead) + 1))
    for t in range(_SEQ):
        acc = fr_add(fr_mul(acc, mult_r), cr[..., t])
        local[..., t] = acc
    mult_s = mult.reshape(W, 1)
    for _ in range(6):                   # mult^64 by repeated squaring
        mult_s = fr_mul(mult_s, mult_s)
    row_ps = affine_scan(acc, mult_s)    # (8, ..., rows) with carry
    zero1 = torch.zeros((W,) + lead + (1,), dtype=torch.int32,
                        device=c.device)
    prev = torch.cat([zero1, row_ps[..., :-1]], dim=-1)   # exclusive
    # p[row, t] = local[row, t] + mult^(t+1) * prev[row]
    mpow = powers_of(mult.reshape(W, 1), _SEQ + 1)[:, 1:]  # mult^1..mult^64
    carry = fr_mul(mpow.reshape((W,) + (1,) * (len(lead) + 1) + (_SEQ,)),
                   prev[..., None])
    ps = fr_add(local, carry)
    return ps.reshape((W,) + lead + (npad,))[..., :n]


def synthetic_divide_device(coeffs: torch.Tensor, x1_mont: torch.Tensor):
    """Divide the polynomial with Montgomery coeffs (8, D+1) by (X - x1).

    Returns (quotient (8, D), remainder (8, 1)).  Exactness is the
    protocol invariant (prover.rs:221); callers check the remainder."""
    dlen = coeffs.shape[-1]
    cr = torch.flip(coeffs, dims=(-1,))       # c'_k = c_{D-k}
    q_rev = affine_scan(cr[:, :dlen - 1], x1_mont)
    rem = fr_add(fr_mul(q_rev[:, -1:], x1_mont.reshape(W, 1)),
                 coeffs[:, :1])
    return torch.flip(q_rev, dims=(-1,)), rem
