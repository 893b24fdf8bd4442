"""Polynomial helpers: affine first-order recurrences and synthetic
division by (X - x1) (counterpart of poly_jax.py).

``affine_scan`` runs p_k = c_k + m * p_(k-1) over (8, N) words in levels
(``plan_levels``): level 0 cuts the sequence into rows of ROW = 16 and one
``affine_scan_reduce`` launch writes each row's total; level 1 scans those
totals with m^16 the same way, and so on until one row is left.  Then one
``affine_scan_apply`` launch a level, from the top down, rescans each row
from its carry-in (the level above's output) and writes every value.  The
multipliers m^(16^l) are taken on the host from the canonical m, so no
product runs between the launches: 2 launches a level (1 for the top),
log_16(N) levels, O(N) work.

``affine_scan_plain`` is the blocked fr_mul / fr_add recurrence that this
replaced (64 lock-step launches of one product over all rows a level): the
plain version the tests and the kernel table hold the kernels' scan
against.
"""

from __future__ import annotations

import torch

from .cuda_field import fr_mul
from .cuda_poly import ROW, affine_scan_apply, affine_scan_reduce, rows_of
from .field import fr_add
from .limbs import FR_SPEC, words_to_ints
from .ntt import powers_of

W = FR_SPEC.W
_SEQ = 64


def plan_levels(n: int, mult: int) -> list:
    """[(elements, multiplier)] of each level of a scan of n elements with
    the canonical multiplier ``mult``: every level but the last scans the
    row totals of the one below with its multiplier to the ROW-th power;
    the last fits one row."""
    levels = [(n, mult % FR_SPEC.modulus)]
    while levels[-1][0] > ROW:
        k, m = levels[-1]
        levels.append((rows_of(k), pow(m, ROW, FR_SPEC.modulus)))
    return levels


def _scan(x: torch.Tensor, levels: list, rev: bool) -> torch.Tensor:
    m = levels[0][1]
    if len(levels) == 1:
        return affine_scan_apply(x, m, None, rev)
    carry = _scan(affine_scan_reduce(x, m, rev), levels[1:], False)
    return affine_scan_apply(x, m, carry, rev)


def affine_scan(c: torch.Tensor, mult: torch.Tensor,
                rev: bool = False) -> torch.Tensor:
    """Inclusive scan of p_k = c_k + mult * p_(k-1) over the (8, N)
    Montgomery words c; mult: (8, 1) Montgomery scalar, read back to the
    host once.  With ``rev`` the scan runs from column N - 1 down to 0
    (p_k = c_k + mult * p_(k+1)) and is stored in natural order."""
    if c.dim() != 2 or c.shape[0] != W:
        raise ValueError(f"affine_scan: c must be ({W}, N) words, got "
                         f"{tuple(c.shape)}")
    m = FR_SPEC.from_mont_int(words_to_ints(mult.reshape(W, 1).cpu())[0])
    return _scan(c, plan_levels(c.shape[1], m), rev)


def synthetic_divide_device(coeffs: torch.Tensor, x1_mont: torch.Tensor):
    """Divide the polynomial with Montgomery coeffs (8, D+1) by (X - x1).

    Returns (quotient (8, D), remainder (8, 1)).  One scan from the top
    coefficient down, p_i = c_i + x1 * p_(i+1) with p_D = c_D, written in
    natural order: p_(i+1) is the quotient's coefficient i and p_0 the
    remainder, so both are views of one (8, D+1) result.  Exactness is
    the protocol invariant (prover.rs:221); callers check the remainder."""
    p = affine_scan(coeffs, x1_mont, rev=True)
    return p[:, 1:], p[:, :1]


def affine_scan_plain(c: torch.Tensor, mult: torch.Tensor) -> torch.Tensor:
    """``affine_scan`` (forward) as the blocked fr_mul / fr_add recurrence:
    rows of 64 scanned in lock step (64 launches of one product over all
    rows), the row totals recursed with mult^64, each row's carry added by
    one broadcast product.  c: (8, ..., N) Montgomery words; mult: (8, 1)
    Montgomery scalar.  Returns (8, ..., N)."""
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
    row_ps = affine_scan_plain(acc, mult_s)  # (8, ..., rows), carried
    zero1 = torch.zeros((W,) + lead + (1,), dtype=torch.int32,
                        device=c.device)
    prev = torch.cat([zero1, row_ps[..., :-1]], dim=-1)   # exclusive
    # p[row, t] = local[row, t] + mult^(t+1) * prev[row]
    mpow = powers_of(mult.reshape(W, 1), _SEQ + 1)[:, 1:]  # mult^1..mult^64
    carry = fr_mul(mpow.reshape((W,) + (1,) * (len(lead) + 1) + (_SEQ,)),
                   prev[..., None])
    ps = fr_add(local, carry)
    return ps.reshape((W,) + lead + (npad,))[..., :n]
