"""Radix-2 NTT over Fr (counterpart of ntt.py).

Semantics match arkworks ``Radix2EvaluationDomain``: natural-order DFT
``evals[i] = sum_j coeffs[j] w^(ij)`` with the canonical 2-adic root from
GENERATOR = 7; the inverse scales by n^-1.

* ``ntt_local_batched`` — every DIT stage of a batch of nl <= 4096
  transforms in one launch of ``csrc/ntt.cu`` (one thread block per
  transform, in shared memory).  The caller bit-reverses the input and
  applies the inverse scale, as in the reference.
* sizes above MAX_LOCAL = 2048 use the Bailey 4-step split n = n1 * n2,
  n1 = 2^ceil(log2(n) / 2): batched column NTTs, the outer twiddle
  w^(j2 k1) (n^-1 folded in for the inverse), batched row NTTs,
  transpose.  Up to 2^22 points both halves are at most 2048; past it a
  half takes up to MAX_WIDE = 4096 points, one launch of the same kernel
  in 128 KB of shared memory.  Largest n = 2^24 (the prover's size-2n
  squaring at n = 2^23).

Arrays are (8, ...) int32 Fr words (limbs.py) in Montgomery form.
"""

from __future__ import annotations

import torch

from ..hostmath.bls12_381 import R, FR_TWO_ADICITY, FR_TWO_ADIC_ROOT
from . import _build
from .cuda_field import fr_mul
from .field import FR, fr_const, fr_sum
from .limbs import FR_SPEC, limbs_to_words, words_to_limbs

W = FR_SPEC.W
MAX_LOCAL = 2048   # largest transform ``ntt`` runs in one launch: 64 KB
MAX_WIDE = 2 * MAX_LOCAL   # largest half of a split: 128 KB of shared memory

#: launches since the last reset (read by chip_smoke.py)
LAUNCHES = {"ntt_local": 0}


def domain_omega(n: int) -> int:
    """Canonical n-th root of unity (arkworks group_gen)."""
    log_n = n.bit_length() - 1
    assert n == 1 << log_n and log_n <= FR_TWO_ADICITY
    return pow(FR_TWO_ADIC_ROOT, 1 << (FR_TWO_ADICITY - log_n), R)


def powers_of(x: torch.Tensor, n: int) -> torch.Tensor:
    """(8, n) Montgomery powers [1, x, x^2, ...] of an (8, 1) Montgomery
    scalar, by doubling (one fr_mul per doubling step)."""
    x = x.reshape(W, 1)
    tbl = fr_const(1, x.device)
    cur = x
    k = 1
    while k < n:
        take = min(k, n - k)
        tbl = torch.cat([tbl, fr_mul(tbl[:, :take], cur)], dim=1)
        if 2 * k < n:
            cur = fr_mul(cur, cur)
        k *= 2
    return tbl[:, :n]


def bitrev(n: int, device=None) -> torch.Tensor:
    """Bit-reversal permutation of range(n) as int64 indices."""
    log_n = n.bit_length() - 1
    idx = torch.arange(n, dtype=torch.int64, device=device)
    rev = torch.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


_TABLES: dict = {}


def _cached(key, make):
    """Twiddle tables and bit-reversal indices, built once per size."""
    if key not in _TABLES:
        _TABLES[key] = make()
    return _TABLES[key]


def _root(n: int, inverse: bool) -> int:
    w = domain_omega(n)
    return pow(w, R - 2, R) if inverse else w


def local_twiddles(nl: int, inverse: bool, device) -> torch.Tensor:
    """(8, nl/2) table of w_nl^k in Montgomery words."""
    return _cached(("tw", nl, inverse, str(device)), lambda: powers_of(
        fr_const(_root(nl, inverse), device), nl // 2))


def ntt_local_plain(x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """Plain version of the local kernel on 16-bit limbs: x (16, B, nl)
    bit-reversed, tw (16, nl/2) -> (16, B, nl) after all DIT stages."""
    L, B, nl = x.shape
    m = 1
    while m < nl:
        w = tw[:, ::nl // (2 * m)][:, :m]                 # (16, m)
        blk = x.reshape(L, B, nl // (2 * m), 2, m)
        lo, hi = blk[:, :, :, 0], blk[:, :, :, 1]
        t = FR.mont_mul(hi, w[:, None, None, :])
        x = torch.stack([FR.add(lo, t), FR.sub(lo, t)], dim=3).reshape(
            L, B, nl)
        m *= 2
    return x


def ntt_local_kernel(x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """All DIT stages of bit-reversed (8, B, nl) words; tw (8, nl/2).
    Launches csrc/ntt.cu on the card, the plain version on the CPU."""
    _, B, nl = x.shape
    if x.device.type == "cpu":
        return limbs_to_words(ntt_local_plain(words_to_limbs(x),
                                              words_to_limbs(tw)))
    if (x.device.type != "cuda" or x.dtype != torch.int32
            or not x.is_contiguous() or tw.shape != (W, nl // 2)
            or tw.device != x.device or tw.stride(1) != 1):
        raise ValueError("ntt_local: needs contiguous int32 (8, B, nl) words "
                         "and an (8, nl/2) twiddle table on the same card")
    out = torch.empty_like(x)
    fn = _build.declare(_build.lib("ntt").pm_ntt_local, 7)
    _build.check(fn(x.data_ptr(), out.data_ptr(), tw.data_ptr(),
                    tw.stride(0), B, nl.bit_length() - 1, _build.stream(x)),
                 "ntt_local")
    LAUNCHES["ntt_local"] += 1
    return out


def ntt_local_batched(x: torch.Tensor, inverse: bool,
                      scaled: bool = True) -> torch.Tensor:
    """NTT along the last axis of (8, B, nl) words, nl <= 4096 a power of
    two.  ``scaled``: multiply by nl^-1 when inverse."""
    _, B, nl = x.shape
    assert nl <= MAX_WIDE and nl & (nl - 1) == 0
    if nl == 1:
        return x
    rev = _cached(("rev", nl, str(x.device)), lambda: bitrev(nl, x.device))
    x = x.index_select(2, rev)
    out = ntt_local_kernel(x, local_twiddles(nl, inverse, x.device))
    if inverse and scaled:
        out = fr_mul(out, fr_const(pow(nl, R - 2, R), x.device).reshape(
            W, 1, 1))
    return out


def outer_twiddles(n: int, n1: int, inverse: bool, device,
                   rows: range | None = None):
    """(8, len(rows), n1) table w^(j2 k1 mod n) for j2 in ``rows`` (default
    all n / n1 of them), times n^-1 for the inverse; built once a size."""
    rows = range(n // n1) if rows is None else rows

    def make():
        pw = powers_of(fr_const(_root(n, inverse), device), n)
        j2 = torch.arange(rows.start, rows.stop, dtype=torch.int64,
                          device=device)[:, None]
        k1 = torch.arange(n1, dtype=torch.int64, device=device)[None, :]
        tw = pw[:, (j2 * k1) & (n - 1)]
        if inverse:
            tw = fr_mul(tw, fr_const(pow(n, R - 2, R), device)[:, :, None])
        return tw
    return _cached(("outer", n, n1, rows.start, rows.stop, inverse,
                    str(device)), make)


def split(n: int) -> tuple:
    """The Bailey split (n1, n2) of n, n1 = 2^ceil(log2(n) / 2); each half
    is at most MAX_WIDE."""
    n1 = 1 << (n.bit_length() // 2)
    if n1 > MAX_WIDE:
        raise ValueError(f"ntt: n = {n} is past {MAX_WIDE ** 2} points")
    return n1, n // n1


def _ntt_4step(a: torch.Tensor, inverse: bool, n1: int) -> torch.Tensor:
    """Bailey split n = n1 * n2 (j = j2 + n2 j1, k = k1 + n1 k2)."""
    n = a.shape[1]
    n2 = n // n1
    X = a.reshape(W, n1, n2).transpose(1, 2)             # (8, n2, n1)
    X = ntt_local_batched(X, inverse, scaled=False)      # [j2, k1]
    X = fr_mul(X, outer_twiddles(n, n1, inverse, a.device))
    X = X.transpose(1, 2)                                # (8, n1, n2)
    X = ntt_local_batched(X, inverse, scaled=False)      # [k1, k2]
    return X.transpose(1, 2).reshape(W, n)


def ntt(a: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """NTT / inverse NTT of (8, n) Montgomery Fr words, n a power of 2 up
    to 2^24."""
    n = a.shape[1]
    if n == 1:
        return a
    if n <= MAX_LOCAL:
        return ntt_local_batched(a.reshape(W, 1, n), inverse).reshape(W, n)
    return _ntt_4step(a, inverse, split(n)[0])


def poly_eval_device(coeffs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Evaluate the polynomial with (8, n) Montgomery coefficients at the
    (8, 1) Montgomery scalar x: sum_i c_i x^i, exact.  Returns (8, 1)."""
    n = coeffs.shape[1]
    prods = fr_mul(coeffs, powers_of(x, n))
    return fr_sum(prods, axis=1).reshape(W, 1)
