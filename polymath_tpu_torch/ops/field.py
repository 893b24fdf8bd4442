"""Plain PyTorch Montgomery field arithmetic (counterpart of field_jax.py).

Two layers:

* ``FieldOps`` (``FR``, ``FQ``) — the plain version of every field
  operation on ``(L, ...)`` 16-bit limbs held in ``int64``, the JAX
  reference's layout.  Torch's CPU ``uint32`` lacks add, shifts and
  ``index_add_``, so limbs live in ``int64``: every 16x16 product and every
  lazy column sum stays exact.  These are the CPU path of the kernel
  wrappers, the reference the kernels are held against on the card, and
  what the tests compare with ``field_jax`` bit for bit.
* word-level helpers (``fr_add``, ``fr_sub``, ...) on the port's data
  format, ``(8, N)`` ``int32`` words (limbs.py).  Additions, subtractions
  and reductions are plain torch on either device (XLA ops in the
  reference); every Montgomery product goes through the ``fr_mul`` /
  ``fr_sqr`` wrappers (cuda_field.py), which launch the CUDA kernel on the
  card.

All results are canonical (fully reduced), so values agree with the
reference whatever the internal schedule.
"""

from __future__ import annotations

import numpy as np
import torch

from .limbs import (
    FieldSpec, LIMB_BITS, LIMB_MASK, FR_SPEC, FQ_SPEC, ints_to_words,
    limbs_to_words, words_to_limbs,
)


def _normalize(t: torch.Tensor) -> torch.Tensor:
    """Propagate carries (or borrows) of a redundant signed limb vector,
    in place, until every limb but the top one is a canonical 16-bit limb.
    Uses whole-vector ripple passes (usually two or three) instead of a
    K-step sequential chain; the top limb keeps the excess (zero or -1 in
    every caller's bounds)."""
    while True:
        c = t[:-1] >> LIMB_BITS          # arithmetic: floor for borrows
        if not bool(c.any()):
            return t
        t[:-1] &= LIMB_MASK
        t[1:] += c


class FieldOps:
    """Plain field ops for one FieldSpec on ``(L, ...)`` int64 limbs."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.L = spec.L
        self._p = torch.from_numpy(spec.p_limbs.astype(np.int64))
        self._n0inv = int(spec.n0inv)

    def _const(self, limbs, like: torch.Tensor, batch_ndim: int):
        arr = torch.as_tensor(np.asarray(limbs, np.int64), device=like.device)
        return arr.reshape((-1,) + (1,) * batch_ndim)

    def zeros(self, shape, device=None):
        return torch.zeros((self.L,) + tuple(shape), dtype=torch.int64,
                           device=device)

    def ones_mont(self, shape, device=None):
        one = torch.as_tensor(self.spec.one_mont.astype(np.int64),
                              device=device)
        return one.reshape((self.L,) + (1,) * len(shape)).expand(
            (self.L,) + tuple(shape)).clone()

    # -- carry / compare machinery ----------------------------------------
    def carry(self, t):
        """Full carry propagation: (K, ...) nonnegative limbs -> canonical
        16-bit limbs, same K (the final carry must vanish)."""
        return _normalize(t.clone())

    def cond_sub_p(self, t):
        """t (K >= L canonical limbs, value < 2p) -> t mod p as L limbs."""
        K = t.shape[0]
        p = self._const(self.spec.p_limbs, t, t.dim() - 1)
        d = t.clone()
        d[: self.L] -= p
        d = _normalize(d)
        keep = d[K - 1] < 0                  # borrow out: t < p, keep t
        return torch.where(keep, t[: self.L], d[: self.L])

    # -- ring ops ----------------------------------------------------------
    def add(self, a, b):
        s = a + b
        s = torch.cat([s, torch.zeros_like(s[:1])])
        return self.cond_sub_p(_normalize(s))

    def sub(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        p = self._const(self.spec.p_limbs, a, a.dim() - 1)
        t = a + p - b                        # value a - b + p in (0, 2p)
        t = torch.cat([t, torch.zeros_like(t[:1])])
        return self.cond_sub_p(_normalize(t))

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    def _reduce(self, t):
        """Montgomery reduction of a (2L+1, ...) redundant product vector
        (limbs < 2^38): returns t * 2^(-16 L) mod p, canonical L limbs."""
        L = self.L
        p = self._const(self.spec.p_limbs, t, t.dim() - 1)
        rows = t.unbind(0)
        for i in range(L):
            # limbs stay < 2^40, so the product fits before the mask
            m = (rows[i] * self._n0inv) & LIMB_MASK
            t[i:i + L].addcmul_(p, m)
            rows[i + 1].add_(rows[i] >> LIMB_BITS)
        return self.cond_sub_p(_normalize(t[L:]))

    def mont_mul(self, a, b):
        """Montgomery product a*b*R^-1 mod p (SOS: schoolbook columns, then
        L reduction steps)."""
        a, b = torch.broadcast_tensors(a, b)
        L = self.L
        t = torch.zeros((2 * L + 1,) + tuple(a.shape[1:]), dtype=torch.int64,
                        device=a.device)
        for i, ai in enumerate(a.unbind(0)):
            t[i:i + L].addcmul_(b, ai)
        return self._reduce(t)

    def mont_sqr(self, a):
        """Montgomery square with symmetric cross terms (ll.py mont_sqr):
        each a_i*a_j, j > i, computed once and added twice."""
        L = self.L
        t = torch.zeros((2 * L + 1,) + tuple(a.shape[1:]), dtype=torch.int64,
                        device=a.device)
        for i, ai in enumerate(a.unbind(0)):
            t[2 * i].addcmul_(ai, ai)
            if i + 1 < L:
                t[2 * i + 1:i + L].addcmul_(a[i + 1:], ai, value=2)
        return self._reduce(t)

    def redc_wide(self, t):
        """Montgomery REDC of a wide canonical value: t (K <= 2L limbs,
        value < R*p) -> t * R^-1 mod p as L limbs."""
        L = self.L
        K = t.shape[0]
        assert K <= 2 * L, "value too wide for one REDC"
        pad = torch.zeros((2 * L + 1 - K,) + tuple(t.shape[1:]),
                          dtype=torch.int64, device=t.device)
        return self._reduce(torch.cat([t, pad]))

    def sum_reduce(self, x, axis=-1):
        """Sum Montgomery-form elements along a batch axis, exactly mod p.
        int64 limb sums are exact for < 2^47 summands; one carry, one REDC
        and an R^2 fix-up finish."""
        if axis < 0:
            axis = x.dim() + axis
        assert axis > 0, "axis 0 is the limb axis"
        n = x.shape[axis]
        s = x.sum(dim=axis)
        extra = max(1, (n.bit_length() + LIMB_BITS - 1) // LIMB_BITS + 1)
        s = torch.cat([s, torch.zeros((extra,) + tuple(s.shape[1:]),
                                      dtype=torch.int64, device=s.device)])
        s = _normalize(s)
        red = self.redc_wide(s)
        return self.mont_mul(red, self._const(self.spec.r2, red,
                                              red.dim() - 1))

    # -- Montgomery domain codecs -----------------------------------------
    def to_mont(self, a):
        return self.mont_mul(a, self._const(self.spec.r2, a, a.dim() - 1))

    def from_mont(self, a):
        one = torch.zeros_like(a)
        one[0] = 1
        return self.mont_mul(a, one)

    # -- exponentiation ----------------------------------------------------
    def pow_fixed(self, a, exponent: int):
        """a^exponent (Montgomery form, static exponent), LSB first."""
        acc = self.ones_mont(tuple(a.shape[1:]), a.device)
        base = a
        for i in range(max(exponent.bit_length(), 1)):
            if (exponent >> i) & 1:
                acc = self.mont_mul(acc, base)
            if (exponent >> (i + 1)):
                base = self.mont_sqr(base)
        return acc

    def inv(self, a):
        """Inversion by Fermat (a^(p-2)); 0 maps to 0."""
        return self.pow_fixed(a, self.spec.modulus - 2)

    # -- predicates --------------------------------------------------------
    def is_zero(self, a):
        return (a == 0).all(dim=0)

    def eq(self, a, b):
        return (a == b).all(dim=0)

    # -- scalar bit access (MSM windowing; canonical, NOT Montgomery) -----
    def window_digits(self, scalars, c: int, num_windows: int):
        """scalars: (L, N) canonical limbs -> (num_windows, N) int64 digits
        of width c <= 16 bits."""
        L, N = scalars.shape
        zero = torch.zeros((N,), dtype=torch.int64, device=scalars.device)
        digits = []
        for w in range(num_windows):
            bit0 = w * c
            limb, off = divmod(bit0, LIMB_BITS)
            lo = scalars[limb] if limb < L else zero
            hi = scalars[limb + 1] if limb + 1 < L else zero
            both = lo | (hi << LIMB_BITS) if off + c > LIMB_BITS else lo
            digits.append((both >> off) & ((1 << c) - 1))
        return torch.stack(digits)


FR = FieldOps(FR_SPEC)
FQ = FieldOps(FQ_SPEC)


# -- the port's word format: (8, N) int32 Fr words ---------------------------

def fr_const(v: int, device=None) -> torch.Tensor:
    """Canonical int -> (8, 1) Montgomery-form Fr words."""
    return torch.from_numpy(ints_to_words(
        [FR_SPEC.to_mont_int(v % FR_SPEC.modulus)], FR_SPEC.L)).to(device)


def fr_zeros(n: int, device=None) -> torch.Tensor:
    return torch.zeros((FR_SPEC.W, n), dtype=torch.int32, device=device)


def fr_add(a, b):
    return limbs_to_words(FR.add(words_to_limbs(a), words_to_limbs(b)))


def fr_sub(a, b):
    return limbs_to_words(FR.sub(words_to_limbs(a), words_to_limbs(b)))


def fr_neg(a):
    return limbs_to_words(FR.neg(words_to_limbs(a)))


def _r2_words(device) -> torch.Tensor:
    return torch.from_numpy(ints_to_words(
        [FR_SPEC.r_mont ** 2 % FR_SPEC.modulus], FR_SPEC.L)).to(device)


def fr_from_lazy(s, count: int):
    """(16, ...) int64 limb-wise sums of ``count`` Montgomery elements ->
    (8, ...) Montgomery words of their field sum: carry, one plain REDC
    (XLA in the reference) and an R^2 fix-up through ``fr_mul``."""
    from .cuda_field import fr_mul
    extra = max(1, (max(count, 1).bit_length() + LIMB_BITS - 1)
                // LIMB_BITS + 1)
    s = torch.cat([s, torch.zeros((extra,) + tuple(s.shape[1:]),
                                  dtype=torch.int64, device=s.device)])
    red = limbs_to_words(FR.redc_wide(_normalize(s)))
    r2 = _r2_words(s.device).reshape((FR_SPEC.W,) + (1,) * (red.dim() - 1))
    return fr_mul(red, r2)


def fr_sum(x, axis=-1):
    """Exact field sum of Fr words along a batch axis."""
    if axis < 0:
        axis = x.dim() + axis
    assert axis > 0, "axis 0 is the word axis"
    return fr_from_lazy(words_to_limbs(x).sum(dim=axis), x.shape[axis])


def fr_from_mont(a):
    from .cuda_field import fr_mul
    one = torch.zeros((FR_SPEC.W, 1), dtype=torch.int32, device=a.device)
    one[0] = 1
    return fr_mul(a, one)


def fr_to_mont(a):
    from .cuda_field import fr_mul
    return fr_mul(a, _r2_words(a.device))


def fr_inv(a):
    """Batched Fermat inversion of Fr words through the mul/sqr kernels."""
    from .cuda_field import fr_mul, fr_sqr
    e = FR_SPEC.modulus - 2
    acc, base = None, a
    for i in range(e.bit_length()):
        if (e >> i) & 1:
            acc = base if acc is None else fr_mul(acc, base)
        if e >> (i + 1):
            base = fr_sqr(base)
    return acc


def fr_window_digits(scalars, c: int, num_windows: int):
    """(8, N) canonical Fr words -> (num_windows, N) int64 c-bit digits."""
    K, N = scalars.shape
    u = scalars.to(torch.int64) & 0xFFFFFFFF
    zero = torch.zeros((N,), dtype=torch.int64, device=scalars.device)
    digits = []
    for w in range(num_windows):
        word, off = divmod(w * c, 32)
        lo = u[word] if word < K else zero
        v = lo >> off
        if off + c > 32 and word + 1 < K:
            v = v | (u[word + 1] << (32 - off))
        digits.append(v & ((1 << c) - 1))
    return torch.stack(digits)
