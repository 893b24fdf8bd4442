"""Batched G1 point arithmetic (counterpart of curve_jax.py).

Two layers, as in field.py:

* the plain formulas (``jac_add_core``, ``jac_madd_core``, ...) on tuples
  of ``(24, ...)`` int64 16-bit limb arrays, the reference's layout.  They
  are the CPU path of the kernel wrappers and the reference the kernels
  are held against on the card.
* point tensors in the port's word format, which every kernel takes:
  Jacobian ``(36, ...)`` int32 words = X | Y | Z (12 words each), affine
  ``(24, ...)`` = X | Y.  Reductions over a batch axis (``tree_sum_jac``,
  ``prefix_scan_jac``) run on these through the ``jac_add`` kernel, or
  through the Jacobian add they are given.

Identity conventions (curve_jax.py): Jacobian Z == 0; affine (0, 0) — Y = 0
never occurs on G1 (no 2-torsion), so it marks the identity in SRS vectors
and MSM padding.
"""

from __future__ import annotations

import torch

from ..hostmath import bls12_381 as bls
from .field import FQ
from .limbs import FQ_SPEC, ints_to_words, words_to_ints, words_to_limbs, \
    limbs_to_words

FW = FQ_SPEC.W            # 12 words per Fq element
JAC = 3 * FW              # 36 words per Jacobian point
AFF = 2 * FW              # 24 words per affine point


# -- plain formulas on 16-bit limbs (curve_jax.py :24-198) -------------------

def jac_identity(shape=(), device=None):
    one = FQ.ones_mont(shape, device)
    return (one, one.clone(), FQ.zeros(shape, device))


def affine_to_jac(xy):
    """(X, Y) affine limbs -> Jacobian; (0, 0) maps to Z = 0."""
    X, Y = xy
    inf = FQ.is_zero(Y)
    one = FQ.ones_mont(tuple(X.shape[1:]), X.device)
    return (X, Y, torch.where(inf, torch.zeros_like(one), one))


def is_identity(p):
    return FQ.is_zero(p[2])


def select_point(mask, a, b):
    """mask (...) bool: a where True else b (per point)."""
    return tuple(torch.where(mask, ai, bi) for ai, bi in zip(a, b))


def jac_double_core(p):
    """dbl-2009-l (a = 0): 2M + 5S; the identity doubles to the identity."""
    X1, Y1, Z1 = p
    A = FQ.mont_sqr(X1)
    B = FQ.mont_sqr(Y1)
    C = FQ.mont_sqr(B)
    t = FQ.mont_sqr(FQ.add(X1, B))
    Dh = FQ.sub(FQ.sub(t, A), C)
    D = FQ.add(Dh, Dh)
    E = FQ.add(FQ.add(A, A), A)
    X3 = FQ.sub(FQ.sub(FQ.mont_sqr(E), D), D)
    C8 = FQ.add(C, C)
    C8 = FQ.add(C8, C8)
    C8 = FQ.add(C8, C8)
    Y3 = FQ.sub(FQ.mont_mul(E, FQ.sub(D, X3)), C8)
    Z3 = FQ.mont_mul(FQ.add(Y1, Y1), Z1)
    return (X3, Y3, Z3)


def _lanes(points, shape):
    """Broadcast point coordinates to ``shape`` and flatten the lanes."""
    return tuple(c.expand((c.shape[0],) + shape).reshape(c.shape[0], -1)
                 for c in points)


def _unlanes(points, shape):
    return tuple(c.reshape((c.shape[0],) + shape) for c in points)


def _batch_shape(*points):
    return torch.broadcast_shapes(*(c.shape[1:] for p in points for c in p))


def jac_add_core(p, q):
    """add-2007-bl with full degenerate handling (identity operands,
    P == Q -> double, P == -Q -> identity).  The formula runs only on the
    lanes where both operands are finite; the rest are selects."""
    shape = _batch_shape(p, q)
    p, q = _lanes(p, shape), _lanes(q, shape)
    p_inf, q_inf = is_identity(p), is_identity(q)
    out = select_point(p_inf[None], q, p)
    live = (~p_inf & ~q_inf).nonzero().squeeze(1)
    if live.numel():
        res = _jac_add_finite(tuple(c[:, live] for c in p),
                              tuple(c[:, live] for c in q))
        for o, r in zip(out, res):
            o[:, live] = r
    return _unlanes(out, shape)


def _muls(*pairs):
    """Independent Montgomery products of equal-shape (24, n) operands as
    one plain mont_mul over the lanes side by side.  The plain field ops
    cost about the same for a few lanes as for a few hundred, so this
    halves the cost of the point formulas at small batches."""
    n = pairs[0][0].shape[1]
    out = FQ.mont_mul(torch.cat([a for a, _ in pairs], dim=1),
                      torch.cat([b for _, b in pairs], dim=1))
    return out.split(n, dim=1)


def _jac_add_finite(p, q):
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1, Z2Z2 = _muls((Z1, Z1), (Z2, Z2))
    U1, U2, Y1Z2, Y2Z1 = _muls((X1, Z2Z2), (X2, Z1Z1), (Y1, Z2), (Y2, Z1))
    S1, S2 = _muls((Y1Z2, Z2Z2), (Y2Z1, Z1Z1))
    H = FQ.sub(U2, U1)
    HH = FQ.mont_sqr(FQ.add(H, H))
    J, V = _muls((H, HH), (U1, HH))
    rr = FQ.sub(S2, S1)
    rr = FQ.add(rr, rr)
    Z12 = FQ.add(Z1, Z2)
    rr2, S1J, Z12sq = _muls((rr, rr), (S1, J), (Z12, Z12))
    X3 = FQ.sub(FQ.sub(rr2, J), FQ.add(V, V))
    ZZ = FQ.sub(FQ.sub(Z12sq, Z1Z1), Z2Z2)
    rVX3, Z3 = _muls((rr, FQ.sub(V, X3)), (ZZ, H))
    Y3 = FQ.sub(rVX3, FQ.add(S1J, S1J))
    out = (X3, Y3, Z3)

    h_zero = FQ.eq(U1, U2)
    r_zero = FQ.eq(S1, S2)
    dbl = (h_zero & r_zero).nonzero().squeeze(1)
    if dbl.numel():
        res = jac_double_core(tuple(c[:, dbl] for c in p))
        for o, r in zip(out, res):
            o[:, dbl] = r
    out = select_point(h_zero & ~r_zero,
                       jac_identity(tuple(X3.shape[1:]), X3.device), out)
    return out


def mdbl_core(leaf):
    """Double an affine (X, Y) point -> Jacobian (mdbl-2007-bl, 1M + 5S)."""
    X1, Y1 = leaf
    XX = FQ.mont_sqr(X1)
    YY = FQ.mont_sqr(Y1)
    YYYY = FQ.mont_sqr(YY)
    t = FQ.mont_sqr(FQ.add(X1, YY))
    Sh = FQ.sub(FQ.sub(t, XX), YYYY)
    S = FQ.add(Sh, Sh)
    M = FQ.add(FQ.add(XX, XX), XX)
    T = FQ.sub(FQ.sub(FQ.mont_sqr(M), S), S)
    C8 = FQ.add(YYYY, YYYY)
    C8 = FQ.add(C8, C8)
    C8 = FQ.add(C8, C8)
    Y3 = FQ.sub(FQ.mont_mul(M, FQ.sub(S, T)), C8)
    Z3 = FQ.add(Y1, Y1)
    return (T, Y3, Z3)


def jac_madd_core(p, leaf, fast: bool = False):
    """Mixed add Jacobian + affine (madd-2007-bl, 8M + 3S).  ``fast`` skips
    the doubling fallback and returns a per-lane collision flag instead
    (set where the safe form would have doubled).  Returns (point, err)
    with err None unless fast.  The formula runs only on the lanes where
    both operands are finite."""
    shape = _batch_shape(p, leaf)
    p, leaf = _lanes(p, shape), _lanes(leaf, shape)
    p_inf, leaf_inf = is_identity(p), FQ.is_zero(leaf[1])
    one = FQ.ones_mont((p_inf.shape[0],), p[0].device)
    out = select_point(leaf_inf, p, select_point(p_inf, leaf + (one,), p))
    err = torch.zeros_like(p_inf) if fast else None
    live = (~p_inf & ~leaf_inf).nonzero().squeeze(1)
    if live.numel():
        res, coll = _jac_madd_finite(tuple(c[:, live] for c in p),
                                     tuple(c[:, live] for c in leaf))
        dbl = coll.nonzero().squeeze(1)
        if fast:
            err[live] = coll
        elif dbl.numel():
            res2 = mdbl_core(tuple(c[:, live[dbl]] for c in leaf))
            for o, r in zip(res, res2):
                o[:, dbl] = r
        for o, r in zip(out, res):
            o[:, live] = r
    out = _unlanes(out, shape)
    return out, (None if err is None else err.reshape(shape))


def _jac_madd_finite(p, leaf):
    """madd-2007-bl on finite lanes -> (point, collision mask).  Where the
    safe form would double, the formula's all-zero value is returned."""
    X1, Y1, Z1 = p
    X2, Y2 = leaf
    Z1Z1 = FQ.mont_sqr(Z1)
    U2, Y2Z1 = _muls((X2, Z1Z1), (Y2, Z1))
    S2 = FQ.mont_mul(Y2Z1, Z1Z1)
    H = FQ.sub(U2, X1)
    I = FQ.mont_sqr(FQ.add(H, H))
    J, V = _muls((H, I), (X1, I))
    rr = FQ.sub(S2, Y1)
    rr = FQ.add(rr, rr)
    rr2, YJ, Z3 = _muls((rr, rr), (Y1, J), (FQ.add(Z1, Z1), H))
    X3 = FQ.sub(FQ.sub(rr2, J), FQ.add(V, V))
    Y3 = FQ.sub(FQ.mont_mul(rr, FQ.sub(V, X3)), FQ.add(YJ, YJ))
    h_zero = FQ.eq(U2, X1)
    r_zero = FQ.eq(S2, Y1)
    out = select_point(h_zero & ~r_zero,
                       jac_identity(tuple(X1.shape[1:]), X1.device),
                       (X3, Y3, Z3))
    return out, h_zero & r_zero


def jac_to_affine_core(p):
    """Jacobian -> affine (X, Y) by Fermat inversion of Z; Z = 0 gives
    (0, 0), the affine identity (fixed_base.jac_to_affine_batch)."""
    X, Y, Z = p
    zinv = FQ.inv(Z)
    zinv2 = FQ.mont_sqr(zinv)
    return FQ.mont_mul(X, zinv2), FQ.mont_mul(Y, FQ.mont_mul(zinv2, zinv))


# -- word-format points --------------------------------------------------------

def split_words(t: torch.Tensor, coords: int):
    """(12 * coords, ...) words -> tuple of (24, ...) int64 limb arrays."""
    return tuple(words_to_limbs(t[FW * k:FW * (k + 1)]) for k in range(coords))


def join_words(coords) -> torch.Tensor:
    return torch.cat([limbs_to_words(c) for c in coords])


def jac_identity_words(shape=(), device=None) -> torch.Tensor:
    one = torch.from_numpy(ints_to_words([FQ_SPEC.r_mont], FQ_SPEC.L))
    one = one.to(device).reshape((FW,) + (1,) * len(shape))
    one = one.expand((FW,) + tuple(shape))
    return torch.cat([one, one, torch.zeros_like(one)])


def affine_to_jac_words(xy: torch.Tensor) -> torch.Tensor:
    """(24, ...) affine words -> (36, ...) Jacobian words."""
    inf = (xy[FW:] == 0).all(dim=0)
    one = jac_identity_words(tuple(xy.shape[1:]), xy.device)[:FW]
    return torch.cat([xy, torch.where(inf, torch.zeros_like(one), one)])


def tree_sum_jac(pj: torch.Tensor, add=None) -> torch.Tensor:
    """Sum a (36, n, ...) Jacobian batch over axis 1 by pairwise halving:
    log2(n) calls of ``add`` (default: the ``jac_add`` kernel wrapper),
    each one batched add.  Returns (36, ...)."""
    if add is None:
        from .cuda_curve import jac_add as add
    n = pj.shape[1]
    while n > 1:
        if n & 1:
            idn = jac_identity_words((1,) + tuple(pj.shape[2:]), pj.device)
            pj = torch.cat([pj, idn], dim=1)
            n += 1
        half = n // 2
        pj = add(pj[:, :half], pj[:, half:])
        n = half
    return pj[:, 0]


def prefix_scan_jac(pj: torch.Tensor, add=None) -> torch.Tensor:
    """Inclusive prefix sum of a (36, n, ...) Jacobian batch along axis 1
    (Hillis-Steele: log2(n) calls of ``add``, default the ``jac_add``
    kernel wrapper, each one full-width batched add)."""
    if add is None:
        from .cuda_curve import jac_add as add
    n = pj.shape[1]
    k = 1
    while k < n:
        idn = jac_identity_words((k,) + tuple(pj.shape[2:]), pj.device)
        pj = add(pj, torch.cat([idn, pj[:, :n - k]], dim=1))
        k *= 2
    return pj


# -- host <-> device point conversion -----------------------------------------

def points_to_device(points, device=None) -> torch.Tensor:
    """Host affine G1 points -> (24, N) Montgomery affine words; ``None``
    (the identity) encodes as (0, 0)."""
    xs = [0 if p is None else FQ_SPEC.to_mont_int(p[0].v) for p in points]
    ys = [0 if p is None else FQ_SPEC.to_mont_int(p[1].v) for p in points]
    return torch.from_numpy(
        ints_to_words(xs + ys, FQ_SPEC.L).reshape(FW, 2, -1)
        .transpose(1, 0, 2).reshape(AFF, -1).copy()).to(device)


def affine_to_host(xy) -> list:
    """(24, N) affine words -> host affine list ((0, 0) -> None)."""
    arr = xy.cpu().numpy()
    xs = [FQ_SPEC.from_mont_int(v) for v in words_to_ints(arr[:FW])]
    ys = [FQ_SPEC.from_mont_int(v) for v in words_to_ints(arr[FW:])]
    return [None if y == 0 else (bls.Fq(x), bls.Fq(y))
            for x, y in zip(xs, ys)]


def jac_to_host(p: torch.Tensor) -> list:
    """(36, N) Jacobian words -> host affine points.  The Z inversions
    share one modular pow (Montgomery batch trick)."""
    arr = p.reshape(JAC, -1).cpu().numpy()
    X = [FQ_SPEC.from_mont_int(v) for v in words_to_ints(arr[:FW])]
    Y = [FQ_SPEC.from_mont_int(v) for v in words_to_ints(arr[FW:2 * FW])]
    Z = [FQ_SPEC.from_mont_int(v) for v in words_to_ints(arr[2 * FW:])]
    nz = [z for z in Z if z != 0]
    inv = {}
    if nz:
        prefix = [1]
        for z in nz:
            prefix.append(prefix[-1] * z % bls.Q)
        acc = pow(prefix[-1], bls.Q - 2, bls.Q)
        for z in reversed(nz):
            inv[z] = acc * prefix[len(prefix) - 2] % bls.Q
            acc = acc * z % bls.Q
            prefix.pop()
    out = []
    for x, y, z in zip(X, Y, Z):
        if z == 0:
            out.append(None)
            continue
        zi = inv[z]
        zi2 = zi * zi % bls.Q
        out.append((bls.Fq(x * zi2 % bls.Q),
                    bls.Fq(y * zi2 % bls.Q * zi % bls.Q)))
    return out
