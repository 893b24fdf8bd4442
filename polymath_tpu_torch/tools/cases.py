"""Kernel inputs with the edge cases planted, the kernels' plain versions
as one call each, the comparisons, and the launch counters, shared by the
kernel table (``kernel_table``) and the card tests
(tests/torch_cases.py, tests/test_torch_cuda.py).

The inputs are the words the kernels read (Montgomery form): field
elements that hold every pair of the edge values on which a carry-chain
fault shows (``edge_values``), points with the degenerate cases of the
group law beside Fq edge words, and an MSM chunk of distinct points with
its bucket order.  ``compare`` reads the words as unsigned 32-bit integers
and raises on any difference, since the kernels are exact;
``compare_points`` compares Jacobian words as affine points, for the tree
kernels, which add in another order than their plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..hostmath import bls12_381 as bls
from ..ops import curve as C
from ..ops import cuda_curve, cuda_field, cuda_gather, cuda_poly, cuda_scan
from ..ops import cuda_tree, poly
from ..ops import msm as M
from ..ops import ntt as N
from ..ops.field import FR
from ..ops.limbs import (FQ_SPEC, FR_SPEC, ints_to_words, limbs_to_words,
                         words_to_limbs)

#: the kernel wrappers whose LAUNCHES the prover's kernels count
COUNTED = (cuda_field, cuda_curve, cuda_gather, cuda_scan, cuda_tree, N,
           cuda_poly)


def launches() -> dict:
    """Every prover kernel's launches since the last reset."""
    out = {}
    for mod in COUNTED:
        out.update(mod.LAUNCHES)
    return out


def reset_launches() -> None:
    """Every launch count to 0 (the measurement tools' T1 and T2 too), and
    ops/msm.py's count of MSMs of more than one chunk."""
    from . import pgather_variants, primbench
    for mod in COUNTED + (primbench, pgather_variants):
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0
    for k in M.RUNS:
        M.RUNS[k] = 0


def compare(name: str, got, want) -> int:
    """Largest |got - want| over the words, read as unsigned 32-bit
    integers; raises if any lane differs (the kernels are exact).  Tuples
    (a kernel's several outputs) compare item by item."""
    if isinstance(got, tuple):
        return max(compare(f"{name}[{i}]", g, w)
                   for i, (g, w) in enumerate(zip(got, want, strict=True)))
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    g = got.to(torch.int64) & 0xFFFFFFFF
    w = want.to(torch.int64) & 0xFFFFFFFF
    diff = (g - w).abs()
    if diff.numel() and bool(diff.any()):
        lanes = int(diff.reshape(diff.shape[0], -1).any(dim=0).sum()) \
            if diff.dim() > 1 else int((diff != 0).sum())
        raise AssertionError(f"{name}: {lanes} lanes differ from the plain "
                             f"version")
    return int(diff.max()) if diff.numel() else 0


def compare_points(name: str, got, want) -> int:
    """Jacobian words that may differ where the group elements do not: both
    sides to affine words by the plain formulas, then ``compare``."""
    return compare(name, plain_to_affine(got.reshape(got.shape[0], -1)),
                   plain_to_affine(want.reshape(want.shape[0], -1)))


# -- inputs ------------------------------------------------------------------

def edge_values(p: int, n_words: int) -> list:
    """Stored words (Montgomery form, as the kernels read them) on which a
    carry-chain fault shows: 0, 1, p - 1, p - 2, R mod p, R^2 mod p, and
    values below p whose low k words are all 0xffffffff (k = 1 .. N - 1),
    so that a carry from word 0 ripples across the element."""
    r = 1 << (32 * n_words)
    vals = [0, 1, p - 1, p - 2, r % p, r * r % p]
    for k in range(1, n_words):
        low = (1 << (32 * k)) - 1
        vals.append(((((p - 1) >> (32 * k)) - 1) << (32 * k)) | low)
    vals.append((1 << (32 * (n_words - 1))) - 1)   # all ones but the top
    return list(dict.fromkeys(v % p for v in vals))


def field_inputs(dev, n: int, seed: int, role: int = 0):
    """n random canonical Fr elements (numpy default_rng(seed)) whose
    first E^2 lanes hold every pair of the E edge values: lane k holds
    edge k // E for role 0, edge k % E for role 1, so two inputs of
    different roles meet every pair."""
    rng = np.random.default_rng(seed)
    p = FR_SPEC.modulus
    vals = [int.from_bytes(rng.bytes(40), "little") % p for _ in range(n)]
    mont = [FR_SPEC.to_mont_int(v) for v in vals]
    e = edge_values(p, FR_SPEC.L)
    for k in range(min(n, len(e) ** 2)):
        mont[k] = e[k // len(e)] if role == 0 else e[k % len(e)]
    return torch.from_numpy(ints_to_words(mont, FR_SPEC.L)).to(dev)


def fq_edge_words(count: int, shift: int):
    """(12, count) Fq words cycling through the Fq edge values, starting
    at edge ``shift``."""
    e = edge_values(FQ_SPEC.modulus, FQ_SPEC.L)
    return torch.from_numpy(ints_to_words(
        [e[(shift + k) % len(e)] for k in range(count)], FQ_SPEC.L))


def host_points(n: int):
    """k * G for k = 1..n by host affine adds (distinct, on the curve)."""
    pts, cur = [], None
    for _ in range(n):
        cur = bls.G1.add(cur, bls.G1.gen)
        pts.append(cur)
    return pts


def host_point(k: int):
    """k G for a small signed k (None for 0)."""
    if k == 0:
        return None
    p = bls.G1.mul(bls.G1.gen, abs(k))
    return p if k > 0 else bls.G1.neg(p)


def point_inputs(dev, n: int):
    """Jacobian accumulators with Z != 1 and affine leaves, with the
    degenerate lanes: identity on either side, a (0, 0) leaf, P + P and
    P + (-P) (both with Z = 1 and with Z != 1); and lanes whose words are
    the Fq edge values.  Returns (acc (36, n), leaf (24, n), q (36, n))."""
    pts = host_points(n)
    aff = C.points_to_device(pts)                          # (24, n) on CPU
    leaf = C.points_to_device(pts[1:] + pts[:1])
    ja = C.affine_to_jac_words(aff)
    # Z != 1: acc_i = P_i + P_(i+1) (plain add on the CPU)
    acc = cuda_curve.jac_add(ja, C.affine_to_jac_words(leaf))
    acc[:, 0] = C.jac_identity_words((), None)             # identity acc
    leaf[:, 1] = 0                                         # (0, 0) leaf
    acc[:, 2] = ja[:, 2]                                   # P + P, Z = 1
    leaf[:, 2] = aff[:, 2]
    acc[:, 3] = ja[:, 3]                                   # P + (-P)
    neg = C.points_to_device([bls.G1.neg(pts[3])])
    leaf[:, 3] = neg[:, 0]
    acc[:, 4] = cuda_curve.jac_add(ja[:, 4:5], ja[:, 4:5])[:, 0]  # 2P
    leaf[:, 4] = C.points_to_device([bls.G1.double(pts[4])])[:, 0]
    # general-add operands: p = acc, q = Jacobian leaf, plus an identity q
    # and q = p (Z != 1) lanes
    q = C.affine_to_jac_words(leaf)
    q[:, 5] = C.jac_identity_words((), None)
    q[:, 6] = acc[:, 6]
    # edge-word lanes 16 .. 16 + 3E: every coordinate an Fq edge value (not
    # points of the curve; the formulas and their selects run all the same)
    e = len(edge_values(bls.Q, 12))
    lanes = slice(16, 16 + 3 * e)
    for c in range(3):
        acc[12 * c:12 * c + 12, lanes] = fq_edge_words(3 * e, c)
        q[12 * c:12 * c + 12, lanes] = fq_edge_words(3 * e, 3 + c)
    for c in range(2):
        leaf[12 * c:12 * c + 12, lanes] = fq_edge_words(3 * e, 3 + c)
    return acc.to(dev), leaf.to(dev), q.to(dev)


def jac_words(ks, seed: int):
    """(36, *ks.shape) Jacobian words of k G with a random Z != 1 (X = x
    z^2, Y = y z^3), but for the first lanes, whose Z words are the Fq edge
    values (turned by the seed); k = 0 is the identity (1, 1, 0)."""
    rng = np.random.default_rng(seed)
    flat = np.asarray(ks).reshape(-1).tolist()
    cache = {k: host_point(k) for k in set(flat)}
    # the first lanes' Z words are the nonzero Fq edge values, in an order
    # that turns with the seed (so another seed gives other words)
    r_inv = pow(1 << 384, -1, bls.Q)
    edge_z = [w * r_inv % bls.Q for w in edge_values(bls.Q, 12) if w]
    coords = [[], [], []]
    for lane, k in enumerate(flat):
        p = cache[k]
        if p is None:
            xyz = (1, 1, 0)
        else:
            z = edge_z[(lane + seed) % len(edge_z)] if lane < len(edge_z) \
                else int(rng.integers(2, 1 << 62))
            xyz = (p[0].v * z * z % bls.Q, p[1].v * z * z * z % bls.Q, z)
        for c, v in zip(coords, xyz):
            c.append(FQ_SPEC.to_mont_int(v))
    words = np.concatenate([ints_to_words(c, FQ_SPEC.L) for c in coords])
    return torch.from_numpy(words.reshape((36,) + np.shape(ks)))


def sum_sets_case(k: int, windows: int, seed: int):
    """k sets of window sums as discrete logs (numpy default_rng(seed)):
    (k, windows) small signed k of the points k G, random but for the
    planted windows (those that fit): 0, set 0 the identity; 1, sets 0, 1
    and h the same point, h the stride of the kernel's first level (half
    the power of two at or above k), so that P + P meets the doubling
    branch in the serial sum and in the tree; 2, sets 1 and h the
    negation of set 0 (P + (-P)); 3, every set the same point (the c_w
    MSM's chunks, BenchCircuit's vector repeating one digit)."""
    rng = np.random.default_rng(seed)
    ks = rng.integers(-40, 41, (k, windows))
    h = (1 << (k - 1).bit_length()) // 2
    if windows > 0:
        ks[0, 0] = 0
    if windows > 1 and k > 1:
        ks[[0, 1, h], 1] = 13
    if windows > 2 and k > 1:
        ks[0, 2], ks[[1, h], 2] = 11, -11
    if windows > 3:
        ks[:, 3] = 7
    return ks


def sum_sets_inputs(dev, k: int, windows: int, seed: int):
    """sum_sets_case on ``dev``: ((k, 36, windows) Jacobian words with
    Z != 1, edge-word Z in the first lanes (jac_words), ks)."""
    ks = sum_sets_case(k, windows, seed)
    return jac_words(ks, seed).permute(1, 0, 2).contiguous().to(dev), ks


def chunk_inputs(dev, chunk: int):
    """One d-MSM chunk as the prover feeds the fused scan: a table of the
    ``chunk`` distinct points k G (k = 1..chunk, formed on ``dev`` from up
    to 4096 host points and offsets of that many G), random canonical
    scalars, and their bucket order: idx (seq, windows, rows) and the
    sorted digits (windows, chunk)."""
    base = host_points(min(chunk, 4096))
    step, offs = bls.G1.mul(bls.G1.gen, len(base)), [None]
    for _ in range(chunk // len(base) - 1):
        offs.append(bls.G1.add(offs[-1], step))
    bj = C.affine_to_jac_words(C.points_to_device(base).to(dev))
    oj = C.affine_to_jac_words(C.points_to_device(offs).to(dev))
    pts = cuda_curve.jac_add(bj[:, :, None], oj[:, None, :])
    table = cuda_curve.to_affine(pts).reshape(C.AFF, chunk).T.contiguous()
    g = torch.Generator(device="cpu").manual_seed(13)
    sc = torch.randint(-2**31, 2**31, (8, chunk), generator=g,
                       dtype=torch.int64)
    # top word below p's (0x73eda753): every scalar is canonical
    sc[7] = torch.randint(0, 0x73eda753, (chunk,), generator=g)
    c, windows = M.window_params(chunk)
    idx, d_sorted = M.bucket_order(sc.to(torch.int32).to(dev), chunk, c,
                                   windows, M.scan_seq(chunk))
    return table, idx, d_sorted


def scan_multipliers(seed: int) -> list:
    """Canonical multipliers for the quotient scan's launches: one from
    numpy default_rng(seed) and three whose Montgomery words are Fr edge
    values (p - 1, R mod p, a run of 0xffffffff words)."""
    p = FR_SPEC.modulus
    e = edge_values(p, FR_SPEC.W)
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % p] + [
        FR_SPEC.from_mont_int(w) for w in (e[2], e[4], e[-2])]


# -- the plain versions -------------------------------------------------------

def plain_fr_mul(a, b):
    return limbs_to_words(FR.mont_mul(words_to_limbs(a), words_to_limbs(b)))


def plain_fr_sqr(a):
    return limbs_to_words(FR.mont_sqr(words_to_limbs(a)))


def plain_add(p, q):
    return C.join_words(C.jac_add_core(C.split_words(p, 3),
                                       C.split_words(q, 3)))


def plain_madd(p, leaf, fast):
    r, e = C.jac_madd_core(C.split_words(p, 3), C.split_words(leaf, 2), fast)
    return C.join_words(r), e


def plain_double(p):
    return C.join_words(C.jac_double_core(C.split_words(p, 3)))


def plain_butterfly(lo, hi, tw):
    lo_l = words_to_limbs(lo)
    t = FR.mont_mul(words_to_limbs(hi), words_to_limbs(tw))
    return limbs_to_words(FR.add(lo_l, t)), limbs_to_words(FR.sub(lo_l, t))


def plain_to_affine(p):
    return C.join_words(C.jac_to_affine_core(C.split_words(p, 3)))


def plain_ntt_local(x, tw):
    return limbs_to_words(N.ntt_local_plain(words_to_limbs(x),
                                            words_to_limbs(tw)))


def plain_scan(c, mult_m, rev):
    """The quotient scan as the blocked fr_mul / fr_add recurrence that it
    replaced (ops/poly.py:affine_scan_plain), in either order."""
    if not rev:
        return poly.affine_scan_plain(c, mult_m)
    return poly.affine_scan_plain(c.flip(-1), mult_m).flip(-1)
