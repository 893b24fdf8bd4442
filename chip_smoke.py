#!/usr/bin/env python3
"""Smoke run of polymath_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py [--constraints N]

Phases, each printing what it found:

1. device: the card's name and power limit; builds every CUDA source of
   polymath_tpu_torch/csrc with nvcc into build/ (one nvcc per source, all
   at once) and prints the build time and each kernel's ptxas report,
   failing on any spill in any source (the report is read from the file
   each build leaves beside its library, so a cached build is checked
   too);
2. kernels: every kernel (B1-B9 and the port-only to_affine) against its
   plain PyTorch version on the same inputs on the card, bit for bit (0
   mismatches allowed): first at moderate shapes that hold the edge cases
   (field edge values, the degenerate point cases, dead and colliding MSM
   leaves), then at the main path's shapes, where the kernel's time, its
   plain version's time and its bound are taken;
3. golden bytes: DummyCircuit / Rng(1234) / a=5, b=7 through the port's
   setup and prove on the card, for all three transcripts, against
   tests/fixtures/golden_dummy.json;
4. main path: BenchCircuit at N constraints (default 2^20 - 100, as
   bench.py), Merlin, seed 0: setup, a warm prove, a second prove, a
   verify of each and a rejected wrong public input, with per-phase times,
   peak device memory and each kernel's launch count (B1-B6 > 0 in a
   prove, the port-only to_affine > 0 in setup);
4b. the fused-scan configuration (POLYMATH_MSM_FUSED=1) of the main path:
   with the phase-4 key, four proves in turns (split, fused, fused,
   split), each from a fresh Rng(7): the proofs must be byte-equal and
   verify, a wrong public input must be rejected, and each fused prove
   must launch fused_scan (B7) once per MSM chunk and no jac_madd or
   gather_rows.  Per-phase times, peak device memory and launches of each;
5. measurement entry points (polymath_tpu_torch/tools), each through its
   main() at its default size: primbench (T2: nine chains of 512
   dependent steps over 2^17 elements, on the tool's constant input and a
   seeded random one, against the plain versions bit for bit but for the
   fused f32 b * a + a row at rtol 1e-4, and every instantiation keeping
   at least 512 of its row's instructions in the SASS),
   pgather_variants (T1: six gather layouts of 22 x 2^18 rows from a 2^18
   -point table, bit for bit), kernel_metrics (NTT at 2^20 and 2^22, MSM
   at 2^20 with its host-oracle check) and fusedprof (each stage of one
   2^19-point MSM chunk, composed back to msm_chunk's window sums, split
   and fused).  Every T1 and T2 kernel must have launched in this phase.

B8 (jac_double) and B9 (fr_butterfly) are on no path of the reference:
phase 2 holds them against their plain versions and times them; their
launch counts on the main path are 0.  T1 and T2 are timed, compared and
counted by phase 5.

Then one JSON line with every kernel's numbers, the card's name and power
limit as nvidia-smi prints them, and as the last line
{"ok": true, "device": {...}}.  Any failed check raises: the script then
exits non-zero without that line.  It also exits non-zero, printing no
result, when no CUDA card is visible or the package is missing.

Bounds (polymath_tpu_torch.tools.bound_ms, which holds the card's rates
for this script and every tool): bytes each input read once and each
output written once, at 3.35e12 B/s; or 32-bit integer multiply-adds at
16.7e12/s (64 INT32 lanes per SM, half the fp32 lanes behind the 67
TFLOP/s fp32 peak, x 132 SMs x 1.98 GHz), counting a 32x32->64-bit
product as two; the larger of the two.  T2's rows count one operation a
step (two for the masked multiply and the shift+xor), its f32 rows at
33.5e12 fp32 instructions/s; T1 is bound by its bytes.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# 32-bit multiply-adds per operation (CIOS / SOS with 32-bit words; a
# wide product counts two, each reduction digit one)
FR_MUL_OPS = 2 * (64 + 64) + 8
FR_SQR_OPS = 2 * (36 + 64) + 8
FQ_MUL_OPS = 2 * (144 + 144) + 12
FQ_SQR_OPS = 2 * (78 + 144) + 12
MADD_OPS = 8 * FQ_MUL_OPS + 3 * FQ_SQR_OPS         # madd-2007-bl
ADD_OPS = 11 * FQ_MUL_OPS + 5 * FQ_SQR_OPS         # add-2007-bl
# g1.cu's Fermat inversion: 384 squarings, popcount(q - 2) = 229 products,
# then zinv^2 and three products
TO_AFFINE_OPS = 385 * FQ_SQR_OPS + (229 + 3) * FQ_MUL_OPS
DOUBLE_OPS = 2 * FQ_MUL_OPS + 5 * FQ_SQR_OPS       # dbl-2009-l
BFLY_OPS = FR_MUL_OPS                              # one product a pair


#: B1-B6, which every (split) prove launches, the kernel that replaces the
#: gather and madd in the fused configuration, the two kernels no path of
#: the reference calls, and the port-only setup kernel
PROVE_KERNELS = ("fr_mul", "fr_sqr", "jac_madd", "gather_rows", "jac_add",
                 "ntt_local")
SPLIT_ONLY = ("jac_madd", "gather_rows")
FUSED_KERNELS = ("fused_scan",)
UNCALLED_KERNELS = ("jac_double", "fr_butterfly")
SETUP_KERNELS = ("to_affine",)
ALL_KERNELS = PROVE_KERNELS + FUSED_KERNELS + UNCALLED_KERNELS + \
    SETUP_KERNELS


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check_ptxas(names) -> None:
    """Prints each source's ptxas report (registers and spills of every
    kernel), read from the file its build left beside the library, so a
    library built by an earlier run is checked too; raises if a report
    lists no kernel or any spill."""
    from polymath_tpu_torch.ops import _build
    for name in names:
        report = _build.ptxas_report(name)
        for line in report.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"    {name}.cu: {line.strip()}")
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill",
                            report)
        if not spills or any(a != "0" or b != "0" for a, b in spills):
            raise AssertionError(f"{name}.cu: ptxas reports spills {spills}")


def compare(name: str, got, want) -> int:
    """Largest |got - want| over the words, read as unsigned 32-bit
    integers; raises if any lane differs (the kernels are exact).  Tuples
    (a kernel's several outputs) compare item by item."""
    import torch
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


# -- phase 2: inputs ---------------------------------------------------------

def field_inputs(dev, n: int, seed: int):
    import numpy as np
    import torch
    from polymath_tpu_torch.ops.limbs import FR_SPEC, ints_to_words
    rng = np.random.default_rng(seed)
    p = FR_SPEC.modulus
    vals = [int.from_bytes(rng.bytes(40), "little") % p for _ in range(n)]
    vals[:4] = [0, 1, p - 1, p - 2]
    mont = [FR_SPEC.to_mont_int(v) for v in vals]
    return torch.from_numpy(ints_to_words(mont, FR_SPEC.L)).to(dev)


def host_points(n: int):
    """k * G for k = 1..n by host affine adds (distinct, on the curve)."""
    from polymath_tpu_torch.hostmath import bls12_381 as bls
    pts, cur = [], None
    for _ in range(n):
        cur = bls.G1.add(cur, bls.G1.gen)
        pts.append(cur)
    return pts


def point_inputs(dev, n: int):
    """Jacobian accumulators with Z != 1 and affine leaves, with the
    degenerate lanes: identity on either side, a (0, 0) leaf, P + P and
    P + (-P) (both with Z = 1 and with Z != 1)."""
    from polymath_tpu_torch.ops import curve as C
    from polymath_tpu_torch.ops.cuda_curve import jac_add
    from polymath_tpu_torch.hostmath import bls12_381 as bls
    pts = host_points(n)
    aff = C.points_to_device(pts)                          # (24, n) on CPU
    leaf = C.points_to_device(pts[1:] + pts[:1])
    ja = C.affine_to_jac_words(aff)
    # Z != 1: acc_i = P_i + P_(i+1) (plain add on the CPU)
    acc = jac_add(ja, C.affine_to_jac_words(leaf))
    acc[:, 0] = C.jac_identity_words((), None)             # identity acc
    leaf[:, 1] = 0                                         # (0, 0) leaf
    acc[:, 2] = ja[:, 2]                                   # P + P, Z = 1
    leaf[:, 2] = aff[:, 2]
    acc[:, 3] = ja[:, 3]                                   # P + (-P)
    neg = C.points_to_device([bls.G1.neg(pts[3])])
    leaf[:, 3] = neg[:, 0]
    acc[:, 4] = jac_add(ja[:, 4:5], ja[:, 4:5])[:, 0]      # 2P, Z != 1
    leaf[:, 4] = C.points_to_device([bls.G1.double(pts[4])])[:, 0]
    # general-add operands: p = acc, q = Jacobian leaf, plus an identity q
    # and q = p (Z != 1) lanes
    q = C.affine_to_jac_words(leaf)
    q[:, 5] = C.jac_identity_words((), None)
    q[:, 6] = acc[:, 6]
    return acc.to(dev), leaf.to(dev), q.to(dev)


def scan_inputs(dev, seq: int = 16, windows: int = 4, rows: int = 256):
    """A fused-scan table of k G (k = 1..1024), then -5G and -9G (T = 1026
    rows), and step-major (seq, windows, rows) leaf indices, random but for
    the planted lanes (index T is a dead leaf): 0 all dead; 1 G, 2G, 3G
    (the leaf equals the running sum, Z != 1); 2 5G, 5G (a duplicate base,
    Z = 1); 3 5G, -5G (P + (-P)), then 7G; 4 9G, -9G, 9G, 9G (a collision
    after the identity); 5 live with every fourth leaf dead."""
    import torch
    from polymath_tpu_torch.hostmath import bls12_381 as bls
    from polymath_tpu_torch.ops import curve as C
    pts = host_points(1024)
    pts += [bls.G1.neg(pts[4]), bls.G1.neg(pts[8])]
    table = C.points_to_device(pts).T.contiguous()
    t = table.shape[0]
    g = torch.Generator(device="cpu").manual_seed(9)
    idx = torch.randint(0, t + 1, (seq, windows * rows), generator=g)
    idx[:, 0] = t
    idx[:3, 1] = torch.tensor([0, 1, 2])
    idx[:2, 2] = torch.tensor([4, 4])
    idx[:3, 3] = torch.tensor([4, t - 2, 6])
    idx[:4, 4] = torch.tensor([8, t - 1, 8, 8])
    idx[::4, 5] = t
    return table.to(dev), idx.reshape(seq, windows, rows).to(dev)


def chunk_inputs(dev):
    """One d-MSM chunk as the prover feeds the fused scan: a table of the
    2^19 distinct points k G (k = 1..2^19, formed on the card from 4096
    host points and 128 offsets), random canonical scalars, and their
    bucket order at c = 13: idx (256, 20, 2048)."""
    import torch
    from polymath_tpu_torch.hostmath import bls12_381 as bls
    from polymath_tpu_torch.ops import curve as C
    from polymath_tpu_torch.ops import cuda_curve
    from polymath_tpu_torch.ops import msm as M
    chunk = M.DEFAULT_CHUNK
    base = host_points(4096)
    step, offs = bls.G1.mul(bls.G1.gen, 4096), [None]
    for _ in range(chunk // 4096 - 1):
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
    idx, _ = M.bucket_order(sc.to(torch.int32).to(dev), chunk, c, windows,
                            M.scan_seq(chunk))
    return table, idx


# -- phase 2: the plain versions -------------------------------------------

def plain_fr_mul(a, b):
    from polymath_tpu_torch.ops.field import FR
    from polymath_tpu_torch.ops.limbs import limbs_to_words, words_to_limbs
    return limbs_to_words(FR.mont_mul(words_to_limbs(a), words_to_limbs(b)))


def plain_fr_sqr(a):
    from polymath_tpu_torch.ops.field import FR
    from polymath_tpu_torch.ops.limbs import limbs_to_words, words_to_limbs
    return limbs_to_words(FR.mont_sqr(words_to_limbs(a)))


def plain_add(p, q):
    from polymath_tpu_torch.ops import curve as C
    return C.join_words(C.jac_add_core(C.split_words(p, 3),
                                       C.split_words(q, 3)))


def plain_madd(p, leaf, fast):
    from polymath_tpu_torch.ops import curve as C
    r, e = C.jac_madd_core(C.split_words(p, 3), C.split_words(leaf, 2), fast)
    return C.join_words(r), e


def plain_double(p):
    from polymath_tpu_torch.ops import curve as C
    return C.join_words(C.jac_double_core(C.split_words(p, 3)))


def plain_butterfly(lo, hi, tw):
    from polymath_tpu_torch.ops.field import FR
    from polymath_tpu_torch.ops.limbs import limbs_to_words, words_to_limbs
    lo_l = words_to_limbs(lo)
    t = FR.mont_mul(words_to_limbs(hi), words_to_limbs(tw))
    return limbs_to_words(FR.add(lo_l, t)), limbs_to_words(FR.sub(lo_l, t))


def plain_to_affine(p):
    from polymath_tpu_torch.ops import curve as C
    return C.join_words(C.jac_to_affine_core(C.split_words(p, 3)))


def plain_ntt_local(x, tw):
    from polymath_tpu_torch.ops import ntt as N
    from polymath_tpu_torch.ops.limbs import limbs_to_words, words_to_limbs
    return limbs_to_words(N.ntt_local_plain(words_to_limbs(x),
                                            words_to_limbs(tw)))


def check_kernels(dev) -> dict:
    """Every kernel against its plain version on the card at moderate
    shapes that hold the edge cases: 2^16 field elements with 0, 1, p - 1
    and p - 2; 2^12 points with the identity on either side, a (0, 0)
    leaf, P + P and P + (-P); a (16, 64, 2048) batch of local NTTs; a
    (16, 4, 256) fused scan with the lanes of scan_inputs.
    Raises on any difference; returns {kernel: largest word error}."""
    import torch
    from polymath_tpu_torch.ops import cuda_curve, cuda_field, cuda_gather
    from polymath_tpu_torch.ops import cuda_scan
    from polymath_tpu_torch.ops import ntt as N

    errs = {}

    def note(name, what, got, want):
        errs[name] = max(errs.get(name, 0), compare(what, got, want))

    a = field_inputs(dev, 1 << 16, 1)
    b = field_inputs(dev, 1 << 16, 2).flip(1).contiguous()
    note("fr_mul", "fr_mul", cuda_field.fr_mul(a, b), plain_fr_mul(a, b))
    note("fr_mul", "fr_mul broadcast", cuda_field.fr_mul(a, b[:, 5:6]),
         plain_fr_mul(a, b[:, 5:6]))
    note("fr_sqr", "fr_sqr", cuda_field.fr_sqr(a), plain_fr_sqr(a))
    note("fr_sqr", "fr_sqr == fr_mul(a, a)", cuda_field.fr_sqr(a),
         cuda_field.fr_mul(a, a))
    c = a.roll(3, 1).contiguous()
    for what, tw in (("", c), (" broadcast", c[:, 2:3])):
        note("fr_butterfly", "fr_butterfly" + what,
             cuda_field.fr_butterfly(a, b, tw), plain_butterfly(a, b, tw))

    acc, leaf, q = point_inputs(dev, 1 << 12)
    for fast in (False, True):
        got, gerr = cuda_curve.jac_madd(acc, leaf, fast)
        want, werr = plain_madd(acc, leaf, fast)
        note("jac_madd", f"jac_madd fast={fast}", got, want)
        if fast:
            note("jac_madd", "jac_madd flag", gerr, werr.to(torch.int32))
            if not bool(werr[2]) or not bool(werr[4]):
                raise AssertionError("fast madd did not flag P + P")
    note("jac_add", "jac_add", cuda_curve.jac_add(acc, q), plain_add(acc, q))
    note("to_affine", "to_affine", cuda_curve.to_affine(acc),
         plain_to_affine(acc))
    # identity lanes whose X and Y are not 1: Z = 0 under a finite point
    dbl_in = acc.clone()
    dbl_in[24:, 7:11] = 0
    note("jac_double", "jac_double", cuda_curve.jac_double(dbl_in),
         plain_double(dbl_in))

    table_s, idx_s = scan_inputs(dev)
    for fast in (False, True):
        got, gerr = cuda_scan.fused_scan_msm(table_s, idx_s, fast)
        want, werr = cuda_scan.fused_scan_msm_plain(table_s, idx_s, fast)
        note("fused_scan", f"fused_scan fast={fast}", got, want)
        if fast:
            note("fused_scan", "fused_scan flag", gerr, werr)
            if not all(bool(werr[i]) for i in (1, 2, 4)):
                raise AssertionError("fast fused scan did not flag the "
                                     "planted collisions")

    table = torch.cat([leaf.T, acc[:24].T]).contiguous()   # (8192, 24)
    g = torch.Generator(device="cpu").manual_seed(5)
    idx = torch.randint(0, table.shape[0] + 1, (20, 2048), generator=g)
    idx[0, :4] = table.shape[0]                            # the zero row
    idx = idx.to(dev)
    note("gather_rows", "gather_rows", cuda_gather.gather_rows(table, idx),
         cuda_gather.gather_rows_plain(table, idx))

    x = field_inputs(dev, 1 << 12, 6).repeat(1, 32).reshape(8, 64, 2048)
    for inverse in (False, True):
        tw = N.local_twiddles(2048, inverse, dev)
        note("ntt_local", f"ntt_local inverse={inverse}",
             N.ntt_local_kernel(x, tw), plain_ntt_local(x, tw))
    return errs


def measure_kernels(dev, errs: dict) -> dict:
    """Each kernel and its plain version at the main path's shapes: both
    run on the same inputs, are compared, then timed.  Returns
    {kernel: the JSON entry without launches}."""
    import torch
    from polymath_tpu_torch.ops import cuda_curve, cuda_field, cuda_gather
    from polymath_tpu_torch.ops import cuda_scan
    from polymath_tpu_torch.ops import ntt as N
    from polymath_tpu_torch.tools import bound_ms, timed_ms

    out = {}

    def entry(name, source, replaces, shape, kernel, plain, reps, nbytes,
              ops, library=None):
        # the plain version runs once (it is slow and no yardstick of
        # speed); the kernel is warmed up, then timed over ``reps`` calls;
        # ``library``, one PyTorch call for the same function, likewise
        want, plain_ms = timed_ms(plain, dev)
        kernel()
        got, kern_ms = timed_ms(kernel, dev, reps)
        err = compare(name, got, want)
        del got
        lib_ms = None
        if library is not None:
            library()
            got, lib_ms = timed_ms(library, dev, reps)
            compare(f"{name} library call", got.reshape(want.shape), want)
            del got
        del want
        b, by = bound_ms(nbytes, ops)
        out[name] = {"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "shape": shape,
                     "max_abs_err": max(err, errs[name]), "ms": kern_ms,
                     "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                     "library_ms": lib_ms}
        lib = "" if lib_ms is None else f"  library {lib_ms:8.4f} ms"
        print(f"  {name:12s} {shape:>30s}  kernel {kern_ms:9.4f} ms  plain "
              f"{plain_ms:10.3f} ms  bound {b:8.4f} ms ({by}){lib}",
              flush=True)

    # the prover's widest Fr vectors: 2n = 2^22 elements
    big = field_inputs(dev, 1 << 12, 3).repeat(1, 1 << 10)
    big2 = big.roll(7, 1).contiguous()
    n = big.shape[1]
    entry("fr_mul", "polymath_tpu_torch/csrc/field.cu",
          "polymath_tpu/ops/pallas_field.py:37", "(8, 2^22) x (8, 2^22)",
          lambda: cuda_field.fr_mul(big, big2),
          lambda: plain_fr_mul(big, big2), 20, 3 * 32 * n, FR_MUL_OPS * n)
    entry("fr_sqr", "polymath_tpu_torch/csrc/field.cu",
          "polymath_tpu/ops/pallas_field.py:43", "(8, 2^22)",
          lambda: cuda_field.fr_sqr(big), lambda: plain_fr_sqr(big), 20,
          2 * 32 * n, FR_SQR_OPS * n)
    # one radix-2 stage of the 2^22-point transform: 2^21 pairs
    half = n // 2
    lo, hi, tw = big[:, :half], big2[:, :half], big2[:, half:]
    entry("fr_butterfly", "polymath_tpu_torch/csrc/field.cu",
          "polymath_tpu/ops/pallas_field.py:28", "(8, 2^21) pairs",
          lambda: cuda_field.fr_butterfly(lo, hi, tw),
          lambda: plain_butterfly(lo, hi, tw), 20, 5 * 32 * half,
          BFLY_OPS * half)
    del big, big2, lo, hi, tw

    # the MSM scan step: 20 windows x 2048 rows of one 2^19-point chunk
    acc, leaf, q = point_inputs(dev, 1 << 12)
    lanes = 20 * 2048
    reps = -(-lanes // acc.shape[1])
    acc_l = acc.repeat(1, reps)[:, :lanes].contiguous()
    leaf_l = leaf.repeat(1, reps)[:, :lanes].contiguous()
    live = int(((acc_l[24:] != 0).any(0) & (leaf_l[12:] != 0).any(0)).sum())
    entry("jac_madd", "polymath_tpu_torch/csrc/g1.cu",
          "polymath_tpu/ops/pallas_curve.py:49", f"({lanes} lanes) fast",
          lambda: cuda_curve.jac_madd(acc_l, leaf_l, True)[0],
          lambda: plain_madd(acc_l, leaf_l, True)[0], 20,
          (36 * 2 + 24) * 4 * lanes + 4 * lanes, MADD_OPS * live)

    # the fixed-base pass of setup: 2^20 lanes (also the widest MSM adds)
    lanes = 1 << 20
    acc_l = acc.repeat(1, lanes // acc.shape[1])
    q_l = q.repeat(1, lanes // acc.shape[1])
    live = int(((acc_l[24:] != 0).any(0) & (q_l[24:] != 0).any(0)).sum())
    entry("jac_add", "polymath_tpu_torch/csrc/g1.cu",
          "polymath_tpu/ops/pallas_curve.py:32", "(2^20 lanes)",
          lambda: cuda_curve.jac_add(acc_l, q_l),
          lambda: plain_add(acc_l, q_l), 10, 36 * 3 * 4 * lanes,
          ADD_OPS * live)
    del q_l
    # no early return: every lane, the identity ones too, does the work
    entry("jac_double", "polymath_tpu_torch/csrc/g1.cu",
          "polymath_tpu/ops/pallas_curve.py:41", "(2^20 lanes)",
          lambda: cuda_curve.jac_double(acc_l),
          lambda: plain_double(acc_l), 10, 36 * 2 * 4 * lanes,
          DOUBLE_OPS * lanes)
    entry("to_affine", "polymath_tpu_torch/csrc/g1.cu",
          "polymath_tpu/ops/fixed_base.py:95", "(2^20 lanes)",
          lambda: cuda_curve.to_affine(acc_l),
          lambda: plain_to_affine(acc_l), 5, (36 + 24) * 4 * lanes,
          TO_AFFINE_OPS * lanes)
    out["to_affine"]["note"] = ("port-only kernel: the reference inverts Z "
                                "with XLA ops, no Pallas kernel")
    del acc_l

    # one chunk's bucket permutation: 256 steps x 20 windows x 2048 rows
    # from a 2^19-row table
    table = torch.cat([leaf.T, acc[:24].T]).contiguous()   # (8192, 24)
    chunk = 1 << 19
    table_l = table.repeat(chunk // table.shape[0], 1).contiguous()
    g = torch.Generator(device="cpu").manual_seed(7)
    idx_l = torch.randint(0, chunk + 1, (256, 20, 2048), generator=g).to(dev)
    m = idx_l.numel()
    # the library call: index_select on the table with its zero row (index
    # T), then the transpose to limb-major
    table_z = torch.cat([table_l, table_l.new_zeros((1, 24))])
    idx_f = idx_l.reshape(-1)
    entry("gather_rows", "polymath_tpu_torch/csrc/g1.cu",
          "polymath_tpu/ops/pallas_gather.py:47",
          "(2^19, 24) table, 20 x 2^19 rows",
          lambda: cuda_gather.gather_rows(table_l, idx_l),
          lambda: cuda_gather.gather_rows_plain(table_l, idx_l), 10,
          chunk * 96 + m * (8 + 96), 0,
          library=lambda: table_z.index_select(0, idx_f).T.contiguous())
    del table_l, idx_l, table_z, idx_f

    # the same chunk through the fused scan, fast as the prover runs it, on
    # the bucket order of random scalars over 2^19 distinct points.  Work:
    # every live leaf after a lane's first is one full madd.
    table_c, idx_c = chunk_inputs(dev)
    seq, lanes = idx_c.shape[0], idx_c[0].numel()
    live = (idx_c < table_c.shape[0]).reshape(seq, lanes).sum(0)
    madds = int((live - 1).clamp(min=0).sum())
    entry("fused_scan", "polymath_tpu_torch/csrc/scan.cu",
          "polymath_tpu/ops/pallas_scan.py:64",
          "(2^19, 24) table, (256, 20, 2048) idx",
          lambda: cuda_scan.fused_scan_msm(table_c, idx_c, True),
          lambda: cuda_scan.fused_scan_msm_plain(table_c, idx_c, True), 5,
          table_c.numel() * 4 + idx_c.numel() * 8
          + 36 * 4 * idx_c.numel() + 4 * lanes, MADD_OPS * madds)
    del table_c, idx_c

    # the 2^22-point NTT's batch of 2048 transforms of 2048
    x = field_inputs(dev, 1 << 12, 6).repeat(1, 32).reshape(8, 64, 2048)
    xl = x.repeat(1, 32, 1).contiguous()                   # (8, 2048, 2048)
    tw = N.local_twiddles(2048, False, dev)
    nt = xl.shape[1] * 2048
    entry("ntt_local", "polymath_tpu_torch/csrc/ntt.cu",
          "polymath_tpu/ops/ntt.py:87", "(8, 2048, 2048)",
          lambda: N.ntt_local_kernel(xl, tw), lambda: plain_ntt_local(xl, tw),
          10, 2 * 32 * nt + 32 * 1024, FR_MUL_OPS * (nt // 2) * 11)
    return out


# -- phase 3 -------------------------------------------------------------------

def golden(dev) -> None:
    from polymath_tpu_torch.circuits import DummyCircuit
    from polymath_tpu_torch.hostmath.bls12_381 import R
    from polymath_tpu_torch.protocol import Polymath, Rng
    from polymath_tpu_torch.transcript import ALL_TRANSCRIPTS
    with open(os.path.join(HERE, "tests", "fixtures",
                           "golden_dummy.json")) as fh:
        fixture = json.load(fh)
    for tr in ALL_TRANSCRIPTS:
        rng = Rng(1234)
        pm = Polymath(transcript=tr, device=dev)
        pk, vk = pm.setup(DummyCircuit(), rng)
        proof = pm.prove(pk, DummyCircuit(5, 7), rng)
        want = fixture[tr.name]
        if vk.to_bytes().hex() != want["vk"]:
            raise AssertionError(f"{tr.name}: VerifyingKey bytes differ")
        if proof.to_bytes().hex() != want["proof"]:
            raise AssertionError(f"{tr.name}: proof bytes differ")
        if not pm.verify(vk, [5 * 7 % R], proof):
            raise AssertionError(f"{tr.name}: golden proof rejected")
        print(f"  {tr.name}: VK and proof bytes equal the fixture",
              flush=True)


# -- phase 4 -------------------------------------------------------------------

def _counted_modules(tools: bool = False):
    """The kernel wrappers with a LAUNCHES counter: the prover's (B1-B9,
    to_affine), or with ``tools`` the measurement tools' (T1, T2)."""
    if tools:
        from polymath_tpu_torch.tools import pgather_variants, primbench
        return (primbench, pgather_variants)
    from polymath_tpu_torch.ops import cuda_curve, cuda_field, cuda_gather
    from polymath_tpu_torch.ops import cuda_scan, ntt
    return (cuda_field, cuda_curve, cuda_gather, cuda_scan, ntt)


def launches(tools: bool = False) -> dict:
    out = {}
    for mod in _counted_modules(tools):
        out.update(mod.LAUNCHES)
    return out


def reset_launches() -> None:
    for mod in _counted_modules() + _counted_modules(tools=True):
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0


def main_path(dev, num_constraints: int) -> dict:
    import torch
    from polymath_tpu_torch.circuits import BenchCircuit
    from polymath_tpu_torch.hostmath.bls12_381 import R
    from polymath_tpu_torch.protocol import Polymath, Rng
    from polymath_tpu_torch.transcript import MerlinFieldTranscript
    from polymath_tpu_torch.utils import timers

    rng = Rng(0)
    a, b = rng.randrange(R), rng.randrange(R)

    def circuit():
        return BenchCircuit(a, b, num_variables=num_constraints,
                            num_constraints=num_constraints)

    pm = Polymath(transcript=MerlinFieldTranscript, device=dev)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    counts = {}

    def step(label, fn):
        before = launches()
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize()
        dt = time.time() - t0
        after = launches()
        counts[label] = {k: after[k] - before[k] for k in after}
        print(f"  {label}: {dt:.3f} s; launches {counts[label]}", flush=True)
        return res, dt

    (pk, vk), setup_s = step("setup", lambda: pm.setup(circuit(), rng))
    print(f"  n = {vk.n}", flush=True)
    proof1, warm_s = step("prove 1 (warm)",
                          lambda: pm.prove(pk, circuit(), rng))
    phases1 = {k: v for k, v in timers.TIMES.items()
               if k.startswith("prover::")}
    proof2, prove_s = step("prove 2", lambda: pm.prove(pk, circuit(), rng))
    total = launches()
    phases2 = {k: v for k, v in timers.TIMES.items()
               if k.startswith("prover::") or k.startswith("setup::")}
    t0 = time.time()
    for i, proof in enumerate((proof1, proof2)):
        if not pm.verify(vk, [a * b % R], proof):
            raise AssertionError(f"bench proof {i + 1} rejected")
    verify_s = (time.time() - t0) / 2
    if pm.verify(vk, [(a * b + 1) % R], proof2):
        raise AssertionError("a wrong public input was accepted")
    peak = torch.cuda.max_memory_allocated()
    print(f"  verify {verify_s * 1e3:.1f} ms per proof; wrong public input "
          f"rejected; peak device memory {peak / 2**30:.2f} GiB", flush=True)
    for k, v in sorted(phases1.items()):
        print(f"    warm {k}: {v:.3f} s")
    for k, v in sorted(phases2.items()):
        print(f"    {'steady' if k.startswith('prover') else 'setup '} "
              f"{k}: {v:.3f} s")
    per_prove = counts["prove 2"]
    missing = [k for k in PROVE_KERNELS if per_prove[k] == 0]
    missing += [k for k in SETUP_KERNELS if counts["setup"][k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    return {"launches": total, "per_prove": per_prove, "setup_s": setup_s,
            "warm_prove_s": warm_s, "prove_s": prove_s,
            "verify_ms": verify_s * 1e3, "peak_bytes": peak, "n": vk.n,
            "pm": pm, "pk": pk, "vk": vk, "circuit": circuit,
            "public": a * b % R}


# -- phase 4b ------------------------------------------------------------------

def fused_path(run: dict) -> list:
    """The fused-scan configuration with the phase-4 key: split and fused
    proves in turns (split, fused, fused, split), each from a fresh
    Rng(7), must give the same proof bytes; each prove's launches,
    per-phase times and peak device memory (peak reset before it) are
    recorded.  Returns one dict per prove, in order."""
    import torch
    from polymath_tpu_torch.hostmath.bls12_381 import R
    from polymath_tpu_torch.protocol import Rng
    from polymath_tpu_torch.utils import timers

    pm, pk, vk = run["pm"], run["pk"], run["vk"]
    saved = os.environ.get("POLYMATH_MSM_FUSED")
    turns = []
    try:
        for label in ("split", "fused", "fused", "split"):
            os.environ["POLYMATH_MSM_FUSED"] = "1" if label == "fused" \
                else "0"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.time()
            proof = pm.prove(pk, run["circuit"](), Rng(7))
            torch.cuda.synchronize()
            turns.append({
                "label": label, "proof": proof,
                "prove_s": time.time() - t0, "launches": launches(),
                "peak_bytes": torch.cuda.max_memory_allocated(),
                "phases": {k: v for k, v in timers.TIMES.items()
                           if k.startswith("prover::")}})
    finally:
        if saved is None:
            os.environ.pop("POLYMATH_MSM_FUSED", None)
        else:
            os.environ["POLYMATH_MSM_FUSED"] = saved
    for i, r in enumerate(turns):
        print(f"  turn {i + 1} {r['label']}: prove {r['prove_s']:.3f} s, "
              f"peak {r['peak_bytes'] / 2**30:.2f} GiB; launches "
              f"{json.dumps(r['launches'])}", flush=True)
        for k, v in sorted(r["phases"].items()):
            print(f"    turn {i + 1} {r['label']} {k}: {v:.3f} s")
    want = turns[0]["proof"].to_bytes()
    for r in turns:
        if r["proof"].to_bytes() != want:
            raise AssertionError("fused and split proofs differ")
        if not pm.verify(vk, [run["public"]], r["proof"]):
            raise AssertionError(f"{r['label']} proof rejected")
    if pm.verify(vk, [(run["public"] + 1) % R], turns[1]["proof"]):
        raise AssertionError("a wrong public input was accepted (fused)")
    split = turns[0]["launches"]
    for r in turns:
        fl = r["launches"]
        if r["label"] == "split":
            if fl != split or fl["fused_scan"]:
                raise AssertionError(f"split prove launched {fl}")
            continue
        if fl["fused_scan"] == 0 or any(fl[k] for k in SPLIT_ONLY):
            raise AssertionError(f"fused prove launched {fl}")
        if fl["fused_scan"] != split["gather_rows"]:
            raise AssertionError(f"fused_scan launches {fl['fused_scan']} "
                                 f"!= split gather_rows "
                                 f"{split['gather_rows']}")
        missing = [k for k in PROVE_KERNELS + FUSED_KERNELS
                   if k not in SPLIT_ONLY and fl[k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the fused "
                                 f"path: {missing}")
    print("  proofs byte-equal, all verify, wrong public input rejected",
          flush=True)
    return turns


# -- phase 5 -------------------------------------------------------------------

T1_SOURCE = "polymath_tpu_torch/csrc/gather_variants.cu"
T1_REPLACES = "tools/pgather_variants.py:19"
T2_SOURCE = "polymath_tpu_torch/csrc/primbench.cu"
T2_REPLACES = "tools/primbench.py:38"


def measurement_path() -> dict:
    """The measurement entry points through their main(), at their default
    sizes, with the launch counts set to 0 just before and read just after.
    Each tool raises on a mismatch with its plain version or its oracle.
    Returns the tools' results, the launches, and the T1/T2 entries of the
    kernels line."""
    from polymath_tpu_torch.tools import (
        fusedprof, kernel_metrics, pgather_variants, primbench)
    reset_launches()
    pb = primbench.main([])
    gv = pgather_variants.main([])
    km = kernel_metrics.main([])
    fp = fusedprof.main([])
    counts = launches(tools=True)
    never = [k for k, v in counts.items() if v == 0]
    if never:
        raise AssertionError(f"kernels never launched in phase 5: {never}")
    if not fp["stages_match"] or not km["msm_oracle_check"].startswith("ok"):
        raise AssertionError("phase 5: a tool's own check did not pass")
    entries = []
    for r in pb["rows"]:
        name = f"primbench:{r['name']}"
        entries.append({
            "name": name, "route": "cuda", "source": T2_SOURCE,
            "replaces": T2_REPLACES, "shape": "(512, 256), K = 512",
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "launches": counts[name], "compared": r["compared"],
            "ps_per_op": r["ps_per_op"],
            "sass_step_instructions": pb["sass"][r["name"]]["count"],
            "path": "measurement entry points (phase 5)"})
    for v in gv["variants"]:
        name = f"pgather_variants:{v['name']}"
        entries.append({
            "name": name, "route": "cuda", "source": T1_SOURCE,
            "replaces": T1_REPLACES,
            "shape": f"({gv['t4']}, 128) quads -> (24, {gv['m']})",
            "max_abs_err": v["max_abs_err"], "ms": v["ms"],
            "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
            "bound_by": v["bound_by"], "library_ms": v["library_ms"],
            "launches": counts[name], "ns_per_row": v["ns_per_row"],
            "path": "measurement entry points (phase 5)"})
    return {"primbench": pb, "pgather_variants": gv, "kernel_metrics": km,
            "fusedprof": fp, "launches": counts, "entries": entries}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--constraints", type=int, default=(1 << 20) - 100)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible", file=sys.stderr)
        return 2
    try:
        from polymath_tpu_torch.ops import _build
        from polymath_tpu_torch import native
    except ImportError as e:
        print(f"chip_smoke: polymath_tpu_torch is not importable ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t_start = time.time()
    # phase timers wait for the card, so each phase reads device time
    os.environ.setdefault("POLYMATH_TRACE", "1")

    # 1. device and build
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"[1] device: {kind}; nvidia-smi: {smi}; torch {torch.__version__}"
          f" CUDA {torch.version.cuda}", flush=True)
    nat = threading.Thread(target=native.get_lib)
    nat.start()
    t0 = time.time()
    built = _build.build_all()
    build_s = time.time() - t0
    nat.join()
    if not native.native_available():
        raise RuntimeError("the native host library did not build")
    print(f"[1] built {sorted(built)} in {build_s:.1f} s "
          f"(per source {json.dumps({k: round(v, 1) for k, v in built.items()})})",
          flush=True)
    check_ptxas(_build.SOURCES)

    # 2. kernels against their plain versions
    print("[2] kernels against plain versions (0 mismatches required):",
          flush=True)
    errs = check_kernels(dev)
    print(f"  edge-case inputs: 0 mismatches in {sorted(errs)}", flush=True)
    numbers = measure_kernels(dev, errs)

    # 3. golden bytes
    print("[3] golden bytes on the card:", flush=True)
    golden(dev)

    # 4. main path
    print(f"[4] main path: BenchCircuit, {args.constraints} constraints, "
          f"Merlin, seed 0", flush=True)
    run = main_path(dev, args.constraints)
    print(f"[4] setup {run['setup_s']:.2f} s, warm prove "
          f"{run['warm_prove_s']:.2f} s, prove {run['prove_s']:.2f} s, "
          f"verify {run['verify_ms']:.1f} ms, peak "
          f"{run['peak_bytes'] / 2**30:.2f} GiB, n = {run['n']}; "
          f"launches per prove {json.dumps(run['per_prove'])}", flush=True)

    # 4b. the fused-scan configuration of the main path
    print("[4b] fused-scan configuration (POLYMATH_MSM_FUSED=1), phase-4 "
          "key, Rng(7): proves split, fused, fused, split", flush=True)
    fused = fused_path(run)[1]
    print(f"[4b] fused prove {fused['prove_s']:.2f} s, peak "
          f"{fused['peak_bytes'] / 2**30:.2f} GiB, fused_scan launches "
          f"{fused['launches']['fused_scan']}", flush=True)

    # 5. the measurement entry points
    print("[5] measurement entry points: primbench (T2), pgather_variants "
          "(T1), kernel_metrics, fusedprof", flush=True)
    t0 = time.time()
    meas = measurement_path()
    km, fp = meas["kernel_metrics"], meas["fusedprof"]
    sass = {k: v["count"] for k, v in meas["primbench"]["sass"].items()}
    rates = [f"{k} steady {v['steady_s'] * 1e3:.3f} ms, "
             + (f"{v['elems_per_s']:.4g} elements/s" if "elems_per_s" in v
                else f"{v['points_per_s']:.4g} points/s")
             for k, v in km["kernels"].items()]
    print(f"[5] T1/T2 launches {json.dumps(meas['launches'])}; SASS step "
          f"instructions {json.dumps(sass)}", flush=True)
    print(f"[5] kernel_metrics: {'; '.join(rates)}; "
          f"{km['msm_oracle_check']}", flush=True)
    print(f"[5] fusedprof chunk {fp['chunk']}: stages "
          f"{json.dumps(fp['stages_ms'])}; sum split "
          f"{fp['split_sum_ms']:.3f} ms, fused {fp['fused_sum_ms']:.3f} ms; "
          f"phase 5 took {time.time() - t0:.1f} s", flush=True)

    kernels = []
    for name in ALL_KERNELS:
        k = dict(numbers[name])
        if name in FUSED_KERNELS:
            k["launches"] = k["launches_per_prove"] = \
                fused["launches"][name]
            k["path"] = "fused-scan configuration (phase 4b)"
        else:
            k["launches"] = run["launches"][name]
            k["launches_per_prove"] = run["per_prove"][name]
        if name in UNCALLED_KERNELS:
            k["note"] = "no path of the reference calls this kernel"
        kernels.append(k)
    kernels += meas["entries"]
    print(f"[6] total {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
