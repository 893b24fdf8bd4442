#!/usr/bin/env python3
"""Smoke run of polymath_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py [--constraints N]

Phases, each printing what it found:

1. device: the card's name and power limit; builds every CUDA source of
   polymath_tpu_torch/csrc with nvcc into build/ (one nvcc per source, all
   at once) and prints the build time and each kernel's ptxas report,
   failing on any spill in any source (the report is read from the file
   each build leaves beside its library, so a cached build is checked
   too), and the blocks of the scan kernels the card holds at once;
2. kernels: every kernel (B1-B9, the port-only to_affine, the one-launch
   madd scan and the three tree kernels that the MSM runs in the place of
   per-step jac_madd and per-launch jac_add -- row offsets, window fold
   and the sum of the chunks' or ranks' window sums -- and the quotient
   scan's reduce and apply kernels that replace its per-step fr_mul)
   against its plain PyTorch version on the same inputs on the card, bit
   for bit (0 mismatches allowed; the tree kernels add in another order
   than their plain versions, so their outputs are compared as affine
   points): first
   at moderate shapes that hold the edge cases (field words on which a
   carry-chain fault shows -- 0, 1, p - 1, p - 2, R mod p, R^2 mod p and
   runs of 0xffffffff words -- in the inputs of every field and point
   kernel, the degenerate point cases, dead and colliding MSM leaves,
   identity, P + P and P + (-P) in the tree, the sum of 1, 2, 3, 4, 40
   and 130 sets with an identity set, P + P, P + (-P) and a window of one
   repeated point planted, the gather at a ragged row
   count with indices outside the table, the quotient scan's launches at
   one to three blocks of rows, ragged, in both orders, with edge words in
   the carries and the multiplier, and its whole scan across four levels
   against the blocked fr_mul / fr_add recurrence it replaced), then at
   the main path's shapes, where the kernel's time, its plain version's
   time and its bound are taken (the quotient scan at D + 1 = 20,971,543
   coefficients, also whole: time, launches and peak memory against the
   recurrence it replaced; the local NTT also at (8, 2048, 4096), the
   wider half of the 2^23-point squaring at n = 2^22; the sum of sets at the d MSM's (40, 36, 20)
   and the other MSMs' (4, 36, 20), beside the 39- and 3-launch jac_add
   chains it replaced, on the same inputs);
3. golden bytes: DummyCircuit / Rng(1234) / a=5, b=7 through the port's
   setup and prove on the card, for all three transcripts, against
   tests/fixtures/golden_dummy.json;
3b. golden multi-chunk MSMs: reduced MiMC (5 rounds) from the recipe of
   tests/fixtures/golden_mimc.json through the port's setup on the card,
   whose VK must equal the fixture's, then 18 proves on the card: each
   transcript at POLYMATH_MSM_CHUNK=8 with the host tail on and off and at
   POLYMATH_MSM_CHUNK=2 with it off, each with the split and the fused
   scan.  Every proof must equal the JAX package's host-prover bytes in
   the fixture and verify; each prove must run its 5 MSMs in more than
   one chunk (ops/msm.py:RUNS), the fused ones through fused_scan and no
   madd_scan, and at chunks of 2 launch sum_sets more than 5 times (the
   d MSM's 171 chunk sums take two levels).  One line a transcript and
   setting, with the split and fused proves' seconds;
4. main path: BenchCircuit at N constraints (default 2^20 - 100, as
   bench.py), Merlin, seed 0: setup, a warm prove, a second prove, a
   verify of each and a rejected wrong public input, with per-phase times,
   peak device memory and each kernel's launch count (every kernel of
   PROVE_KERNELS > 0 in a prove, the port-only to_affine and jac_add > 0
   in setup; one madd_scan per MSM chunk and no jac_madd, at most 3 tree
   launches a chunk, no jac_add and one sum_sets for each MSM of more than
   one chunk (ops/msm.py:RUNS counts them); the quotient scan phase
   launching only its reduce and apply kernels, 2 a level and 1 for the
   top, no fr_mul), and the second prove's peak memory and launches by
   phase;
4b. the fused-scan configuration (POLYMATH_MSM_FUSED=1) of the main path:
   with the phase-4 key, four proves in turns (split, fused, fused,
   split), each from a fresh Rng(7): the proofs must be byte-equal and
   verify, a wrong public input must be rejected, and each fused prove
   must launch fused_scan (B7) once per MSM chunk, no madd_scan, jac_madd
   or gather_rows, at most 3 tree launches a chunk, and the sums of sets
   as in phase 4; the quotient scan as in phase 4.  Per-phase times, peak device memory (also by phase)
   and launches of each.  Then one split prove each under the Keccak256
   and Blake3 transcripts with the same key from Rng(7): each must verify
   under its transcript and reject a wrong public input; their seconds
   are printed beside the Merlin split proves';
4c. the key store and the bench entry, with the phase-4 key:
   ``protocol/keys.save_dir`` into a fresh directory under build/ (its
   seconds and GiB on disk); ``python3 -m polymath_tpu_torch.bench
   --cache-dir`` that directory's parent in a fresh process
   (POLYMATH_BENCH_REPS=3), which must load the key rather than run setup
   and report every proof verified and the fused proof equal to the split
   one (its JSON line and its phase timers up to the warm prove are
   printed); then ``keys.load_dir`` of the same
   directory here and one split prove from Rng(7), byte-equal to phase
   4b's first proof.  The directory is removed at the end;
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
   and fused, beside the per-step madd loop and the per-launch tree that
   the one-launch kernels replaced), and productprobe (to_affine at
   40,960 and 2^20 lanes, a probe of one Fq product's latency and
   throughput, and the SASS instructions of one inlined product), and
   msmtime (one MSM of 2^21 distinct points under each of its ten
   chunk:c[:seq] configurations; every configuration must give the first
   one's point).  Every T1 and T2 kernel must have launched in this phase;
6. multi-device proving (polymath_tpu_torch/parallel), at most 120 s:
   6a, ``python3 -m polymath_tpu_torch.parallel.dryrun --device cpu
   --ranks 4`` in a subprocess that sees no card (four gloo CPU ranks:
   the reference dry run's NTT, MSM and reduced-MiMC checks and the
   sharded NTT at n = 4096, the only cross-rank layouts one card can
   check); 6b, one NCCL rank on the card in this process: ntt_sharded at
   2^21 and 2^22 both ways, bit for bit against ops/ntt.py:ntt, the
   sharded MSM of 2^21 of the key's points against msm_device's point,
   and with the phase-4 key, each from Rng(7), a warm sharded prove, then
   split, sharded, sharded, split: every proof byte-equal to phase 4b's
   split proof and verified, a wrong public input rejected; each prove's
   seconds, peak memory (whole and by phase), collectives (11 all_to_all,
   9 all_gather, 1 broadcast a sharded proof) and launches, which in a
   steady sharded prove must equal the split proves' and meet phase 4's
   MSM rule (one rank adds no sum of the ranks' sums).

B8 (jac_double) and B9 (fr_butterfly) are on no path of the reference:
phase 2 holds them against their plain versions and times them; their
launch counts on the main path are 0.  So is the one-step jac_madd's (B3
at one step), since the split scan runs as one madd_scan launch a chunk;
fusedprof launches it in phase 5 as the per-step yardstick.  T1 and T2
are timed, compared and counted by phase 5.

Then one JSON line with every kernel's numbers (launches on the main
path, a split prove's, a steady sharded prove's, and a setup's for the
setup kernels), the card's name and power limit as nvidia-smi prints
them, and as the last line
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
import contextlib
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


#: the kernels every (split) prove launches: B1, B2, B4, B6, the one-launch
#: madd scan (B3), the three tree kernels that replace B5's launches in the
#: MSM, the quotient scan's two kernels (B1's main-path use); the kernel
#: that replaces the gather and madd scan in the fused configuration;
#: kernels no prove launches (two that no path of the reference calls, and
#: B3 at one step); the setup kernels: the port-only to_affine and B5
#: itself (ops/fixed_base.py, 32 launches a batch)
PROVE_KERNELS = ("fr_mul", "fr_sqr", "madd_scan", "gather_rows",
                 "row_offsets", "window_fold", "sum_sets", "ntt_local",
                 "affine_scan_reduce", "affine_scan_apply")
SPLIT_ONLY = ("madd_scan", "gather_rows")
TREE_KERNELS = ("row_offsets", "window_fold")
QUOTIENT_KERNELS = ("affine_scan_reduce", "affine_scan_apply")
QUOTIENT_PHASE = "prover::stage2b (quotient scan)"
POLY_SOURCE = "polymath_tpu_torch/csrc/poly.cu"
POLY_REPLACES = "polymath_tpu/ops/pallas_field.py:37"
POLY_NOTE = ("B1 (_mul_kernel) as the reference's quotient scan runs it: "
             "poly_jax.py:affine_scan :23-75, its fr_mul carry :70-72")
TREE_SOURCE = "polymath_tpu_torch/csrc/tree.cu"
ADD_REPLACES = "polymath_tpu/ops/pallas_curve.py:32"
SUM_SETS_NOTE = ("B5 (_add_kernel) as the reference adds an MSM's chunk "
                 "sums, a fori_loop of jac_add (ops/msm.py:325-336), and "
                 "the ranks' sums (parallel/msm_sharded.py:25-34)")
#: the sums of sets phase 2 checks, and those it times (the d MSM's 40
#: chunks, the other MSMs' 4) with the dependent adds on the kernel's
#: critical path, ceil(log2 k)
SUM_SETS_CHECKED = (1, 2, 3, 4, 40, 130)
SUM_SETS_TIMED = {40: 6, 4: 2}
FUSED_KERNELS = ("fused_scan",)
UNCALLED_KERNELS = ("jac_double", "fr_butterfly")
OFF_PATH_KERNELS = ("jac_madd",)
SETUP_KERNELS = ("to_affine", "jac_add")
ALL_KERNELS = PROVE_KERNELS + FUSED_KERNELS + UNCALLED_KERNELS + \
    OFF_PATH_KERNELS + SETUP_KERNELS
#: the collectives of one sharded proof (parallel/prover_sharded.py): two
#: all_to_all for each of the five NTTs and one relayout; u, w, wu and u^2
#: gathered and one window-sum gather for each of the five MSMs; r_a's
#: broadcast
SHARDED_COLLECTIVES = {"all_to_all": 11, "all_gather": 9, "broadcast": 1}


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


def compare_points(name: str, got, want) -> int:
    """Jacobian words that may differ where the group elements do not: both
    sides to affine words by the plain formulas, then ``compare``."""
    return compare(name, plain_to_affine(got.reshape(got.shape[0], -1)),
                   plain_to_affine(want.reshape(want.shape[0], -1)))


# -- phase 2: inputs ---------------------------------------------------------

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
    import numpy as np
    import torch
    from polymath_tpu_torch.ops.limbs import FR_SPEC, ints_to_words
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
    import torch
    from polymath_tpu_torch.ops.limbs import FQ_SPEC, ints_to_words
    e = edge_values(FQ_SPEC.modulus, FQ_SPEC.L)
    return torch.from_numpy(ints_to_words(
        [e[(shift + k) % len(e)] for k in range(count)], FQ_SPEC.L))


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
    P + (-P) (both with Z = 1 and with Z != 1); and lanes whose words are
    the Fq edge values.  Returns (acc (36, n), leaf (24, n), q (36, n))."""
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


def scan_inputs(dev, seq: int = 16, windows: int = 4, rows: int = 256):
    """A fused-scan table of k G (k = 1..1024), then -5G and -9G, then E
    rows whose words are the Fq edge values (x edge k, y edge k + 1; not
    points of the curve), and step-major (seq, windows, rows) leaf
    indices, random but for the planted lanes (index T is a dead leaf):
    0 all dead; 1 G, 2G, 3G (the leaf equals the running sum, Z != 1);
    2 5G, 5G (a duplicate base, Z = 1); 3 5G, -5G (P + (-P)), then 7G;
    4 9G, -9G, 9G, 9G (a collision after the identity); 5 live with every
    fourth leaf dead; 6 the edge rows in turn."""
    import torch
    from polymath_tpu_torch.hostmath import bls12_381 as bls
    from polymath_tpu_torch.ops import curve as C
    pts = host_points(1024)
    pts += [bls.G1.neg(pts[4]), bls.G1.neg(pts[8])]
    table = C.points_to_device(pts)
    e = len(edge_values(bls.Q, 12))
    table = torch.cat([table, torch.cat([fq_edge_words(e, 0),
                                         fq_edge_words(e, 1)])], dim=1)
    table = table.T.contiguous()
    t = table.shape[0]
    g = torch.Generator(device="cpu").manual_seed(9)
    idx = torch.randint(0, t + 1, (seq, windows * rows), generator=g)
    idx[:, 0] = t
    idx[:3, 1] = torch.tensor([0, 1, 2])
    idx[:2, 2] = torch.tensor([4, 4])
    idx[:3, 3] = torch.tensor([4, 1024, 6])
    idx[:4, 4] = torch.tensor([8, 1025, 8, 8])
    idx[::4, 5] = t
    idx[:, 6] = 1026 + torch.arange(seq) % e
    return table.to(dev), idx.reshape(seq, windows, rows).to(dev)


def tree_case(windows: int, rows: int, n: int, seed: int):
    """The MSM tree's inputs as discrete logs (numpy default_rng(seed)):
    row totals (W, rows) and threshold prefixes (W, n) as small signed k
    (the point k G), counts and rows of the thresholds (W, n),
    non-increasing as msm.threshold_prefixes makes them, the last quarter
    of the counts 0, and the exclusive row offsets (W, rows) they imply.
    Planted: an identity total, a P + P pair and a P + (-P) pair among the
    totals; a threshold equal to its row's offset and one equal to its
    negation."""
    import numpy as np
    rng = np.random.default_rng(seed)
    tot = rng.integers(-40, 41, (windows, rows))
    if rows >= 4:
        tot[0, 1] = 0
        tot[0, 2] = tot[0, 3] = 17
    if rows >= 3 and windows > 1:
        tot[1, 1] = -tot[1, 0]
    cnt = np.sort(rng.integers(0, 2 * rows, (windows, n)), axis=1)[:, ::-1]
    cnt[:, -max(1, n // 4):] = 0
    r_of = np.sort(rng.integers(0, rows, (windows, n)), axis=1)[:, ::-1]
    ps = rng.integers(-40, 41, (windows, n))
    offs = np.concatenate([np.zeros((windows, 1), np.int64),
                           np.cumsum(tot, axis=1)[:, :-1]], axis=1)
    if rows > 1:
        ps[0, 0] = offs[0, r_of[0, 0]]
        ps[-1, 1] = -offs[-1, r_of[-1, 1]]
        cnt[0, :2] = np.maximum(cnt[0, :2], 1)
        cnt[-1, :2] = np.maximum(cnt[-1, :2], 1)
    return tuple(np.ascontiguousarray(x) for x in (tot, ps, cnt, r_of, offs))


def sum_sets_case(k: int, windows: int, seed: int):
    """k sets of window sums as discrete logs (numpy default_rng(seed)):
    (k, windows) small signed k of the points k G, random but for the
    planted windows (those that fit): 0, set 0 the identity; 1, sets 0, 1
    and h the same point, h the stride of the kernel's first level (half
    the power of two at or above k), so that P + P meets the doubling
    branch in the serial sum and in the tree; 2, sets 1 and h the
    negation of set 0 (P + (-P)); 3, every set the same point (the c_w
    MSM's chunks, BenchCircuit's vector repeating one digit)."""
    import numpy as np
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


def host_point(k: int):
    """k G for a small signed k (None for 0)."""
    from polymath_tpu_torch.hostmath import bls12_381 as bls
    if k == 0:
        return None
    p = bls.G1.mul(bls.G1.gen, abs(k))
    return p if k > 0 else bls.G1.neg(p)


def jac_words(ks, seed: int):
    """(36, *ks.shape) Jacobian words of k G with a random Z != 1 (X = x
    z^2, Y = y z^3), but for the first lanes, whose Z words are the Fq edge
    values (turned by the seed); k = 0 is the identity (1, 1, 0)."""
    import numpy as np
    import torch
    from polymath_tpu_torch.hostmath import bls12_381 as bls
    from polymath_tpu_torch.ops.limbs import FQ_SPEC, ints_to_words
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


def tree_inputs(dev, windows: int = 3, rows: int = 300, n: int = 1000,
                seed: int = 3):
    """tree_case on the card: (totals (36, W, rows), ps (36, W, n), cnt,
    r_of (W, n) int64).  The default has two segments of rows (joined by
    the carry pass) and several fold blocks a window (summed by the last
    one)."""
    import torch
    tot, ps, cnt, r_of, _ = tree_case(windows, rows, n, seed)
    return (jac_words(tot, seed).to(dev), jac_words(ps, seed + 1).to(dev),
            torch.from_numpy(cnt).to(dev), torch.from_numpy(r_of).to(dev))


def chunk_inputs(dev):
    """One d-MSM chunk as the prover feeds the fused scan: a table of the
    2^19 distinct points k G (k = 1..2^19, formed on the card from 4096
    host points and 128 offsets), random canonical scalars, and their
    bucket order at c = 13: idx (256, 20, 2048) and the sorted digits
    (20, 2^19)."""
    import torch
    from polymath_tpu_torch.hostmath import bls12_381 as bls
    from polymath_tpu_torch.ops import curve as C
    from polymath_tpu_torch.ops import cuda_curve
    from polymath_tpu_torch.ops import msm as M
    chunk = M.default_chunk()
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
    idx, d_sorted = M.bucket_order(sc.to(torch.int32).to(dev), chunk, c,
                                   windows, M.scan_seq(chunk))
    return table, idx, d_sorted


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


def plain_scan(c, mult_m, rev):
    """The quotient scan as the blocked fr_mul / fr_add recurrence that it
    replaced (ops/poly.py:affine_scan_plain), in either order."""
    from polymath_tpu_torch.ops import poly
    if not rev:
        return poly.affine_scan_plain(c, mult_m)
    return poly.affine_scan_plain(c.flip(-1), mult_m).flip(-1)


def scan_multipliers(seed: int) -> list:
    """Canonical multipliers for the quotient scan's launches: one from
    numpy default_rng(seed) and three whose Montgomery words are Fr edge
    values (p - 1, R mod p, a run of 0xffffffff words)."""
    import numpy as np
    from polymath_tpu_torch.ops.limbs import FR_SPEC
    p = FR_SPEC.modulus
    e = edge_values(p, FR_SPEC.W)
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % p] + [
        FR_SPEC.from_mont_int(w) for w in (e[2], e[4], e[-2])]


def check_kernels(dev) -> dict:
    """Every kernel against its plain version on the card at moderate
    shapes that hold the edge cases: 2^16 field elements with every pair of
    the Fr edge values (edge_values); 2^12 points with the identity on
    either side, a (0, 0) leaf, P + P, P + (-P) and lanes of Fq edge
    words; a (16, 64, 2048) batch of local NTTs, and the (8, 2048, 4096)
    batch of the 2^23-point transform's wider half; a (16, 4, 256) fused scan,
    and the madd scan on its gathered leaves, with the lanes of
    scan_inputs (edge-word rows among them); the tree kernels on
    tree_inputs (edge-word Z); the gather at 40,960 rows and at 7,013 rows
    with the sentinel and indices outside the table; the quotient scan's
    reduce and apply at 1, 16, 17 and 2,053 elements (one row, one full
    row, a ragged second row, three blocks of rows) in both orders, with
    edge words in the elements and the carries and as the multiplier
    (scan_multipliers), and its whole scan at 4,103 elements (three levels
    of row totals) against plain_scan; the sum of SUM_SETS_CHECKED sets
    of 20 windows (sum_sets_case's planted windows).
    Raises on any difference; returns {kernel: largest word error}."""
    import torch
    from polymath_tpu_torch.ops import cuda_curve, cuda_field, cuda_gather
    from polymath_tpu_torch.ops import cuda_poly, cuda_scan, cuda_tree, poly
    from polymath_tpu_torch.ops import ntt as N
    from polymath_tpu_torch.ops.field import fr_const

    errs = {}

    def note(name, what, got, want):
        errs[name] = max(errs.get(name, 0), compare(what, got, want))

    a = field_inputs(dev, 1 << 16, 1)
    b = field_inputs(dev, 1 << 16, 2, role=1)
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
    leaves_s = cuda_gather.gather_rows_plain(table_s, idx_s)
    for fast in (False, True):
        got, gerr = cuda_scan.madd_scan(leaves_s, fast)
        want, werr = cuda_scan.madd_scan_plain(leaves_s, fast)
        note("madd_scan", f"madd_scan fast={fast}", got, want)
        if fast:
            note("madd_scan", "madd_scan flag", gerr, werr)
            if not all(bool(werr[i]) for i in (1, 2, 4)):
                raise AssertionError("fast madd scan did not flag the "
                                     "planted collisions")

    totals, ps, cnt, r_of = tree_inputs(dev)
    for what, t in (("", totals), (" (rows 5)", totals[:, :, :5]),
                    (" (word stride 2 W rows)",
                     torch.stack([totals.flip(2), totals], dim=1)[:, 1])):
        offs = cuda_tree.row_offsets(t)
        errs["row_offsets"] = max(errs.get("row_offsets", 0), compare_points(
            "row_offsets" + what, offs, cuda_tree.row_offsets_plain(t)))
    offs = cuda_tree.row_offsets(totals)
    for what, o, r in (("", offs, r_of),
                       (" (one row)", None, torch.zeros_like(r_of))):
        errs["window_fold"] = max(errs.get("window_fold", 0), compare_points(
            "window_fold" + what, cuda_tree.window_fold(ps, cnt, r, o),
            cuda_tree.window_fold_plain(ps, cnt, r, o)))
    for k in SUM_SETS_CHECKED:
        parts, _ = sum_sets_inputs(dev, k, 20, 50 + k)
        errs["sum_sets"] = max(errs.get("sum_sets", 0), compare_points(
            f"sum_sets (k {k})", cuda_tree.sum_sets(parts),
            cuda_tree.sum_sets_plain(parts)))

    table = torch.cat([leaf.T, acc[:24].T]).contiguous()   # (8192, 24)
    g = torch.Generator(device="cpu").manual_seed(5)
    idx = torch.randint(0, table.shape[0] + 1, (20, 2048), generator=g)
    idx[0, :4] = table.shape[0]                            # the zero row
    idx = idx.to(dev)
    note("gather_rows", "gather_rows", cuda_gather.gather_rows(table, idx),
         cuda_gather.gather_rows_plain(table, idx))
    # a row count that no block of rows divides, the sentinel T and indices
    # outside the table
    t = table.shape[0]
    idx_r = torch.randint(0, t + 1, (7013,), generator=g)
    idx_r[:6] = torch.tensor([t, -1, t + 5, 1 << 40, -(1 << 40), t - 1])
    idx_r[-1] = t
    idx_r = idx_r.to(dev)
    note("gather_rows", "gather_rows (7013 rows)",
         cuda_gather.gather_rows(table, idx_r),
         cuda_gather.gather_rows_plain(table, idx_r))

    x = field_inputs(dev, 1 << 12, 6).repeat(1, 32).reshape(8, 64, 2048)
    for inverse in (False, True):
        tw = N.local_twiddles(2048, inverse, dev)
        note("ntt_local", f"ntt_local inverse={inverse}",
             N.ntt_local_kernel(x, tw), plain_ntt_local(x, tw))
    # the wider half of the prover's 2^23-point squaring at n = 2^22: 2048
    # transforms of 4096 points (128 KB of shared memory, one block an SM)
    x = field_inputs(dev, 1 << 16, 14).repeat(1, 128).reshape(8, 2048, 4096)
    for inverse in (False, True):
        tw = N.local_twiddles(4096, inverse, dev)
        note("ntt_local", f"ntt_local (8, 2048, 4096) inverse={inverse}",
             N.ntt_local_kernel(x, tw), plain_ntt_local(x, tw))
    del x

    mults = scan_multipliers(8)
    row = cuda_poly.ROW
    for n in (1, row, row + 1, 128 * row + 5):
        x = field_inputs(dev, n, 10 + n)
        # rolled, so that row 1 starts from an edge word and not from 0
        carry = field_inputs(dev, cuda_poly.rows_of(n), 20 + n,
                             role=1).roll(1, 1)
        for mult in mults:
            for rev in (False, True):
                what = f"(n {n}, rev {rev}, mult {mult:#x})"
                note("affine_scan_reduce", f"affine_scan_reduce {what}",
                     cuda_poly.affine_scan_reduce(x, mult, rev),
                     cuda_poly.affine_scan_reduce_plain(x, mult, rev))
                note("affine_scan_apply", f"affine_scan_apply {what}",
                     cuda_poly.affine_scan_apply(x, mult, carry, rev),
                     cuda_poly.affine_scan_apply_plain(x, mult, carry, rev))
    x = field_inputs(dev, row ** 3 + 7, 30)
    for mult in mults[:2]:
        mult_m = fr_const(mult, dev)
        for rev in (False, True):
            got = poly.affine_scan(x, mult_m, rev)
            err = compare(f"quotient scan (n {x.shape[1]}, rev {rev})", got,
                          plain_scan(x, mult_m, rev))
            for k in QUOTIENT_KERNELS:
                errs[k] = max(errs[k], err)
    return errs


def measure_kernels(dev, errs: dict) -> dict:
    """Each kernel and its plain version at the main path's shapes: both
    run on the same inputs, are compared, then timed.  Returns
    {kernel: the JSON entry without launches}."""
    import numpy as np
    import torch
    from polymath_tpu_torch.ops import cuda_curve, cuda_field, cuda_gather
    from polymath_tpu_torch.ops import cuda_poly, cuda_scan, cuda_tree, poly
    from polymath_tpu_torch.ops import msm as M
    from polymath_tpu_torch.ops import ntt as N
    from polymath_tpu_torch.ops.field import fr_const
    from polymath_tpu_torch.tools import bound_ms, timed_ms

    out = {}

    def entry(name, source, replaces, shape, kernel, plain, reps, nbytes,
              ops, library=None, cmp=compare):
        # the plain version runs once (it is slow and no yardstick of
        # speed); the kernel is warmed up, then timed over ``reps`` calls;
        # ``library``, one PyTorch call for the same function, likewise.
        # two warm-up results are held at once, so that the timed calls
        # reuse their two blocks and no allocation lands in the timed region
        want, plain_ms = timed_ms(plain, dev)
        warm = kernel(), kernel()
        del warm
        got, kern_ms = timed_ms(kernel, dev, reps)
        err = cmp(name, got, want)
        del got
        lib_ms = None
        if library is not None:
            warm = library(), library()
            del warm
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
    # the shape at which the blocked recurrence that the quotient scan's
    # kernels replaced launched it (ops/poly.py:affine_scan_plain): a step
    # of level 0, 327,681 rows times the (8, 1) multiplier
    step, m1 = big[:, :327_681], big2[:, :1]
    cuda_field.fr_mul(step, m1)
    got, s_ms = timed_ms(lambda: cuda_field.fr_mul(step, m1), dev, 50)
    compare("fr_mul (8, 327681) x (8, 1)", got, plain_fr_mul(step, m1))
    s_bound, s_by = bound_ms(2 * 32 * 327_681 + 32, FR_MUL_OPS * 327_681)
    out["fr_mul"].update(scan_step_ms=s_ms, scan_step_bound_ms=s_bound)
    print(f"  fr_mul at the replaced quotient scan's step (8, 327681) x "
          f"(8, 1): {s_ms:.4f} ms, bound {s_bound:.6f} ms ({s_by})",
          flush=True)
    del big, big2, lo, hi, tw, step, m1

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
    # the shape the prover runs it at: one MSM's (36, 20) window sums plus
    # the next chunk's (ops/msm.py:290), 20 general lanes; latency-bound
    acc_w, q_w = acc[:, 100:120].contiguous(), q[:, 100:120].contiguous()
    cuda_curve.jac_add(acc_w, q_w)
    got, w_ms = timed_ms(lambda: cuda_curve.jac_add(acc_w, q_w), dev, 50)
    compare("jac_add (36, 20)", got, plain_add(acc_w, q_w))
    w_bound, w_by = bound_ms(36 * 3 * 4 * 20, ADD_OPS * 20)
    out["jac_add"].update(window_sums_ms=w_ms, window_sums_bound_ms=w_bound)
    print(f"  jac_add at the prover's (36, 20) window sums: {w_ms:.4f} ms, "
          f"bound {w_bound:.6f} ms ({w_by})", flush=True)

    # the sums of an MSM's chunk sums at the prover's 20 windows, beside
    # the jac_add chains they replaced (the plain version over the jac_add
    # kernel: k - 1 launches of one add a lane) on the same inputs.  Work:
    # a window's L sets other than the identity need L - 1 adds.
    def chain(parts):
        return cuda_tree.sum_sets_plain(parts, cuda_curve.jac_add)

    for k, depth in SUM_SETS_TIMED.items():
        parts, ks = sum_sets_inputs(dev, k, 20, 60 + k)
        adds = int(np.maximum((ks != 0).sum(0) - 1, 0).sum())
        nbytes, ops = 36 * 4 * 20 * (k + 1), ADD_OPS * adds
        if k == 40:
            entry("sum_sets", TREE_SOURCE, ADD_REPLACES,
                  "(40, 36, 20) window sums",
                  lambda: cuda_tree.sum_sets(parts),
                  lambda: cuda_tree.sum_sets_plain(parts), 50, nbytes, ops,
                  cmp=compare_points)
            s_ms = out["sum_sets"]["ms"]
        else:
            cuda_tree.sum_sets(parts)
            got, s_ms = timed_ms(lambda: cuda_tree.sum_sets(parts), dev, 50)
            compare_points(f"sum_sets ({k}, 36, 20)", got,
                           cuda_tree.sum_sets_plain(parts))
        s_bound, s_by = bound_ms(nbytes, ops)
        chain(parts)
        got, c_ms = timed_ms(lambda: chain(parts), dev, 20)
        compare_points(f"jac_add chain ({k}, 36, 20)", got,
                       cuda_tree.sum_sets(parts))
        out["sum_sets"].setdefault("by_k", {})[str(k)] = {
            "ms": s_ms, "bound_ms": s_bound, "bound_by": s_by,
            "critical_path_adds": depth, "chain_ms": c_ms,
            "chain_launches": k - 1}
        print(f"  sum_sets ({k}, 36, 20): {s_ms:.4f} ms, bound "
              f"{s_bound:.6f} ms ({s_by}), {depth} dependent adds; the "
              f"{k - 1}-launch jac_add chain {c_ms:.4f} ms", flush=True)
    out["sum_sets"]["note"] = SUM_SETS_NOTE
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
    table_c, idx_c, d_sorted = chunk_inputs(dev)
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
    # the split configuration's scan over the same chunk's gathered leaves
    leaves = cuda_gather.gather_rows(table_c, idx_c)
    entry("madd_scan", "polymath_tpu_torch/csrc/scan.cu",
          "polymath_tpu/ops/pallas_curve.py:49",
          "(24, 256, 20, 2048) leaves, fast",
          lambda: cuda_scan.madd_scan(leaves, True),
          lambda: cuda_scan.madd_scan_plain(leaves, True), 5,
          (24 + 36) * 4 * idx_c.numel() + 4 * lanes, MADD_OPS * madds)
    del leaves
    # the chunk's tree: (36, 20, 2048) row totals, 2^13 thresholds a window.
    # Work: an exclusive prefix of R rows needs R - 2 adds; a threshold
    # with a count adds its row's offset unless the row is 0, and a
    # window's L live thresholds need L - 1 adds to sum.
    local, _ = M.scan_local(table_c, idx_c, True, True)
    del table_c, idx_c
    ps, cnt, r_of = M.threshold_prefixes(
        local, d_sorted, M.window_params(M.default_chunk())[0])
    totals = local[:, seq - 1]
    windows, rows = totals.shape[1:]
    entry("row_offsets", TREE_SOURCE, ADD_REPLACES,
          f"(36, {windows}, {rows}) row totals",
          lambda: cuda_tree.row_offsets(totals),
          lambda: cuda_tree.row_offsets_plain(totals), 10,
          2 * 36 * 4 * windows * rows, ADD_OPS * windows * (rows - 2),
          cmp=compare_points)
    offs = cuda_tree.row_offsets(totals)
    del local, totals
    n_live = (cnt > 0).sum(1)
    adds = int(((cnt > 0) & (r_of > 0)).sum()) \
        + int((n_live - 1).clamp(min=0).sum())
    entry("window_fold", TREE_SOURCE, ADD_REPLACES,
          f"(36, {windows}, {ps.shape[2]}) thresholds",
          lambda: cuda_tree.window_fold(ps, cnt, r_of, offs),
          lambda: cuda_tree.window_fold_plain(ps, cnt, r_of, offs), 10,
          (36 * 4 + 16) * ps[0].numel() + 36 * 4 * (offs[0].numel()
                                                      + windows),
          ADD_OPS * adds, cmp=compare_points)
    del ps, cnt, r_of, offs

    # the 2^22-point NTT's batch of 2048 transforms of 2048
    x = field_inputs(dev, 1 << 12, 6).repeat(1, 32).reshape(8, 64, 2048)
    xl = x.repeat(1, 32, 1).contiguous()                   # (8, 2048, 2048)
    tw = N.local_twiddles(2048, False, dev)
    nt = xl.shape[1] * 2048
    entry("ntt_local", "polymath_tpu_torch/csrc/ntt.cu",
          "polymath_tpu/ops/ntt.py:87", "(8, 2048, 2048)",
          lambda: N.ntt_local_kernel(xl, tw), lambda: plain_ntt_local(xl, tw),
          10, 2 * 32 * nt + 32 * 1024, FR_MUL_OPS * (nt // 2) * 11)
    del x, xl
    # the 2^23-point transform's wider half (n = 2^22's squaring, split
    # (4096, 2048)): 2048 transforms of 4096, kept under the entry above
    square = out["ntt_local"]
    xw = field_inputs(dev, 1 << 12, 13).repeat(1, 2048).reshape(8, 2048, 4096)
    tw = N.local_twiddles(4096, False, dev)
    nt = xw.shape[1] * 4096
    entry("ntt_local", "polymath_tpu_torch/csrc/ntt.cu",
          "polymath_tpu/ops/ntt.py:87", "(8, 2048, 4096)",
          lambda: N.ntt_local_kernel(xw, tw), lambda: plain_ntt_local(xw, tw),
          10, 2 * 32 * nt + 32 * 2048, FR_MUL_OPS * (nt // 2) * 12)
    square["wide"] = out["ntt_local"]
    out["ntt_local"] = square
    del xw

    # the quotient scan at the bench workload, as stage2b runs it: the D
    # numerator's D + 1 = 20,971,543 coefficients (2^12 seeded elements
    # repeated) read top down, x1 from a seed; level 0's reduce, and its
    # apply from the real carries.  One Fr product an element.
    dlen = 20_971_543
    coeffs = field_inputs(dev, 1 << 12, 12).repeat(
        1, -(-dlen // 4096))[:, :dlen].contiguous()
    x1 = scan_multipliers(9)[0]
    rows = cuda_poly.rows_of(dlen)
    shape = f"(8, {dlen}) reversed, level 0"
    entry("affine_scan_reduce", POLY_SOURCE, POLY_REPLACES, shape,
          lambda: cuda_poly.affine_scan_reduce(coeffs, x1, True),
          lambda: cuda_poly.affine_scan_reduce_plain(coeffs, x1, True), 10,
          32 * (dlen + rows), FR_MUL_OPS * dlen)
    totals = cuda_poly.affine_scan_reduce(coeffs, x1, True)
    carry = poly.affine_scan(
        totals, fr_const(poly.plan_levels(dlen, x1)[1][1], dev))
    entry("affine_scan_apply", POLY_SOURCE, POLY_REPLACES, shape,
          lambda: cuda_poly.affine_scan_apply(coeffs, x1, carry, True),
          lambda: cuda_poly.affine_scan_apply_plain(coeffs, x1, carry, True),
          10, 32 * (2 * dlen + rows), FR_MUL_OPS * dlen)
    del totals, carry
    for k in QUOTIENT_KERNELS:
        out[k]["note"] = POLY_NOTE

    # the whole scan (stage2b's work): the kernels' levels against the
    # blocked fr_mul / fr_add recurrence they replaced, with each side's
    # launches and the device memory it takes above its input
    def scan_run(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        res, ms = timed_ms(fn, dev)
        counts = {k: v for k, v in launches().items() if v}
        return res, ms, torch.cuda.max_memory_allocated() - base, counts

    x1_m = fr_const(x1, dev)
    want, plain_ms, plain_peak, plain_counts = scan_run(
        lambda: plain_scan(coeffs, x1_m, True))
    got, _, peak, counts = scan_run(
        lambda: poly.affine_scan(coeffs, x1_m, True))
    err = compare("quotient scan (bench size)", got, want)
    del got, want
    warm = (poly.synthetic_divide_device(coeffs, x1_m),
            poly.synthetic_divide_device(coeffs, x1_m))
    del warm
    _, ms = timed_ms(lambda: poly.synthetic_divide_device(coeffs, x1_m),
                     dev, 10)
    b, by = bound_ms(2 * 32 * dlen, FR_MUL_OPS * dlen)
    whole = {"shape": f"(8, {dlen}) reversed", "ms": ms,
             "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
             "max_abs_err": err, "launches": counts,
             "plain_launches": plain_counts, "peak_bytes": peak,
             "plain_peak_bytes": plain_peak}
    out["affine_scan_apply"]["quotient_scan"] = whole
    print(f"  quotient scan (8, {dlen}): {ms:.4f} ms in {counts} against "
          f"plain {plain_ms:.1f} ms in {plain_counts}; bound {b:.4f} ms "
          f"({by}); memory above the input {peak / 2**30:.3f} GiB, plain "
          f"{plain_peak / 2**30:.3f} GiB", flush=True)
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


#: phase 3b's MSM settings, (POLYMATH_MSM_CHUNK, POLYMATH_MSM_TAIL): the
#: host tail on (6 of the d MSM's 342 points to the host), off (the tail
#: one more chunk on the card), and chunks of 2 (the d MSM's 171 chunk
#: sums take two sum_sets levels)
MULTI_CHUNK_SETTINGS = (("8", "1"), ("8", "0"), ("2", "0"))
#: the golden MiMC proof's MSMs (a, r, c_w, c_h, d): each takes more than
#: one chunk at every setting of phase 3b
GOLDEN_MSMS = 5


def golden_multi_chunk(dev) -> dict:
    """Phase 3b: the reduced MiMC recipe of tests/fixtures/golden_mimc.json
    through the port's setup and prove on ``dev``.  The VK must equal the
    fixture's, and every transcript's proof, at each of
    MULTI_CHUNK_SETTINGS with the split and with the fused scan, must
    equal the JAX host prover's bytes and verify; each prove runs all
    GOLDEN_MSMS MSMs in more than one chunk, the fused ones through
    fused_scan only, and at chunks of 2 sum_sets launches more than once
    for some MSM.  Returns the setup's and each prove's seconds."""
    import copy
    import random
    from polymath_tpu_torch.circuits import MiMCDemo
    from polymath_tpu_torch.circuits.mimc import mimc_hash
    from polymath_tpu_torch.hostmath.bls12_381 import R
    from polymath_tpu_torch.protocol import Polymath, Rng
    from polymath_tpu_torch.transcript import ALL_TRANSCRIPTS
    from polymath_tpu_torch.utils.config import device_sync, environ
    with open(os.path.join(HERE, "tests", "fixtures",
                           "golden_mimc.json")) as fh:
        fixture = json.load(fh)
    recipe = fixture["recipe"]
    crng = random.Random(recipe["constants_seed"])
    consts = [crng.randrange(R) for _ in range(recipe["rounds"])]
    rng = Rng(recipe["rng_seed"])
    xl, xr = rng.randrange(R), rng.randrange(R)
    image = int(fixture["image"], 16)
    if mimc_hash(xl, xr, consts) != image:
        raise AssertionError("the recipe's MiMC image differs from the "
                             "fixture's")
    t0 = time.time()
    pk, vk = Polymath(device=dev).setup(MiMCDemo(constants=consts), rng)
    device_sync()
    out = {"setup_s": time.time() - t0, "proves": []}
    if vk.to_bytes().hex() != fixture["vk"]:
        raise AssertionError("golden MiMC: VerifyingKey bytes differ")
    print(f"  setup {out['setup_s']:.3f} s; VK bytes equal the fixture",
          flush=True)
    for tr in ALL_TRANSCRIPTS:
        pm = Polymath(transcript=tr, device=dev)
        for chunk, tail in MULTI_CHUNK_SETTINGS:
            setting = (f"chunk {chunk}, tail "
                       f"{'on' if tail == '1' else 'off'}")
            seconds = {}
            for scan in ("split", "fused"):
                label = f"{tr.name}, {setting}, {scan}"
                before, multi0 = launches(), multi_chunk_msms()
                t0 = time.time()
                with environ(POLYMATH_MSM_CHUNK=chunk,
                             POLYMATH_MSM_TAIL=tail,
                             POLYMATH_MSM_FUSED="1" if scan == "fused"
                             else "0"):
                    proof = pm.prove(pk, MiMCDemo(xl, xr, consts),
                                     copy.deepcopy(rng))
                    device_sync()
                seconds[scan] = time.time() - t0
                after = launches()
                fl = {k: after[k] - before[k] for k in after}
                multi = multi_chunk_msms() - multi0
                if proof.to_bytes().hex() != fixture["proofs"][tr.name]:
                    raise AssertionError(f"{label}: proof bytes differ from "
                                         f"the JAX package's")
                if not pm.verify(vk, [image], proof):
                    raise AssertionError(f"{label}: proof rejected")
                if multi != GOLDEN_MSMS:
                    raise AssertionError(f"{label}: {multi} MSMs of more "
                                         f"than one chunk, want "
                                         f"{GOLDEN_MSMS}")
                ran, idle = (("fused_scan", "madd_scan") if scan == "fused"
                             else ("madd_scan", "fused_scan"))
                if fl[ran] == 0 or fl[idle]:
                    raise AssertionError(f"{label}: {ran} launched "
                                         f"{fl[ran]}, {idle} {fl[idle]}")
                if chunk == "2" and fl["sum_sets"] <= GOLDEN_MSMS:
                    raise AssertionError(f"{label}: sum_sets launched "
                                         f"{fl['sum_sets']} times, want "
                                         f"more than {GOLDEN_MSMS}")
                out["proves"].append({"label": label,
                                      "prove_s": seconds[scan],
                                      "sum_sets": fl["sum_sets"]})
            print(f"  {tr.name}, {setting}: proof bytes equal the JAX "
                  f"package's, verified, {GOLDEN_MSMS} MSMs of more than "
                  f"one chunk; split {seconds['split']:.3f} s, fused "
                  f"{seconds['fused']:.3f} s; sum_sets launches "
                  f"{out['proves'][-2]['sum_sets']} / "
                  f"{out['proves'][-1]['sum_sets']}", flush=True)
    return out


# -- phase 4 -------------------------------------------------------------------

def _counted_modules(tools: bool = False):
    """The kernel wrappers with a LAUNCHES counter: the prover's (B1-B9,
    to_affine, the madd scan and the tree kernels), or with ``tools`` the
    measurement tools' (T1, T2)."""
    if tools:
        from polymath_tpu_torch.tools import pgather_variants, primbench
        return (primbench, pgather_variants)
    from polymath_tpu_torch.ops import cuda_curve, cuda_field, cuda_gather
    from polymath_tpu_torch.ops import cuda_poly, cuda_scan, cuda_tree, ntt
    return (cuda_field, cuda_curve, cuda_gather, cuda_scan, cuda_tree, ntt,
            cuda_poly)


def launches(tools: bool = False) -> dict:
    out = {}
    for mod in _counted_modules(tools):
        out.update(mod.LAUNCHES)
    return out


def reset_launches() -> None:
    """Every launch count to 0, and ops/msm.py's count of MSMs."""
    from polymath_tpu_torch.ops import msm as M
    for mod in _counted_modules() + _counted_modules(tools=True):
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0
    for k in M.RUNS:
        M.RUNS[k] = 0


def multi_chunk_msms() -> int:
    """MSMs of more than one chunk since the last reset (ops/msm.py)."""
    from polymath_tpu_torch.ops import msm as M
    return M.RUNS["multi_chunk"]


class PhaseProbe:
    """Each prover phase's kernel launches and peak device memory, taken
    through utils/timers.HOOKS while ``installed``.  The peak statistic is
    reset as each phase starts; ``peak`` keeps the largest over the phases
    and what came between them."""

    def __init__(self):
        self.phases, self.peak = {}, 0

    @contextlib.contextmanager
    def __call__(self, label: str):
        import torch
        if label.startswith("collective::"):   # nested in a prover phase
            yield
            return
        self.peak = max(self.peak, torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        before = launches()
        try:
            yield
        finally:
            phase_peak = torch.cuda.max_memory_allocated()
            self.peak = max(self.peak, phase_peak)
            after = launches()
            self.phases[label] = {
                "peak_bytes": phase_peak,
                "launches": {k: after[k] - before[k] for k in after
                             if after[k] != before[k]}}

    @contextlib.contextmanager
    def installed(self):
        from polymath_tpu_torch.utils import timers
        timers.HOOKS.append(self)
        try:
            yield self
        finally:
            timers.HOOKS.remove(self)

    def overall_peak(self) -> int:
        import torch
        return max(self.peak, torch.cuda.max_memory_allocated())

    def report(self, what: str) -> None:
        for label, r in sorted(self.phases.items()):
            print(f"    {what} {label}: peak {r['peak_bytes'] / 2**30:.3f} "
                  f"GiB; launches {json.dumps(r['launches'])}")


def check_quotient_launches(probe: PhaseProbe) -> None:
    """The quotient scan phase launches the scan's reduce and apply
    kernels only, 2 a level and 1 for the top (one more apply than
    reduces), and no fr_mul."""
    fl = probe.phases[QUOTIENT_PHASE]["launches"]
    red, app = (fl.get(k, 0) for k in QUOTIENT_KERNELS)
    if set(fl) - set(QUOTIENT_KERNELS) or red < 1 or app != red + 1:
        raise AssertionError(f"{QUOTIENT_PHASE} launched {fl}: want only "
                             f"{QUOTIENT_KERNELS}, one more apply than "
                             f"reduces")


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
    counts, multi = {}, {}

    def step(label, fn):
        before, multi0 = launches(), multi_chunk_msms()
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize()
        dt = time.time() - t0
        after = launches()
        counts[label] = {k: after[k] - before[k] for k in after}
        multi[label] = multi_chunk_msms() - multi0
        print(f"  {label}: {dt:.3f} s; launches {counts[label]}; MSMs of "
              f"more than one chunk {multi[label]}", flush=True)
        return res, dt

    (pk, vk), setup_s = step("setup", lambda: pm.setup(circuit(), rng))
    print(f"  n = {vk.n}", flush=True)
    proof1, warm_s = step("prove 1 (warm)",
                          lambda: pm.prove(pk, circuit(), rng))
    phases1 = {k: v for k, v in timers.TIMES.items()
               if k.startswith("prover::")}
    with PhaseProbe().installed() as probe:
        proof2, prove_s = step("prove 2",
                               lambda: pm.prove(pk, circuit(), rng))
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
    peak = probe.overall_peak()
    print(f"  verify {verify_s * 1e3:.1f} ms per proof; wrong public input "
          f"rejected; peak device memory {peak / 2**30:.2f} GiB", flush=True)
    probe.report("prove 2")
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
    check_msm_launches(per_prove, "madd_scan", multi["prove 2"])
    check_quotient_launches(probe)
    return {"launches": total, "per_prove": per_prove,
            "per_setup": counts["setup"], "setup_s": setup_s,
            "warm_prove_s": warm_s, "prove_s": prove_s,
            "verify_ms": verify_s * 1e3, "peak_bytes": peak, "n": vk.n,
            "pm": pm, "pk": pk, "vk": vk, "circuit": circuit,
            "public": a * b % R}


def check_msm_launches(fl: dict, scan: str, multi_chunk: int) -> None:
    """One prove's MSM launches: one ``scan`` (madd_scan or fused_scan) per
    chunk (a chunk is one gather_rows in a split prove), no per-step
    jac_madd, at most 3 tree launches a chunk, no jac_add, and one
    sum_sets for each of the ``multi_chunk`` MSMs of more than one chunk
    (the adds across an MSM's chunks)."""
    chunks = fl[scan]
    if scan == "madd_scan" and fl["gather_rows"] != chunks:
        raise AssertionError(f"madd_scan launches {chunks} != gather_rows "
                             f"{fl['gather_rows']}")
    tree = sum(fl[k] for k in TREE_KERNELS)
    if fl["jac_madd"] or fl["jac_add"] or not chunks \
            or tree > 3 * chunks or fl["sum_sets"] != multi_chunk:
        raise AssertionError(f"MSM launches per prove {fl}: want one {scan} "
                             f"a chunk, no jac_madd, at most 3 tree launches "
                             f"a chunk, no jac_add, and {multi_chunk} "
                             f"sum_sets, one an MSM of more than one chunk")


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
    from polymath_tpu_torch.utils.config import environ

    pm, pk, vk = run["pm"], run["pk"], run["vk"]
    turns = []
    for label in ("split", "fused", "fused", "split"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.time()
        with environ(POLYMATH_MSM_FUSED="1" if label == "fused" else "0"), \
                PhaseProbe().installed() as probe:
            proof = pm.prove(pk, run["circuit"](), Rng(7))
            torch.cuda.synchronize()
        turns.append({
            "label": label, "proof": proof,
            "prove_s": time.time() - t0, "launches": launches(),
            "multi_chunk": multi_chunk_msms(),
            "peak_bytes": probe.overall_peak(), "probe": probe,
            "phases": {k: v for k, v in timers.TIMES.items()
                       if k.startswith("prover::")}})
    for i, r in enumerate(turns):
        print(f"  turn {i + 1} {r['label']}: prove {r['prove_s']:.3f} s, "
              f"peak {r['peak_bytes'] / 2**30:.2f} GiB; launches "
              f"{json.dumps(r['launches'])}", flush=True)
        for k, v in sorted(r["phases"].items()):
            print(f"    turn {i + 1} {r['label']} {k}: {v:.3f} s")
        r["probe"].report(f"turn {i + 1} {r['label']}")
        check_quotient_launches(r["probe"])
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
            check_msm_launches(fl, "madd_scan", r["multi_chunk"])
            continue
        if fl["fused_scan"] == 0 or any(fl[k] for k in SPLIT_ONLY):
            raise AssertionError(f"fused prove launched {fl}")
        if fl["fused_scan"] != split["gather_rows"]:
            raise AssertionError(f"fused_scan launches {fl['fused_scan']} "
                                 f"!= split gather_rows "
                                 f"{split['gather_rows']}")
        check_msm_launches(fl, "fused_scan", r["multi_chunk"])
        missing = [k for k in PROVE_KERNELS + FUSED_KERNELS
                   if k not in SPLIT_ONLY and fl[k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the fused "
                                 f"path: {missing}")
    print("  proofs byte-equal, all verify, wrong public input rejected",
          flush=True)
    return turns


def other_transcripts(run: dict) -> dict:
    """Phase 4b's Keccak256 and Blake3 proves: one split prove each with
    the phase-4 key from a fresh Rng(7), which must verify under its
    transcript and reject a wrong public input.  Returns each one's
    seconds."""
    from polymath_tpu_torch.hostmath.bls12_381 import R
    from polymath_tpu_torch.protocol import Polymath, Rng
    from polymath_tpu_torch.transcript import (
        Blake3Transcript, Keccak256Transcript,
    )
    from polymath_tpu_torch.utils.config import device_sync, environ
    seconds = {}
    for tr in (Keccak256Transcript, Blake3Transcript):
        pm = Polymath(transcript=tr, device=run["pm"].device)
        t0 = time.time()
        with environ(POLYMATH_MSM_FUSED="0"):
            proof = pm.prove(run["pk"], run["circuit"](), Rng(7))
            device_sync()
        seconds[tr.name] = time.time() - t0
        if not pm.verify(run["vk"], [run["public"]], proof):
            raise AssertionError(f"{tr.name} bench proof rejected")
        if pm.verify(run["vk"], [(run["public"] + 1) % R], proof):
            raise AssertionError(f"{tr.name}: a wrong public input was "
                                 f"accepted")
    return seconds


# -- phase 4c ------------------------------------------------------------------

#: what the bench entry's JSON line must hold (polymath_tpu_torch/bench.py)
BENCH_FIELDS = ("metric", "value", "unit", "vs_baseline", "detail")
BENCH_DETAIL = ("prove_seconds", "fused_prove_seconds", "warm_prove_seconds",
                "setup_seconds", "pk_load_seconds", "kernel_build_seconds",
                "verify_ms", "verify_reps", "peak_gib", "domain_n",
                "num_constraints", "device", "verify", "fused_equals_split")


def key_store_path(dev, run: dict, split_proof, num_constraints: int) -> dict:
    """The key store and the bench entry with the phase-4 key (phase 4c of
    the module docstring).  Returns the seconds and bytes of save_dir, the
    bench entry's line and wall seconds, and the load and prove here."""
    import shutil
    import tempfile
    import torch
    from polymath_tpu_torch import bench
    from polymath_tpu_torch.protocol import Rng, keys
    from polymath_tpu_torch.utils.config import environ

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    parent = tempfile.mkdtemp(prefix="keystore.",
                              dir=os.path.join(HERE, "build"))
    try:
        pk_dir = os.path.join(parent,
                              f"torch_pk_{num_constraints}_{bench.SEED}.dir")
        t0 = time.time()
        keys.save_dir(run["pk"], pk_dir)
        save_s = time.time() - t0
        disk = sum(os.path.getsize(os.path.join(pk_dir, f))
                   for f in os.listdir(pk_dir))
        print(f"  save_dir: {save_s:.3f} s, {disk / 2**30:.3f} GiB on disk "
              f"({len(os.listdir(pk_dir))} files)", flush=True)

        torch.cuda.empty_cache()
        env = dict(os.environ, POLYMATH_BENCH_REPS="3",
                   POLYMATH_BENCH_CONSTRAINTS=str(num_constraints),
                   POLYMATH_BENCH_VARIABLES=str(num_constraints))
        env.pop("POLYMATH_MSM_FUSED", None)
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "polymath_tpu_torch.bench",
             "--cache-dir", parent], cwd=HERE, env=env, capture_output=True,
            text=True, timeout=600)
        bench_s = time.time() - t0
        # its summary lines, and the phase timers up to the warm prove
        warm = True
        for ln in proc.stderr.splitlines():
            if warm or ln.startswith("#"):
                print(f"  bench {ln}", flush=True)
            warm = warm and not ln.startswith("# warm prove")
        if proc.returncode != 0:
            raise AssertionError(f"the bench entry exited {proc.returncode}:"
                                 f"\n{proc.stderr[-4000:]}")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        detail = line.get("detail", {})
        missing = [k for k in BENCH_FIELDS if k not in line]
        missing += [k for k in BENCH_DETAIL if k not in detail]
        if missing:
            raise AssertionError(f"bench line lacks {missing}")
        if detail["setup_seconds"] != 0 or not detail["pk_load_seconds"] > 0:
            raise AssertionError(f"the bench entry ran setup instead of "
                                 f"loading {pk_dir}")
        if detail["verify"] is not True or \
                detail["fused_equals_split"] is not True:
            raise AssertionError(f"bench line: verify {detail['verify']}, "
                                 f"fused equal to split "
                                 f"{detail['fused_equals_split']}")
        if detail["domain_n"] != run["n"]:
            raise AssertionError(f"bench domain {detail['domain_n']} != "
                                 f"{run['n']}")
        print(f"  bench entry, fresh process, {bench_s:.1f} s wall:",
              flush=True)
        print(f"  bench line: {json.dumps(line)}", flush=True)

        t0 = time.time()
        pk = keys.load_dir(pk_dir, dev)
        torch.cuda.synchronize()
        load_s = time.time() - t0
        with environ(POLYMATH_MSM_FUSED="0"):
            t0 = time.time()
            proof = run["pm"].prove(pk, run["circuit"](), Rng(7))
            torch.cuda.synchronize()
            prove_s = time.time() - t0
        if proof.to_bytes() != split_proof.to_bytes():
            raise AssertionError("the loaded key's proof differs from phase "
                                 "4b's first proof")
        if not run["pm"].verify(run["vk"], [run["public"]], proof):
            raise AssertionError("the loaded key's proof was rejected")
        print(f"  load_dir here {load_s:.3f} s; prove from Rng(7) "
              f"{prove_s:.3f} s, byte-equal to phase 4b's first proof",
              flush=True)
        del pk
    finally:
        shutil.rmtree(parent, ignore_errors=True)
    return {"save_s": save_s, "disk_bytes": disk, "bench": line,
            "bench_wall_s": bench_s, "load_s": load_s, "prove_s": prove_s}


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
        fusedprof, kernel_metrics, msmtime, pgather_variants, primbench,
        productprobe)
    reset_launches()
    pb = primbench.main([])
    gv = pgather_variants.main([])
    km = kernel_metrics.main([])
    fp = fusedprof.main([])
    pp = productprobe.main([])
    mt = msmtime.main([])
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
            "fusedprof": fp, "productprobe": pp, "msmtime": mt,
            "launches": counts, "entries": entries}


# -- phase 6 -------------------------------------------------------------------

#: phase 6's budget: it fails past this many seconds
PHASE6_LIMIT_S = 120
SHARDED_NTT_SIZES = (1 << 21, 1 << 22)
SHARDED_MSM_POINTS = 1 << 21


def random_words(dev, n: int, seed: int):
    """(8, n) Fr words below 2^254 (< r), drawn on the card: valid
    Montgomery words and canonical scalars alike."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randint(-2 ** 31, 2 ** 31, (8, n), dtype=torch.int32,
                      device=dev, generator=g)
    w[7] &= 0x3FFFFFFF
    return w


def multi_device_cpu() -> dict:
    """Phase 6a: ``python3 -m polymath_tpu_torch.parallel.dryrun --device
    cpu --ranks 4`` in a subprocess that sees no card: four gloo ranks on
    the card's host, the one cross-rank layout a one-card machine can
    check.  Returns its JSON line and wall seconds."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "polymath_tpu_torch.parallel.dryrun",
         "--device", "cpu", "--ranks", "4", "--timeout", "80"], cwd=HERE,
        env=env, capture_output=True, text=True, timeout=90)
    wall = time.time() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the CPU dry run exited {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    if line.get("ok") is not True or line.get("ranks") != 4:
        raise AssertionError(f"the CPU dry run's line: {line}")
    return {"line": line, "wall_s": wall}


def multi_device_card(run: dict, split_proof) -> dict:
    """Phase 6b: one NCCL rank on the card, in this process, through
    parallel/launch.py (see ``card_rank``)."""
    from polymath_tpu_torch.parallel import launch
    return launch.run_ranks(card_rank, 1, "cuda", PHASE6_LIMIT_S, run,
                            split_proof)[0]


def card_rank(mesh, run: dict, split_proof) -> dict:
    """The rank body of phase 6b: ``ntt_sharded`` at 2^21 and 2^22 both
    ways, bit for bit against ops/ntt.py:ntt (a cold call, then the least
    of 3 of each); the sharded MSM of 2^21 of the key's x-power points with
    random scalars, the point of ``msm_device`` (the least of 2 of each);
    then, with the phase-4 key and each from a fresh Rng(7), a warm
    sharded prove and then split, sharded, sharded, split proves, all
    byte-equal to phase 4b's split proof and verified, with their seconds,
    peak memory (whole and by phase), launches and collectives."""
    import copy
    import torch
    from polymath_tpu_torch.hostmath.bls12_381 import R
    from polymath_tpu_torch.ops.msm import msm_device
    from polymath_tpu_torch.ops.ntt import ntt
    from polymath_tpu_torch.ops.prover import get_artifacts
    from polymath_tpu_torch.parallel.mesh import COLLECTIVES, reset_collectives
    from polymath_tpu_torch.parallel.msm_sharded import msm_sharded
    from polymath_tpu_torch.parallel.ntt_sharded import (
        columns_of, gather, ntt_sharded)
    from polymath_tpu_torch.parallel.prover_sharded import (
        create_proof_sharded)
    from polymath_tpu_torch.protocol import Rng

    def timed(fn, reps):
        """(result, cold ms, least steady ms of ``reps``)"""
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.time()
            res = fn()
            torch.cuda.synchronize()
            times.append((time.time() - t0) * 1e3)
        return res, times[0], min(times[1:])

    dev = mesh.device
    out = {"ntt_ms": {}}
    for n in SHARDED_NTT_SIZES:
        a = random_words(dev, n, n)
        for inverse in (False, True):
            got, cold, sharded_ms = timed(lambda: gather(ntt_sharded(
                columns_of(a, mesh), mesh, inverse), mesh), 3)
            want, _, one_ms = timed(lambda: ntt(a, inverse), 3)
            compare(f"ntt_sharded n={n} inverse={inverse}", got, want)
            out["ntt_ms"][f"{n}{' inverse' if inverse else ''}"] = {
                "sharded_cold": cold, "sharded": sharded_ms,
                "one_device": one_ms}
        del a, got, want
    xp = get_artifacts(run["pk"], dev).srs["x_powers_g1"]
    sc = random_words(dev, SHARDED_MSM_POINTS, 3)
    p_sh, _, sh_ms = timed(lambda: msm_sharded(xp, sc, mesh, fast=True), 2)
    p_one, _, one_ms = timed(lambda: msm_device(xp, sc, fast=True), 2)
    if p_sh != p_one:
        raise AssertionError("the sharded MSM's point differs from "
                             "msm_device's")
    out["msm_ms"] = {"sharded": sh_ms, "one_device": one_ms}
    del sc

    out["proves"] = []
    want = split_proof.to_bytes()
    for label in ("sharded warm", "split", "sharded", "sharded", "split"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        reset_collectives()
        circuit = run["circuit"]()
        with PhaseProbe().installed() as probe:
            t0 = time.time()
            if label == "split":
                proof = run["pm"].prove(run["pk"], circuit, Rng(7))
            else:
                proof = create_proof_sharded(circuit, run["pk"], Rng(7),
                                             run["pm"].transcript, mesh)
            torch.cuda.synchronize()
            prove_s = time.time() - t0
        if proof.to_bytes() != want:
            raise AssertionError(f"{label} proof differs from phase 4b's "
                                 f"split proof")
        if not run["pm"].verify(run["vk"], [run["public"]], proof):
            raise AssertionError(f"{label} proof rejected")
        out["proves"].append({
            "label": label, "prove_s": prove_s,
            "peak_bytes": probe.overall_peak(), "launches": launches(),
            "multi_chunk": multi_chunk_msms(),
            "collectives": copy.deepcopy(COLLECTIVES),
            "phase_peaks": {k: v["peak_bytes"]
                            for k, v in probe.phases.items()}})
    if run["pm"].verify(run["vk"], [(run["public"] + 1) % R], proof):
        raise AssertionError("a wrong public input was accepted (sharded)")
    return out


def check_sharded(card: dict) -> None:
    """Phase 6b's counts: every prove kernel launched in each steady
    sharded prove, as many times as in the split proves beside it and by
    phase 4's MSM rule (one rank adds no sum of the ranks' sums); 11
    all_to_all, 9 all_gather (4 vectors, 5 window-sum gathers) and 1
    broadcast a sharded proof, none a split one."""
    proves = card["proves"]
    split = [r for r in proves if r["label"] == "split"]
    for r in proves:
        calls = {k: v["calls"] for k, v in r["collectives"].items()}
        want = SHARDED_COLLECTIVES if r["label"] != "split" else \
            dict.fromkeys(SHARDED_COLLECTIVES, 0)
        if calls != want:
            raise AssertionError(f"collectives of a {r['label']} prove "
                                 f"{calls} != {want}")
        if r["label"] != "sharded":
            continue
        missing = [k for k in PROVE_KERNELS if r["launches"][k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched in the sharded "
                                 f"prove: {missing}")
        if any(r["launches"] != s["launches"] for s in split):
            raise AssertionError(f"sharded prove launched {r['launches']}, "
                                 f"the split proves "
                                 f"{[s['launches'] for s in split]}")
        check_msm_launches(r["launches"], "madd_scan", r["multi_chunk"])


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
    from polymath_tpu_torch.utils.config import nvidia_smi_line
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
    from polymath_tpu_torch.ops import cuda_scan
    blocks = cuda_scan.max_blocks(dev)
    print(f"[1] scan kernels: {blocks} blocks of 64 threads at once "
          f"({blocks // torch.cuda.get_device_properties(dev).multi_processor_count}"
          f" an SM); a 2^19-point chunk's 40,960 lanes are "
          f"{-(-40960 // 64)} blocks", flush=True)

    # 2. kernels against their plain versions
    print("[2] kernels against plain versions (0 mismatches required):",
          flush=True)
    errs = check_kernels(dev)
    print(f"  edge-case inputs: 0 mismatches in {sorted(errs)}", flush=True)
    numbers = measure_kernels(dev, errs)

    # 3. golden bytes
    print("[3] golden bytes on the card:", flush=True)
    golden(dev)
    print("[3b] golden multi-chunk MSMs: reduced MiMC against "
          "tests/fixtures/golden_mimc.json, each transcript at chunk 8 "
          "(tail on, off) and 2, split and fused", flush=True)
    t0 = time.time()
    gm = golden_multi_chunk(dev)
    print(f"[3b] VK and all {len(gm['proves'])} proofs equal the JAX "
          f"package's bytes; setup {gm['setup_s']:.3f} s, proves "
          f"{sum(r['prove_s'] for r in gm['proves']):.3f} s; phase 3b took "
          f"{time.time() - t0:.1f} s", flush=True)

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
    turns = fused_path(run)
    fused = turns[1]
    print(f"[4b] fused prove {fused['prove_s']:.2f} s, peak "
          f"{fused['peak_bytes'] / 2**30:.2f} GiB, fused_scan launches "
          f"{fused['launches']['fused_scan']}", flush=True)
    tr_s = other_transcripts(run)
    print(f"[4b] split proves from Rng(7) by transcript: merlin "
          f"{turns[0]['prove_s']:.3f} / {turns[3]['prove_s']:.3f} s, "
          f"keccak256 {tr_s['keccak256']:.3f} s, blake3 "
          f"{tr_s['blake3']:.3f} s; each verified under its transcript, "
          f"a wrong public input rejected", flush=True)

    # 4c. the key store and the bench entry
    print("[4c] key store and bench entry: save_dir of the phase-4 key, "
          "python3 -m polymath_tpu_torch.bench in a fresh process, load_dir "
          "and a prove from Rng(7) here", flush=True)
    t0 = time.time()
    store = key_store_path(dev, run, turns[0]["proof"], args.constraints)
    bd = store["bench"]["detail"]
    print(f"[4c] save_dir {store['save_s']:.2f} s, "
          f"{store['disk_bytes'] / 2**30:.3f} GiB; bench: pk_load "
          f"{bd['pk_load_seconds']:.3f} s, kernel build "
          f"{bd['kernel_build_seconds']:.3f} s, warm prove "
          f"{bd['warm_prove_seconds']:.3f} s, prove {bd['prove_seconds']:.3f}"
          f" s, fused {bd['fused_prove_seconds']:.3f} s, peak "
          f"{bd['peak_gib']:.3f} GiB, verify {bd['verify_ms']:.3f} ms; "
          f"phase 4c took {time.time() - t0:.1f} s", flush=True)

    # 5. the measurement entry points
    print("[5] measurement entry points: primbench (T2), pgather_variants "
          "(T1), kernel_metrics, fusedprof, productprobe, msmtime",
          flush=True)
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
          f"{json.dumps(fp['stages_ms'])}; yardsticks "
          f"{json.dumps(fp['yardsticks_ms'])}; sum split "
          f"{fp['split_sum_ms']:.3f} ms, fused {fp['fused_sum_ms']:.3f} ms; "
          f"phase 5 took {time.time() - t0:.1f} s", flush=True)
    pp = meas["productprobe"]
    print(f"[5] productprobe: to_affine {json.dumps(pp['to_affine'])}; SASS "
          f"of one inlined product {json.dumps(pp['sass'])}", flush=True)
    mt = meas["msmtime"]
    sweep = [f"{r['config']} (chunk {r['chunk']}, c {r['c']}, seq "
             f"{r['seq']}) {r['steady_ms']:.3f} ms {r['mpts_per_s']:.3f} "
             f"Mpts/s" for r in mt["configs"]]
    print(f"[5] msmtime, {mt['n']} points, one point in every config; "
          f"fastest {mt['fastest']}: {'; '.join(sweep)}", flush=True)

    # 6. multi-device proving
    print("[6] multi-device: (a) the dry run on 4 gloo CPU ranks; (b) one "
          "NCCL rank on the card: ntt_sharded, the sharded MSM, sharded and "
          "split proves from Rng(7) in turns", flush=True)
    t0 = time.time()
    cpu = multi_device_cpu()
    print(f"[6a] dry run, 4 gloo ranks, {cpu['wall_s']:.1f} s wall: "
          f"{json.dumps(cpu['line'])}", flush=True)
    card = multi_device_card(run, turns[0]["proof"])
    check_sharded(card)
    print(f"[6b] ms, cold and least of 3 (one rank) against ops.ntt: "
          f"{json.dumps(card['ntt_ms'])}; MSM of {SHARDED_MSM_POINTS} "
          f"points ms {json.dumps(card['msm_ms'])}", flush=True)
    for r in card["proves"]:
        peaks = {k: round(v / 2**30, 3) for k, v in
                 sorted(r["phase_peaks"].items())}
        print(f"  {r['label']} prove: {r['prove_s']:.3f} s, peak "
              f"{r['peak_bytes'] / 2**30:.3f} GiB, collectives "
              f"{json.dumps(r['collectives'])}; launches "
              f"{json.dumps(r['launches'])}; peak GiB by phase "
              f"{json.dumps(peaks)}", flush=True)
    phase6_s = time.time() - t0
    print(f"[6b] every proof byte-equal to phase 4b's split proof and "
          f"verified; a steady sharded prove launches what a split prove "
          f"does; phase 6 took {phase6_s:.1f} s", flush=True)
    if phase6_s > PHASE6_LIMIT_S:
        raise AssertionError(f"phase 6 took {phase6_s:.1f} s, over its "
                             f"{PHASE6_LIMIT_S} s")
    sharded = card["proves"][-2]["launches"]

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
        if name in SETUP_KERNELS:
            k["launches_per_setup"] = run["per_setup"][name]
        k["launches_per_sharded_prove"] = sharded[name]
        if name in UNCALLED_KERNELS:
            k["note"] = "no path of the reference calls this kernel"
        if name in OFF_PATH_KERNELS:
            k["note"] = ("B3 at one step: the split scan runs as one "
                         "madd_scan launch a chunk; fusedprof launches it "
                         "as its per-step yardstick (phase 5)")
        kernels.append(k)
    kernels += meas["entries"]
    print(f"[done] total {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
