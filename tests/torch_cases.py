"""What the port's card tests share (tests/test_torch_cuda.py), with the
inputs that only tests use (the CPU tests of the scan and the tree take
theirs from here too): every kernel against its plain version at shapes
that hold the edge cases; keys set up on a device (the golden MiMC,
BenchCircuit) and their golden proofs; the launch rules of a prove; the
rank bodies of a sharded prove and of the sharded NTT and MSM at the bench
workload's widths.

The kernels' shared inputs and plain versions are
``polymath_tpu_torch.tools.cases``, which the kernel table uses too.
Nothing here imports jax or the JAX package: the card's machine has
neither (tests/test_torch_prover.py scans this file for it).
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import random

import numpy as np
import torch

from polymath_tpu_torch.hostmath import bls12_381 as bls
from polymath_tpu_torch.ops import curve as C
from polymath_tpu_torch.ops import cuda_curve, cuda_field, cuda_gather
from polymath_tpu_torch.ops import cuda_poly, cuda_scan, cuda_tree
from polymath_tpu_torch.ops import msm as M
from polymath_tpu_torch.ops import ntt as N
from polymath_tpu_torch.transcript import MerlinFieldTranscript
from polymath_tpu_torch.tools.cases import (
    compare, compare_points, edge_values, field_inputs, fq_edge_words,
    host_points, jac_words, launches, plain_add, plain_butterfly,
    plain_double, plain_fr_mul, plain_fr_sqr, plain_madd, plain_ntt_local,
    plain_to_affine, point_inputs, scan_multipliers)
from polymath_tpu_torch.utils import timers

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")

#: the kernels every (split) prove launches: B1, B2, B4, B6, the one-launch
#: madd scan (B3), the three tree kernels that replace B5's launches in the
#: MSM, the quotient scan's two kernels (B1's main-path use); the kernel
#: that replaces the gather and madd scan in the fused configuration;
#: kernels no prove launches (two that no path of the reference calls, and
#: B3 at one step); the setup kernels: the port-only to_affine and B5
#: itself (ops/fixed_base.py)
PROVE_KERNELS = ("fr_mul", "fr_sqr", "madd_scan", "gather_rows",
                 "row_offsets", "window_fold", "sum_sets", "ntt_local",
                 "affine_scan_reduce", "affine_scan_apply")
SPLIT_ONLY = ("madd_scan", "gather_rows")
TREE_KERNELS = ("row_offsets", "window_fold")
QUOTIENT_KERNELS = ("affine_scan_reduce", "affine_scan_apply")
QUOTIENT_PHASE = "prover::stage2b (quotient scan)"
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
#: the MSM settings of the golden multi-chunk proves, (POLYMATH_MSM_CHUNK,
#: POLYMATH_MSM_TAIL): the host tail on (6 of the d MSM's 342 points to
#: the host), off (the tail one more chunk on the card), and chunks of 2
#: (the d MSM's 171 chunk sums take two sum_sets levels)
MULTI_CHUNK_SETTINGS = (("8", "1"), ("8", "0"), ("2", "0"))
#: a prove's MSMs (a, r, c_w, c_h, d): in the golden MiMC proof each takes
#: more than one chunk at every one of those settings, and so it does in a
#: prove of the bench workload (n = 2^21) at the main path's defaults
PROVE_MSMS = 5
#: the MSM overrides of ops/msm.py but POLYMATH_MSM_FUSED, all unset: the
#: main path's chunk of 2^19 points, host tail and 20 windows
MSM_DEFAULTS = dict.fromkeys(("POLYMATH_MSM_C", "POLYMATH_MSM_SEQ",
                              "POLYMATH_MSM_CHUNK", "POLYMATH_MSM_TAIL"))
#: the widths of the sharded NTT and MSM at the bench workload: its
#: transforms of n and 2n points, and an MSM over n of its key's points
SHARDED_NTT_SIZES = (1 << 21, 1 << 22)
SHARDED_MSM_POINTS = 1 << 21


# -- inputs that only tests use -----------------------------------------------

def scan_inputs(dev, seq: int = 16, windows: int = 4, rows: int = 256):
    """A fused-scan table of k G (k = 1..1024), then -5G and -9G, then E
    rows whose words are the Fq edge values (x edge k, y edge k + 1; not
    points of the curve), and step-major (seq, windows, rows) leaf
    indices, random but for the planted lanes (index T is a dead leaf):
    0 all dead; 1 G, 2G, 3G (the leaf equals the running sum, Z != 1);
    2 5G, 5G (a duplicate base, Z = 1); 3 5G, -5G (P + (-P)), then 7G;
    4 9G, -9G, 9G, 9G (a collision after the identity); 5 live with every
    fourth leaf dead; 6 the edge rows in turn."""
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


def tree_inputs(dev, windows: int = 3, rows: int = 300, n: int = 1000,
                seed: int = 3):
    """tree_case on ``dev``: (totals (36, W, rows), ps (36, W, n), cnt,
    r_of (W, n) int64).  The default has two segments of rows (joined by
    the carry pass) and several fold blocks a window (summed by the last
    one)."""
    tot, ps, cnt, r_of, _ = tree_case(windows, rows, n, seed)
    return (jac_words(tot, seed).to(dev), jac_words(ps, seed + 1).to(dev),
            torch.from_numpy(cnt).to(dev), torch.from_numpy(r_of).to(dev))


def random_words(dev, n: int, seed: int):
    """(8, n) Fr words below 2^254 (< r), drawn on ``dev``: valid
    Montgomery words and canonical scalars alike."""
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randint(-2 ** 31, 2 ** 31, (8, n), dtype=torch.int32,
                      device=dev, generator=g)
    w[7] &= 0x3FFFFFFF
    return w


# -- every kernel against its plain version -----------------------------------

def check_kernels(dev) -> dict:
    """Every kernel against its plain version on ``dev`` at moderate shapes
    that hold the edge cases: 2^16 field elements with every pair of the
    Fr edge values (edge_values); 2^12 points with the identity on either
    side, a (0, 0) leaf, P + P, P + (-P) and lanes of Fq edge words; a
    (16, 64, 2048) batch of local NTTs, and the (8, 2048, 4096) batch of
    the 2^23-point transform's wider half; a (16, 4, 256) fused scan, and
    the madd scan on its gathered leaves, with the lanes of scan_inputs
    (edge-word rows among them); the tree kernels on tree_inputs
    (edge-word Z); the gather at 40,960 rows with the zero row; the
    quotient scan's reduce and apply at 1, 16, 17 and 2,053 elements (one
    row, one full row, a ragged second row, three blocks of rows) in both
    orders, with edge words in the elements and the carries and as the
    multiplier (scan_multipliers).  The sum of sets, the gather at a
    ragged row count and the whole quotient scan have tests of their own
    (tests/test_torch_cuda.py).  Raises on any difference; returns
    {kernel: largest word error}."""
    errs = {}

    def note(name, what, got, want, cmp=compare):
        errs[name] = max(errs.get(name, 0), cmp(what, got, want))

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
    leaves_s = cuda_gather.gather_rows_plain(table_s, idx_s)
    for name, kernel, plain, args in (
            ("fused_scan", cuda_scan.fused_scan_msm,
             cuda_scan.fused_scan_msm_plain, (table_s, idx_s)),
            ("madd_scan", cuda_scan.madd_scan, cuda_scan.madd_scan_plain,
             (leaves_s,))):
        for fast in (False, True):
            got, gerr = kernel(*args, fast)
            want, werr = plain(*args, fast)
            note(name, f"{name} fast={fast}", got, want)
            if fast:
                note(name, f"{name} flag", gerr, werr)
                if not all(bool(werr[i]) for i in (1, 2, 4)):
                    raise AssertionError(f"fast {name} did not flag the "
                                         f"planted collisions")

    totals, ps, cnt, r_of = tree_inputs(dev)
    for what, t in (("", totals), (" (rows 5)", totals[:, :, :5]),
                    (" (word stride 2 W rows)",
                     torch.stack([totals.flip(2), totals], dim=1)[:, 1])):
        note("row_offsets", "row_offsets" + what, cuda_tree.row_offsets(t),
             cuda_tree.row_offsets_plain(t), compare_points)
    offs = cuda_tree.row_offsets(totals)
    for what, o, r in (("", offs, r_of),
                       (" (one row)", None, torch.zeros_like(r_of))):
        note("window_fold", "window_fold" + what,
             cuda_tree.window_fold(ps, cnt, r, o),
             cuda_tree.window_fold_plain(ps, cnt, r, o), compare_points)

    table = torch.cat([leaf.T, acc[:24].T]).contiguous()   # (8192, 24)
    g = torch.Generator(device="cpu").manual_seed(5)
    idx = torch.randint(0, table.shape[0] + 1, (20, 2048), generator=g)
    idx[0, :4] = table.shape[0]                            # the zero row
    idx = idx.to(dev)
    note("gather_rows", "gather_rows", cuda_gather.gather_rows(table, idx),
         cuda_gather.gather_rows_plain(table, idx))

    # the 2n-point transform's batches, and the wider half of the prover's
    # 2^23-point squaring at n = 2^22: 2048 transforms of 4096 points (128
    # KB of shared memory, one block an SM)
    for x in (field_inputs(dev, 1 << 12, 6).repeat(1, 32).reshape(8, 64,
                                                                   2048),
              field_inputs(dev, 1 << 16, 14).repeat(1, 128).reshape(
                  8, 2048, 4096)):
        for inverse in (False, True):
            tw = N.local_twiddles(x.shape[2], inverse, dev)
            note("ntt_local", f"ntt_local {tuple(x.shape)} inverse="
                 f"{inverse}", N.ntt_local_kernel(x, tw),
                 plain_ntt_local(x, tw))
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
    return errs


# -- golden proofs ------------------------------------------------------------

def _fixture(name: str) -> dict:
    with open(os.path.join(FIXTURES, name)) as fh:
        return json.load(fh)


def golden(dev) -> None:
    """DummyCircuit, Rng(1234), a = 5, b = 7 through the port's setup and
    prove on ``dev`` for all three transcripts: the VK and proof bytes of
    tests/fixtures/golden_dummy.json, verified."""
    from polymath_tpu_torch.circuits import DummyCircuit
    from polymath_tpu_torch.hostmath.bls12_381 import R
    from polymath_tpu_torch.protocol import Polymath, Rng
    from polymath_tpu_torch.transcript import ALL_TRANSCRIPTS
    fixture = _fixture("golden_dummy.json")
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


class KeyedCase:
    """A circuit's key set up on ``dev`` (Merlin), the setup's launches,
    the Rng state each prove starts from a copy of, and the public input.
    ``circuit(witness=False)`` is what setup is given; ``circuit()`` is
    proved."""

    def __init__(self, dev, circuit, public: int, rng):
        from polymath_tpu_torch.protocol import Polymath
        self.dev, self.circuit, self.public, self.rng = dev, circuit, \
            public, rng
        before = launches()
        self.pk, self.vk = Polymath(device=dev).setup(circuit(witness=False),
                                                      rng)
        after = launches()
        self.setup_launches = {k: after[k] - before[k] for k in after}

    def prove(self, transcript=None, **env):
        """One prove from a copy of the post-setup Rng with the environment
        ``env`` set: (proof, {kernel: launches}, MSMs of more than one
        chunk, {phase: {kernel: launches}})."""
        from polymath_tpu_torch.protocol import Polymath
        from polymath_tpu_torch.utils.config import device_sync, environ
        pm = Polymath(transcript or MerlinFieldTranscript, device=self.dev)
        before, multi0 = launches(), M.RUNS["multi_chunk"]
        with environ(**env), launches_by_phase() as phases:
            proof = pm.prove(self.pk, self.circuit(), copy.deepcopy(self.rng))
            device_sync()
        after = launches()
        return (proof, {k: after[k] - before[k] for k in after},
                M.RUNS["multi_chunk"] - multi0, phases)

    def verify(self, proof, transcript=None, public=None) -> bool:
        from polymath_tpu_torch.protocol import Polymath
        pm = Polymath(transcript or MerlinFieldTranscript, device=self.dev)
        return pm.verify(self.vk, [self.public if public is None else public],
                         proof)


class GoldenMiMC(KeyedCase):
    """The reduced MiMC recipe of tests/fixtures/golden_mimc.json set up
    on ``dev``; its VK must be the fixture's."""

    def __init__(self, dev):
        from polymath_tpu_torch.circuits import MiMCDemo
        from polymath_tpu_torch.circuits.mimc import mimc_hash
        from polymath_tpu_torch.hostmath.bls12_381 import R
        from polymath_tpu_torch.protocol import Rng
        self.fixture = _fixture("golden_mimc.json")
        recipe = self.fixture["recipe"]
        crng = random.Random(recipe["constants_seed"])
        consts = [crng.randrange(R) for _ in range(recipe["rounds"])]
        rng = Rng(recipe["rng_seed"])
        xl, xr = rng.randrange(R), rng.randrange(R)
        image = int(self.fixture["image"], 16)
        if mimc_hash(xl, xr, consts) != image:
            raise AssertionError("the recipe's MiMC image differs from the "
                                 "fixture's")

        def circuit(witness=True):
            return MiMCDemo(xl, xr, consts) if witness else \
                MiMCDemo(constants=consts)
        super().__init__(dev, circuit, image, rng)
        if self.vk.to_bytes().hex() != self.fixture["vk"]:
            raise AssertionError("golden MiMC: VerifyingKey bytes differ")


class BenchCase(KeyedCase):
    """BenchCircuit at ``constraints`` constraints, from the setup Rng of
    parallel/dryrun.py's bench job (the dummy cell's circuit at the bench
    workload's 2^20 - 100)."""

    def __init__(self, dev, constraints: int):
        from polymath_tpu_torch.parallel import dryrun
        circuit, public, rng, _ = dryrun.job_circuit("bench", constraints)
        super().__init__(dev, circuit, public[0], rng)


def golden_multi_chunk(dev) -> list:
    """The reduced MiMC recipe of tests/fixtures/golden_mimc.json through
    the port's setup and prove on ``dev``: the VK must equal the fixture's,
    and every transcript's proof, at each of MULTI_CHUNK_SETTINGS with the
    split and with the fused scan, must equal the JAX host prover's bytes
    and verify; each prove runs all PROVE_MSMS MSMs in more than one
    chunk, the fused ones through fused_scan only, and at chunks of 2
    sum_sets launches more than once for some MSM.  Returns a label for
    each prove."""
    from polymath_tpu_torch.transcript import ALL_TRANSCRIPTS
    case = GoldenMiMC(dev)
    labels = []
    for tr in ALL_TRANSCRIPTS:
        for chunk, tail in MULTI_CHUNK_SETTINGS:
            for scan in ("split", "fused"):
                label = f"{tr.name}, chunk {chunk}, tail {tail}, {scan}"
                proof, fl, multi, _ = case.prove(
                    tr, POLYMATH_MSM_CHUNK=chunk, POLYMATH_MSM_TAIL=tail,
                    POLYMATH_MSM_FUSED="1" if scan == "fused" else "0")
                if proof.to_bytes().hex() != \
                        case.fixture["proofs"][tr.name]:
                    raise AssertionError(f"{label}: proof bytes differ from "
                                         f"the JAX package's")
                if not case.verify(proof, tr):
                    raise AssertionError(f"{label}: proof rejected")
                if multi != PROVE_MSMS:
                    raise AssertionError(f"{label}: {multi} MSMs of more "
                                         f"than one chunk, want "
                                         f"{PROVE_MSMS}")
                ran, idle = (("fused_scan", "madd_scan") if scan == "fused"
                             else ("madd_scan", "fused_scan"))
                if fl[ran] == 0 or fl[idle]:
                    raise AssertionError(f"{label}: {ran} launched "
                                         f"{fl[ran]}, {idle} {fl[idle]}")
                if chunk == "2" and fl["sum_sets"] <= PROVE_MSMS:
                    raise AssertionError(f"{label}: sum_sets launched "
                                         f"{fl['sum_sets']} times, want "
                                         f"more than {PROVE_MSMS}")
                labels.append(label)
    return labels


# -- the launch rules of a prove ----------------------------------------------

@contextlib.contextmanager
def launches_by_phase():
    """{prover phase: {kernel: launches}} of the phases run inside, taken
    through utils/timers.HOOKS."""
    phases = {}

    @contextlib.contextmanager
    def hook(label):
        before = launches()
        try:
            yield
        finally:
            after = launches()
            phases[label] = {k: after[k] - before[k] for k in after
                             if after[k] != before[k]}

    timers.HOOKS.append(hook)
    try:
        yield phases
    finally:
        timers.HOOKS.remove(hook)


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


def check_quotient_launches(phases: dict) -> None:
    """The quotient scan phase launches the scan's reduce and apply
    kernels only, 2 a level and 1 for the top (one more apply than
    reduces), and no fr_mul."""
    fl = phases[QUOTIENT_PHASE]
    red, app = (fl.get(k, 0) for k in QUOTIENT_KERNELS)
    if set(fl) - set(QUOTIENT_KERNELS) or red < 1 or app != red + 1:
        raise AssertionError(f"{QUOTIENT_PHASE} launched {fl}: want only "
                             f"{QUOTIENT_KERNELS}, one more apply than "
                             f"reduces")


# -- a sharded prove ----------------------------------------------------------

def sharded_at_width(mesh, pk) -> None:
    """The rank body of the sharded NTT and MSM at the bench workload's
    widths: ``ntt_sharded`` of SHARDED_NTT_SIZES points both ways, word
    for word against ops/ntt.py:ntt, and ``msm_sharded`` of the first
    SHARDED_MSM_POINTS of ``pk``'s x-power points with random scalars
    against ``msm_device``'s point.  Raises on any difference."""
    from polymath_tpu_torch.ops.prover import get_artifacts
    from polymath_tpu_torch.parallel.msm_sharded import msm_sharded
    from polymath_tpu_torch.parallel.ntt_sharded import (
        columns_of, gather, ntt_sharded)
    dev = mesh.device
    for n in SHARDED_NTT_SIZES:
        a = random_words(dev, n, n)
        for inverse in (False, True):
            compare(f"ntt_sharded n={n} inverse={inverse}",
                    gather(ntt_sharded(columns_of(a, mesh), mesh, inverse),
                           mesh), N.ntt(a, inverse))
    xp = get_artifacts(pk, dev).srs["x_powers_g1"][:SHARDED_MSM_POINTS]
    sc = random_words(dev, SHARDED_MSM_POINTS, 3)
    if msm_sharded(xp, sc, mesh, fast=True) != M.msm_device(xp, sc,
                                                            fast=True):
        raise AssertionError("the sharded MSM's point differs from "
                             "msm_device's")


def sharded_and_split(mesh, pk, circuit, rng, env: dict) -> list:
    """The rank body of a sharded prove: sharded (its first, warm),
    split, sharded, split proves of ``circuit()`` with ``pk`` on ``mesh``,
    Merlin, each from a copy of ``rng`` with the environment ``env`` set:
    for each, (label, proof bytes, launches, MSMs of more than one chunk,
    collective calls)."""
    from polymath_tpu_torch.parallel.mesh import COLLECTIVES, reset_collectives
    from polymath_tpu_torch.parallel.prover_sharded import (
        create_proof_sharded)
    from polymath_tpu_torch.protocol import Polymath
    from polymath_tpu_torch.utils.config import device_sync, environ
    pm = Polymath(MerlinFieldTranscript, device=mesh.device)
    out = []
    for label in ("sharded", "split", "sharded", "split"):
        reset_collectives()
        before, multi0 = launches(), M.RUNS["multi_chunk"]
        with environ(**env):
            if label == "split":
                proof = pm.prove(pk, circuit(), copy.deepcopy(rng))
            else:
                proof = create_proof_sharded(circuit(), pk,
                                             copy.deepcopy(rng),
                                             MerlinFieldTranscript, mesh)
            device_sync()
        after = launches()
        out.append((label, proof.to_bytes(),
                    {k: after[k] - before[k] for k in after},
                    M.RUNS["multi_chunk"] - multi0,
                    {k: v["calls"] for k, v in COLLECTIVES.items()}))
    return out
