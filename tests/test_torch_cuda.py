"""The port's checks on the card (marker ``cuda``; each test skips
without a CUDA device).  Run on the H100 with
``python -m pytest -m cuda tests/``.

Every kernel source's ptxas report without a spill; every kernel against
its plain PyTorch version on the same card inputs, bit for bit (the tree
kernels, which add in another order, as affine points), at edge-case
shapes (tests/torch_cases.py:check_kernels), at the main path's shapes
(``python3 -m polymath_tpu_torch.tools.kernel_table``, which also times
them) and, for the one-launch madd scan and the tree kernels, at the
shapes of the CPU tests (tests/test_torch_tree.py); the quotient scan's
two kernels chained over their levels against the recurrence they
replaced; the MSM in its fused-scan configuration against the split one,
each through its own launches; the golden DummyCircuit bytes for all
three transcripts proved on the card, and the golden reduced-MiMC bytes
with every MSM in more than one chunk; the launch rules of a split and of
a fused prove whose MSMs run in several chunks, on the golden MiMC and on
the bench workload (BenchCircuit, n = 2^21) at the main path's MSM
defaults; a key written by ``keys.save_dir`` and read back by
``keys.load_dir`` on the card proving to the bytes of the key it came
from; the sharded NTT, MSM and prove (parallel/) on one NCCL rank against
the single-device results, at small sizes and at the bench workload's,
and a kernel operand off the current card refused; the NTT past 2^22
points (2^23, 2^24) and its 4096-point local kernel; the measurement
tools' kernels (T1 gather variants, T2 primitive chains) against their
plain versions, with T2's SASS holding every step; and the prover's
assignment upload through its reused pinned buffer.  None needs jax: the
card machine has none.
"""

import copy
import random
import re

import pytest
import torch

import torch_cases as TC
from polymath_tpu_torch.tools import cases

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_no_kernel_spills(card):
    """Every CUDA source's ptxas report, read from the file its build left
    beside the library (so a library built earlier is checked too), lists
    its kernels' registers and no spill."""
    from polymath_tpu_torch.ops import _build
    _build.build_all()
    for name in _build.SOURCES:
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill",
                            _build.ptxas_report(name))
        assert spills, f"{name}.cu: the ptxas report lists no kernel"
        assert all(a == b == "0" for a, b in spills), (name, spills)


def test_kernels_match_plain_versions(card):
    """Every kernel but sum_sets, which test_sum_sets_matches_plain_version
    holds at the same numbers of sets."""
    errs = TC.check_kernels(card)
    assert set(errs) == set(TC.ALL_KERNELS) - {"sum_sets"}
    assert len(errs) == 15
    assert not any(errs.values())


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("seq, windows, rows", [(5, 2, 3), (8, 3, 4),
                                                (256, 2, 100)])
def test_madd_scan_matches_plain_version(card, seq, windows, rows, fast):
    """Gathered leaves of k G (k < 200, about a fifth dead), lane 1 with a
    repeated leaf: every prefix and the flag bit for bit."""
    from polymath_tpu_torch.ops import cuda_gather, cuda_scan
    from polymath_tpu_torch.ops.curve import points_to_device
    table = points_to_device(cases.host_points(200)).T.contiguous()
    g = torch.Generator().manual_seed(seq * rows)
    idx = torch.randint(0, 250, (seq, windows * rows), generator=g)
    idx[:2, 1] = 7
    leaves = cuda_gather.gather_rows_plain(
        table, idx.clamp(max=200).reshape(seq, windows, rows)).to(card)
    got, gerr = cuda_scan.madd_scan(leaves, fast)
    want, werr = cuda_scan.madd_scan_plain(leaves, fast)
    assert torch.equal(got, want)
    if fast:
        assert torch.equal(gerr, werr) and bool(gerr[1])


@pytest.mark.parametrize("n", [1, 65, 128 * 64 + 17, 300_000])
def test_quotient_scan_matches_plain_version(card, n):
    """The quotient scan's two kernels chained over their levels (ops/
    poly.py:affine_scan), forward and reversed, against the blocked fr_mul /
    fr_add recurrence they replaced, word for word, with edge words in the
    elements and as the multiplier; one more apply launch than reduces."""
    from polymath_tpu_torch.ops import cuda_poly, poly
    from polymath_tpu_torch.ops.field import fr_const
    x = cases.field_inputs(card, n, n)
    levels = len(poly.plan_levels(n, 1))
    for mult in cases.scan_multipliers(n):
        m = fr_const(mult, card)
        for rev in (False, True):
            cases.reset_launches()
            got = poly.affine_scan(x, m, rev)
            assert cuda_poly.LAUNCHES == {"affine_scan_reduce": levels - 1,
                                          "affine_scan_apply": levels}
            assert torch.equal(got, cases.plain_scan(x, m, rev))


@pytest.mark.parametrize("windows, rows, n", [(3, 6, 16), (3, 8, 16),
                                              (2, 5, 13), (2, 1, 7),
                                              (3, 300, 1000), (20, 2048, 600)])
def test_tree_kernels_match_plain_versions(card, windows, rows, n):
    """torch_cases.tree_case's inputs, as affine points: the CPU tests'
    shapes, and shapes with several segments of rows and several fold
    blocks a window."""
    from polymath_tpu_torch.ops import cuda_tree
    from polymath_tpu_torch.ops import msm as M
    totals, ps, cnt, r_of = TC.tree_inputs(card, windows, rows, n, rows + n)
    cases.reset_launches()
    offs = M.row_offsets(totals[:, None])
    wsum = cuda_tree.window_fold(ps, cnt, r_of, offs)
    if rows == 1:
        assert offs is None
    else:
        cases.compare_points("row_offsets", offs,
                             cuda_tree.row_offsets_plain(totals))
    cases.compare_points("window_fold", wsum, cuda_tree.window_fold_plain(
        ps, cnt, r_of, offs))
    # more than 2 rows a thread of one block: a carry pass joins segments
    assert cuda_tree.LAUNCHES == {
        "row_offsets": 0 if rows == 1 else 1 + int(rows > 2 * 128),
        "window_fold": 1, "sum_sets": 0}


@pytest.mark.parametrize("k", [1, 2, 3, 4, 40, 130])
def test_sum_sets_matches_plain_version(card, k):
    """cases.sum_sets_case's sets at the prover's 20 windows (the
    identity, P + P, P + (-P) and a repeated point planted), as affine
    points against the serial sum; 130 sets take two launches."""
    from polymath_tpu_torch.ops import cuda_tree
    parts, _ = cases.sum_sets_inputs(card, k, 20, 300 + k)
    cases.reset_launches()
    got = cuda_tree.sum_sets(parts)
    assert cuda_tree.LAUNCHES["sum_sets"] == len(cuda_tree.sum_levels(k))
    cases.compare_points("sum_sets", got, cuda_tree.sum_sets_plain(parts))


def test_msm_fused_equals_split_on_the_card(card):
    """One 2^12-point chunk (plus a peeled tail) of distinct points with
    random scalars: the fused scan and the split scan give the same point,
    and each launches only its own scan kernel, then the two tree kernels
    once each (2^8 thresholds: one fold launch)."""
    from polymath_tpu_torch.hostmath.bls12_381 import R
    from polymath_tpu_torch.ops import cuda_curve, cuda_gather, cuda_scan
    from polymath_tpu_torch.ops import cuda_tree
    from polymath_tpu_torch.ops import msm as M
    from polymath_tpu_torch.ops.curve import points_to_device
    from polymath_tpu_torch.ops.limbs import FR_SPEC, ints_to_words
    from polymath_tpu_torch.native import g1_msm
    n = (1 << 12) + 9
    pts = cases.host_points(n)
    rng = random.Random(4)
    vals = [rng.randrange(R) for _ in range(n)]
    rows = points_to_device(pts).T.contiguous().to(card)
    sc = torch.from_numpy(ints_to_words(vals, FR_SPEC.L)).to(card)
    cases.reset_launches()
    split = M.msm_device(rows, sc, chunk=1 << 12, fused=False)
    assert cuda_scan.LAUNCHES == {"madd_scan": 1, "fused_scan": 0}
    assert cuda_gather.LAUNCHES["gather_rows"] == 1
    assert cuda_curve.LAUNCHES["jac_madd"] == 0
    assert cuda_tree.LAUNCHES == {"row_offsets": 1, "window_fold": 1,
                                  "sum_sets": 0}
    cases.reset_launches()
    fused = M.msm_device(rows, sc, chunk=1 << 12, fused=True)
    assert cuda_scan.LAUNCHES == {"madd_scan": 0, "fused_scan": 1}
    assert cuda_gather.LAUNCHES["gather_rows"] == 0
    assert cuda_curve.LAUNCHES["jac_madd"] == 0
    assert cuda_tree.LAUNCHES == {"row_offsets": 1, "window_fold": 1,
                                  "sum_sets": 0}
    assert fused == split == g1_msm(pts, vals)


def test_golden_dummy_bytes_on_the_card(card):
    TC.golden(card)


def test_golden_multi_chunk_proofs_on_the_card(card):
    """The reduced MiMC proofs of tests/fixtures/golden_mimc.json, proved
    on the card with every MSM in more than one chunk (chunk 8, tail on
    and off; chunk 2, where sum_sets takes more than one level), split and
    fused, for all three transcripts, equal the JAX package's bytes."""
    assert len(TC.golden_multi_chunk(card)) == 18


#: the bench workload's BenchCircuit: 2^20 - 100 constraints, n = 2^21
BENCH_CONSTRAINTS = (1 << 20) - 100
#: each keyed case's MSM settings: the golden MiMC and the small BenchCircuit
#: with every MSM in more than one chunk and sum_sets in one level; the
#: bench workload at the main path's defaults, where every MSM runs in
#: more than one chunk too
SETTINGS = {
    "golden_mimc": {"POLYMATH_MSM_CHUNK": "8", "POLYMATH_MSM_TAIL": "0"},
    "small_bench": {"POLYMATH_MSM_CHUNK": "1024", "POLYMATH_MSM_TAIL": "0"},
    "bench": TC.MSM_DEFAULTS}


@pytest.fixture(scope="module")
def golden_mimc(card):
    return TC.GoldenMiMC(card)


@pytest.fixture(scope="module")
def small_bench(card):
    """BenchCircuit at 2,000 constraints: n = 4096, where every transform
    takes the Bailey split, as at the bench workload's n."""
    return TC.BenchCase(card, 2000)


@pytest.fixture(scope="module")
def bench(card):
    """BenchCircuit at the bench workload's size, set up on the card and
    proved once (a warm prove)."""
    case = TC.BenchCase(card, BENCH_CONSTRAINTS)
    assert case.vk.n == 1 << 21
    case.prove(**SETTINGS["bench"])
    return case


@pytest.mark.parametrize("scan", ["split", "fused"])
@pytest.mark.parametrize("which", ["golden_mimc", "bench"])
def test_prove_launches_follow_the_msm_rules(request, which, scan):
    """One prove whose five MSMs each run in several chunks (the golden
    MiMC at chunks of 8, the bench workload at the defaults): every prove
    kernel launches (setup launches to_affine and jac_add); one scan
    launch a chunk, the split scan with one gather a chunk and the fused
    one with none, no per-step madd, at most 3 tree launches a chunk, no
    jac_add and one sum_sets an MSM; the quotient scan phase launches only
    its reduce and apply kernels.  The fused proof is the split proof's
    bytes (the golden MiMC's, the JAX package's), verifies, and a wrong
    public input is refused."""
    case = request.getfixturevalue(which)
    assert all(case.setup_launches[k] > 0 for k in TC.SETUP_KERNELS)
    split = case.prove(POLYMATH_MSM_FUSED="0", **SETTINGS[which])
    proof, fl, multi, phases = split if scan == "split" else case.prove(
        POLYMATH_MSM_FUSED="1", **SETTINGS[which])
    assert multi == TC.PROVE_MSMS
    ran = "madd_scan" if scan == "split" else "fused_scan"
    TC.check_msm_launches(fl, ran, multi)
    TC.check_quotient_launches(phases)
    kernels = TC.PROVE_KERNELS if scan == "split" else [
        k for k in TC.PROVE_KERNELS + TC.FUSED_KERNELS
        if k not in TC.SPLIT_ONLY]
    assert [k for k in kernels if fl[k] == 0] == []
    if scan == "split":
        assert fl["fused_scan"] == 0
    else:
        assert all(fl[k] == 0 for k in TC.SPLIT_ONLY)
        assert fl["fused_scan"] == split[1]["gather_rows"]
    assert proof.to_bytes() == split[0].to_bytes()
    if which == "golden_mimc":
        assert proof.to_bytes().hex() == case.fixture["proofs"]["merlin"]
    assert case.verify(proof)
    assert not case.verify(proof, public=case.public + 1)


def test_key_store_round_trip_on_the_card(card, tmp_path):
    """DummyCircuit, Rng(1234): the card's key through save_dir and
    load_dir keeps its vk and SRS rows and proves to the same bytes."""
    from polymath_tpu_torch.circuits import DummyCircuit
    from polymath_tpu_torch.protocol import Polymath, Rng, keys
    from polymath_tpu_torch.transcript import MerlinFieldTranscript
    rng = Rng(1234)
    pm = Polymath(transcript=MerlinFieldTranscript, device=card)
    pk, vk = pm.setup(DummyCircuit(), rng)
    keys.save_dir(pk, str(tmp_path / "pk"))
    loaded = keys.load_dir(str(tmp_path / "pk"), card)
    assert loaded.vk.to_bytes() == vk.to_bytes()
    for name, rows in pk.device["srs"].items():
        assert torch.equal(loaded.device["srs"][name], rows)
    want = pm.prove(pk, DummyCircuit(5, 7), copy.deepcopy(rng))
    got = pm.prove(loaded, DummyCircuit(5, 7), copy.deepcopy(rng))
    assert got.to_bytes() == want.to_bytes()
    assert pm.verify(vk, [35], got)


@pytest.mark.parametrize("row", range(9))
def test_primbench_rows_match_plain_versions(card, row):
    """Bit for bit, the fused f32 row at rtol 1e-4, on the tool's constant
    input and a random one."""
    from polymath_tpu_torch.tools import primbench as PB
    for seed in (None, row + 1):
        x = PB.make_input(row, card, seed)
        PB.max_error(row, PB.chain(row, x), PB.chain_plain(row, x))


def test_primbench_sass_keeps_every_step(card):
    from polymath_tpu_torch.ops import _build
    from polymath_tpu_torch.tools import primbench as PB
    _build.lib("primbench")
    PB.check_sass(PB.sass_counts())


@pytest.mark.parametrize("variant", range(6))
def test_gather_variants_match_plain_versions(card, variant):
    """A 2^14-point table (t4 >= 4096 for the noidx probe), 2^15 rows, with
    indices outside the table planted."""
    from polymath_tpu_torch.tools import pgather_variants as GV
    v = GV.VARIANTS[variant]
    quad, idx = GV.make_inputs(1 << 14, 2, seed=5, device=card)
    idx[:3] = torch.tensor([-1, 4 * quad.shape[0], 4 * quad.shape[0] - 1])
    assert GV.mismatches(GV.gather_variant(v, quad, idx),
                         GV.gather_variant_plain(v, quad, idx)) == 0


def test_gather_rows_ragged_with_out_of_range_indices(card):
    """B4 at a row count that no block of rows divides, with the
    sentinel T and indices outside the table in both directions."""
    from polymath_tpu_torch.ops import cuda_gather
    from polymath_tpu_torch.ops.curve import points_to_device
    table = points_to_device(cases.host_points(300)).T.contiguous()
    t = table.shape[0]
    g = torch.Generator().manual_seed(2)
    idx = torch.randint(-20, t + 20, (3, 1001), generator=g)
    idx[0, :4] = torch.tensor([t, -1, 1 << 40, -(1 << 40)])
    table, idx = table.to(card), idx.to(card)
    got = cuda_gather.gather_rows(table, idx)
    assert torch.equal(got, cuda_gather.gather_rows_plain(table, idx))
    assert not bool(got[:, 0, :2].any()) and bool(got[:, 1].any())


@pytest.mark.parametrize("log_n", [23, 24])
def test_ntt_round_trip_past_2_to_the_22(card, log_n):
    """The local kernel at 4096 points (128 KB of shared memory) against its
    plain version, and transforms of 2^23 and 2^24 points: the inverse
    gives back the input, and sampled outputs are the polynomial's values
    at those powers of the root."""
    from polymath_tpu_torch.hostmath.bls12_381 import R
    from polymath_tpu_torch.ops import ntt as N
    from polymath_tpu_torch.ops.field import fr_const, fr_to_mont
    from polymath_tpu_torch.ops.prover import mont_to_int
    gen = torch.Generator().manual_seed(log_n)

    def fr_words(count):
        w = torch.randint(-2 ** 31, 2 ** 31, (8, count), generator=gen,
                          dtype=torch.int64)
        w[7] &= 0x3FFFFFFF                  # canonical: below 2^254 < r
        return fr_to_mont(w.to(torch.int32).to(card))

    x = fr_words(3 * N.MAX_WIDE).reshape(8, 3, N.MAX_WIDE)
    tw = N.local_twiddles(N.MAX_WIDE, False, card)
    assert torch.equal(N.ntt_local_kernel(x, tw).cpu(),
                       N.ntt_local_kernel(x.cpu(), tw.cpu()))
    n = 1 << log_n
    a = fr_words(n)
    ev = N.ntt(a)
    assert torch.equal(N.ntt(ev, inverse=True), a)
    omega = N.domain_omega(n)
    for k in (1, 4097, n - 3):
        at = N.poly_eval_device(a, fr_const(pow(omega, k, R), card))
        assert mont_to_int(ev[:, k:k + 1]) == mont_to_int(at), k


def test_sharded_ntt_and_msm_on_one_nccl_rank(card):
    """parallel/ on one NCCL rank in this process: the sharded NTT both
    ways and the stage-1 chain at n = 4096 against ops/ntt.py on the card,
    word for word; the sharded MSM of 300 points in chunks of 64 (fast,
    rerun safe on a collision flag), the host tail on and off, against
    msm_device's point on the card."""
    import numpy as np
    from polymath_tpu_torch.hostmath.bls12_381 import R
    from polymath_tpu_torch.ops import msm as M
    from polymath_tpu_torch.ops.curve import points_to_device
    from polymath_tpu_torch.ops.limbs import FR_SPEC, ints_to_words
    from polymath_tpu_torch.ops.ntt import ntt
    from polymath_tpu_torch.ops.prover import LocalOps, fr_ints_to_mont_device
    from polymath_tpu_torch.parallel import dryrun, launch
    from polymath_tpu_torch.utils.config import environ
    rng = random.Random(8)
    coeffs = [rng.randrange(R) for _ in range(4096)]
    pts = cases.host_points(300)
    vals = [rng.randrange(R) for _ in pts]
    rows = points_to_device(pts).T.contiguous().numpy()
    words = ints_to_words(vals, FR_SPEC.L)
    calls = [(dryrun.transforms, (coeffs,), {})]
    calls += [(dryrun.msm, (rows, words, True), {
        "POLYMATH_MSM_CHUNK": "64", "POLYMATH_MSM_TAIL": tail})
        for tail in ("1", "0")]
    got = launch.run_ranks(dryrun.steps, 1, "cuda", 120, calls)[0]
    a = fr_ints_to_mont_device(coeffs, card)
    local = LocalOps(card)
    want = {"forward": ntt(a), "inverse": ntt(a, inverse=True), "back": a,
            "chain": local.square(local.coeffs(a))}
    for k, w in want.items():
        assert np.array_equal(got[0][k], w.cpu().numpy()), k
    # k G for k = 1..300: a bucket's running sum can meet its next leaf,
    # so the fast form may flag a collision; both then rerun safe, and at
    # one rank in the same chunks they flag alike
    rows_t = torch.from_numpy(rows).to(card)
    words_t = torch.from_numpy(words).to(card)
    for res, (_, _, env) in zip(got[1:], calls[1:]):
        with environ(**env):
            try:
                one, rerun = M.msm_device(rows_t, words_t, fast=True), False
            except AssertionError:
                one, rerun = M.msm_device(rows_t, words_t), True
        assert res == {"point": dryrun.point_ints(one), "rerun": rerun}


@pytest.mark.parametrize("which", ["small_bench", "bench"])
def test_sharded_prove_on_one_nccl_rank(request, which):
    """The case's key proved by parallel/prover_sharded.py on one NCCL
    rank, in turns with the single-device prover, every MSM in several
    chunks (the small BenchCircuit at chunks of 1024, the bench workload
    at the defaults): every proof has the single-device bytes and
    verifies, a wrong public input is refused; a sharded proof makes 11
    all_to_all, 9 all_gather and 1 broadcast, a split one none; a steady
    sharded prove launches every prove kernel, as often as a split prove
    does, and meets its MSM rule (one rank adds no sum of the ranks'
    sums)."""
    from polymath_tpu_torch.parallel import launch
    from polymath_tpu_torch.protocol import Proof
    case = request.getfixturevalue(which)
    env = {**SETTINGS[which], "POLYMATH_MSM_FUSED": "0"}
    runs = launch.run_ranks(TC.sharded_and_split, 1, "cuda", 120, case.pk,
                            case.circuit, case.rng, env)[0]
    assert [r[0] for r in runs] == ["sharded", "split", "sharded", "split"]
    for label, proof, _, _, calls in runs:
        assert proof == runs[1][1], label
        assert calls == (TC.SHARDED_COLLECTIVES if label == "sharded" else
                         dict.fromkeys(TC.SHARDED_COLLECTIVES, 0)), label
    proof = Proof.from_bytes(runs[1][1])
    assert case.verify(proof)
    assert not case.verify(proof, public=case.public + 1)
    _, _, steady, multi, _ = runs[2]
    assert multi == TC.PROVE_MSMS
    assert steady == runs[1][2] == runs[3][2]
    assert [k for k in TC.PROVE_KERNELS if steady[k] == 0] == []
    TC.check_msm_launches(steady, "madd_scan", multi)


def test_sharded_ntt_and_msm_at_the_bench_width(bench):
    """On one NCCL rank: the sharded NTT of 2^21 and 2^22 points both ways
    against ops/ntt.py, word for word, and the sharded MSM over 2^21 of
    the bench key's points against msm_device's point."""
    from polymath_tpu_torch.parallel import launch
    launch.run_ranks(TC.sharded_at_width, 1, "cuda", 120, bench.pk)


def test_kernel_table_matches_plain_versions(card):
    """python3 -m polymath_tpu_torch.tools.kernel_table on the card: every
    kernel at the main path's shapes (the (8, 2^22) Fr vectors, the 2^19
    -point MSM chunk, the 2^22- and 2^23-point NTTs' local batches, the
    20,971,543-element quotient scan) and T1 and T2 at their tools'
    defaults equal their plain versions, bit for bit but for T2's fused
    f32 row (cases.compare raises on a difference); every kernel of the
    port has a row."""
    from polymath_tpu_torch.tools import kernel_table
    from polymath_tpu_torch.tools import pgather_variants as GV
    from polymath_tpu_torch.tools import primbench as PB
    rows = kernel_table.main(["--device", "cuda"])["kernels"]
    assert len(rows) == 21 + len(GV.VARIANTS) + len(PB.NAMES)
    assert set(TC.ALL_KERNELS) <= {name.split(" ")[0] for name in rows}
    assert all(r["max_abs_err"] == 0 or
               r.get("compared") == f"rtol {PB.F32_RTOL}"
               for r in rows.values() if "max_abs_err" in r)


def test_operand_off_the_current_card_raises(card, monkeypatch):
    """A rank whose current device is not its tensors' card (it skipped
    torch.cuda.set_device) gets an error from every kernel wrapper, not a
    launch on the wrong context."""
    from polymath_tpu_torch.ops.cuda_field import fr_mul
    x = cases.field_inputs(card, 64, 1)
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: x.device.index + 1)
    with pytest.raises(RuntimeError, match="current device is cuda:"):
        fr_mul(x, x)


def test_upload_words_reuses_its_pinned_buffer(card):
    """The prover's assignment upload: four assignments of one column count
    packed in turn into one pinned buffer, each copied without blocking and
    the buffer rewritten only after that copy: every upload equals its
    words packed afresh."""
    from polymath_tpu_torch.hostmath.bls12_381 import R
    from polymath_tpu_torch.ops.prover import fr_words, upload_words
    rng = random.Random(17)
    staging = {}
    got, want = [], []
    for k in range(4):
        lists = ([1, rng.randrange(R)],
                 [rng.randrange(R) for _ in range(1 << 20)] + [R + k, -k])
        got.append(upload_words(lists, card, staging))
        want.append(fr_words(lists))
    ((n, (buf, _)),) = staging.items()
    assert n == 2 + (1 << 20) + 2 and buf.is_pinned()
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and torch.equal(g.cpu(), w)
