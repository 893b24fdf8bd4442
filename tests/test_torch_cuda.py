"""The port's CUDA kernels on the card (marker ``cuda``; each test skips
without a CUDA device).  Run on the H100 with
``python -m pytest -m cuda tests/test_torch_cuda.py``.

Every kernel against its plain PyTorch version on the same card inputs,
bit for bit (the tree kernels, which add in another order, as affine
points), at the edge-case shapes of chip_smoke.py's phase 2 and, for the
one-launch madd scan and the tree kernels, at the shapes of the CPU tests
(tests/test_torch_tree.py); the quotient scan's two kernels chained
over their levels against the recurrence they replaced; the MSM in its
fused-scan configuration against the split one, each through its own
launches; the golden DummyCircuit bytes for all three transcripts proved
on the card, and the golden reduced-MiMC bytes with every MSM in more
than one chunk (chip_smoke.py phase 3b); a key written by ``keys.save_dir`` and read back by
``keys.load_dir`` on the card proving to the bytes of the key it came
from; the sharded NTT and MSM (parallel/) on one NCCL rank against the
single-device results, and a kernel operand off the current card
refused; and the measurement tools' kernels (T1 gather variants, T2
primitive chains) against their plain versions, with T2's SASS holding
every step.  None needs jax: the card machine has none.
"""

import copy
import random

import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_kernels_match_plain_versions(card):
    errs = chip_smoke.check_kernels(card)
    assert set(errs) == set(chip_smoke.ALL_KERNELS)
    assert len(errs) == 16
    assert not any(errs.values())


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("seq, windows, rows", [(5, 2, 3), (8, 3, 4),
                                                (256, 2, 100)])
def test_madd_scan_matches_plain_version(card, seq, windows, rows, fast):
    """Gathered leaves of k G (k < 200, about a fifth dead), lane 1 with a
    repeated leaf: every prefix and the flag bit for bit."""
    from polymath_tpu_torch.ops import cuda_gather, cuda_scan
    from polymath_tpu_torch.ops.curve import points_to_device
    table = points_to_device(chip_smoke.host_points(200)).T.contiguous()
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
    x = chip_smoke.field_inputs(card, n, n)
    levels = len(poly.plan_levels(n, 1))
    for mult in chip_smoke.scan_multipliers(n):
        m = fr_const(mult, card)
        for rev in (False, True):
            chip_smoke.reset_launches()
            got = poly.affine_scan(x, m, rev)
            assert cuda_poly.LAUNCHES == {"affine_scan_reduce": levels - 1,
                                          "affine_scan_apply": levels}
            assert torch.equal(got, chip_smoke.plain_scan(x, m, rev))


@pytest.mark.parametrize("windows, rows, n", [(3, 6, 16), (3, 8, 16),
                                              (2, 5, 13), (2, 1, 7),
                                              (3, 300, 1000), (20, 2048, 600)])
def test_tree_kernels_match_plain_versions(card, windows, rows, n):
    """chip_smoke.tree_case's inputs, as affine points: the CPU tests'
    shapes, and shapes with several segments of rows and several fold
    blocks a window."""
    from polymath_tpu_torch.ops import cuda_tree
    from polymath_tpu_torch.ops import msm as M
    totals, ps, cnt, r_of = chip_smoke.tree_inputs(card, windows, rows, n,
                                                   rows + n)
    chip_smoke.reset_launches()
    offs = M.row_offsets(totals[:, None])
    wsum = cuda_tree.window_fold(ps, cnt, r_of, offs)
    if rows == 1:
        assert offs is None
    else:
        chip_smoke.compare_points("row_offsets", offs,
                                  cuda_tree.row_offsets_plain(totals))
    chip_smoke.compare_points("window_fold", wsum, cuda_tree.window_fold_plain(
        ps, cnt, r_of, offs))
    # more than 2 rows a thread of one block: a carry pass joins segments
    assert cuda_tree.LAUNCHES == {
        "row_offsets": 0 if rows == 1 else 1 + int(rows > 2 * 128),
        "window_fold": 1, "sum_sets": 0}


@pytest.mark.parametrize("k", [1, 2, 3, 4, 40, 130])
def test_sum_sets_matches_plain_version(card, k):
    """chip_smoke.sum_sets_case's sets at the prover's 20 windows (the
    identity, P + P, P + (-P) and a repeated point planted), as affine
    points against the serial sum; 130 sets take two launches."""
    from polymath_tpu_torch.ops import cuda_tree
    parts, _ = chip_smoke.sum_sets_inputs(card, k, 20, 300 + k)
    chip_smoke.reset_launches()
    got = cuda_tree.sum_sets(parts)
    assert cuda_tree.LAUNCHES["sum_sets"] == len(cuda_tree.sum_levels(k))
    chip_smoke.compare_points("sum_sets", got,
                              cuda_tree.sum_sets_plain(parts))


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
    pts = chip_smoke.host_points(n)
    rng = random.Random(4)
    vals = [rng.randrange(R) for _ in range(n)]
    rows = points_to_device(pts).T.contiguous().to(card)
    sc = torch.from_numpy(ints_to_words(vals, FR_SPEC.L)).to(card)
    chip_smoke.reset_launches()
    split = M.msm_device(rows, sc, chunk=1 << 12, fused=False)
    assert cuda_scan.LAUNCHES == {"madd_scan": 1, "fused_scan": 0}
    assert cuda_gather.LAUNCHES["gather_rows"] == 1
    assert cuda_curve.LAUNCHES["jac_madd"] == 0
    assert cuda_tree.LAUNCHES == {"row_offsets": 1, "window_fold": 1,
                                  "sum_sets": 0}
    chip_smoke.reset_launches()
    fused = M.msm_device(rows, sc, chunk=1 << 12, fused=True)
    assert cuda_scan.LAUNCHES == {"madd_scan": 0, "fused_scan": 1}
    assert cuda_gather.LAUNCHES["gather_rows"] == 0
    assert cuda_curve.LAUNCHES["jac_madd"] == 0
    assert cuda_tree.LAUNCHES == {"row_offsets": 1, "window_fold": 1,
                                  "sum_sets": 0}
    assert fused == split == g1_msm(pts, vals)


def test_golden_dummy_bytes_on_the_card(card):
    chip_smoke.golden(card)


def test_golden_multi_chunk_proofs_on_the_card(card):
    """chip_smoke.py phase 3b: the reduced MiMC proofs of
    tests/fixtures/golden_mimc.json, proved on the card with every MSM in
    more than one chunk (chunk 8, tail on and off; chunk 2, where sum_sets
    takes more than one level), split and fused, for all three
    transcripts, equal the JAX package's bytes."""
    out = chip_smoke.golden_multi_chunk(card)
    assert len(out["proves"]) == 18


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
    table = points_to_device(chip_smoke.host_points(300)).T.contiguous()
    t = table.shape[0]
    g = torch.Generator().manual_seed(2)
    idx = torch.randint(-20, t + 20, (3, 1001), generator=g)
    idx[0, :4] = torch.tensor([t, -1, 1 << 40, -(1 << 40)])
    table, idx = table.to(card), idx.to(card)
    got = cuda_gather.gather_rows(table, idx)
    assert torch.equal(got, cuda_gather.gather_rows_plain(table, idx))
    assert not bool(got[:, 0, :2].any()) and bool(got[:, 1].any())


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
    pts = chip_smoke.host_points(300)
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


def test_operand_off_the_current_card_raises(card, monkeypatch):
    """A rank whose current device is not its tensors' card (it skipped
    torch.cuda.set_device) gets an error from every kernel wrapper, not a
    launch on the wrong context."""
    from polymath_tpu_torch.ops.cuda_field import fr_mul
    x = chip_smoke.field_inputs(card, 64, 1)
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: x.device.index + 1)
    with pytest.raises(RuntimeError, match="current device is cuda:"):
        fr_mul(x, x)
