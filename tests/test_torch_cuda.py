"""The port's CUDA kernels on the card (marker ``cuda``; each test skips
without a CUDA device).  Run on the H100 with
``python -m pytest -m cuda tests/test_torch_cuda.py``.

Every kernel against its plain PyTorch version on the same card inputs,
bit for bit, at the edge-case shapes of chip_smoke.py's phase 2; the MSM
in its fused-scan configuration against the split one; the golden
DummyCircuit bytes for all three transcripts proved on the card; and the
measurement tools' kernels (T1 gather variants, T2 primitive chains)
against their plain versions, with T2's SASS holding every step.  None
needs jax: the card machine has none.
"""

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
    assert len(errs) == 10
    assert not any(errs.values())


def test_msm_fused_equals_split_on_the_card(card):
    """One 2^12-point chunk (plus a peeled tail) of distinct points with
    random scalars: the fused scan and the split scan give the same point,
    and each launches only its own scan kernels."""
    from polymath_tpu_torch.hostmath.bls12_381 import R
    from polymath_tpu_torch.ops import cuda_curve, cuda_gather, cuda_scan
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
    assert cuda_scan.LAUNCHES["fused_scan"] == 0
    assert cuda_gather.LAUNCHES["gather_rows"] == 1
    chip_smoke.reset_launches()
    fused = M.msm_device(rows, sc, chunk=1 << 12, fused=True)
    assert cuda_scan.LAUNCHES["fused_scan"] == 1
    assert cuda_gather.LAUNCHES["gather_rows"] == 0
    assert cuda_curve.LAUNCHES["jac_madd"] == 0
    assert fused == split == g1_msm(pts, vals)


def test_golden_dummy_bytes_on_the_card(card):
    chip_smoke.golden(card)


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
