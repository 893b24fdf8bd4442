"""The port's CUDA kernels on the card (marker ``cuda``; each test skips
without a CUDA device).  Run on the H100 with
``python -m pytest -m cuda tests/test_torch_cuda.py``.

Every kernel against its plain PyTorch version on the same card inputs,
bit for bit, at the edge-case shapes of chip_smoke.py's phase 2; the MSM
in its fused-scan configuration against the split one; and the golden
DummyCircuit bytes for all three transcripts proved on the card.  None
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
