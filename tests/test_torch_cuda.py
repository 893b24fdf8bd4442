"""The port's CUDA kernels on the card (marker ``cuda``; each test skips
without a CUDA device).  Run on the H100 with
``python -m pytest -m cuda tests/test_torch_cuda.py``.

Every kernel against its plain PyTorch version on the same card inputs,
bit for bit, at the edge-case shapes of chip_smoke.py's phase 2, and the
golden DummyCircuit bytes for all three transcripts proved on the card.
Neither needs jax: the card machine has none.
"""

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
    assert set(errs) == set(chip_smoke.PROVE_KERNELS +
                            chip_smoke.SETUP_KERNELS)
    assert not any(errs.values())


def test_golden_dummy_bytes_on_the_card(card):
    chip_smoke.golden(card)
