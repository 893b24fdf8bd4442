"""Device selection for the port's entry points.

The port runs on the card unless the caller asks for the CPU.  There is
no silent fallback: with no CUDA device and no ``device="cpu"``,
``resolve_device`` raises.
"""

from __future__ import annotations

import contextlib
import os

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the first CUDA card; anything else is taken as given
    (``"cpu"`` runs every kernel wrapper's plain version)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "polymath_tpu_torch runs on a CUDA card and none is visible; "
                "pass device='cpu' to run the plain PyTorch versions")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is unavailable")
    return device


def device_sync(x=None):
    """Wait for the card to finish everything queued (a no-op on the CPU).
    Returns its argument."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return x


@contextlib.contextmanager
def environ(**values):
    """Set (a string) or unset (None) environment variables for the block,
    and restore what they were after it."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
