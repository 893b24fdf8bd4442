"""Device selection for the port's entry points.

The port runs on the card unless the caller asks for the CPU.  There is
no silent fallback: with no CUDA device and no ``device="cpu"``,
``resolve_device`` raises.
"""

from __future__ import annotations

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
