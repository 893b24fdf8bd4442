"""Fr Montgomery product, square and butterfly kernels (counterpart of
pallas_field.py).

``fr_mul``, ``fr_sqr`` and ``fr_butterfly`` take ``(8, ...)`` int32 Fr
words (limbs.py).  On a CUDA tensor they launch ``csrc/field.cu``; on a
CPU tensor they run the plain version (``field.FR`` on 16-bit limbs).  There is no size threshold
and no fallback: a CUDA launch that fails raises.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .field import FR
from .limbs import FR_SPEC, limbs_to_words, words_to_limbs

W = FR_SPEC.W

#: launches per kernel since the last reset (read by the benchmark's
#: launches_per_proof, the card tests and tools/kernel_table.py)
LAUNCHES = {"fr_mul": 0, "fr_sqr": 0, "fr_butterfly": 0}


def _check_dtype(*ts):
    for t in ts:
        if t.dtype != torch.int32:
            raise TypeError(f"Fr words must be int32, got {t.dtype}")


def fr_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise Montgomery product of broadcastable (8, ...) Fr words."""
    _check_dtype(a, b)
    shape = torch.broadcast_shapes(a.shape, b.shape)
    if shape[0] != W:
        raise ValueError(f"Fr words need a leading axis of {W}: {shape}")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return limbs_to_words(FR.mont_mul(words_to_limbs(a),
                                          words_to_limbs(b)))
    if a.device != b.device or a.device.type != "cuda":
        raise ValueError(f"fr_mul operands on {a.device} and {b.device}")
    m = math.prod(shape[1:])
    a2, sa = _build.operand(a, shape, "fr_mul")
    b2, sb = _build.operand(b, shape, "fr_mul")
    out = torch.empty((W, m), dtype=torch.int32, device=a.device)
    fn = _build.declare(_build.lib("field").pm_fr_mul, 10)
    _build.check(fn(a2.data_ptr(), a2.stride(0), sa, b2.data_ptr(),
                    b2.stride(0), sb, out.data_ptr(), m, m,
                    _build.stream(out)), "fr_mul")
    LAUNCHES["fr_mul"] += 1
    return out.reshape(shape)


def fr_sqr(a: torch.Tensor) -> torch.Tensor:
    """Montgomery square of (8, ...) Fr words; equals fr_mul(a, a)."""
    _check_dtype(a)
    if a.shape[0] != W:
        raise ValueError(f"Fr words need a leading axis of {W}: {a.shape}")
    if a.device.type == "cpu":
        return limbs_to_words(FR.mont_sqr(words_to_limbs(a)))
    m = math.prod(a.shape[1:])
    a2, _ = _build.operand(a, a.shape, "fr_sqr")
    out = torch.empty((W, m), dtype=torch.int32, device=a.device)
    fn = _build.declare(_build.lib("field").pm_fr_sqr, 6)
    _build.check(fn(a2.data_ptr(), a2.stride(0), out.data_ptr(), m, m,
                    _build.stream(out)), "fr_sqr")
    LAUNCHES["fr_sqr"] += 1
    return out.reshape(a.shape)


def fr_butterfly(lo: torch.Tensor, hi: torch.Tensor, tw: torch.Tensor):
    """Radix-2 butterfly (lo + tw*hi, lo - tw*hi) of broadcastable (8, ...)
    Fr words; a one-element ``tw`` is read once for the whole batch."""
    _check_dtype(lo, hi, tw)
    shape = torch.broadcast_shapes(lo.shape, hi.shape, tw.shape)
    if shape[0] != W:
        raise ValueError(f"Fr words need a leading axis of {W}: {shape}")
    devs = {lo.device, hi.device, tw.device}
    if devs == {torch.device("cpu")}:
        lo_l = words_to_limbs(lo)
        t = FR.mont_mul(words_to_limbs(hi), words_to_limbs(tw))
        return (limbs_to_words(FR.add(lo_l, t)),
                limbs_to_words(FR.sub(lo_l, t)))
    if len(devs) != 1 or lo.device.type != "cuda":
        raise ValueError(f"fr_butterfly operands on {sorted(map(str, devs))}")
    m = math.prod(shape[1:])
    ops = [_build.operand(t, shape, "fr_butterfly") for t in (lo, hi, tw)]
    out = torch.empty((2, W, m), dtype=torch.int32, device=lo.device)
    args = [v for t2, step in ops for v in (t2.data_ptr(), t2.stride(0), step)]
    fn = _build.declare(_build.lib("field").pm_fr_butterfly, 14)
    _build.check(fn(*args, out[0].data_ptr(), out[1].data_ptr(), m, m,
                    _build.stream(out)), "fr_butterfly")
    LAUNCHES["fr_butterfly"] += 1
    return out[0].reshape(shape), out[1].reshape(shape)
