"""Fixed-base batch scalar multiplication of the G1 generator (SRS
generation; counterpart of fixed_base.py).

A shared window table T[w][d] = d * 2^(8 w) * G (32 windows of 256
Jacobian entries, built once on the host) turns each scalar into 32
table lookups and 32 ``jac_add`` launches over the whole batch, then one
``to_affine`` launch (port-only kernel: per-point Fermat inversion of Z).
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..hostmath import bls12_381 as bls
from .cuda_curve import jac_add, to_affine
from .curve import AFF, JAC, jac_identity_words
from .field import fr_window_digits
from .limbs import FQ_SPEC, ints_to_words

FB_C = 8                      # window width of the table
FB_WINDOWS = 256 // FB_C      # 32 windows cover 256 bits
FB_CHUNK = 1 << 20            # points per batch of launches


@lru_cache(maxsize=None)
def _host_table():
    """(36, FB_WINDOWS, 2^c) int32 Jacobian Montgomery words of
    d * 2^(c w) * G, built with host group adds (entry 0 the identity)."""
    g = bls.G1
    xs, ys, zs = [], [], []
    base = g.to_jacobian(g.gen)
    for _ in range(FB_WINDOWS):
        acc = None
        row = [None]
        for _ in range((1 << FB_C) - 1):
            acc = base if acc is None else g.jac_add(acc, base)
            row.append(acc)
        for p in row:
            if p is None:
                xs.append(FQ_SPEC.r_mont)
                ys.append(FQ_SPEC.r_mont)
                zs.append(0)
            else:
                xs.append(FQ_SPEC.to_mont_int(p[0].v))
                ys.append(FQ_SPEC.to_mont_int(p[1].v))
                zs.append(FQ_SPEC.to_mont_int(p[2].v))
        for _ in range(FB_C):
            base = g.jac_double(base)
    words = ints_to_words(xs + ys + zs, FQ_SPEC.L)       # (12, 3 * W * 2^c)
    t = torch.from_numpy(words).reshape(FQ_SPEC.W, 3, FB_WINDOWS, 1 << FB_C)
    return t.transpose(0, 1).reshape(JAC, FB_WINDOWS, 1 << FB_C).contiguous()


_TABLES: dict = {}


def g1_table(device) -> torch.Tensor:
    key = str(torch.device(device))
    if key not in _TABLES:
        _TABLES[key] = _host_table().to(device)
    return _TABLES[key]


def fixed_base_mul(scalars: torch.Tensor, chunk: int = FB_CHUNK):
    """scalars: (8, N) canonical Fr words -> (N, 24) affine Montgomery rows
    of s_i * G (the identity, for s_i = 0, as (0, 0))."""
    dev = scalars.device
    table = g1_table(dev)
    n = scalars.shape[-1]
    out = torch.empty((n, AFF), dtype=torch.int32, device=dev)
    for start in range(0, n, chunk):
        sc = scalars[:, start:start + chunk]
        digits = fr_window_digits(sc, FB_C, FB_WINDOWS)     # (W, size)
        acc = jac_identity_words((sc.shape[-1],), dev).contiguous()
        for w in range(FB_WINDOWS):
            acc = jac_add(acc, table[:, w, digits[w]])
        out[start:start + sc.shape[-1]] = to_affine(acc).T
    return out
