"""G1 point kernels (counterpart of pallas_curve.py: add, mixed add,
doubling) plus the port-only Jacobian -> affine kernel.

Points are word tensors (curve.py): Jacobian ``(36, ...)``, affine
``(24, ...)``, int32.  On CUDA tensors the wrappers launch
``csrc/g1.cu``; on CPU tensors they run the plain formulas of curve.py.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .curve import (
    AFF, JAC, jac_add_core, jac_double_core, jac_madd_core,
    jac_to_affine_core, join_words, split_words,
)

#: launches per kernel since the last reset (read by the benchmark's
#: launches_per_proof, the card tests and tools/kernel_table.py)
LAUNCHES = {"jac_add": 0, "jac_madd": 0, "jac_double": 0, "to_affine": 0}


def _lanes(t: torch.Tensor, K: int, what: str) -> torch.Tensor:
    """A (K, ...) operand as a 2-D view with unit lane stride."""
    if t.shape[0] != K:
        raise ValueError(f"{what}: expected {K} words, got {tuple(t.shape)}")
    t2, _ = _build.operand(t, t.shape, what)
    return t2


def jac_add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """General Jacobian add of broadcastable (36, ...) point tensors."""
    shape = torch.broadcast_shapes(p.shape, q.shape)
    if shape[0] != JAC:
        raise ValueError(f"jac_add: expected {JAC} words, got {shape}")
    if p.device.type == "cpu" and q.device.type == "cpu":
        return join_words(jac_add_core(split_words(p, 3), split_words(q, 3)))
    if p.device != q.device:
        raise ValueError(f"jac_add operands on {p.device} and {q.device}")
    m = math.prod(shape[1:])
    p2, sp = _build.operand(p, shape, "jac_add")
    q2, sq = _build.operand(q, shape, "jac_add")
    out = torch.empty((JAC, m), dtype=torch.int32, device=p.device)
    fn = _build.declare(_build.lib("g1").pm_g1_add, 10)
    _build.check(fn(p2.data_ptr(), p2.stride(0), sp, q2.data_ptr(),
                    q2.stride(0), sq, out.data_ptr(), m, m,
                    _build.stream(out)), "jac_add")
    LAUNCHES["jac_add"] += 1
    return out.reshape(shape)


def jac_madd(p: torch.Tensor, leaf: torch.Tensor, fast: bool = False,
             out: torch.Tensor | None = None,
             err: torch.Tensor | None = None):
    """Mixed add: (36, M) Jacobian accumulators += (24, M) affine leaves.

    ``out`` may be a (36, M) view with unit lane stride (the MSM scan
    writes each step's sums straight into its prefix buffer).  With
    ``fast``, ``err`` (int32 (M,), zeros if not given) gets 1 in every
    lane that needed the doubling the fast form skips.  Returns
    (out, err), err None unless fast."""
    if p.dim() != 2 or leaf.dim() != 2 or leaf.shape[1] != p.shape[1]:
        raise ValueError(f"jac_madd shapes {tuple(p.shape)} "
                         f"{tuple(leaf.shape)}")
    m = p.shape[1]
    if fast and err is None:
        err = torch.zeros((m,), dtype=torch.int32, device=p.device)
    if p.device.type == "cpu":
        res, e = jac_madd_core(split_words(p, 3), split_words(leaf, 2), fast)
        res = join_words(res)
        if out is None:
            out = res
        else:
            out.copy_(res)
        if fast:
            err |= e.to(torch.int32)
        return out, (err if fast else None)
    p2 = _lanes(p, JAC, "jac_madd")
    l2 = _lanes(leaf, AFF, "jac_madd")
    if out is None:
        out = torch.empty((JAC, m), dtype=torch.int32, device=p.device)
    o2 = _lanes(out, JAC, "jac_madd")
    if o2.data_ptr() != out.data_ptr() or (m > 1 and out.stride(1) != 1):
        raise ValueError("jac_madd: out must have unit lane stride")
    if fast and (err.dtype != torch.int32 or not err.is_contiguous()
                 or err.shape != (m,) or err.device != p.device):
        raise ValueError("jac_madd: err must be a contiguous int32 (M,)")
    fn = _build.declare(_build.lib("g1").pm_g1_madd, 10)
    _build.check(fn(p2.data_ptr(), p2.stride(0), l2.data_ptr(), l2.stride(0),
                    o2.data_ptr(), o2.stride(0),
                    err.data_ptr() if fast else 0, int(fast), m,
                    _build.stream(o2)), "jac_madd")
    LAUNCHES["jac_madd"] += 1
    return out, (err if fast else None)


def jac_double(p: torch.Tensor) -> torch.Tensor:
    """dbl-2009-l on (36, ...) Jacobian words.  The identity (Z = 0)
    doubles to Z = 0 with the formula's X and Y, as jac_double_core."""
    if p.shape[0] != JAC:
        raise ValueError(f"jac_double: expected {JAC} words, got {p.shape}")
    if p.device.type == "cpu":
        return join_words(jac_double_core(split_words(p, 3)))
    m = math.prod(p.shape[1:])
    p2 = _lanes(p, JAC, "jac_double")
    out = torch.empty((JAC, m), dtype=torch.int32, device=p.device)
    fn = _build.declare(_build.lib("g1").pm_g1_double, 6)
    _build.check(fn(p2.data_ptr(), p2.stride(0), out.data_ptr(), m, m,
                    _build.stream(out)), "jac_double")
    LAUNCHES["jac_double"] += 1
    return out.reshape(p.shape)


def to_affine(p: torch.Tensor) -> torch.Tensor:
    """(36, ...) Jacobian -> (24, ...) affine words, identity -> (0, 0).
    Port-only kernel: the reference inverts Z with XLA (Fermat)."""
    if p.shape[0] != JAC:
        raise ValueError(f"to_affine: expected {JAC} words, got {p.shape}")
    if p.device.type == "cpu":
        return join_words(jac_to_affine_core(split_words(p, 3)))
    m = math.prod(p.shape[1:])
    p2 = _lanes(p, JAC, "to_affine")
    out = torch.empty((AFF, m), dtype=torch.int32, device=p.device)
    fn = _build.declare(_build.lib("g1").pm_g1_to_affine, 6)
    _build.check(fn(p2.data_ptr(), p2.stride(0), out.data_ptr(), m, m,
                    _build.stream(out)), "to_affine")
    LAUNCHES["to_affine"] += 1
    return out.reshape((AFF,) + tuple(p.shape[1:]))
