"""The quotient scan's two kernels (counterpart of poly_jax.affine_scan's
blocked levels and the Pallas fr_mul that adds their carries).

Both take ``x`` (8, n) int32 Fr words (word planes contiguous, any plane
stride) and ``mult``, the multiplier as a canonical int, and cut the
logical sequence into rows of ``ROW`` elements; with ``rev`` logical
element k is column n - 1 - k, for the input and the output alike.

* ``affine_scan_reduce(x, mult, rev)`` -> (8, rows): each row's scan
  acc = acc * mult + x_k from zero, its elements past n taken as zeros.
* ``affine_scan_apply(x, mult, carry, rev)`` -> (8, n): the inclusive scan
  p_k = x_k + mult * p_(k-1) within each row, row r starting from
  ``carry[:, r - 1]`` (row 0 from zero), stored where x_k was read.  With
  one row ``carry`` may be None.

On a CUDA tensor each launches its csrc/poly.cu kernel or raises; on a CPU
tensor it runs the plain version of that one launch (``field.FR`` on 16-bit
limbs, the rows zero-padded).  ops/poly.py chains them into the scan.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .field import FR, fr_const
from .limbs import FR_SPEC, limbs_to_words, words_to_limbs

W = FR_SPEC.W
#: elements a thread scans (csrc/poly.cu kRow)
ROW = 16

#: launches per kernel since the last reset (read by the benchmark's
#: launches_per_proof, the card tests and tools/kernel_table.py)
LAUNCHES = {"affine_scan_reduce": 0, "affine_scan_apply": 0}


def rows_of(n: int) -> int:
    return -(-n // ROW)


def _check(x: torch.Tensor, what: str) -> None:
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[0] != W:
        raise ValueError(f"{what}: x must be (8, n) int32 Fr words, got "
                         f"{x.dtype} {tuple(x.shape)}")


def _mult_words(mult: int):
    """The multiplier's 8 little-endian Montgomery words as a ctypes array
    (the kernel copies them into its parameters)."""
    v = FR_SPEC.to_mont_int(mult % FR_SPEC.modulus)
    return (ctypes.c_uint32 * W).from_buffer_copy(v.to_bytes(4 * W, "little"))


def _planes(x: torch.Tensor, what: str) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: operand on {x.device}, not on the card")
    return x if x.stride(1) == 1 else x.contiguous()


def affine_scan_reduce(x: torch.Tensor, mult: int,
                       rev: bool = False) -> torch.Tensor:
    _check(x, "affine_scan_reduce")
    if x.device.type == "cpu":
        return affine_scan_reduce_plain(x, mult, rev)
    x = _planes(x, "affine_scan_reduce")
    n = x.shape[1]
    totals = torch.empty((W, rows_of(n)), dtype=torch.int32, device=x.device)
    m = _mult_words(mult)
    fn = _build.declare(_build.lib("poly").pm_affine_scan_reduce, 8)
    _build.check(fn(x.data_ptr(), x.stride(0), n, int(rev),
                    ctypes.addressof(m), totals.data_ptr(), totals.stride(0),
                    _build.stream(totals)), "affine_scan_reduce")
    LAUNCHES["affine_scan_reduce"] += 1
    return totals


def affine_scan_apply(x: torch.Tensor, mult: int,
                      carry: torch.Tensor | None = None,
                      rev: bool = False) -> torch.Tensor:
    _check(x, "affine_scan_apply")
    n = x.shape[1]
    rows = rows_of(n)
    if rows > 1 and (carry is None or carry.shape != (W, rows)
                     or carry.dtype != torch.int32
                     or carry.device != x.device):
        raise ValueError(f"affine_scan_apply: {rows} rows need an int32 "
                         f"carry of shape ({W}, {rows}) on {x.device}")
    if x.device.type == "cpu":
        return affine_scan_apply_plain(x, mult, carry, rev)
    x = _planes(x, "affine_scan_apply")
    out = torch.empty((W, n), dtype=torch.int32, device=x.device)
    c = None if rows <= 1 else _planes(carry, "affine_scan_apply")
    m = _mult_words(mult)
    fn = _build.declare(_build.lib("poly").pm_affine_scan_apply, 10)
    _build.check(fn(x.data_ptr(), x.stride(0), n, int(rev),
                    ctypes.addressof(m), None if c is None else c.data_ptr(),
                    0 if c is None else c.stride(0), out.data_ptr(),
                    out.stride(0), _build.stream(out)), "affine_scan_apply")
    LAUNCHES["affine_scan_apply"] += 1
    return out


# -- the plain versions (field.FR on 16-bit limbs) ----------------------------

def _limb_rows(x: torch.Tensor, rev: bool) -> torch.Tensor:
    """(8, n) words -> (16, rows, ROW) int64 limbs in logical order, the
    last row padded with zeros."""
    n = x.shape[1]
    limbs = words_to_limbs(x.flip(-1) if rev else x)
    limbs = torch.nn.functional.pad(limbs, (0, rows_of(n) * ROW - n))
    return limbs.reshape(2 * W, rows_of(n), ROW)


def _steps(acc, mult: int, xr, keep=None):
    m = words_to_limbs(fr_const(mult, xr.device))
    for t in range(ROW):
        acc = FR.add(FR.mont_mul(acc, m), xr[..., t])
        if keep is not None:
            keep[..., t] = acc
    return acc


def affine_scan_reduce_plain(x: torch.Tensor, mult: int,
                             rev: bool = False) -> torch.Tensor:
    xr = _limb_rows(x, rev)
    return limbs_to_words(_steps(FR.zeros(xr.shape[1:2], x.device), mult,
                                 xr))


def affine_scan_apply_plain(x: torch.Tensor, mult: int,
                            carry: torch.Tensor | None = None,
                            rev: bool = False) -> torch.Tensor:
    n = x.shape[1]
    xr = _limb_rows(x, rev)
    acc = FR.zeros(xr.shape[1:2], x.device)
    if xr.shape[1] > 1:
        acc[:, 1:] = words_to_limbs(carry[:, :-1])
    ps = torch.empty_like(xr)
    _steps(acc, mult, xr, ps)
    p = limbs_to_words(ps.reshape(2 * W, -1)[:, :n])
    return p.flip(-1) if rev else p
