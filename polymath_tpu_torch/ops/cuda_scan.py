"""Fused MSM bucket scan (counterpart of pallas_scan.py).

``fused_scan_msm(table, idx, fast)`` runs, for every lane of an MSM
chunk, the inclusive mixed-add scan of its ``seq`` sorted leaves, reading
each leaf straight from the affine point table.  It computes what the
split pair of ops/msm.py computes (``gather_rows`` into a leaf buffer,
then ``seq`` launches of ``jac_madd``), in one launch of csrc/scan.cu's
``g1_scan_msm_kernel`` that never writes the gathered leaves.

  table (T, 24) int32 affine rows (x words then y words); idx (seq, ...)
  int64 step-major leaf indices, index T (or any index outside [0, T)) is
  the affine identity.  Returns (local, err): local (36, seq, ...) int32
  Jacobian words, step s holding each lane's prefix after s + 1 leaves
  (local[:, seq - 1] are the lane totals); err (lanes,) int32 with 1 where
  the fast form skipped a doubling, None unless ``fast``.

On CUDA tensors the wrapper launches the kernel or raises; on CPU tensors
it runs the plain version, the split pair on the kernels' plain formulas.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .cuda_gather import ROW, gather_rows_plain
from .curve import (
    AFF, JAC, jac_identity_words, jac_madd_core, join_words, split_words,
)

#: launches since the last reset (read by chip_smoke.py)
LAUNCHES = {"fused_scan": 0}


def _outputs(idx, fast, out, err):
    seq, lanes = idx.shape[0], math.prod(idx.shape[1:])
    shape = (JAC,) + tuple(idx.shape)
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=idx.device)
    elif (out.shape != shape or out.dtype != torch.int32
          or not out.is_contiguous() or out.device != idx.device):
        raise ValueError(f"fused_scan_msm: out must be a contiguous int32 "
                         f"{shape} on {idx.device}")
    if fast and err is None:
        err = torch.zeros((lanes,), dtype=torch.int32, device=idx.device)
    elif fast and (err.shape != (lanes,) or err.dtype != torch.int32
                   or not err.is_contiguous() or err.device != idx.device):
        raise ValueError(f"fused_scan_msm: err must be a contiguous int32 "
                         f"({lanes},) on {idx.device}")
    return seq, lanes, out, (err if fast else None)


def fused_scan_msm_plain(table: torch.Tensor, idx: torch.Tensor, fast: bool,
                         out: torch.Tensor | None = None,
                         err: torch.Tensor | None = None):
    """The split pair on plain formulas: gather every leaf, then one
    jac_madd_core over all lanes per step."""
    seq, lanes, out, err = _outputs(idx, fast, out, err)
    leaves = gather_rows_plain(table, idx).reshape(AFF, seq, lanes)
    local = out.reshape(JAC, seq, lanes)
    acc = split_words(jac_identity_words((lanes,), idx.device), 3)
    for s in range(seq):
        acc, e = jac_madd_core(acc, split_words(leaves[:, s], 2), fast)
        local[:, s] = join_words(acc)
        if fast:
            err |= e.to(torch.int32)
    return out, err


def fused_scan_msm(table: torch.Tensor, idx: torch.Tensor, fast: bool,
                   out: torch.Tensor | None = None,
                   err: torch.Tensor | None = None):
    """The fused bucket scan (module docstring); ``out`` and ``err`` may be
    given preallocated, ``err`` is OR-ed into."""
    if table.dim() != 2 or table.shape[1] != ROW:
        raise ValueError(f"fused_scan_msm: table must be (T, {ROW}), got "
                         f"{tuple(table.shape)}")
    if idx.dtype != torch.int64 or idx.dim() < 2:
        raise TypeError(f"fused_scan_msm: idx must be int64 (seq, ...), got "
                        f"{idx.dtype} {tuple(idx.shape)}")
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return fused_scan_msm_plain(table, idx, fast, out, err)
    if (table.device != idx.device or table.device.type != "cuda"
            or table.dtype != torch.int32 or not table.is_contiguous()
            or table.data_ptr() % 16):
        raise ValueError("fused_scan_msm: needs a contiguous, 16-byte "
                         "aligned int32 CUDA table and indices on the same "
                         "card")
    idx = idx.contiguous()
    seq, lanes, out, err = _outputs(idx, fast, out, err)
    fn = _build.declare(_build.lib("scan").pm_g1_scan_msm, 9)
    _build.check(fn(table.data_ptr(), table.shape[0], idx.data_ptr(),
                    out.data_ptr(), err.data_ptr() if fast else 0, int(fast),
                    seq, lanes, _build.stream(out)), "fused_scan_msm")
    LAUNCHES["fused_scan"] += 1
    return out, err
