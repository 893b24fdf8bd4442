"""Sparse linear algebra over Fr: COO matvec with segment sums
(counterpart of sparse.py).

The SAP evaluation products are O(nnz): gather z by column index, one
Montgomery product per entry (the ``fr_mul`` kernel), exact segment sums
into rows, one REDC.  The reference sums 16-bit limbs in uint32, which is
exact only below 2^15 entries per segment and forced its two-level
segment plan; here the limb sums are ``int64`` ``index_add_``, exact up to
2^47 entries, so rows are summed in one level.  Keys written by the
reference with a two-level plan are mapped back to plain row ids when
they are loaded (``CooMatrix.from_arrays``), and ``plan_segments`` (the
reference's planner, numpy only) makes that plan again when a key is
written in the reference's layout (protocol/keys.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..hostmath.bls12_381 import R
from .field import fr_from_lazy
from .limbs import FR_SPEC, ints_to_words, pack_np, words_to_limbs

#: The reference's lazy uint32 limb sums stay < 2^31 only for segments of
#: < 2^15 entries (each Montgomery limb < 2^16); plan_segments splits
#: denser segments.
MAX_SEG = 1 << 15


def plan_segments(seg_ids: np.ndarray, num_segments: int):
    """The reference's segment plan (ops/sparse.py:plan_segments), output
    for output.  Returns (sub_ids, lvl2_ids, n_sub):

    * every segment < MAX_SEG entries: sub_ids is seg_ids as int32,
      lvl2_ids is None, n_sub == num_segments;
    * otherwise the entries of segment s map to compact sub-segments (one
      per MAX_SEG - 1 entries, so n_sub ~ nnz / MAX_SEG + num_segments),
      and lvl2_ids (length n_sub) maps each sub-segment back to its
      segment."""
    seg_ids = np.asarray(seg_ids, np.int32)
    counts = np.bincount(seg_ids, minlength=num_segments)
    max_c = int(counts.max()) if counts.size else 0
    if max_c < MAX_SEG:
        return seg_ids, None, num_segments
    cap = MAX_SEG - 1
    n_parts = np.maximum(-(-counts // cap), 1)   # empty segments keep a slot
    sub_start = np.zeros(num_segments + 1, np.int64)
    np.cumsum(n_parts, out=sub_start[1:])
    n_sub = int(sub_start[-1])
    order = np.argsort(seg_ids, kind="stable")
    starts = np.zeros(num_segments + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    ranks = np.empty(len(seg_ids), np.int64)
    ranks[order] = np.arange(len(seg_ids)) - starts[seg_ids[order]]
    sub_ids = (sub_start[seg_ids] + ranks // cap).astype(np.int32)
    lvl2_ids = np.repeat(np.arange(num_segments, dtype=np.int32), n_parts)
    return sub_ids, lvl2_ids, n_sub


class CooMatrix:
    """A sparse Fr matrix as COO arrays on one device: int64 row and
    column ids, (8, nnz) Montgomery coefficient words."""

    def __init__(self, rows, cols, coeffs_mont, num_rows: int,
                 num_cols: int, device=None):
        self.row_idx = torch.as_tensor(np.asarray(rows, np.int64),
                                       device=device)
        self.col_idx = torch.as_tensor(np.asarray(cols, np.int64),
                                       device=device)
        self.coeffs_mont = torch.as_tensor(coeffs_mont, device=device)
        self.num_rows = num_rows
        self.num_cols = num_cols
        self.nnz = int(self.col_idx.shape[0])

    @classmethod
    def from_sparse_rows(cls, sparse_rows, num_cols: int, device=None):
        """From list-of-rows [(coeff, col)] (frontend r1cs.to_matrices)."""
        rows, cols, coeffs = [], [], []
        for i, row in enumerate(sparse_rows):
            for coeff, j in row:
                rows.append(i)
                cols.append(j)
                coeffs.append(coeff)
        if not rows:  # keep a 1-element dummy so shapes stay static
            rows, cols, coeffs = [0], [0], [0]
        words = ints_to_words([FR_SPEC.to_mont_int(c % R) for c in coeffs],
                              FR_SPEC.L)
        return cls(rows, cols, torch.from_numpy(words), len(sparse_rows),
                   num_cols, device)

    @classmethod
    def from_arrays(cls, row_idx, col_idx, coeffs_limbs, lvl2_idx,
                    num_rows: int, num_cols: int, device=None):
        """From the reference's saved COO arrays: (sub-)segment ids, column
        ids, (16, nnz) Montgomery 16-bit limbs, and the optional
        sub-segment -> row map of its two-level plan."""
        rows = np.asarray(row_idx, np.int64)
        if lvl2_idx is not None:
            rows = np.asarray(lvl2_idx, np.int64)[rows]
        words = pack_np(np.asarray(coeffs_limbs, np.uint32))
        return cls(rows, col_idx, torch.from_numpy(np.ascontiguousarray(words)),
                   num_rows, num_cols, device)


def segment_sum_mod(vals, seg_ids, num_segments: int):
    """vals: (8, nnz) Montgomery words -> (8, num_segments) words, the
    exact field sum of the entries of each segment."""
    limbs = words_to_limbs(vals)                          # (16, nnz)
    lazy = torch.zeros((limbs.shape[0], num_segments), dtype=torch.int64,
                       device=vals.device)
    lazy.index_add_(1, seg_ids, limbs)
    return fr_from_lazy(lazy, max(1, vals.shape[1]))


def coo_matvec(mat: CooMatrix, z_mont):
    """(8, num_rows) = M @ z for z_mont (8, num_cols) Montgomery words."""
    from .cuda_field import fr_mul
    gathered = z_mont[:, mat.col_idx]                     # (8, nnz)
    prods = fr_mul(gathered, mat.coeffs_mont)
    return segment_sum_mod(prods, mat.row_idx, mat.num_rows)
