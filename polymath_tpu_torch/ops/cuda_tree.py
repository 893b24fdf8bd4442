"""The MSM's group-law tree after the bucket scan (steps 4 and 5 of
ops/msm.py), as two kernels of csrc/tree.cu in the place of the
launch-by-launch ``jac_add`` composition (counterpart of the reference's
``curve_jax.prefix_scan_jac_tree`` and ``tree_sum_jac`` over
pallas_curve.py's ``_add_kernel``):

* ``row_offsets(totals)``: totals (36, W, rows) Jacobian words, the row
  totals of each window -> (36, W, rows), the exclusive prefix along rows
  (the identity at row 0): a scan of each segment of rows, then a pass
  that adds the earlier segments' totals (two launches; one for a single
  segment).
* ``window_fold(ps, cnt, r_of, offs)``: ps (36, W, n) threshold prefixes,
  cnt and r_of (W, n) int64 (``msm.threshold_prefixes``), offs from
  ``row_offsets`` or None (a single row) -> (36, W): per window the sum of
  ps + offs[r_of] over the thresholds with cnt > 0; one launch.
* ``sum_sets(parts)``: parts (k, 36, W), k sets of window sums (an MSM's
  chunks, or the ranks' sums) -> (36, W), their sum: one launch for up to
  THREADS sets, a pairwise tree a window (more sets take a launch a
  level, ``sum_levels``).  It replaces the chain of k - 1 ``jac_add``
  launches (the reference's fori_loop, polymath_tpu/ops/msm.py:325-336).

Segments and slices are sized so that every block of a launch is on the
card at once (csrc/tree.cu says why).

The kernels add in another order than the composition, so their Jacobian
words may differ from the plain versions'; the group elements do not
(``jac_equal`` compares them).  On CUDA tensors the wrappers launch their
kernel or raise; on CPU tensors they run the plain versions, the
composition on plain formulas.  The plain versions take ``add``, the
Jacobian add they compose: with the ``jac_add`` kernel wrapper they are the
per-launch composition the kernels replace (tools/fusedprof.py times it).
"""

from __future__ import annotations

import torch

from . import _build
from .curve import (
    JAC, jac_add_core, jac_identity_words, join_words, prefix_scan_jac,
    split_words, tree_sum_jac,
)
from .field import FQ

#: launches since the last reset (read by the benchmark's
#: launches_per_proof, the card tests and tools/kernel_table.py)
LAUNCHES = {"row_offsets": 0, "window_fold": 0, "sum_sets": 0}

#: csrc/tree.cu's block size; the most segments or slices a window has
THREADS = 128

def _blocks_on_card(dev: torch.device) -> int:
    """How many tree-kernel blocks the card runs at once."""
    per_sm = _build.declare(_build.lib("tree").pm_tree_blocks_per_sm, 0)()
    return per_sm * torch.cuda.get_device_properties(dev).multi_processor_count


def _split(length: int, windows: int, per_min: int, dev) -> tuple:
    """(parts a window, items a part): at least ``per_min`` items a thread,
    at most THREADS parts, and at most one block of each window for every
    block the card runs at once."""
    parts = max(1, min(-(-length // (per_min * THREADS)),
                       _blocks_on_card(dev) // windows, THREADS))
    size = -(-length // parts)
    return -(-length // size), size


def add_plain(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """jac_add on plain formulas, on any device."""
    return join_words(jac_add_core(split_words(p, 3), split_words(q, 3)))


def jac_equal(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Per lane, whether (36, ...) Jacobian words p and q are the same
    group element: both the identity, or X1 Z2^2 = X2 Z1^2 and
    Y1 Z2^3 = Y2 Z1^3 with both Z nonzero (plain formulas)."""
    (x1, y1, z1), (x2, y2, z2) = split_words(p, 3), split_words(q, 3)
    inf1, inf2 = FQ.is_zero(z1), FQ.is_zero(z2)
    zz1, zz2 = FQ.mont_sqr(z1), FQ.mont_sqr(z2)
    same = FQ.eq(FQ.mont_mul(x1, zz2), FQ.mont_mul(x2, zz1)) & FQ.eq(
        FQ.mont_mul(y1, FQ.mont_mul(zz2, z2)),
        FQ.mont_mul(y2, FQ.mont_mul(zz1, z1)))
    return (inf1 & inf2) | (~inf1 & ~inf2 & same)


def row_offsets_plain(totals: torch.Tensor, add=add_plain) -> torch.Tensor:
    """An inclusive Hillis-Steele prefix along rows (``prefix_scan_jac``),
    shifted by one row."""
    _, windows, rows = totals.shape
    incl = prefix_scan_jac(totals.transpose(1, 2), add)      # (36, rows, W)
    offs = torch.cat([jac_identity_words((1, windows), totals.device),
                      incl[:, :-1]], dim=1)
    return offs.transpose(1, 2).contiguous()


def window_fold_plain(ps: torch.Tensor, cnt: torch.Tensor,
                      r_of: torch.Tensor, offs: torch.Tensor | None,
                      add=add_plain) -> torch.Tensor:
    """Each threshold adds its row's offset (one ``add``), thresholds with
    no digit become the identity, then pairwise halving
    (``tree_sum_jac``)."""
    _, windows, n = ps.shape
    if offs is not None:
        rows = offs.shape[2]
        w_of = torch.arange(windows, device=ps.device)[:, None]
        off_g = offs.reshape(JAC, -1)[:, (w_of * rows + r_of).reshape(-1)]
        ps = add(ps, off_g.reshape(ps.shape))
    ps = torch.where((cnt > 0)[None], ps,
                     jac_identity_words((windows, n), ps.device))
    return tree_sum_jac(ps.transpose(1, 2), add)


def sum_sets_plain(parts: torch.Tensor, add=add_plain) -> torch.Tensor:
    """The sets added one by one in index order (the reference's
    fori_loop over the chunks)."""
    acc = parts[0]
    for s in range(1, parts.shape[0]):
        acc = add(acc, parts[s])
    return acc


def sum_levels(k: int) -> list:
    """The launches of ``sum_sets`` over k sets: (sets in, sets a block)
    for each, a launch leaving ceil(sets in / sets a block) sums."""
    levels = [(k, min(k, THREADS))]
    while levels[-1][0] > THREADS:
        k = -(-k // THREADS)
        levels.append((k, min(k, THREADS)))
    return levels


def _check(t: torch.Tensor, dtype, what: str) -> None:
    if t.dtype != dtype or t.device.type != "cuda":
        raise ValueError(f"{what}: expected {dtype} on the card, got "
                         f"{t.dtype} on {t.device}")


def row_offsets(totals: torch.Tensor) -> torch.Tensor:
    """Exclusive row offsets (module docstring).  ``totals`` may be a view
    whose word stride is not W * rows (``local[:, seq - 1]``)."""
    if totals.dim() != 3 or totals.shape[0] != JAC:
        raise ValueError(f"row_offsets: totals must be ({JAC}, W, rows), got "
                         f"{tuple(totals.shape)}")
    if totals.device.type == "cpu":
        return row_offsets_plain(totals)
    _check(totals, torch.int32, "row_offsets")
    _, windows, rows = totals.shape
    if totals.stride(2) != 1 or totals.stride(1) != rows:
        totals = totals.contiguous()
    dev = totals.device
    segs, seg = _split(rows, windows, 2, dev)
    offs = torch.empty((JAC, windows, rows), dtype=torch.int32, device=dev)
    seg_tot = torch.empty((JAC, windows, segs), dtype=torch.int32,
                          device=dev)
    scan = _build.declare(_build.lib("tree").pm_g1_row_scan, 9)
    _build.check(scan(totals.data_ptr(), totals.stride(0), offs.data_ptr(),
                      seg_tot.data_ptr(), windows, rows, seg, segs,
                      _build.stream(offs)), "row_offsets")
    LAUNCHES["row_offsets"] += 1
    if segs > 1:
        carry = _build.declare(_build.lib("tree").pm_g1_row_carry, 7)
        _build.check(carry(offs.data_ptr(), seg_tot.data_ptr(), windows,
                           rows, seg, segs, _build.stream(offs)),
                     "row_offsets")
        LAUNCHES["row_offsets"] += 1
    return offs


def window_fold(ps: torch.Tensor, cnt: torch.Tensor, r_of: torch.Tensor,
                offs: torch.Tensor | None,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """Offsets + mask + fold (module docstring) -> (36, W) window sums,
    written into ``out`` when given (a contiguous (36, W) int32 slot, such
    as one set of ``sum_sets``' operand)."""
    if ps.dim() != 3 or ps.shape[0] != JAC or cnt.shape != ps.shape[1:] \
            or r_of.shape != ps.shape[1:]:
        raise ValueError(f"window_fold: ps ({JAC}, W, n), cnt and r_of "
                         f"(W, n); got {tuple(ps.shape)}, "
                         f"{tuple(cnt.shape)}, {tuple(r_of.shape)}")
    if out is not None and (out.shape != ps.shape[:2]
                            or out.dtype != torch.int32
                            or out.device != ps.device
                            or not out.is_contiguous()):
        raise ValueError(f"window_fold: out must be a contiguous int32 "
                         f"{tuple(ps.shape[:2])} on {ps.device}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    if ps.device.type == "cpu":
        res = window_fold_plain(ps, cnt, r_of, offs)
        return res if out is None else out.copy_(res)
    _check(ps, torch.int32, "window_fold")
    _check(cnt, torch.int64, "window_fold")
    _check(r_of, torch.int64, "window_fold")
    ps, cnt, r_of = ps.contiguous(), cnt.contiguous(), r_of.contiguous()
    if offs is not None:
        _check(offs, torch.int32, "window_fold")
        if offs.shape[:2] != ps.shape[:2]:
            raise ValueError(f"window_fold: offs must be ({JAC}, W, rows), "
                             f"got {tuple(offs.shape)}")
        offs = offs.contiguous()
    _, windows, n = ps.shape
    dev = ps.device
    slices, size = _split(n, windows, 2, dev)
    if out is None:
        out = torch.empty((JAC, windows), dtype=torch.int32, device=dev)
    part = torch.empty((JAC, windows, slices), dtype=torch.int32, device=dev)
    count = torch.zeros((windows,), dtype=torch.int32, device=dev)
    fn = _build.declare(_build.lib("tree").pm_g1_fold, 13)
    _build.check(fn(ps.data_ptr(), n, cnt.data_ptr(), r_of.data_ptr(),
                    0 if offs is None else offs.data_ptr(),
                    0 if offs is None else offs.shape[2],
                    part.data_ptr(), count.data_ptr(), out.data_ptr(),
                    windows, slices, -(-size // THREADS),
                    _build.stream(out)), "window_fold")
    LAUNCHES["window_fold"] += 1
    return out


def sum_sets(parts: torch.Tensor) -> torch.Tensor:
    """(k, 36, W) sets of Jacobian window sums -> (36, W), their sum
    (module docstring); the sets may lie ``parts.stride(0)`` words apart."""
    if parts.dim() != 3 or parts.shape[1] != JAC or parts.shape[0] < 1:
        raise ValueError(f"sum_sets: parts must be (k >= 1, {JAC}, W), got "
                         f"{tuple(parts.shape)}")
    if parts.dtype != torch.int32:
        raise ValueError(f"sum_sets: expected int32 words, got "
                         f"{parts.dtype}")
    if parts.device.type == "cpu":
        return sum_sets_plain(parts)
    _check(parts, torch.int32, "sum_sets")
    windows = parts.shape[2]
    if parts.stride(2) != 1 or parts.stride(1) != windows:
        parts = parts.contiguous()
    fn = _build.declare(_build.lib("tree").pm_g1_sum_sets, 7)
    for k, per in sum_levels(parts.shape[0]):
        out = torch.empty((-(-k // per), JAC, windows), dtype=torch.int32,
                          device=parts.device)
        _build.check(fn(parts.data_ptr(), parts.stride(0), k, per,
                        out.data_ptr(), windows, _build.stream(out)),
                     "sum_sets")
        LAUNCHES["sum_sets"] += 1
        parts = out
    return parts[0]
