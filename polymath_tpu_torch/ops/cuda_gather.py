"""MSM point permutation: gather affine rows by index (counterpart of
pallas_gather.py).

``gather_rows(table, idx)``: table (T, 24) int32 affine rows (x words then
y words, row-major), idx int64 of any shape.  Returns
(24, *idx.shape), limb-major, with out[:, j] = table[idx[j]] and index T
(or any index outside [0, T)) giving the zero row (the affine identity)
without a sentinel row in the table.  On a CUDA table it launches
csrc/g1.cu's gather kernel; on the CPU it runs the plain torch gather.
"""

from __future__ import annotations

import math

import torch

from . import _build

ROW = 24

#: launches since the last reset (read by the benchmark's
#: launches_per_proof, the card tests and tools/kernel_table.py)
LAUNCHES = {"gather_rows": 0}


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    t = table.shape[0]
    ext = torch.cat([table, torch.zeros((1, ROW), dtype=table.dtype,
                                        device=table.device)])
    flat = idx.reshape(-1)
    g = ext[torch.where((flat >= 0) & (flat < t), flat, t)]   # (M, 24)
    return g.T.reshape((ROW,) + tuple(idx.shape))


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The point gather (module docstring)."""
    if table.dim() != 2 or table.shape[1] != ROW:
        raise ValueError(f"gather_rows: table must be (T, {ROW}), got "
                         f"{tuple(table.shape)}")
    if idx.dtype != torch.int64:
        raise TypeError(f"gather_rows: idx must be int64, got {idx.dtype}")
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return gather_rows_plain(table, idx)
    if (table.device != idx.device or table.device.type != "cuda"
            or table.dtype != torch.int32 or not table.is_contiguous()):
        raise ValueError("gather_rows: needs a contiguous int32 CUDA table "
                         "and indices on the same card")
    m = math.prod(idx.shape)
    idx = idx.contiguous()
    out = torch.empty((ROW, m), dtype=torch.int32, device=table.device)
    fn = _build.declare(_build.lib("g1").pm_g1_gather, 7)
    _build.check(fn(table.data_ptr(), table.shape[0], idx.data_ptr(),
                    out.data_ptr(), m, m, _build.stream(out)), "gather_rows")
    LAUNCHES["gather_rows"] += 1
    return out.reshape((ROW,) + tuple(idx.shape))
