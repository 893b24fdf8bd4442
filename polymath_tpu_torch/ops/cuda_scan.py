"""The MSM bucket scans (counterparts of pallas_scan.py and of the madd
scan in msm.py:_scan_local_madd).

For every lane of an MSM chunk, the inclusive mixed-add scan of its
``seq`` sorted leaves, in one launch of a csrc/scan.cu kernel:

* ``madd_scan(leaves, fast)``, the split configuration: the leaves already
  gathered, (24, seq, ...) int32 affine words, step major ((0, 0) is the
  identity); ``g1_madd_scan_kernel``.  It replaces ``seq`` launches of
  ``jac_madd``, with the same madds in the same order.
* ``fused_scan_msm(table, idx, fast)``, the fused configuration: each leaf
  read straight from the affine point table, never written;
  ``g1_scan_msm_kernel``.  table (T, 24) int32 affine rows (x words then y
  words); idx (seq, ...) int64 step-major leaf indices, index T (or any
  index outside [0, T)) is the affine identity.  It computes what the
  split pair computes (``gather_rows`` into a leaf buffer, then
  ``madd_scan``).

Both return (local, err): local (36, seq, ...) int32 Jacobian words, step s
holding each lane's prefix after s + 1 leaves (local[:, seq - 1] are the
lane totals); err (lanes,) int32 with 1 where the fast form skipped a
doubling, None unless ``fast``.  ``out`` and ``err`` may be given
preallocated; ``err`` is OR-ed into.

On CUDA tensors the wrappers launch their kernel or raise; on CPU tensors
they run the plain version, one ``jac_madd_core`` over all lanes per step.
"""

from __future__ import annotations

import functools
import math

import torch

from . import _build
from .cuda_gather import ROW, gather_rows_plain
from .curve import (
    AFF, JAC, jac_identity_words, jac_madd_core, join_words, split_words,
)

#: launches since the last reset (read by the benchmark's
#: launches_per_proof, the card tests and tools/kernel_table.py)
LAUNCHES = {"madd_scan": 0, "fused_scan": 0}


@functools.lru_cache(maxsize=None)
def max_blocks(dev: torch.device) -> int:
    """The most blocks of a scan kernel the card holds at once: the
    occupancy API's blocks per SM (registers and shared memory, the least
    over the two kernels) times the SMs; asked once a card.  The kernels
    walk the lanes with a grid stride, so a launch never asks for more."""
    with torch.cuda.device(dev):
        per_sm = _build.declare(_build.lib("scan").pm_scan_blocks_per_sm, 0)()
    if per_sm <= 0:
        raise RuntimeError(f"scan kernels: no block fits an SM of {dev}")
    return per_sm * torch.cuda.get_device_properties(dev).multi_processor_count


def _outputs(shape, device, fast, out, err, what):
    """``out`` (36, *shape) and ``err`` (lanes,) checked or made; shape =
    (seq, ...lanes)."""
    lanes = math.prod(shape[1:])
    full = (JAC,) + tuple(shape)
    if out is None:
        out = torch.empty(full, dtype=torch.int32, device=device)
    elif (out.shape != full or out.dtype != torch.int32
          or not out.is_contiguous() or out.device != device):
        raise ValueError(f"{what}: out must be a contiguous int32 {full} on "
                         f"{device}")
    if fast and err is None:
        err = torch.zeros((lanes,), dtype=torch.int32, device=device)
    elif fast and (err.shape != (lanes,) or err.dtype != torch.int32
                   or not err.is_contiguous() or err.device != device):
        raise ValueError(f"{what}: err must be a contiguous int32 ({lanes},) "
                         f"on {device}")
    return shape[0], lanes, out, (err if fast else None)


def madd_scan_plain(leaves: torch.Tensor, fast: bool,
                    out: torch.Tensor | None = None,
                    err: torch.Tensor | None = None):
    """The per-step loop on plain formulas: one jac_madd_core over all
    lanes per step."""
    seq, lanes, out, err = _outputs(leaves.shape[1:], leaves.device, fast,
                                    out, err, "madd_scan")
    leaves = leaves.reshape(AFF, seq, lanes)
    local = out.reshape(JAC, seq, lanes)
    acc = split_words(jac_identity_words((lanes,), leaves.device), 3)
    for s in range(seq):
        acc, e = jac_madd_core(acc, split_words(leaves[:, s], 2), fast)
        local[:, s] = join_words(acc)
        if fast:
            err |= e.to(torch.int32)
    return out, err


def madd_scan(leaves: torch.Tensor, fast: bool,
              out: torch.Tensor | None = None,
              err: torch.Tensor | None = None):
    """The split configuration's scan over gathered leaves (module
    docstring)."""
    if leaves.dim() < 3 or leaves.shape[0] != AFF:
        raise ValueError(f"madd_scan: leaves must be ({AFF}, seq, ...), got "
                         f"{tuple(leaves.shape)}")
    if leaves.device.type == "cpu":
        return madd_scan_plain(leaves, fast, out, err)
    if leaves.dtype != torch.int32 or leaves.device.type != "cuda":
        raise ValueError("madd_scan: needs int32 CUDA leaves")
    leaves = leaves.contiguous()
    seq, lanes, out, err = _outputs(leaves.shape[1:], leaves.device, fast,
                                    out, err, "madd_scan")
    fn = _build.declare(_build.lib("scan").pm_g1_madd_scan, 8)
    _build.check(fn(leaves.data_ptr(), out.data_ptr(),
                    err.data_ptr() if fast else 0, int(fast), seq, lanes,
                    max_blocks(leaves.device), _build.stream(out)),
                 "madd_scan")
    LAUNCHES["madd_scan"] += 1
    return out, err


def fused_scan_msm_plain(table: torch.Tensor, idx: torch.Tensor, fast: bool,
                         out: torch.Tensor | None = None,
                         err: torch.Tensor | None = None):
    """The split pair on plain formulas: gather every leaf, then the
    per-step loop."""
    return madd_scan_plain(gather_rows_plain(table, idx), fast, out, err)


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
    seq, lanes, out, err = _outputs(idx.shape, idx.device, fast, out, err,
                                    "fused_scan_msm")
    fn = _build.declare(_build.lib("scan").pm_g1_scan_msm, 10)
    _build.check(fn(table.data_ptr(), table.shape[0], idx.data_ptr(),
                    out.data_ptr(), err.data_ptr() if fast else 0, int(fast),
                    seq, lanes, max_blocks(idx.device), _build.stream(out)),
                 "fused_scan_msm")
    LAUNCHES["fused_scan"] += 1
    return out, err
