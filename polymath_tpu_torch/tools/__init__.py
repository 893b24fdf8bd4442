"""The port's tools: measurement entry points (counterparts of the
reference's measurement scripts) and the Rust-vector importer.  Each
measurement entry point runs as

    python3 -m polymath_tpu_torch.tools.<name> [--device {cuda,cpu}] ...

and has ``main(argv=None) -> dict``, which returns what it prints:

* ``primbench``: what one 32-bit (or 16-bit) operation costs in a chain of
  512 dependent steps (csrc/primbench.cu);
* ``pgather_variants``: six row-gather layouts of the MSM's point
  permutation (csrc/gather_variants.cu);
* ``kernel_metrics``: NTT elements/s at 2^20 and 2^22, MSM points/s at
  2^20, with a host-oracle check;
* ``fusedprof``: each stage of one MSM chunk timed on its own;
* ``productprobe``: what one Montgomery product costs (``to_affine`` at
  the scans' lane count and at a full card, and the SASS instructions of
  one inlined product);
* ``kernel_table``: every kernel alone at the main path's shapes against
  its bound and its plain version, the rows of PERF.md's kernel table, on
  the inputs and plain versions of ``cases``, which the card tests share.

``import_rust_vectors FILE`` (the reference's
tools/import_rust_vectors.py) is host only and takes no ``--device``: it
verifies the Rust reference crate's proofs under the port's verifier and
installs them as a test fixture.

``--device cuda`` (the default) raises when no card is visible; ``--device
cpu`` runs the kernels' plain versions, and every time it reports is then
read on the host clock of the CPU run, never a device time.

The card's peak rates, the operation counts of the field and curve
formulas, the bound rule and the CUDA-event timer live here once, and
every tool uses them.  ``benchmark/harness/peaks.py`` keeps a frozen copy
of the rates and of the madd count, since the benchmark imports nothing
of the program to count its work.
"""

from __future__ import annotations

import argparse
import time

import torch

MEM_RATE = 3.35e12          # bytes/s, H100 SXM HBM3
# 32-bit integer operations/s, H100 SXM: 64 INT32 lanes per SM (half the
# fp32 lanes) x 132 SMs x 1.98 GHz
INT_OPS_RATE = 16.7e12
F32_OPS_RATE = 33.5e12      # fp32 instructions/s: 128 lanes x 132 SMs x 1.98 GHz

# 32-bit multiply-adds per operation (CIOS / SOS with 32-bit words; a
# wide product counts two, each reduction digit one)
FR_MUL_OPS = 2 * (64 + 64) + 8
FR_SQR_OPS = 2 * (36 + 64) + 8
FQ_MUL_OPS = 2 * (144 + 144) + 12
FQ_SQR_OPS = 2 * (78 + 144) + 12
MADD_OPS = 8 * FQ_MUL_OPS + 3 * FQ_SQR_OPS         # madd-2007-bl
ADD_OPS = 11 * FQ_MUL_OPS + 5 * FQ_SQR_OPS         # add-2007-bl
# g1.cu's Fermat inversion: 384 squarings, popcount(q - 2) = 229 products,
# then zinv^2 and three products
TO_AFFINE_OPS = 385 * FQ_SQR_OPS + (229 + 3) * FQ_MUL_OPS
DOUBLE_OPS = 2 * FQ_MUL_OPS + 5 * FQ_SQR_OPS       # dbl-2009-l
BFLY_OPS = FR_MUL_OPS                              # one product a pair


def bound_ms(nbytes: float, ops: float, rate: float = INT_OPS_RATE) -> tuple:
    """(ms, "bytes" or "operations"): the least time for work that moves
    ``nbytes`` (each input read once, each output written once) at the
    memory rate and does ``ops`` operations at ``rate``, the larger of the
    two."""
    t_b, t_o = nbytes / MEM_RATE, ops / rate
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def parser(description: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a card) or cpu "
                         "(the plain versions)")
    return ap


def pick_device(name: str) -> torch.device:
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is visible; pass --device cpu to run "
                           "the plain versions on the CPU")
    return torch.device(name)


def describe(dev: torch.device) -> dict:
    """The device a result was taken on, and the clock that timed it."""
    if dev.type == "cuda":
        return {"device": torch.cuda.get_device_name(dev),
                "count": torch.cuda.device_count(),
                "clock": "CUDA events"}
    return {"device": "cpu", "count": 1, "clock": "host (CPU run)"}


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_ms(fn, dev, reps: int = 1):
    """(last result, mean ms of one call) over ``reps`` back-to-back calls:
    CUDA events on the card, the host clock on the CPU."""
    dev = torch.device(dev)
    sync(dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            res = fn()
        end.record()
        torch.cuda.synchronize(dev)
        return res, start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        res = fn()
    return res, (time.perf_counter() - t0) * 1e3 / reps


def wall_s(fn, dev: torch.device):
    """(result, seconds) on the host clock around ``fn`` and a device sync."""
    sync(dev)
    t0 = time.perf_counter()
    res = fn()
    sync(dev)
    return res, time.perf_counter() - t0
