"""Row-gather layout experiments (counterpart of tools/pgather_variants.py):
six ways to gather m = W * n rows of 24 words from a table of quads of an
n-point table and write them limb-major, (24, m).

    python3 -m polymath_tpu_torch.tools.pgather_variants [--device cpu]
        [--log-n 18] [--windows 22] [--seed 0] [--reps 10]

The table is the tool's: (t4, 128) 32-bit words, t4 = (n + 4) // 4, row i
= words 24*(i%4) .. 24*(i%4)+23 of quad row i // 4 (lanes 96-127 are
padding); idx int32 (m,), m a multiple of BLK = 1024; both from
numpy's default_rng(seed) in the tool's order.  Variants, in the tool's
order (what each computes is what its TPU body computes):

* ``rowload u8``, ``rowload u16``, ``tileload u8``, ``tileload u16``:
  out[:, j] = row idx[j];
* ``probe noidx u8``: out[:, j] = quad[(k + t*64) % 4096, 24*(idx[j]%4) :
  +24] with p = j % 1024, k = p // 8, t = p % 8 (needs t4 >= 4096);
* ``probe noextract u8``: out[:, j] = quad[idx[j] // 4, 0:24].

An index outside [0, 4 * t4) reads a zero row.  csrc/gather_variants.cu
says how the variants read the table.  ``gather_variant`` launches it on
a CUDA tensor and runs ``gather_variant_plain`` (torch indexing on the
(4 * t4, 24) row view) on a CPU tensor.  Each variant is reported in ms
and ns per row, with its plain version's time, and on the card the time
of ``index_select`` plus the transpose to limb-major for the two gathers.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from . import bound_ms, describe, parser, pick_device, timed_ms
from ..ops import _build

ROW = 24
BLK = 1024
VARIANTS = ("rowload u8", "rowload u16", "tileload u8", "tileload u16",
            "probe noidx u8", "probe noextract u8")
#: variants that compute the plain row gather (the probes do not)
GATHERS = VARIANTS[:4]

#: launches since the last reset (read by tools/kernel_table.py)
LAUNCHES = {f"pgather_variants:{v}": 0 for v in VARIANTS}


def make_inputs(n: int, windows: int, seed: int = 0, device=None):
    """The tool's quads (t4, 128) and idx (windows * n,) as int32 tensors,
    drawn in the tool's order from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    t4 = (n + 4) // 4
    quad = rng.integers(0, 1 << 32, (t4, 128), dtype=np.uint32)
    idx = rng.integers(0, n, (windows * n,), dtype=np.int32)
    return (torch.from_numpy(quad.view(np.int32)).to(device),
            torch.from_numpy(idx).to(device))


def row_view(quad: torch.Tensor) -> torch.Tensor:
    """The (4 * t4, 24) rows of the quads, then one zero row."""
    t4 = quad.shape[0]
    rows = quad[:, :4 * ROW].reshape(4 * t4, ROW)
    return torch.cat([rows, rows.new_zeros((1, ROW))])


def source_rows(variant: str, idx: torch.Tensor, t4: int) -> torch.Tensor:
    """The int64 row of the (4 * t4 + 1, 24) row view that each output
    column of ``variant`` reads (4 * t4 is the zero row)."""
    i = idx.to(torch.int64)
    if variant == "probe noidx u8":
        p = torch.arange(i.numel(), device=i.device) % BLK
        return 4 * ((p // 8 + (p % 8) * 64) % 4096) + (i & 3)
    live = (i >= 0) & (i < 4 * t4)
    if variant == "probe noextract u8":
        i = 4 * (i >> 2)
    return torch.where(live, i, torch.full_like(i, 4 * t4))


def _check(variant: str, quad: torch.Tensor, idx: torch.Tensor) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"gather_variant: unknown variant {variant!r}")
    if quad.dim() != 2 or quad.shape[1] != 128 or quad.dtype != torch.int32:
        raise ValueError(f"gather_variant: quads must be int32 (t4, 128), got "
                         f"{quad.dtype} {tuple(quad.shape)}")
    if idx.dim() != 1 or idx.dtype != torch.int32 or idx.numel() % BLK:
        raise ValueError(f"gather_variant: idx must be int32 (m,) with m a "
                         f"multiple of {BLK}, got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    if variant == "probe noidx u8" and quad.shape[0] < 4096:
        raise ValueError("gather_variant: the noidx probe needs t4 >= 4096")


def gather_variant_plain(variant: str, quad: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    _check(variant, quad, idx)
    rows = row_view(quad)
    return rows[source_rows(variant, idx, quad.shape[0])].T.contiguous()


def gather_variant(variant: str, quad: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """(24, m) int32 for ``variant``: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    _check(variant, quad, idx)
    if quad.device.type == "cpu" and idx.device.type == "cpu":
        return gather_variant_plain(variant, quad, idx)
    if (quad.device != idx.device or quad.device.type != "cuda"
            or not quad.is_contiguous() or not idx.is_contiguous()
            or quad.data_ptr() % 16):
        raise ValueError("gather_variant: needs contiguous CUDA quads "
                         "(16-byte aligned) and idx on the same card")
    m = idx.numel()
    out = torch.empty((ROW, m), dtype=torch.int32, device=quad.device)
    fn = _build.declare(_build.lib("gather_variants").pm_gather_variant, 7)
    _build.check(fn(VARIANTS.index(variant), quad.data_ptr(), quad.shape[0],
                    idx.data_ptr(), out.data_ptr(), m, _build.stream(out)),
                 f"gather_variant {variant}")
    LAUNCHES[f"pgather_variants:{variant}"] += 1
    return out


def library_gather(rows: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """One PyTorch call for the row gather (the yardstick, used nowhere
    else): index_select on the row view, then limb-major."""
    return rows.index_select(0, idx).T.contiguous()


def mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    """Output columns that differ anywhere (0 required)."""
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    return int((got != want).any(dim=0).sum())


def main(argv=None) -> dict:
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, default=18)
    ap.add_argument("--windows", type=int, default=22)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10,
                    help="back-to-back launches timed per variant")
    args = ap.parse_args(argv)
    dev = pick_device(args.device)
    n = 1 << args.log_n
    quad, idx = make_inputs(n, args.windows, args.seed, dev)
    t4, m = quad.shape[0], idx.numel()
    # the quads, idx and the output each moved once; no arithmetic
    b, by = bound_ms(t4 * 128 * 4 + m * 4 + ROW * m * 4, 0)
    lib_ms = None
    if dev.type == "cuda":
        rows = row_view(quad)
        library_gather(rows, idx)
        _, lib_ms = timed_ms(lambda: library_gather(rows, idx), dev, args.reps)
        del rows
    out = []
    for v in VARIANTS:
        if v == "probe noidx u8" and t4 < 4096:
            continue
        want, plain_ms = timed_ms(lambda: gather_variant_plain(v, quad, idx),
                                  dev)
        got = gather_variant(v, quad, idx)
        bad = mismatches(got, want)
        del got
        got, ms = timed_ms(lambda: gather_variant(v, quad, idx), dev,
                           args.reps)
        bad += mismatches(got, want)
        if bad:
            raise AssertionError(f"gather_variant {v}: {bad} columns differ "
                                 f"from the plain version")
        del got, want
        out.append({"name": v, "ms": ms, "ns_per_row": ms * 1e6 / m,
                    "plain_ms": plain_ms,
                    "library_ms": lib_ms if v in GATHERS else None,
                    "bound_ms": b, "bound_by": by, "mismatches": 0,
                    "max_abs_err": 0, "reps": args.reps})
        print(f"# {v:20s} {ms:8.3f} ms  {ms * 1e6 / m:6.3f} ns/row  plain "
              f"{plain_ms:8.3f} ms  bound {b:.3f} ms  ok", flush=True)
    res = {**describe(dev), "n": n, "windows": args.windows, "t4": t4,
           "m": m, "library": "index_select + transpose", "library_ms": lib_ms,
           "variants": out}
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
