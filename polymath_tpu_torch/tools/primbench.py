"""Primitive-cost chains (counterpart of tools/primbench.py): what one 32-bit
(or 16-bit) operation costs on the card in a chain of K = 512 dependent
steps.

    python3 -m polymath_tpu_torch.tools.primbench [--device cpu] [--reps N]
        [--seed S]

Each row computes o = body^K(x) elementwise over (GRID * ROWS, LANES) =
(512, 256) elements filled with the row's ``init``, with a = x and b = x
to start, and reports ms, ps per operation and Top/s.  ``chain(row, x)``
launches csrc/primbench.cu on a CUDA tensor and runs ``chain_plain`` (the
same chain in PyTorch, integer rows in int64 masked to 32 or 16 bits) on a
CPU tensor.  On the card every row is held against its plain version, on
the constant input and on a random one drawn from ``--seed``: bit for bit,
but for the f32 b * a + a row, which is one fused multiply-add on the card
and two roundings in the plain version, held at rtol 1e-4.  (At the
constant input 1 + 2^-23 a tolerance could not tell the f32 mul chain
from its input; compared bit for bit, a chain one step short fails.)
``sass_counts`` checks that each instantiation kept its K instructions.
"""

from __future__ import annotations

import collections
import json
import re
import subprocess
from dataclasses import dataclass

import numpy as np
import torch

from . import (F32_OPS_RATE, INT_OPS_RATE, bound_ms, describe, parser,
               pick_device, timed_ms)
from ..ops import _build

K = 512
ROWS, LANES = 8, 256
GRID = 64                       # elements = GRID * ROWS * LANES = 2^17
F32_RTOL = 1e-4
#: the one row the plain version cannot match bit for bit (FFMA vs two
#: roundings); every other row is compared exactly
FUSED_ROW = "f32 fma-ish"
_M32 = 0xFFFFFFFF


@dataclass(frozen=True)
class Row:
    name: str
    kind: str            # "u32", "i32", "f32" or "u16"
    init: float
    ops: int             # operations per step on the card
    sass: tuple          # SASS mnemonics that carry one step


#: the tool's nine rows, in its order (tools/primbench.py:58-66); the index
#: is the kernel's template argument
ROW_SPECS = (
    Row("u32 add", "u32", 3, 1, ("IADD3", "IMAD.IADD", "IADD")),
    Row("u32 mul", "u32", 3, 1, ("IMAD",)),
    Row("u32 mul (a<2^16 hint?)", "u32", 3, 2, ("IMAD",)),
    Row("u32 shift+and", "u32", 3, 2, ("SHF",)),
    Row("i32 mul", "i32", 3, 1, ("IMAD",)),
    Row("f32 mul", "f32", 1.0000001, 1, ("FMUL",)),
    Row("f32 fma-ish", "f32", 1.0000001, 1, ("FFMA",)),
    Row("u16 mul", "u16", 3, 1, ("IMAD",)),
    Row("u32 select", "u32", 3, 1, ("SEL",)),
)
NAMES = tuple(r.name for r in ROW_SPECS)
#: kind -> (numpy value type, numpy type of the stored bits, torch dtype)
_TYPES = {"u32": (np.uint32, np.int32, torch.int32),
          "i32": (np.uint32, np.int32, torch.int32),
          "u16": (np.uint16, np.int16, torch.int16),
          "f32": (np.float32, np.float32, torch.float32)}
#: multiply-adds that are not a product (moves, shifts, wide products)
_NOT_PRODUCTS = ("IMAD.MOV", "IMAD.SHL", "IMAD.WIDE", "IMAD.HI", "IMAD.IADD",
                 "IMAD.X")

#: launches since the last reset (read by chip_smoke.py)
LAUNCHES = {f"primbench:{n}": 0 for n in NAMES}


def row_index(row) -> int:
    return NAMES.index(row) if isinstance(row, str) else int(row)


def make_input(row, device=None, seed: int | None = None) -> torch.Tensor:
    """(GRID * ROWS, LANES) input of the row's type: filled with ``init``
    as the tool, or, with a seed, random (integer rows over their whole
    range, f32 rows in [0.999, 1.001), where 512 steps neither overflow nor
    reach subnormals)."""
    spec = ROW_SPECS[row_index(row)]
    value, stored, _ = _TYPES[spec.kind]
    shape = (GRID * ROWS, LANES)
    if seed is None:
        x = np.full(shape, spec.init, value)
    elif spec.kind == "f32":
        x = np.random.default_rng(seed).uniform(0.999, 1.001, shape)
        x = x.astype(np.float32)
    else:
        x = np.random.default_rng(seed).integers(
            0, np.iinfo(value).max, shape, dtype=value, endpoint=True)
    return torch.from_numpy(x.view(stored)).to(device)


def _mul32(x, y):
    """x * y mod 2^32 of values below 2^32 in int64 (each partial product
    stays below 2^48)."""
    lo = x * (y & 0xFFFF)
    hi = ((x * (y >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def chain_plain(row, x: torch.Tensor) -> torch.Tensor:
    """The row's chain in PyTorch: integer rows in int64 masked to their
    width each step (torch's uint32 arithmetic is incomplete), f32 rows in
    float32 with one rounding per operation."""
    spec = ROW_SPECS[row_index(row)]
    if spec.kind == "f32":
        a = x
        b = a
        for _ in range(K):
            b = b * a if spec.name == "f32 mul" else b * a + a
        return b
    bits = 16 if spec.kind == "u16" else 32
    mask = (1 << bits) - 1
    a = x.to(torch.int64) & mask
    b = a
    lo = a & 0xFFFF
    for _ in range(K):
        if spec.name == "u32 add":
            b = (b + a) & mask
        elif spec.name == "u32 mul (a<2^16 hint?)":
            b = ((b & 0xFFFF) * a) & mask
        elif spec.name == "u32 shift+and":
            b = (b >> 1) ^ lo
        elif spec.name == "u16 mul":
            b = (b * a) & mask
        elif spec.name == "u32 select":
            b = torch.where(a > 1, b, a)
        else:                                   # u32 and i32 mul
            b = _mul32(b, a)
    b = torch.where(b >= 1 << (bits - 1), b - (1 << bits), b)
    return b.to(x.dtype)


def chain(row, x: torch.Tensor) -> torch.Tensor:
    """o = body^K(x) for row ``row`` (index or name): the kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    i = row_index(row)
    spec = ROW_SPECS[i]
    if x.dtype != _TYPES[spec.kind][2]:
        raise TypeError(f"primbench {spec.name}: expected "
                        f"{_TYPES[spec.kind][2]}, got {x.dtype}")
    if x.device.type == "cpu":
        return chain_plain(i, x)
    if x.device.type != "cuda" or not x.is_contiguous():
        raise ValueError(f"primbench {spec.name}: needs a contiguous CUDA "
                         f"tensor")
    out = torch.empty_like(x)
    fn = _build.declare(_build.lib("primbench").pm_primbench, 5)
    _build.check(fn(i, x.data_ptr(), out.data_ptr(), x.numel(),
                    _build.stream(x)), f"primbench {spec.name}")
    LAUNCHES[f"primbench:{spec.name}"] += 1
    return out


def max_error(row, got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| (unsigned words for the integer rows); raises
    unless every row but the fused f32 one agrees bit for bit, and that one
    within rtol 1e-4."""
    spec = ROW_SPECS[row_index(row)]
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"primbench {spec.name}: got {got.dtype} "
                             f"{tuple(got.shape)}, want {want.dtype} "
                             f"{tuple(want.shape)}")
    if spec.name == FUSED_ROW:
        if not torch.allclose(got, want, rtol=F32_RTOL, atol=0.0):
            raise AssertionError(f"primbench {spec.name}: outside rtol "
                                 f"{F32_RTOL} of the plain version")
        return float((got - want).abs().max())
    bits = (got.view(torch.int32), want.view(torch.int32)) \
        if spec.kind == "f32" else (got, want)
    differ = bits[0] != bits[1]
    if bool(differ.any()):
        raise AssertionError(f"primbench {spec.name}: {int(differ.sum())}"
                             f" elements differ from the plain version")
    return 0.0


def row_bound_ms(row) -> tuple:
    """The bound of one launch: K steps over all elements at the card's
    integer or fp32 rate, or the input and output bytes."""
    spec = ROW_SPECS[row_index(row)]
    n = GRID * ROWS * LANES
    return bound_ms(2 * n * (2 if spec.kind == "u16" else 4),
                    K * n * spec.ops,
                    F32_OPS_RATE if spec.kind == "f32" else INT_OPS_RATE)


_FUNC = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def _counts(mnemonic: str, ops) -> bool:
    return (any(mnemonic == op or mnemonic.startswith(op + ".") for op in ops)
            and not any(mnemonic.startswith(x) for x in _NOT_PRODUCTS
                        if x not in ops))


def sass_counts(so_path: str | None = None) -> dict:
    """{row name: {"count": instructions that carry a step, "top": the
    most frequent mnemonics}} from ``cuobjdump -sass`` of the built
    library, one entry per kernel instantiation."""
    so_path = so_path or _build.library_path("primbench")
    sass = subprocess.run([_build.cuda_tool("cuobjdump"), "-sass", so_path],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out = {}
    for part in sass.split("Function : ")[1:]:
        m = re.search(r"chain_kernelILi(\d+)E", part.split(None, 1)[0])
        if not m:
            continue
        spec = ROW_SPECS[int(m.group(1))]
        hist = collections.Counter(_INSN.findall(part))
        out[spec.name] = {
            "count": sum(v for k, v in hist.items() if _counts(k, spec.sass)),
            "top": dict(hist.most_common(4))}
    return out


def check_sass(counts: dict) -> None:
    """Raises unless every row's instantiation holds at least K of its
    row's instruction (the chain was not folded)."""
    short = {n: counts.get(n, {}).get("count", 0) for n in NAMES
             if counts.get(n, {}).get("count", 0) < K}
    if short:
        raise AssertionError(f"primbench: fewer than K = {K} step "
                             f"instructions in the SASS of {short}")


def main(argv=None) -> dict:
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200,
                    help="back-to-back launches timed per row")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random input each row is also "
                         "checked on")
    args = ap.parse_args(argv)
    dev = pick_device(args.device)
    n = GRID * ROWS * LANES
    rows = []
    for i, spec in enumerate(ROW_SPECS):
        x = make_input(i, dev)
        want, plain_ms = timed_ms(lambda: chain_plain(i, x), dev)
        got, first_ms = timed_ms(lambda: chain(i, x), dev)
        err = max_error(i, got, want)
        got, ms = timed_ms(lambda: chain(i, x), dev, args.reps)
        err = max(err, max_error(i, got, want))
        r = make_input(i, dev, args.seed + i)
        err = max(err, max_error(i, chain(i, r), chain_plain(i, r)))
        b, by = row_bound_ms(i)
        ps = ms * 1e9 / (K * n)
        rows.append({"name": spec.name, "first_ms": first_ms, "ms": ms,
                     "ps_per_op": ps, "top_s": 1.0 / ps, "plain_ms": plain_ms,
                     "bound_ms": b, "bound_by": by, "max_abs_err": err,
                     "compared": (f"rtol {F32_RTOL}" if spec.name == FUSED_ROW
                                  else "bit for bit"),
                     "inputs": ["constant", f"seed {args.seed + i}"],
                     "reps": args.reps})
        print(f"# {spec.name:28s} {ms:9.5f} ms  -> {ps:7.3f} ps/op "
              f"({1 / ps:6.2f} Top/s)  plain {plain_ms:8.3f} ms  bound "
              f"{b:8.5f} ms", flush=True)
    res = {**describe(dev), "K": K, "elements": n, "rows": rows}
    if dev.type == "cuda":
        res["sass"] = sass_counts()
    print(json.dumps(res))
    if dev.type == "cuda":
        check_sass(res["sass"])
    return res


if __name__ == "__main__":
    main()
