"""Every kernel of the port alone, at the main path's shapes: the rows of
PERF.md's kernel table.

    python3 -m polymath_tpu_torch.tools.kernel_table [--device cpu]

Each row runs the kernel's plain version once (it is slow and no
yardstick of speed), warms the kernel up, times ``reps`` back-to-back
calls with CUDA events, and compares the last result with the plain one
(``cases.compare``: bit for bit; the tree kernels as affine points).  It
reports the kernel's ms, its bound (``bound_ms``: each input read once and
each output written once at ``MEM_RATE``, or the formulas' 32-bit
multiply-adds at ``INT_OPS_RATE``, the larger), the plain version's ms,
the launches of one call (the wrappers' ``LAUNCHES``) and, where one
PyTorch call does the same work, the library's ms.

The shapes (``SHAPES``) are the bench workload's, n = 2^21: the prover's
widest Fr vectors (2n); the fixed-base pass of setup (2^20 lanes); one MSM
chunk of 2^19 points (20 windows of 2048 rows, 256 steps); the 2^22- and
2^23-point NTTs' local batches; the quotient scan over the D numerator's
D + 1 = 20,971,543 coefficients.  The inputs (``cases``) hold the edge
words and degenerate points.  T1 and T2 come from ``pgather_variants`` and
``primbench`` run through their ``main`` at their default sizes.

Prints one line a row, then the whole table as one JSON line;
``main(argv=None) -> dict`` returns it.  ``--device cpu`` runs the plain
versions against themselves, on the host clock: no time it reports is a
device time.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from . import (ADD_OPS, BFLY_OPS, DOUBLE_OPS, FR_MUL_OPS, FR_SQR_OPS,
               MADD_OPS, TO_AFFINE_OPS, bound_ms, describe, parser,
               pick_device, timed_ms)
from . import cases as K
from . import pgather_variants, primbench
from ..ops import cuda_curve, cuda_field, cuda_gather, cuda_poly, cuda_scan
from ..ops import cuda_tree, poly
from ..ops import msm as M
from ..ops import ntt as N
from ..ops.field import fr_const

#: the bench workload's shapes (module docstring); the arguments of the T1
#: and T2 tools' ``main``
SHAPES = {"fr": 1 << 22, "lanes": 1 << 20, "chunk": 1 << 19,
          "ntt": (2048, 2048), "ntt_wide": (2048, 4096),
          "quotient": 20_971_543, "pgather_variants": [], "primbench": []}
#: the sums of sets timed beside the jac_add chains they replaced (the d
#: MSM's 40 chunks, the other MSMs' 4), with the dependent adds on the
#: kernel's critical path, ceil(log2 k)
SUM_SETS_TIMED = {40: 6, 4: 2}

FIELD = "polymath_tpu_torch/csrc/field.cu"
G1 = "polymath_tpu_torch/csrc/g1.cu"
SCAN = "polymath_tpu_torch/csrc/scan.cu"
TREE = "polymath_tpu_torch/csrc/tree.cu"
NTT = "polymath_tpu_torch/csrc/ntt.cu"
POLY = "polymath_tpu_torch/csrc/poly.cu"
ADD_REPLACES = "polymath_tpu/ops/pallas_curve.py:32"
MUL_REPLACES = "polymath_tpu/ops/pallas_field.py:37"
NTT_REPLACES = "polymath_tpu/ops/ntt.py:87"


def _points() -> int:
    """Lanes of distinct points and planted cases (``cases.point_inputs``)
    that the wider point inputs repeat."""
    return min(1 << 12, SHAPES["lanes"])


def _size(n: int) -> str:
    return f"2^{n.bit_length() - 1}" if n & (n - 1) == 0 else str(n)


class Table:
    """The rows taken so far on ``dev``."""

    def __init__(self, dev):
        self.dev, self.rows = dev, {}

    def reps(self, n: int) -> int:
        """``n`` timed calls on the card; one on the CPU, whose times are
        the plain versions' on the host clock and measure nothing."""
        return n if self.dev.type == "cuda" else 1

    def add(self, name: str, shape: str, ms: float, bound: tuple,
            **extra) -> dict:
        """One row: ``bound`` is ``bound_ms``'s (ms, "bytes" or
        "operations")."""
        row = {"name": name, "shape": shape, "ms": ms, "bound_ms": bound[0],
               "bound_by": bound[1], "plain_ms": None, "library_ms": None,
               "launches": None, **extra}
        self.rows[name] = row
        plain = "" if row["plain_ms"] is None else \
            f"  plain {row['plain_ms']:10.3f} ms"
        lib = "" if row["library_ms"] is None else \
            f"  library {row['library_ms']:8.4f} ms"
        calls = "" if row["launches"] is None else \
            f"  launches {json.dumps(row['launches'])}"
        print(f"{name:28s} {shape:>38s}  kernel {ms:9.4f} ms  bound "
              f"{bound[0]:9.6f} ms ({bound[1]}){plain}{lib}{calls}",
              flush=True)
        return row

    def measure(self, name, source, replaces, shape, kernel, plain, reps,
                nbytes, ops, library=None, cmp=K.compare, **extra) -> dict:
        """The kernel against its plain version on the same inputs.  Two
        warm-up results are held at once, so that the timed calls reuse
        their two blocks and no allocation lands in the timed region."""
        reps = self.reps(reps)
        want, plain_ms = timed_ms(plain, self.dev)
        K.reset_launches()
        warm = kernel(), kernel()
        del warm
        got, ms = timed_ms(kernel, self.dev, reps)
        calls = {k: v // (reps + 2) for k, v in K.launches().items() if v}
        err = cmp(name, got, want)
        del got
        lib_ms = None
        if library is not None:
            warm = library(), library()
            del warm
            got, lib_ms = timed_ms(library, self.dev, reps)
            K.compare(f"{name} library call", got.reshape(want.shape), want)
            del got
        return self.add(name, shape, ms, bound_ms(nbytes, ops),
                        source=source, replaces=replaces, max_abs_err=err,
                        plain_ms=plain_ms, library_ms=lib_ms, launches=calls,
                        **extra)

    def timed(self, name, shape, kernel, check, reps, nbytes, ops,
              **extra) -> dict:
        """A kernel at a second shape of its row: checked, then timed."""
        kernel()
        got, ms = timed_ms(kernel, self.dev, self.reps(reps))
        check(got)
        return self.add(name, shape, ms, bound_ms(nbytes, ops), **extra)


def field_rows(t: Table) -> None:
    dev, n = t.dev, SHAPES["fr"]
    big = K.field_inputs(dev, 1 << 12, 3).repeat(1, n >> 12)
    big2 = big.roll(7, 1).contiguous()
    t.measure("fr_mul", FIELD, MUL_REPLACES, f"(8, {_size(n)}) x (8, "
              f"{_size(n)})", lambda: cuda_field.fr_mul(big, big2),
              lambda: K.plain_fr_mul(big, big2), 20, 3 * 32 * n,
              FR_MUL_OPS * n)
    t.measure("fr_sqr", FIELD, "polymath_tpu/ops/pallas_field.py:43",
              f"(8, {_size(n)})", lambda: cuda_field.fr_sqr(big),
              lambda: K.plain_fr_sqr(big), 20, 2 * 32 * n, FR_SQR_OPS * n)
    # one radix-2 stage of the 2n-point transform
    half = n // 2
    lo, hi, tw = big[:, :half], big2[:, :half], big2[:, half:]
    t.measure("fr_butterfly", FIELD, "polymath_tpu/ops/pallas_field.py:28",
              f"(8, {_size(half)}) pairs",
              lambda: cuda_field.fr_butterfly(lo, hi, tw),
              lambda: K.plain_butterfly(lo, hi, tw), 20, 5 * 32 * half,
              BFLY_OPS * half)
    # the shape at which the blocked recurrence that the quotient scan's
    # kernels replaced launched fr_mul (ops/poly.py:affine_scan_plain): a
    # step of level 0, one row a block of _SEQ, times the (8, 1) multiplier
    rows = -(-SHAPES["quotient"] // poly._SEQ)
    step, m1 = big[:, :rows], big2[:, :1]
    t.timed("fr_mul (quotient step)", f"(8, {rows}) x (8, 1)",
            lambda: cuda_field.fr_mul(step, m1),
            lambda got: K.compare("fr_mul (quotient step)", got,
                                  K.plain_fr_mul(step, m1)),
            50, 2 * 32 * rows + 32, FR_MUL_OPS * rows)


def curve_rows(t: Table) -> None:
    dev = t.dev
    acc, leaf, q = K.point_inputs(dev, _points())
    # the MSM scan step: every window's rows of one chunk
    chunk = SHAPES["chunk"]
    _, windows = M.window_params(chunk)
    lanes = windows * (chunk // M.scan_seq(chunk))
    reps = -(-lanes // acc.shape[1])
    acc_l = acc.repeat(1, reps)[:, :lanes].contiguous()
    leaf_l = leaf.repeat(1, reps)[:, :lanes].contiguous()
    live = int(((acc_l[24:] != 0).any(0) & (leaf_l[12:] != 0).any(0)).sum())
    t.measure("jac_madd", G1, "polymath_tpu/ops/pallas_curve.py:49",
              f"({lanes} lanes) fast",
              lambda: cuda_curve.jac_madd(acc_l, leaf_l, True)[0],
              lambda: K.plain_madd(acc_l, leaf_l, True)[0], 20,
              (36 * 2 + 24) * 4 * lanes + 4 * lanes, MADD_OPS * live)

    # the fixed-base pass of setup (also the widest MSM adds)
    lanes = SHAPES["lanes"]
    acc_l = acc.repeat(1, lanes // acc.shape[1])
    q_l = q.repeat(1, lanes // acc.shape[1])
    live = int(((acc_l[24:] != 0).any(0) & (q_l[24:] != 0).any(0)).sum())
    t.measure("jac_add", G1, ADD_REPLACES, f"({_size(lanes)} lanes)",
              lambda: cuda_curve.jac_add(acc_l, q_l),
              lambda: K.plain_add(acc_l, q_l), 10, 36 * 3 * 4 * lanes,
              ADD_OPS * live)
    del q_l
    # the shape the prover ran it at until the sums of sets: one MSM's
    # (36, 20) window sums plus the next chunk's; latency-bound
    acc_w, q_w = acc[:, 100:120].contiguous(), q[:, 100:120].contiguous()
    t.timed("jac_add (window sums)", "(36, 20)",
            lambda: cuda_curve.jac_add(acc_w, q_w),
            lambda got: K.compare("jac_add (36, 20)", got,
                                  K.plain_add(acc_w, q_w)),
            50, 36 * 3 * 4 * 20, ADD_OPS * 20)
    # no early return: every lane, the identity ones too, does the work
    t.measure("jac_double", G1, "polymath_tpu/ops/pallas_curve.py:41",
              f"({_size(lanes)} lanes)",
              lambda: cuda_curve.jac_double(acc_l),
              lambda: K.plain_double(acc_l), 10, 36 * 2 * 4 * lanes,
              DOUBLE_OPS * lanes)
    t.measure("to_affine", G1, "polymath_tpu/ops/fixed_base.py:95",
              f"({_size(lanes)} lanes)", lambda: cuda_curve.to_affine(acc_l),
              lambda: K.plain_to_affine(acc_l), 5, (36 + 24) * 4 * lanes,
              TO_AFFINE_OPS * lanes,
              note="port-only kernel: the reference inverts Z with XLA "
                   "ops, no Pallas kernel")


def sum_sets_rows(t: Table) -> None:
    """The sums of an MSM's chunk sums at the prover's 20 windows, beside
    the jac_add chains they replaced (the plain version over the jac_add
    kernel: k - 1 launches of one add a lane) on the same inputs.  Work: a
    window's L sets other than the identity need L - 1 adds."""
    for k, depth in SUM_SETS_TIMED.items():
        parts, ks = K.sum_sets_inputs(t.dev, k, 20, 60 + k)
        adds = int(np.maximum((ks != 0).sum(0) - 1, 0).sum())
        cuda_tree.sum_sets_plain(parts, cuda_curve.jac_add)
        chain, chain_ms = timed_ms(
            lambda: cuda_tree.sum_sets_plain(parts, cuda_curve.jac_add),
            t.dev, t.reps(20))
        K.compare_points(f"jac_add chain ({k}, 36, 20)", chain,
                         cuda_tree.sum_sets_plain(parts))
        t.measure(f"sum_sets ({k} sets)", TREE, ADD_REPLACES,
                  f"({k}, 36, 20) window sums",
                  lambda: cuda_tree.sum_sets(parts),
                  lambda: cuda_tree.sum_sets_plain(parts), 50,
                  36 * 4 * 20 * (k + 1), ADD_OPS * adds,
                  cmp=K.compare_points, critical_path_adds=depth,
                  chain_ms=chain_ms, chain_launches=k - 1)


def msm_rows(t: Table) -> None:
    dev, chunk = t.dev, SHAPES["chunk"]
    # one chunk's bucket permutation from a table of ``chunk`` rows
    acc, leaf, _ = K.point_inputs(dev, _points())
    table = torch.cat([leaf.T, acc[:24].T]).contiguous()   # (2 x 4096, 24)
    del acc, leaf
    table_l = table.repeat(-(-chunk // table.shape[0]), 1)[:chunk]
    table_l = table_l.contiguous()
    c, windows = M.window_params(chunk)
    seq = M.scan_seq(chunk)
    g = torch.Generator(device="cpu").manual_seed(7)
    idx_l = torch.randint(0, chunk + 1, (seq, windows, chunk // seq),
                          generator=g).to(dev)
    m = idx_l.numel()
    # the library call: index_select on the table with its zero row (index
    # T), then the transpose to limb-major
    table_z = torch.cat([table_l, table_l.new_zeros((1, 24))])
    idx_f = idx_l.reshape(-1)
    t.measure("gather_rows", G1, "polymath_tpu/ops/pallas_gather.py:47",
              f"({_size(chunk)}, 24) table, {windows} x {_size(chunk)} rows",
              lambda: cuda_gather.gather_rows(table_l, idx_l),
              lambda: cuda_gather.gather_rows_plain(table_l, idx_l), 10,
              chunk * 96 + m * (8 + 96), 0,
              library=lambda: table_z.index_select(0, idx_f).T.contiguous())
    del table_l, idx_l, table_z, idx_f

    # the same chunk through the fused scan, fast as the prover runs it, on
    # the bucket order of random scalars over distinct points.  Work: every
    # live leaf after a lane's first is one full madd.
    table_c, idx_c, d_sorted = K.chunk_inputs(dev, chunk)
    lanes = idx_c[0].numel()
    live = (idx_c < table_c.shape[0]).reshape(seq, lanes).sum(0)
    madds = int((live - 1).clamp(min=0).sum())
    shape = tuple(idx_c.shape)
    t.measure("fused_scan", SCAN, "polymath_tpu/ops/pallas_scan.py:64",
              f"({_size(chunk)}, 24) table, {shape} idx",
              lambda: cuda_scan.fused_scan_msm(table_c, idx_c, True),
              lambda: cuda_scan.fused_scan_msm_plain(table_c, idx_c, True), 5,
              table_c.numel() * 4 + idx_c.numel() * 8
              + 36 * 4 * idx_c.numel() + 4 * lanes, MADD_OPS * madds)
    # the split configuration's scan over the same chunk's gathered leaves
    leaves = cuda_gather.gather_rows(table_c, idx_c)
    t.measure("madd_scan", SCAN, "polymath_tpu/ops/pallas_curve.py:49",
              f"(24, {', '.join(map(str, shape))}) leaves, fast",
              lambda: cuda_scan.madd_scan(leaves, True),
              lambda: cuda_scan.madd_scan_plain(leaves, True), 5,
              (24 + 36) * 4 * idx_c.numel() + 4 * lanes, MADD_OPS * madds)
    del leaves
    # the chunk's tree: row totals and the thresholds of each window.
    # Work: an exclusive prefix of R rows needs R - 2 adds; a threshold
    # with a count adds its row's offset unless the row is 0, and a
    # window's L live thresholds need L - 1 adds to sum.
    local, _ = M.scan_local(table_c, idx_c, True, True)
    del table_c, idx_c
    ps, cnt, r_of = M.threshold_prefixes(local, d_sorted, c)
    totals = local[:, seq - 1]
    rows = totals.shape[2]
    t.measure("row_offsets", TREE, ADD_REPLACES,
              f"(36, {windows}, {rows}) row totals",
              lambda: cuda_tree.row_offsets(totals),
              lambda: cuda_tree.row_offsets_plain(totals), 10,
              2 * 36 * 4 * windows * rows, ADD_OPS * windows * (rows - 2),
              cmp=K.compare_points)
    offs = cuda_tree.row_offsets(totals)
    del local, totals
    n_live = (cnt > 0).sum(1)
    adds = int(((cnt > 0) & (r_of > 0)).sum()) \
        + int((n_live - 1).clamp(min=0).sum())
    t.measure("window_fold", TREE, ADD_REPLACES,
              f"(36, {windows}, {ps.shape[2]}) thresholds",
              lambda: cuda_tree.window_fold(ps, cnt, r_of, offs),
              lambda: cuda_tree.window_fold_plain(ps, cnt, r_of, offs), 10,
              (36 * 4 + 16) * ps[0].numel() + 36 * 4 * (offs[0].numel()
                                                          + windows),
              ADD_OPS * adds, cmp=K.compare_points)


def ntt_rows(t: Table) -> None:
    """The local batches of the 2n-point transform and of the 2^23-point
    one's wider half (n = 2^22's squaring)."""
    for name, key, seed in (("ntt_local", "ntt", 6),
                            ("ntt_local (wide)", "ntt_wide", 13)):
        batch, length = SHAPES[key]
        x = K.field_inputs(t.dev, 1 << 12, seed).repeat(
            1, batch * length >> 12).reshape(8, batch, length)
        tw = N.local_twiddles(length, False, t.dev)
        pts = batch * length
        t.measure(name, NTT, NTT_REPLACES, f"(8, {batch}, {length})",
                  lambda: N.ntt_local_kernel(x, tw),
                  lambda: K.plain_ntt_local(x, tw), 10,
                  2 * 32 * pts + 32 * length // 2,
                  FR_MUL_OPS * (pts // 2) * (length.bit_length() - 1))
        del x


def quotient_rows(t: Table) -> None:
    """The quotient scan as stage2b runs it: the D numerator's coefficients
    (2^12 seeded elements repeated) read top down, x1 from a seed; level
    0's reduce, its apply from the real carries, and the whole scan against
    the blocked fr_mul / fr_add recurrence it replaced, with each side's
    launches and the device memory it takes above its input.  One Fr
    product an element."""
    dev, dlen = t.dev, SHAPES["quotient"]
    coeffs = K.field_inputs(dev, 1 << 12, 12).repeat(
        1, -(-dlen // 4096))[:, :dlen].contiguous()
    x1 = K.scan_multipliers(9)[0]
    rows = cuda_poly.rows_of(dlen)
    shape = f"(8, {dlen}) reversed, level 0"
    note = ("B1 (_mul_kernel) as the reference's quotient scan runs it: "
            "poly_jax.py:affine_scan :23-75, its fr_mul carry :70-72")
    t.measure("affine_scan_reduce", POLY, MUL_REPLACES, shape,
              lambda: cuda_poly.affine_scan_reduce(coeffs, x1, True),
              lambda: cuda_poly.affine_scan_reduce_plain(coeffs, x1, True),
              10, 32 * (dlen + rows), FR_MUL_OPS * dlen, note=note)
    totals = cuda_poly.affine_scan_reduce(coeffs, x1, True)
    carry = poly.affine_scan(
        totals, fr_const(poly.plan_levels(dlen, x1)[1][1], dev))
    t.measure("affine_scan_apply", POLY, MUL_REPLACES, shape,
              lambda: cuda_poly.affine_scan_apply(coeffs, x1, carry, True),
              lambda: cuda_poly.affine_scan_apply_plain(coeffs, x1, carry,
                                                        True),
              10, 32 * (2 * dlen + rows), FR_MUL_OPS * dlen, note=note)
    del totals, carry

    def scan_run(fn):
        base = _memory(dev, reset=True)
        K.reset_launches()
        res, ms = timed_ms(fn, dev)
        counts = {k: v for k, v in K.launches().items() if v}
        return res, ms, _memory(dev) - base, counts

    x1_m = fr_const(x1, dev)
    want, plain_ms, plain_peak, plain_counts = scan_run(
        lambda: K.plain_scan(coeffs, x1_m, True))
    got, _, peak, counts = scan_run(
        lambda: poly.affine_scan(coeffs, x1_m, True))
    err = K.compare("quotient scan", got, want)
    del got, want
    warm = (poly.synthetic_divide_device(coeffs, x1_m),
            poly.synthetic_divide_device(coeffs, x1_m))
    del warm
    _, ms = timed_ms(lambda: poly.synthetic_divide_device(coeffs, x1_m),
                     dev, t.reps(10))
    t.add("quotient scan", f"(8, {dlen}) reversed", ms,
          bound_ms(2 * 32 * dlen, FR_MUL_OPS * dlen),
          source="polymath_tpu_torch/ops/poly.py", replaces="stage2b",
          max_abs_err=err, plain_ms=plain_ms, launches=counts,
          plain_launches=plain_counts, peak_bytes=peak,
          plain_peak_bytes=plain_peak)


def _memory(dev, reset: bool = False) -> int:
    """Device bytes allocated (``reset``: now, after clearing the peak),
    else the peak since the reset; 0 on the CPU."""
    if dev.type != "cuda":
        return 0
    if reset:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        return torch.cuda.memory_allocated(dev)
    return torch.cuda.max_memory_allocated(dev)


def tool_rows(t: Table) -> None:
    """T1 and T2 through their tools' ``main``, with the launches each
    variant or row made there."""
    args = ["--device", t.dev.type]
    K.reset_launches()
    gv = pgather_variants.main(args + SHAPES["pgather_variants"])
    for v in gv["variants"]:
        name = f"pgather_variants:{v['name']}"
        t.add(name, f"({gv['t4']}, 128) quads -> (24, {gv['m']})", v["ms"],
              (v["bound_ms"], v["bound_by"]),
              **{k: v[k] for k in ("plain_ms", "library_ms", "max_abs_err",
                                   "ns_per_row")},
              source="polymath_tpu_torch/csrc/gather_variants.cu",
              replaces="tools/pgather_variants.py:19",
              launches=pgather_variants.LAUNCHES[name])
    pb = primbench.main(args + SHAPES["primbench"])
    for r in pb["rows"]:
        name = f"primbench:{r['name']}"
        t.add(name, f"({primbench.GRID * primbench.ROWS}, "
              f"{primbench.LANES}), K = {primbench.K}", r["ms"],
              (r["bound_ms"], r["bound_by"]),
              **{k: r[k] for k in ("plain_ms", "max_abs_err", "compared",
                                   "ps_per_op")},
              source="polymath_tpu_torch/csrc/primbench.cu",
              replaces="tools/primbench.py:38",
              launches=primbench.LAUNCHES[name],
              sass_step_instructions=(pb.get("sass") or {}).get(
                  r["name"], {}).get("count"))


def main(argv=None) -> dict:
    args = parser(__doc__.splitlines()[0]).parse_args(argv)
    dev = pick_device(args.device)
    t = Table(dev)
    for rows in (field_rows, curve_rows, sum_sets_rows, msm_rows, ntt_rows,
                 quotient_rows, tool_rows):
        rows(t)
    out = {**describe(dev), "kernels": t.rows}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
