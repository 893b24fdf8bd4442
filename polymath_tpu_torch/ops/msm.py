"""Pippenger-style variable-base G1 MSM (counterpart of msm.py).

Keeps the reference's skew-proof formulation.  Per chunk of points and per
window w of c-bit digits:

  1. d_i = digit_w(s_i); one sort of (d_i << shift | i) descending gives
     both the sorted digits and the point order;
  2. the ``gather_rows`` kernel permutes the affine bases into that order
     (dead leaves, digit 0, read the zero row: the affine identity);
  3. the sorted leaves, viewed as (rows, seq), run ONE inclusive mixed-add
     scan along seq: ``seq`` launches of the ``jac_madd`` kernel, each over
     all windows and rows at once, writing every local prefix;
  4. an inclusive prefix over the row totals (``jac_add``) gives exclusive
     row offsets;
  5. sum_i d_i P_i = sum_{t=1}^{2^c} PS_{cnt(d >= t)}: the global prefix is
     formed only at the 2^c threshold positions (one ``jac_add`` each) and
     the thresholds fold by pairwise halving.

The fused configuration (``fused=True``, or ``POLYMATH_MSM_FUSED`` set to
``1``/``on``/``true`` when ``fused`` is None, as the reference's
``msm.py:_fused_mode``) replaces steps 2 and 3 with one launch of the
``fused_scan`` kernel per chunk (ops/cuda_scan.py), which reads each leaf
straight from the table and never writes the gathered leaves.  Its
outputs are the split pair's, word for word.  The default is the
reference's: the split scan.

The work per chunk is the same whatever the digit distribution: a digit
repeated across the whole chunk (BenchCircuit's c_w vector) costs what
random digits cost.  Window sums add across chunks on the card; the final
Horner over windows and any peeled tail run on the host through the
native ``g1_msm``.

Bases are the port's packed form: an (N, 24) int32 row table of affine
Montgomery words (x words then y words; (0, 0) is the identity), so each
chunk's gather table is a plain row slice.  Scalars are (8, M) Fr words,
canonical or Montgomery (``mont=True``).

``fast=True`` runs the madd without its doubling branch and asserts the
per-lane collision flag when the result is read; the prover then reruns
safe.  ``defer=True`` returns an ``MsmPending`` whose launches are queued
on the card; ``.result()`` waits for them.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..hostmath import bls12_381 as bls
from .cuda_curve import jac_add, jac_madd
from .cuda_gather import gather_rows
from .cuda_scan import fused_scan_msm
from .curve import (
    AFF, FW, JAC, jac_identity_words, jac_to_host,
    prefix_scan_jac, tree_sum_jac,
)
from .field import fr_from_mont, fr_window_digits
from .limbs import FQ_SPEC, words_to_ints

SCALAR_BITS = 255
DEFAULT_CHUNK = 1 << 19
TAIL_MAX = 64         # a tail this short past whole chunks goes to the host


def window_params(chunk: int):
    """Window width c and count for a chunk of ``chunk`` points.

    Total adds per chunk ~ W*(chunk + 2*2^c) with W = ceil(255/c).  Large
    chunks keep the reference's c = log2(chunk) - 6 (c = 13 at 2^19);
    small ones take the c that minimises the count."""
    log_n = max(chunk, 2).bit_length() - 1
    if chunk <= 4096:
        c = min(8, max(4, log_n - 3))
    else:
        c = min(14, max(8, log_n - 6))
    return c, (SCALAR_BITS + c - 1) // c


def scan_seq(chunk: int) -> int:
    """Scan length per row: about sqrt(chunk) (at least 2, so adjacent
    equal leaves meet in the madd), capped at 256 (the reference's length
    at 2^19, where rows = 2048 keep each launch wide)."""
    return min(256, 1 << (chunk.bit_length() // 2))


def choose_chunk(m: int) -> int:
    """The smallest power of two holding m points, at most DEFAULT_CHUNK."""
    return min(DEFAULT_CHUNK, 1 << max(m - 1, 1).bit_length())


def fused_mode() -> bool:
    """The fused-scan configuration is asked for (reference:
    msm.py:_fused_mode, read at each call)."""
    return os.environ.get("POLYMATH_MSM_FUSED", "") in ("1", "on", "true")


def bucket_order(scalars: torch.Tensor, t: int, c: int, windows: int,
                 seq: int):
    """Step 1 of the module docstring for one chunk: scalars (8, n)
    canonical words, t live table rows.  Returns (idx, d_sorted): idx
    (seq, windows, n // seq) int64 step-major leaf indices (sorted
    position k = r*seq + s at [s, w, r]; dead leaves read row t) and the
    (windows, n) digits in descending order."""
    return sort_digits(fr_window_digits(scalars, c, windows), t, seq)


def sort_digits(digits: torch.Tensor, t: int, seq: int):
    """The sort of ``bucket_order``: (windows, n) int64 digits -> (idx,
    d_sorted)."""
    windows, n = digits.shape
    rows = n // seq
    shift = (n - 1).bit_length()
    iota = torch.arange(n, dtype=torch.int64, device=digits.device)
    skey = torch.sort((digits << shift) | iota, dim=-1,
                      descending=True).values
    d_sorted = skey >> shift
    order = skey & ((1 << shift) - 1)
    idx = torch.where(d_sorted > 0, order, torch.full_like(order, t))
    # step-major layout: sorted position k = r*seq + s lives at [s, w, r],
    # so each scan step reads and writes one contiguous (W*rows) slab
    idx = idx.reshape(windows, rows, seq).permute(2, 0, 1)
    return idx, d_sorted


def madd_scan(leaves: torch.Tensor, fast: bool, out: torch.Tensor,
              err: torch.Tensor | None) -> torch.Tensor:
    """Step 3 of the split scan: gathered leaves (24, seq, ...) -> every
    local prefix in ``out`` (36, seq, ...), ``seq`` launches of
    ``jac_madd`` over all lanes; the fast form ORs its flag into ``err``."""
    seq = leaves.shape[1]
    lanes = leaves[0, 0].numel()
    acc = jac_identity_words((lanes,), leaves.device)
    for s in range(seq):
        acc, _ = jac_madd(acc, leaves[:, s].reshape(AFF, lanes), fast,
                          out=out[:, s].reshape(JAC, lanes), err=err)
    return out


def scan_local(table: torch.Tensor, idx: torch.Tensor, fast: bool,
               fused: bool):
    """Steps 2-3 for one chunk: idx (seq, windows, rows) from
    ``bucket_order`` -> (local (36, seq, windows, rows) Jacobian prefixes,
    err (lanes,) int32 or None).  ``fused`` runs them as one fused_scan
    launch, else ``gather_rows`` then ``madd_scan``."""
    lanes = idx[0].numel()
    local = torch.empty((JAC,) + tuple(idx.shape), dtype=torch.int32,
                        device=idx.device)
    err = torch.zeros((lanes,), dtype=torch.int32, device=idx.device) \
        if fast else None
    if fused:
        fused_scan_msm(table, idx, fast, out=local, err=err)
    else:
        madd_scan(gather_rows(table, idx), fast, local, err)
    return local, err


def threshold_prefixes(local: torch.Tensor, d_sorted: torch.Tensor, c: int):
    """Step 5's search and gather: per window the counts of digits >= t
    for t = 1..2^c, by binary search in the ascending sorted digits, and
    the local prefix at each count's last position.  Threshold 2^c is dead
    (count 0) and only rounds the fold's width to a power of two.
    Returns (ps (36, windows, 2^c), cnt (windows, 2^c), r_of: the row of
    each position)."""
    _, seq, windows, rows = local.shape
    n = seq * rows
    dev = local.device
    asc = torch.flip(d_sorted, dims=(-1,)).contiguous()
    t_vals = torch.arange(1, (1 << c) + 1, dtype=torch.int64, device=dev)
    first_ge = torch.searchsorted(asc,
                                  t_vals.expand(windows, -1).contiguous())
    cnt = n - first_ge                                        # (W, 2^c)
    pos = torch.clamp(cnt - 1, 0, n - 1)
    r_of, s_of = pos // seq, pos % seq
    w_of = torch.arange(windows, device=dev)[:, None]
    flat = (s_of * windows + w_of) * rows + r_of
    ps = local.reshape(JAC, -1)[:, flat.reshape(-1)].reshape(
        JAC, windows, 1 << c)
    return ps, cnt, r_of


def add_row_offsets(local: torch.Tensor, ps: torch.Tensor,
                    r_of: torch.Tensor) -> torch.Tensor:
    """Step 4: an inclusive prefix over the row totals (``prefix_scan_jac``)
    gives exclusive row offsets; each threshold prefix adds its row's
    (one ``jac_add``).  A single row has no offsets."""
    _, seq, windows, rows = local.shape
    if rows == 1:
        return ps
    dev = local.device
    totals = local[:, seq - 1].transpose(1, 2)                # (36, rows, W)
    row_ps = prefix_scan_jac(totals)
    offs = torch.cat([jac_identity_words((1, windows), dev),
                      row_ps[:, :-1]], dim=1)                 # exclusive
    w_of = torch.arange(windows, device=dev)[:, None]
    off_g = offs.transpose(1, 2).reshape(JAC, -1)[
        :, (w_of * rows + r_of).reshape(-1)].reshape(ps.shape)
    return jac_add(ps, off_g)


def fold_windows(ps: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    """Step 5's fold: thresholds with no digit become the identity, then
    pairwise halving (``tree_sum_jac``) -> (36, windows) window sums."""
    ps = torch.where((cnt > 0)[None], ps,
                     jac_identity_words(tuple(cnt.shape), ps.device))
    return tree_sum_jac(ps.transpose(1, 2))


def msm_chunk(table: torch.Tensor, scalars: torch.Tensor, chunk: int,
              c: int, windows: int, fast: bool, fused: bool = False):
    """One chunk: table (t, 24) affine rows (t <= chunk), scalars (8, chunk)
    canonical words (zero past t) -> ((36, windows) window sums, err).
    ``fused`` runs steps 2-3 as one fused_scan launch."""
    idx, d_sorted = bucket_order(scalars, table.shape[0], c, windows,
                                 scan_seq(chunk))
    local, err = scan_local(table, idx, fast, fused)
    ps, cnt, r_of = threshold_prefixes(local, d_sorted, c)
    ps = add_row_offsets(local, ps, r_of)
    del local
    wsum = fold_windows(ps, cnt)
    return wsum, (None if err is None else err.any())


def _horner_windows_host(wsums: torch.Tensor, c: int, windows: int):
    """acc = sum_w 2^(c w) W_w on the host: ``windows`` points through the
    native MSM with power-of-two scalars."""
    from ..native import g1_msm
    pts = jac_to_host(wsums)
    return g1_msm(pts, [1 << (c * w) for w in range(windows)])


def _host_tail(rows: np.ndarray, scalars: list):
    """Host MSM over peeled tail rows (t, 24) and canonical int scalars."""
    from ..native import g1_msm
    xs = [FQ_SPEC.from_mont_int(v) for v in words_to_ints(rows[:, :FW].T)]
    ys = [FQ_SPEC.from_mont_int(v) for v in words_to_ints(rows[:, FW:].T)]
    live = [((bls.Fq(x), bls.Fq(y)), s) for x, y, s in zip(xs, ys, scalars)
            if y != 0 and s]
    if not live:
        return None
    return g1_msm([p for p, _ in live], [s for _, s in live])


class MsmPending:
    """An MSM whose launches are queued on the card; ``result()`` waits,
    checks the fast-mode flag, and finishes the window Horner and tail on
    the host."""

    def __init__(self, wsums, err, c, windows, tail):
        self._w = wsums
        self._err = err
        self._c = c
        self._windows = windows
        self._tail = tail

    def result(self):
        if self._err is not None:
            assert not bool(self._err), (
                "MSM madd collision: repeated base point hit the "
                "fast-mode doubling skip; rerun with fast=False")
        out = _horner_windows_host(self._w, self._c, self._windows)
        if self._tail is not None:
            rows, sc = self._tail
            words = sc.cpu().numpy()
            tail_pt = _host_tail(rows.cpu().numpy(), words_to_ints(words))
            if tail_pt is not None:
                out = bls.G1.add(out, tail_pt)
        return out


def msm_device(bases: torch.Tensor, scalars: torch.Tensor,
               chunk: int | None = None, fast: bool = False,
               mont: bool = False, n_eff: int | None = None,
               defer: bool = False, fused: bool | None = None):
    """MSM of (N, 24) affine base rows with (8, M) Fr scalar words ->
    host affine point (``None`` is the identity), or ``MsmPending`` with
    ``defer=True``.

    ``fused`` selects the fused-scan configuration; None reads
    ``POLYMATH_MSM_FUSED`` now (default off).  Unlike the reference
    (msm.py:522-523) it needs no shape condition: the fused kernel takes
    every chunk the split scan takes.

    Only the first ``n_eff`` (default N) bases take part; when M is smaller
    the remaining bases get zero scalars, so callers pass short per-proof
    scalar vectors against a longer stored basis."""
    if bases.dim() != 2 or bases.shape[1] != AFF:
        raise ValueError(f"msm bases must be (N, {AFF}) rows, got "
                         f"{tuple(bases.shape)}")
    n = bases.shape[0] if n_eff is None else n_eff
    # scalars past the stored bases meet the identity (the reference pads
    # its bases with (0, 0) rows), so they are simply dropped
    m = min(scalars.shape[-1], n, bases.shape[0])
    if m == 0:
        return None
    sc = scalars[:, :m]
    if mont:
        sc = fr_from_mont(sc)
    if chunk is None:
        chunk = choose_chunk(m)
    tail = None
    if m > chunk and 0 < m % chunk <= TAIL_MAX:
        lo = m - m % chunk
        tail = (bases[lo:m], sc[:, lo:m])
        m = lo
        sc = sc[:, :m]
    n_chunks = (m + chunk - 1) // chunk
    c, windows = window_params(chunk)
    if fused is None:
        fused = fused_mode()
    dev = scalars.device
    acc = None
    err = None
    for k in range(n_chunks):
        lo, hi = k * chunk, min(m, (k + 1) * chunk)
        sc_k = sc[:, lo:hi]
        if hi - lo < chunk:
            sc_k = torch.cat([sc_k, torch.zeros(
                (sc.shape[0], chunk - (hi - lo)), dtype=sc.dtype,
                device=dev)], dim=1)
        part, e = msm_chunk(bases[lo:hi], sc_k.contiguous(), chunk, c,
                            windows, fast, fused)
        acc = part if acc is None else jac_add(acc, part)
        if fast:
            err = e if err is None else (err | e)
    pending = MsmPending(acc, err, c, windows, tail)
    return pending if defer else pending.result()

