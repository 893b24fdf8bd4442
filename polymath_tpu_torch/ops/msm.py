"""Pippenger-style variable-base G1 MSM (counterpart of msm.py).

Keeps the reference's skew-proof formulation.  Per chunk of points and per
window w of c-bit digits:

  1. d_i = digit_w(s_i); one sort of (d_i << shift | i) descending gives
     both the sorted digits and the point order;
  2. the ``gather_rows`` kernel permutes the affine bases into that order
     (dead leaves, digit 0, read the zero row: the affine identity);
  3. the sorted leaves, viewed as (rows, seq), run ONE inclusive mixed-add
     scan along seq over all windows and rows at once, writing every local
     prefix: one launch of the ``madd_scan`` kernel (ops/cuda_scan.py);
  4. an exclusive prefix over the row totals gives the row offsets
     (``row_offsets``, ops/cuda_tree.py: a scan of each segment of rows and
     a carry pass, two launches);
  5. sum_i d_i P_i = sum_{t=1}^{2^c} PS_{cnt(d >= t)}: the global prefix is
     formed only at the 2^c threshold positions (each adds its row's
     offset) and the thresholds are summed: one launch of ``window_fold``,
     which writes the chunk's window sums into its slot of one (chunks,
     36, W) buffer;
  6. after the last chunk, one ``sum_sets`` launch (ops/cuda_tree.py) adds
     the chunks' window sums, a pairwise tree a window (none for a single
     chunk).

The fused configuration (``fused=True``, or ``POLYMATH_MSM_FUSED`` set to
``1``/``on``/``true`` when ``fused`` is None, as the reference's
``msm.py:_fused_mode``) replaces steps 2 and 3 with one launch of the
``fused_scan`` kernel per chunk (ops/cuda_scan.py), which reads each leaf
straight from the table and never writes the gathered leaves.  Its
outputs are the split pair's, word for word.  The default is the
reference's: the split scan.

The work per chunk is the same whatever the digit distribution: a digit
repeated across the whole chunk (BenchCircuit's c_w vector) costs what
random digits cost.  The final Horner over windows and any peeled tail
run on the host through the native ``g1_msm``.

Bases are the port's packed form: an (N, 24) int32 row table of affine
Montgomery words (x words then y words; (0, 0) is the identity), so each
chunk's gather table is a plain row slice.  Scalars are (8, M) Fr words,
canonical or Montgomery (``mont=True``).

``fast=True`` runs the madd without its doubling branch and asserts the
per-lane collision flag when the result is read; the prover then reruns
safe.  ``defer=True`` returns an ``MsmPending`` whose launches are queued
on the card; ``.result()`` waits for them.

Tuning overrides, read at each call as the reference reads them
(msm.py:_window_params, _scan_seq, _default_chunk and the tail switch);
unset, the defaults below hold.  A value outside what the kernels and
their buffers take raises ``ValueError`` naming the limit:

* ``POLYMATH_MSM_C``: the window width c, 1 to 16 (the reference's digit
  limit; the fold then holds 2^c thresholds a window);
* ``POLYMATH_MSM_SEQ``: the scan length a row, a power of two; a chunk
  shorter than it is scanned as one row, as the reference does
  (msm.py:521, ``min(seq, chunk)``);
* ``POLYMATH_MSM_CHUNK``: the points a chunk, a power of two from 2 to
  2^22 (``default_chunk``);
* ``POLYMATH_MSM_TAIL=0`` (or ``off``/``false``): no host tail; a short
  tail past whole chunks then runs as one more chunk on the card.

The reference's ``POLYMATH_MSM_ROWSCAN`` (a choice between two row-offset
strategies) has no counterpart: csrc/tree.cu's row scan replaces both.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..hostmath import bls12_381 as bls
from .cuda_gather import gather_rows
from .cuda_scan import fused_scan_msm, madd_scan
from .cuda_tree import row_offsets as _row_offsets, sum_sets, window_fold
from .curve import AFF, FW, JAC, jac_to_host
from .field import fr_from_mont, fr_window_digits
from .limbs import FQ_SPEC, words_to_ints

SCALAR_BITS = 255
DEFAULT_CHUNK = 1 << 19
TAIL_MAX = 64         # a tail this short past whole chunks goes to the host
MAX_C = 16
# A chunk's scan buffers take about 250 bytes a lane step (prefixes 144,
# gathered leaves 96, indices 8; W x chunk lane steps): 21 GB at 2^22 and
# c = 13, and past the card's 80 GB beside the bench key at 2^23 and c = 8.
MAX_CHUNK = 1 << 22

#: MSMs since the last reset of more than one chunk, whose window sums one
#: ``sum_sets`` launch adds (read by the card tests and the golden tests)
RUNS = {"multi_chunk": 0}


def _env_int(name: str):
    """The override ``name`` as an int, or None when it is unset."""
    raw = os.environ.get(name, "")
    if raw == "":
        return None
    try:
        return int(raw)
    except ValueError:
        raise ValueError(f"{name}={raw!r} is not an integer") from None


def _power_of_two(v: int) -> bool:
    return v > 0 and v & (v - 1) == 0


def window_params(chunk: int):
    """Window width c and count for a chunk of ``chunk`` points.

    Total adds per chunk ~ W*(chunk + 2*2^c) with W = ceil(255/c).  Large
    chunks keep the reference's c = log2(chunk) - 6 (c = 13 at 2^19);
    small ones take the c that minimises the count.  ``POLYMATH_MSM_C``
    overrides c (1 to MAX_C)."""
    c = _env_int("POLYMATH_MSM_C")
    log_n = max(chunk, 2).bit_length() - 1
    if c is not None:
        if not 1 <= c <= MAX_C:
            raise ValueError(f"POLYMATH_MSM_C={c}: the window width must be "
                             f"1 to {MAX_C}")
    elif chunk <= 4096:
        c = min(8, max(4, log_n - 3))
    else:
        c = min(14, max(8, log_n - 6))
    return c, (SCALAR_BITS + c - 1) // c


def scan_seq(chunk: int) -> int:
    """Scan length per row: about sqrt(chunk) (at least 2, so adjacent
    equal leaves meet in the madd), capped at 256 (the reference's length
    at 2^19, where rows = 2048 keep each launch wide).
    ``POLYMATH_MSM_SEQ`` overrides it (a power of two; a chunk shorter
    than it is one row)."""
    seq = _env_int("POLYMATH_MSM_SEQ")
    if seq is None:
        return min(256, 1 << (chunk.bit_length() // 2))
    if not _power_of_two(seq):
        raise ValueError(f"POLYMATH_MSM_SEQ={seq}: the scan length must be a "
                         f"power of two, so that it divides the chunk")
    return min(seq, chunk)


def default_chunk() -> int:
    """The most points a chunk: ``POLYMATH_MSM_CHUNK`` (a power of two, 2
    to MAX_CHUNK) or DEFAULT_CHUNK."""
    chunk = _env_int("POLYMATH_MSM_CHUNK")
    if chunk is None:
        return DEFAULT_CHUNK
    if not (_power_of_two(chunk) and 2 <= chunk <= MAX_CHUNK):
        raise ValueError(f"POLYMATH_MSM_CHUNK={chunk}: a chunk must be a "
                         f"power of two from 2 to {MAX_CHUNK}")
    return chunk


def tail_mode() -> bool:
    """Whether a short tail past whole chunks goes to the host (default);
    ``POLYMATH_MSM_TAIL`` set to ``0``/``off``/``false`` turns it off."""
    raw = os.environ.get("POLYMATH_MSM_TAIL", "")
    if raw in ("", "1", "on", "true"):
        return True
    if raw in ("0", "off", "false"):
        return False
    raise ValueError(f"POLYMATH_MSM_TAIL={raw!r}: use 0/off/false or "
                     f"1/on/true")


def choose_chunk(m: int) -> int:
    """The smallest power of two holding m points, at most
    ``default_chunk()``."""
    return min(default_chunk(), 1 << max(m - 1, 1).bit_length())


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


def scan_local(table: torch.Tensor, idx: torch.Tensor, fast: bool,
               fused: bool):
    """Steps 2-3 for one chunk: idx (seq, windows, rows) from
    ``bucket_order`` -> (local (36, seq, windows, rows) Jacobian prefixes,
    err (lanes,) int32 or None).  ``fused`` runs them as one fused_scan
    launch, else ``gather_rows`` then one ``madd_scan`` launch."""
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


def row_offsets(local: torch.Tensor) -> torch.Tensor | None:
    """Step 4: the exclusive prefix over each window's row totals
    ``local[:, seq - 1]`` -> (36, windows, rows); None for a single row,
    which has no offsets."""
    _, seq, _, rows = local.shape
    return None if rows == 1 else _row_offsets(local[:, seq - 1])


def msm_chunk(table: torch.Tensor, scalars: torch.Tensor, chunk: int,
              c: int, windows: int, fast: bool, fused: bool = False,
              out: torch.Tensor | None = None):
    """One chunk: table (t, 24) affine rows (t <= chunk), scalars (8, chunk)
    canonical words (zero past t) -> ((36, windows) window sums, err).
    ``fused`` runs steps 2-3 as one fused_scan launch; the window sums go
    into ``out`` when given (``window_fold``'s slot)."""
    idx, d_sorted = bucket_order(scalars, table.shape[0], c, windows,
                                 scan_seq(chunk))
    local, err = scan_local(table, idx, fast, fused)
    ps, cnt, r_of = threshold_prefixes(local, d_sorted, c)
    offs = row_offsets(local)
    del local
    wsum = window_fold(ps, cnt, r_of, offs, out)
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
    the host.

    Its parts can be had before ``result()`` (parallel/msm_sharded.py
    gathers them over a group): ``wsums`` the (36, windows) Jacobian window
    sums on the card, ``err`` the collision flag (a card bool, or None
    when not fast), ``c`` and ``windows``, and ``tail`` the peeled tail as
    (rows (t, 24), canonical scalar words (8, t)) on the card, or None.
    Zero scalars and identity rows in the tail add nothing."""

    def __init__(self, wsums, err, c, windows, tail):
        self.wsums = wsums
        self.err = err
        self.c = c
        self.windows = windows
        self.tail = tail

    def result(self):
        if self.err is not None:
            assert not bool(self.err), (
                "MSM madd collision: repeated base point hit the "
                "fast-mode doubling skip; rerun with fast=False")
        out = _horner_windows_host(self.wsums, self.c, self.windows)
        if self.tail is not None:
            rows, sc = self.tail
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
    if tail_mode() and m > chunk and 0 < m % chunk <= TAIL_MAX:
        lo = m - m % chunk
        tail = (bases[lo:m], sc[:, lo:m])
        m = lo
        sc = sc[:, :m]
    n_chunks = (m + chunk - 1) // chunk
    c, windows = window_params(chunk)
    if fused is None:
        fused = fused_mode()
    dev = scalars.device
    parts = torch.empty((n_chunks, JAC, windows), dtype=torch.int32,
                        device=dev)
    err = None
    for k in range(n_chunks):
        lo, hi = k * chunk, min(m, (k + 1) * chunk)
        sc_k = sc[:, lo:hi]
        if hi - lo < chunk:
            sc_k = torch.cat([sc_k, torch.zeros(
                (sc.shape[0], chunk - (hi - lo)), dtype=sc.dtype,
                device=dev)], dim=1)
        _, e = msm_chunk(bases[lo:hi], sc_k.contiguous(), chunk, c,
                         windows, fast, fused, out=parts[k])
        if fast:
            err = e if err is None else (err | e)
    if n_chunks > 1:
        RUNS["multi_chunk"] += 1
    wsums = sum_sets(parts) if n_chunks > 1 else parts[0]
    pending = MsmPending(wsums, err, c, windows, tail)
    return pending if defer else pending.result()

