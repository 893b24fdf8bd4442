"""Per-stage profile of one MSM chunk (counterpart of tools/fusedprof.py).

    python3 -m polymath_tpu_torch.tools.fusedprof [--device cpu]
        [--log-chunk LOG] [--reps 3] [--seed 0]

One chunk as ``ops/msm.py:msm_chunk`` runs it in the prover (fast form),
at ``msm.default_chunk()`` points by default (2^19, or
``POLYMATH_MSM_CHUNK``), with c and the window count from
``msm.window_params`` and the scan length from ``msm.scan_seq`` (so
``POLYMATH_MSM_C`` and ``POLYMATH_MSM_SEQ`` apply).  The points are distinct, made on the device by
``fixed_base_mul`` from random scalars; the chunk's scalars are random
and canonical (numpy default_rng(seed)).  Each stage runs on its own, with
its inputs already on the device, through the public helpers of
``ops/msm.py``:

  digits          ``fr_window_digits``
  sort            ``sort_digits`` (the sort of ``bucket_order``)
  fused scan      one ``fused_scan_msm`` launch
  split gather    ``gather_rows``
  split madd      ``madd_scan`` (one launch)
  threshold       ``threshold_prefixes`` (searchsorted + prefix gather)
  row offsets     ``row_offsets`` (segment scan and carry, two launches)
  fold            ``window_fold`` (offsets, mask and sum; one launch)

then the whole ``msm_chunk``, split and fused (``stages_ms``), and two
yardsticks that ``msm_chunk`` no longer runs, the compositions the
one-launch kernels replaced, timed in the same run (``yardsticks_ms``):

  split madd, per step   ``seq`` launches of ``jac_madd``, one per step
  tree, per launch       ``row_offsets_plain`` and ``window_fold_plain``
                         over the ``jac_add`` kernel (prefix_scan_jac,
                         one jac_add, tree_sum_jac)

Each time is the least of ``--reps`` calls after one warm-up, by CUDA
events on the card (the host clock on the CPU).  The stages must compose
to ``msm_chunk``'s window sums in both forms; the fused scan, the split
madd and the per-step loop must agree word for word; the per-launch tree
adds in another order, so its window sums must be the same points
(``jac_equal``).  Any difference raises.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from . import describe, parser, pick_device, timed_ms
from ..ops import cuda_tree
from ..ops import msm as M
from ..ops.cuda_curve import jac_add, jac_madd
from ..ops.cuda_gather import gather_rows
from ..ops.cuda_scan import fused_scan_msm
from ..ops.curve import AFF, JAC, jac_identity_words
from ..ops.field import fr_window_digits
from ..ops.fixed_base import fixed_base_mul

#: top word of r = 0x73eda753...: a top word below it keeps a scalar
#: canonical
_R_TOP = 0x73eda753

SPLIT = ("digits", "sort", "split gather", "split madd", "threshold",
         "row offsets", "fold")
FUSED = ("digits", "sort", "fused scan", "threshold", "row offsets", "fold")


def madd_per_step(leaves, fast, out, err):
    """The split madd as it ran before the one-launch scan: one ``jac_madd``
    launch per step over all lanes, each writing its step's prefixes."""
    seq, lanes = leaves.shape[1], leaves[0, 0].numel()
    acc = jac_identity_words((lanes,), leaves.device)
    for s in range(seq):
        acc, _ = jac_madd(acc, leaves[:, s].reshape(AFF, lanes), fast,
                          out=out[:, s].reshape(JAC, lanes), err=err)
    return out


def tree_per_launch(local, ps, cnt, r_of):
    """Steps 4 and 5 as they ran before the tree kernels: the plain
    versions' composition over the ``jac_add`` kernel."""
    _, seq, _, rows = local.shape
    offs = None if rows == 1 else cuda_tree.row_offsets_plain(
        local[:, seq - 1], jac_add)
    return cuda_tree.window_fold_plain(ps, cnt, r_of, offs, jac_add)


def random_scalars(rng: np.random.Generator, n: int, device) -> torch.Tensor:
    """(8, n) random canonical Fr words."""
    w = rng.integers(0, 1 << 32, (8, n), dtype=np.uint32)
    w[7] = rng.integers(0, _R_TOP, n, dtype=np.uint32)
    return torch.from_numpy(w.view(np.int32)).to(device)


def main(argv=None) -> dict:
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--log-chunk", type=int, default=None,
                    help="log2 of the chunk (default: msm.default_chunk())")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = pick_device(args.device)
    chunk = M.default_chunk() if args.log_chunk is None \
        else 1 << args.log_chunk
    c, windows = M.window_params(chunk)
    seq = M.scan_seq(chunk)
    rng = np.random.default_rng(args.seed)
    table = fixed_base_mul(random_scalars(rng, chunk, dev))
    sc = random_scalars(rng, chunk, dev)
    ms, yard = {}, {}

    def stage(name, fn, into=ms):
        res = fn()
        into[name] = min(timed_ms(fn, dev)[1] for _ in range(args.reps))
        print(f"# {name:22s} {into[name]:10.3f} ms", flush=True)
        return res

    digits = stage("digits", lambda: fr_window_digits(sc, c, windows))
    idx, d_sorted = stage("sort", lambda: M.sort_digits(digits, chunk, seq))
    local_f, err_f = M.scan_local(table, idx, True, True)
    stage("fused scan", lambda: fused_scan_msm(table, idx, True, out=local_f,
                                               err=err_f))
    leaves = stage("split gather", lambda: gather_rows(table, idx))
    local, err = torch.empty_like(local_f), torch.zeros_like(err_f)
    stage("split madd", lambda: M.madd_scan(leaves, True, local, err))
    step, step_err = torch.empty_like(local_f), torch.zeros_like(err_f)
    stage("split madd, per step",
          lambda: madd_per_step(leaves, True, step, step_err), yard)
    del leaves
    for name, (a, e) in (("fused scan", (local_f, err_f)),
                         ("split madd, per step", (step, step_err))):
        if not torch.equal(local, a) or not torch.equal(err, e):
            raise AssertionError(f"the {name} differs from the split madd")
    del local_f, err_f, step, step_err
    ps, cnt, r_of = stage("threshold",
                          lambda: M.threshold_prefixes(local, d_sorted, c))
    offs = stage("row offsets", lambda: M.row_offsets(local))
    wsum = stage("fold", lambda: cuda_tree.window_fold(ps, cnt, r_of, offs))
    old = stage("tree, per launch",
                lambda: tree_per_launch(local, ps, cnt, r_of), yard)
    del local
    if not bool(cuda_tree.jac_equal(old, wsum).all()):
        raise AssertionError("the per-launch tree's window sums are other "
                             "points than the tree kernels'")
    whole = {}
    for fused in (False, True):
        name = "msm_chunk " + ("fused" if fused else "split")
        got, e = stage(name, lambda: M.msm_chunk(table, sc, chunk, c, windows,
                                                 True, fused))
        if not torch.equal(got, wsum) or bool(e):
            raise AssertionError(f"{name}: window sums differ from the "
                                 f"stages' composition")
        whole[name] = ms[name]
    res = {**describe(dev), "chunk": chunk, "c": c, "windows": windows,
           "seq": seq, "rows": chunk // seq, "stages_ms": ms,
           "yardsticks_ms": yard,
           "split_sum_ms": sum(ms[k] for k in SPLIT),
           "fused_sum_ms": sum(ms[k] for k in FUSED),
           "stages_match": True}
    print(f"# stages sum: split {res['split_sum_ms']:.3f} ms, fused "
          f"{res['fused_sum_ms']:.3f} ms; whole chunk {json.dumps(whole)}",
          flush=True)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
