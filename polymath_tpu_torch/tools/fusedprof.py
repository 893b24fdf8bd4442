"""Per-stage profile of one MSM chunk (counterpart of tools/fusedprof.py).

    python3 -m polymath_tpu_torch.tools.fusedprof [--device cpu]
        [--log-chunk 19] [--reps 3] [--seed 0]

One chunk as ``ops/msm.py:msm_chunk`` runs it in the prover (fast form),
at the port's bench chunk of 2^19 points by default, with c and the window
count from ``msm.window_params`` and the scan length from
``msm.scan_seq``.  The points are distinct, made on the device by
``fixed_base_mul`` from random scalars; the chunk's scalars are random
and canonical (numpy default_rng(seed)).  Each stage runs on its own, with
its inputs already on the device, through the public helpers of
``ops/msm.py``:

  digits          ``fr_window_digits``
  sort            ``sort_digits`` (the sort of ``bucket_order``)
  fused scan      one ``fused_scan_msm`` launch
  split gather    ``gather_rows``
  split madd      ``madd_scan`` (seq ``jac_madd`` launches)
  threshold       ``threshold_prefixes`` (searchsorted + prefix gather)
  row offsets     ``add_row_offsets`` (prefix_scan_jac + jac_add)
  fold            ``fold_windows`` (tree_sum_jac)

then the whole ``msm_chunk``, split and fused.  Each time is the least of
``--reps`` calls after one warm-up, by CUDA events on the card (the host
clock on the CPU).  The stages must compose to ``msm_chunk``'s window sums
in both forms, and the fused scan must equal the split pair word for word;
any difference raises.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from . import describe, parser, pick_device, timed_ms
from ..ops import msm as M
from ..ops.cuda_gather import gather_rows
from ..ops.cuda_scan import fused_scan_msm
from ..ops.field import fr_window_digits
from ..ops.fixed_base import fixed_base_mul

#: top word of r = 0x73eda753...: a top word below it keeps a scalar
#: canonical
_R_TOP = 0x73eda753

SPLIT = ("digits", "sort", "split gather", "split madd", "threshold",
         "row offsets", "fold")
FUSED = ("digits", "sort", "fused scan", "threshold", "row offsets", "fold")


def random_scalars(rng: np.random.Generator, n: int, device) -> torch.Tensor:
    """(8, n) random canonical Fr words."""
    w = rng.integers(0, 1 << 32, (8, n), dtype=np.uint32)
    w[7] = rng.integers(0, _R_TOP, n, dtype=np.uint32)
    return torch.from_numpy(w.view(np.int32)).to(device)


def main(argv=None) -> dict:
    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--log-chunk", type=int, default=19)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = pick_device(args.device)
    chunk = 1 << args.log_chunk
    c, windows = M.window_params(chunk)
    seq = M.scan_seq(chunk)
    rng = np.random.default_rng(args.seed)
    table = fixed_base_mul(random_scalars(rng, chunk, dev))
    sc = random_scalars(rng, chunk, dev)
    ms = {}

    def stage(name, fn):
        res = fn()
        ms[name] = min(timed_ms(fn, dev)[1] for _ in range(args.reps))
        print(f"# {name:22s} {ms[name]:10.3f} ms", flush=True)
        return res

    digits = stage("digits", lambda: fr_window_digits(sc, c, windows))
    idx, d_sorted = stage("sort", lambda: M.sort_digits(digits, chunk, seq))
    local_f, err_f = M.scan_local(table, idx, True, True)
    stage("fused scan", lambda: fused_scan_msm(table, idx, True, out=local_f,
                                               err=err_f))
    leaves = stage("split gather", lambda: gather_rows(table, idx))
    local, err = torch.empty_like(local_f), torch.zeros_like(err_f)
    stage("split madd", lambda: M.madd_scan(leaves, True, local, err))
    del leaves
    if not torch.equal(local, local_f) or not torch.equal(err, err_f):
        raise AssertionError("the fused scan differs from the split pair")
    del local_f, err_f
    ps, cnt, r_of = stage("threshold",
                          lambda: M.threshold_prefixes(local, d_sorted, c))
    ps_rows = stage("row offsets",
                    lambda: M.add_row_offsets(local, ps, r_of))
    del local
    wsum = stage("fold", lambda: M.fold_windows(ps_rows, cnt))
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
