"""The MSM bucket scan's share of its bound, in %: the least time of the
scan's work at the card's rates over the device time of the kernels that
do it, from the traced window.

The work is counted here, not by the program: the five bulk MSMs' points
of a proof (from the key's dimensions) times one mixed addition a point
a window at the window width C below (the default at the prover's chunk
of 2^19 points), each costed at ``peaks.MADD_OPS``.  So the count is the
same for the split scan, the fused scan and any ``POLYMATH_MSM_*``
setting, and a change that does less work reads a higher share.  The
kernels: the split scan (``csrc/scan.cu`` madd scan and the point gather
of ``csrc/g1.cu`` that feeds it) or the fused scan (``csrc/scan.cu``),
matched by name in the trace.
"""

from benchmark.harness import peaks

C = 13
KERNELS = ("g1_madd_scan_kernel", "g1_scan_msm_kernel", "g1_gather_kernel")


def read(run):
    if run.device is None or not run.proofs:
        return None
    seconds = sum(s for name, s in run.device["kernel_s"].items()
                  if any(k in name for k in KERNELS))
    if not seconds:
        return None
    d = run.dims
    points = sum(peaks.prove_msm_points(d["n"], d["m0"], d["m"], d["n_r"]))
    return 100.0 * peaks.scan_bound_s(points, C) * run.proofs / seconds
