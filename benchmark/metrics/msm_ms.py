"""The bulk MSMs a proof (``ops/msm.py``): the A, r, c_w and c_h MSMs'
dispatch and finalize, and the d MSM."""

from benchmark.metrics._phases import ms_per_proof


def read(run):
    return ms_per_proof(run, ("msm a+r+c dispatch", "msm a+r+c finalize",
                              "msm d_g1"))
