"""The scan roofline's work: counted from the MSMs' point counts at a fixed
window width, so the split scan, the fused scan and a ``POLYMATH_MSM_C``
override at the same inputs give the same work, and the counts are the
points the prover's MSMs really take."""

import random

import pytest

from benchmark.harness import peaks

from conftest import TINY


def _prove_points(env):
    from polymath_tpu_torch.circuits import BenchCircuit
    from polymath_tpu_torch.ops import prover
    from polymath_tpu_torch.protocol import Polymath, Rng
    from polymath_tpu_torch.utils.config import environ
    cfg = TINY["bench"]
    pm = Polymath(device="cpu")
    pk, _ = pm.setup(BenchCircuit(num_variables=cfg["num_variables"],
                                  num_constraints=cfg["num_constraints"]),
                     Rng(5))
    seen, orig = [], prover.LocalOps.msm

    def msm(self, bases, scalars, n_eff=None, **kw):
        seen.append(min(scalars.shape[-1], n_eff or bases.shape[0],
                        bases.shape[0]))
        return orig(self, bases, scalars, n_eff=n_eff, **kw)

    prover.LocalOps.msm = msm
    try:
        with environ(**env):
            pm.prove(pk, BenchCircuit(3, 5, 4, 4), Rng(6))
    finally:
        prover.LocalOps.msm = orig
    m0, m, n_r = pk.sap_matrices.m0_m_n()
    return seen, peaks.prove_msm_points(pk.vk.n, m0, m, n_r)


@pytest.mark.parametrize("env", [
    {"POLYMATH_MSM_FUSED": "0"}, {"POLYMATH_MSM_FUSED": "1"},
    {"POLYMATH_MSM_C": "5"}], ids=["split", "fused", "c5"])
def test_same_work_in_every_configuration(env):
    seen, counted = _prove_points(env)
    assert sorted(seen) == sorted(counted)
    assert peaks.scan_bound_s(sum(counted), 13) == peaks.scan_bound_s(
        sum(_prove_points({})[1]), 13)


def test_bench_bound():
    """At the bench workload (2^20 - 100 constraints, n = 2^21): 29.36M
    points, 20 windows of 13 bits, 6,072 ops a mixed addition."""
    n, m0, m, n_r = 1 << 21, 2, 1048477, 1048476
    points = sum(peaks.prove_msm_points(n, m0, m, n_r))
    assert points == 29_359_953
    assert peaks.MADD_OPS == 6072
    assert peaks.scan_bound_s(points, 13) == pytest.approx(
        points * 20 * 6072 / 16.7e12)
    assert random.Random(0)  # the module needs no card
