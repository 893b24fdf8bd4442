"""The MiMC batch circuit: bulk prove-mode assignment, domain reckoning,
and a CPU prove that verifies."""

import random

import pytest

from benchmark.circuits import mimc_batch
from benchmark.ref import verify
from benchmark.ref.kinds import mimc_batch as ref_mimc

from conftest import TINY


def test_bulk_assignment_equals_composed_mimcdemo():
    from polymath_tpu_torch.circuits import MiMCDemo
    from polymath_tpu_torch.frontend.r1cs import ConstraintSystem, synthesize
    cfg = dict(TINY["mimc"], instances=3, rounds=5)
    st = mimc_batch.draw_statement(cfg, random.Random(1))
    consts = mimc_batch.constants(cfg)

    class Composed:
        def generate_constraints(self, cs):
            for xl, xr in zip(st["xl"], st["xr"]):
                MiMCDemo(xl, xr, consts).generate_constraints(cs)

    want = synthesize(Composed(), ConstraintSystem.PROVE)
    got = synthesize(mimc_batch.prove_circuit(
        cfg, mimc_batch.prepare(cfg, st)), ConstraintSystem.PROVE)
    assert got.witness_assignment == want.witness_assignment
    assert got.instance_assignment == want.instance_assignment
    assert got.num_constraints == want.num_constraints == 2 * 5 * 3
    setup = synthesize(mimc_batch.setup_circuit(cfg), ConstraintSystem.SETUP)
    assert setup.num_instance_variables == want.num_instance_variables
    assert setup.num_witness_variables == want.num_witness_variables
    # the reference's images are the prover's public inputs
    assert ref_mimc.publics(cfg, st) == want.instance_assignment[1:]


@pytest.mark.parametrize("instances,log_n", [(1625, 21), (1626, 22)])
def test_domain(instances, log_n):
    m0, cons, rows = mimc_batch.shape(instances, 322)
    from polymath_tpu_torch.protocol.poly_host import Radix2Domain
    assert Radix2Domain(rows).n == 1 << log_n
    cfg = {"instances": instances, "rounds": 322}
    assert ref_mimc.shape(cfg) == (m0, cons)
    assert verify.domain_size(m0, cons) == 1 << log_n


def test_cpu_prove_verifies(tmp_path, work):
    from benchmark.harness import cell as harness
    from conftest import tiny_cell
    import os
    c = tiny_cell(tmp_path, "mimc")
    run, info, numbers, attempted, failed = harness.execute(
        c, 2**31 + 11, 0.5, False, "cpu", 0.0,
        keys_dir=os.path.join(work, "keys"))
    assert numbers == {"vk_differs": (0, 0), "proofs_rejected": (0, 0),
                       "proves_failed": (0, 0)}
    assert attempted >= 2 and failed == 0 and run.proofs >= 1
