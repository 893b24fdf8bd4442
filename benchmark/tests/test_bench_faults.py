"""A run with the timed path broken underneath comes out not correct, once
a fault, and a sound run comes out correct (the harness's look for a
card skipped; tiny configurations on the CPU)."""

import contextlib
import os

import pytest

from benchmark import faults
from benchmark.harness import cell as harness, check

from conftest import tiny_cell


def _run(tmp_path, work, which, fault=None, trace=False):
    c = tiny_cell(tmp_path, which)
    with (faults.planted(fault) if fault else contextlib.nullcontext()):
        run, info, numbers, attempted, failed = harness.execute(
            c, 977, 0.5, trace, "cpu", 0.0,
            keys_dir=os.path.join(work, "keys"))
    return harness.result(c, run, info, numbers, attempted, failed, trace)


def test_sound_run_is_correct(tmp_path, work):
    line = _run(tmp_path, work, "bench", trace=True)
    assert line["correct"] and line["failed"] == 0
    assert list(line)[-1] == "check"
    assert {"key_load_s", "warm_prove_s", "host_assign_ms", "poly_ms",
            "msm_ms"} <= set(line["metrics"])
    # no card: no launches and no device time to read
    assert "launches_per_proof" not in line["metrics"]
    assert "msm_scan_roofline_pct" not in line["metrics"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("which", ["bench", "mimc"])
def test_fault_is_not_correct(tmp_path, work, which, fault):
    line = _run(tmp_path, work, which, fault)
    assert not line["correct"]
    assert line["check"]["proofs_rejected"]["value"] >= 1
    assert not check.correct({k: (v["value"], v["limit"])
                              for k, v in line["check"].items()})


def test_a_key_from_another_setup_seed_differs(tmp_path):
    """vk_differs reads 1 for a key made from another seed than the
    configuration's, and every proof made with it is rejected."""
    import random
    from benchmark.circuits import bench as kind
    from polymath_tpu_torch.protocol import Polymath, Rng
    c = tiny_cell(tmp_path, "bench")
    cfg = dict(c.cfg, setup_seed=c.cfg["setup_seed"] + 1)
    pm = Polymath(device="cpu")
    pk, vk = pm.setup(kind.setup_circuit(c.cfg), Rng(c.cfg["setup_seed"]))
    st = kind.draw_statement(c.cfg, random.Random(1))
    proof = pm.prove(pk, kind.prove_circuit(c.cfg, st), Rng(2)).to_bytes()
    numbers = check.judge(cfg, vk.to_bytes(), [(0, st, proof)], 0, 1)
    assert numbers["vk_differs"] == (1, 0)
    assert numbers["proofs_rejected"] == (1, 0)


def test_a_prove_that_raises_fails(tmp_path, work, monkeypatch):
    from polymath_tpu_torch.protocol.api import Polymath

    def prove(self, pk, circuit, rng=None):
        raise AssertionError("vanishing division must be exact")

    monkeypatch.setattr(Polymath, "prove", prove)
    c = tiny_cell(tmp_path, "bench")
    c.loop = dict(c.loop, warm_proves=0)
    run, info, numbers, attempted, failed = harness.execute(
        c, 979, 0.5, False, "cpu", 0.0, keys_dir=os.path.join(work, "keys"))
    line = harness.result(c, run, info, numbers, attempted, failed, False)
    assert numbers["proves_failed"][0] == harness.MAX_FAILED_IN_A_ROW
    assert not line["correct"] and line["failed"] >= 1
    assert "prove_s" not in line["metrics"]
