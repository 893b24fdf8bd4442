"""A golden reduced-MiMC proof whose MSMs run in more than one chunk,
held against the JAX package's own bytes (tests/fixtures/golden_mimc.json):

* the JAX package's host setup and host prover reproduce the fixture's
  VerifyingKey and its proofs under all three transcripts, so the fixture
  stays the reference's own output;
* the port's setup on the CPU gives the fixture's VerifyingKey;
* the port on the CPU proves the Merlin bytes at ``POLYMATH_MSM_CHUNK=16``
  with the host tail off (all five MSMs take more than one chunk, so the
  plain ``sum_sets`` adds their chunk sums) and on (the tail takes the
  remainders of the c_w and c_h MSMs, which leaves each one chunk), with
  the split scan and with the fused one (``POLYMATH_MSM_FUSED=1``): a
  whole prove in the fused configuration gives the split prove's bytes,
  which are the JAX package's.

tests/test_torch_cuda.py::test_golden_multi_chunk_proofs_on_the_card
proves the same bytes on the card at chunks 8 and 2, split and fused.
The recipe is that of tests/test_torch_keys.py: 5 rounds, constants from
random.Random(9); Rng(7) draws the preimage (xl, xr) first, setup starts
from the state after that, and each prove from a copy of the state after
setup.  The host prover runs with the native G1 MSM in its hook (an
exact group sum, as its default Pippenger), the points cut to the
scalars.

Rewrite the fixture (only when the reference's bytes rightly change) with

    JAX_PLATFORMS=cpu python -m tests.test_torch_golden
"""

import copy
import json
import os
import random

import pytest
import torch

from polymath_tpu.circuits.mimc import MiMCDemo as RefMiMC, mimc_hash
from polymath_tpu.frontend.r1cs import (
    ConstraintSystem as RefCS, synthesize as ref_synthesize,
)
from polymath_tpu.hostmath.bls12_381 import R as REF_R
from polymath_tpu.native import g1_msm as ref_g1_msm
from polymath_tpu.protocol import Polymath as RefPolymath, Rng as RefRng
from polymath_tpu.protocol.prover import (
    create_proof_with_assignment as ref_create_proof,
)
from polymath_tpu.transcript import ALL_TRANSCRIPTS as REF_TRANSCRIPTS

from polymath_tpu_torch.circuits import MiMCDemo
from polymath_tpu_torch.ops import msm as M
from polymath_tpu_torch.protocol import Polymath, Rng
from polymath_tpu_torch.transcript import MerlinFieldTranscript
from polymath_tpu_torch.utils.config import environ

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "golden_mimc.json")
RECIPE = {"rounds": 5, "constants_seed": 9, "rng_seed": 7}


def recipe_inputs(rng_cls):
    """(constants, xl, xr, rng) of the recipe: the rng is in the state
    setup starts from."""
    crng = random.Random(RECIPE["constants_seed"])
    consts = [crng.randrange(REF_R) for _ in range(RECIPE["rounds"])]
    rng = rng_cls(RECIPE["rng_seed"])
    xl, xr = rng.randrange(REF_R), rng.randrange(REF_R)
    return consts, xl, xr, rng


def make_fixture() -> dict:
    """The JAX package's host setup and host proofs for the recipe."""
    consts, xl, xr, rng = recipe_inputs(RefRng)
    pk, vk = RefPolymath(backend="host").setup(
        RefMiMC(constants=consts), rng)
    cs = ref_synthesize(RefMiMC(xl, xr, consts), RefCS.PROVE)
    proofs = {}
    for tr in REF_TRANSCRIPTS:
        proof = ref_create_proof(
            pk, cs.instance_assignment, cs.witness_assignment,
            copy.deepcopy(rng), tr,
            msm=lambda sc, pts: ref_g1_msm(pts[:len(sc)], sc))
        proofs[tr.name] = proof.to_bytes().hex()
    return {"recipe": dict(RECIPE),
            "image": hex(mimc_hash(xl, xr, consts)),
            "vk": vk.to_bytes().hex(), "proofs": proofs}


def write_fixture(path: str = FIXTURE) -> None:
    with open(path, "w") as fh:
        json.dump(make_fixture(), fh, indent=1)
        fh.write("\n")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain PyTorch ops here are small: one intra-op thread is as fast
    and leaves the other cores to parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def golden():
    with open(FIXTURE) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def reference():
    return make_fixture()


@pytest.fixture(scope="module")
def port_key():
    """The port's CPU setup from the recipe: (key, Rng state after it)."""
    consts, _, _, rng = recipe_inputs(Rng)
    pm = Polymath(transcript=MerlinFieldTranscript, device="cpu")
    pk, _ = pm.setup(MiMCDemo(constants=consts), rng)
    return pk, rng


def test_reference_reproduces_the_fixture_vk(reference, golden):
    assert reference["recipe"] == golden["recipe"]
    assert reference["image"] == golden["image"]
    assert reference["vk"] == golden["vk"]


@pytest.mark.parametrize("name", [t.name for t in REF_TRANSCRIPTS])
def test_reference_reproduces_the_fixture_proof(reference, golden, name):
    assert reference["proofs"][name] == golden["proofs"][name]


def test_port_setup_gives_the_fixture_vk(port_key, golden):
    assert port_key[0].vk.to_bytes().hex() == golden["vk"]


@pytest.mark.parametrize("tail, multi_chunk, fused", [
    ("0", 5, "0"), ("1", 3, "0"), ("0", 5, "1"), ("1", 3, "1")],
    ids=["tail_off", "tail_on", "tail_off-fused", "tail_on-fused"])
def test_port_multi_chunk_prove_gives_the_fixture_proof(port_key, golden,
                                                        tail, multi_chunk,
                                                        fused):
    """The port's CPU prove, split and fused, with the host tail off and
    on: the JAX package's Merlin bytes, verified.  Its card counterpart is
    tests/test_torch_cuda.py::test_golden_multi_chunk_proofs_on_the_card."""
    pk, rng = port_key
    consts, xl, xr, _ = recipe_inputs(Rng)
    pm = Polymath(transcript=MerlinFieldTranscript, device="cpu")
    M.RUNS["multi_chunk"] = 0
    with environ(POLYMATH_MSM_CHUNK="16", POLYMATH_MSM_TAIL=tail,
                 POLYMATH_MSM_FUSED=fused):
        proof = pm.prove(pk, MiMCDemo(xl, xr, consts), copy.deepcopy(rng))
    assert M.RUNS["multi_chunk"] == multi_chunk
    assert proof.to_bytes().hex() == golden["proofs"]["merlin"]
    assert pm.verify(pk.vk, [int(golden["image"], 16)], proof)


if __name__ == "__main__":
    write_fixture()
    print(f"wrote {FIXTURE}")
