"""A batch of MiMC ``LongsightF322p3`` preimage proofs in one circuit: the
reference's ``tests/mimc.rs`` circuit (``rounds`` rounds of 2 constraints,
the image public) repeated ``instances`` times, with round constants drawn
from ``constants_seed``.  A statement is K preimages (xl, xr).

Setup composes the port's ``MiMCDemo`` K times, as a user would.  Prove
mode assigns the same variables in bulk: the harness computes the witness
in set-up (``prepare``), in the order that the composition allocates it
(per instance xl, xr, then tmp_i and xl_{i+1} a round, the last xl_{i+1}
being the public image).
"""

from __future__ import annotations

import random

from polymath_tpu_torch.circuits import MiMCDemo
from polymath_tpu_torch.hostmath.bls12_381 import R


def constants(cfg) -> list:
    rng = random.Random(cfg["constants_seed"])
    return [rng.randrange(R) for _ in range(cfg["rounds"])]


def shape(instances: int, rounds: int) -> tuple:
    """(m0, R1CS constraints, SAP rows) of a batch: one public image an
    instance beside the constant 1, 2 constraints a round, and the SAP's
    2 (m0 + constraints) rows (frontend/sap.py)."""
    m0, cons = instances + 1, 2 * rounds * instances
    return m0, cons, 2 * (m0 + cons)


class MiMCBatch:
    def __init__(self, cfg, witness=None, images=None):
        self.cfg = cfg
        self.witness = witness
        self.images = images

    def generate_constraints(self, cs):
        k, rounds = self.cfg["instances"], self.cfg["rounds"]
        if cs.mode == cs.SETUP:
            consts = constants(self.cfg)
            for _ in range(k):
                MiMCDemo(constants=consts).generate_constraints(cs)
            return
        cs.alloc_witness_block(len(self.witness), self.witness)
        for image in self.images:
            cs.new_input_variable(image)
        cs.constraints.extend([None] * (2 * rounds * k))


def setup_circuit(cfg):
    return MiMCBatch(cfg)


def draw_statement(cfg, rng) -> dict:
    k = cfg["instances"]
    return {"xl": [rng.randrange(R) for _ in range(k)],
            "xr": [rng.randrange(R) for _ in range(k)]}


def prepare(cfg, statement) -> dict:
    """The batch's witness and images, computed round by round."""
    consts = constants(cfg)
    last = len(consts) - 1
    witness, images = [], []
    for xl, xr in zip(statement["xl"], statement["xr"]):
        witness += (xl, xr)
        for i, c in enumerate(consts):
            t = (xl + c) % R
            tmp = t * t % R
            xl, xr = (t * tmp + xr) % R, xl
            witness.append(tmp)
            if i < last:
                witness.append(xl)
        images.append(xl)
    return {"witness": witness, "images": images}


def prove_circuit(cfg, prepared):
    return MiMCBatch(cfg, prepared["witness"], prepared["images"])
