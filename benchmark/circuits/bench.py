"""BenchCircuit, the workload of the reference's ``benches/bench.rs``: a*b = c
repeated ``num_constraints`` times, c public, ``num_variables`` - 3 filler
witnesses equal to a.  A statement is the pair (a, b)."""

from __future__ import annotations

from polymath_tpu_torch.circuits import BenchCircuit
from polymath_tpu_torch.hostmath.bls12_381 import R


def setup_circuit(cfg):
    return BenchCircuit(num_variables=cfg["num_variables"],
                        num_constraints=cfg["num_constraints"])


def draw_statement(cfg, rng) -> dict:
    return {"a": rng.randrange(R), "b": rng.randrange(R)}


def prepare(cfg, statement):
    return statement


def prove_circuit(cfg, prepared):
    return BenchCircuit(prepared["a"], prepared["b"],
                        num_variables=cfg["num_variables"],
                        num_constraints=cfg["num_constraints"])
