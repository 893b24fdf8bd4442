"""BenchCircuit: c = a b is the one public input."""

from ..bls12_381 import R


def shape(cfg) -> tuple:
    return 2, cfg["num_constraints"]


def publics(cfg, statement) -> list:
    return [statement["a"] * statement["b"] % R]
