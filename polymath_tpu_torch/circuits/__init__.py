"""Example circuit families (the reference's test/bench circuits and more)."""

from .dummy import DummyCircuit, BenchCircuit
from .mimc import MiMCDemo, mimc_hash, MIMC_ROUNDS

__all__ = ["DummyCircuit", "BenchCircuit", "MiMCDemo", "mimc_hash", "MIMC_ROUNDS"]
