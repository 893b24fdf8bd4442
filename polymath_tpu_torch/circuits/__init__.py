"""Example circuit families (the reference's test/bench circuits and more)."""

from .dummy import DummyCircuit, BenchCircuit
from .mimc import MiMCDemo, mimc_hash, MIMC_ROUNDS
from .sha256 import MerkleTwoPaths, sha256_compress

__all__ = ["DummyCircuit", "BenchCircuit", "MiMCDemo", "mimc_hash", "MIMC_ROUNDS",
           "MerkleTwoPaths", "sha256_compress"]
