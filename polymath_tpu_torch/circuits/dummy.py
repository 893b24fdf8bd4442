"""The reference's smallest circuits.

``DummyCircuit``: a*b = c with c public (tests/dummy.rs:20-35).
``BenchCircuit``: the bench harness variant with num_variables /
num_constraints knobs (benches/bench.rs:21-63).
"""

from __future__ import annotations

from ..hostmath.bls12_381 import R
from ..frontend.r1cs import lc


class DummyCircuit:
    def __init__(self, a=None, b=None):
        self.a = a
        self.b = b

    def generate_constraints(self, cs):
        a = cs.new_witness_variable(lambda: self.a)
        b = cs.new_witness_variable(lambda: self.b)
        c = cs.new_input_variable(
            lambda: None if (self.a is None or self.b is None) else self.a * self.b % R)
        cs.enforce_constraint(lc(a), lc(b), lc(c))


class BenchCircuit:
    """DummyCircuit padded to `num_constraints` copies of a*b=c plus
    filler witnesses and one empty constraint (benches/bench.rs:40-63)."""

    def __init__(self, a=None, b=None, num_variables=10, num_constraints=8):
        self.a = a
        self.b = b
        self.num_variables = num_variables
        self.num_constraints = num_constraints

    def generate_constraints(self, cs):
        a = cs.new_witness_variable(lambda: self.a)
        b = cs.new_witness_variable(lambda: self.b)
        c = cs.new_input_variable(
            lambda: None if (self.a is None or self.b is None) else self.a * self.b % R)
        filler = self.num_variables - 3
        cs.alloc_witness_block(
            filler, lambda: [self.a % R] * filler)
        if cs.mode == cs.PROVE:
            # matrices are not constructed in prove mode; skip 10^6 empty
            # python-level enforce calls (arkworks pays ns per call here)
            cs.constraints.extend([None] * self.num_constraints)
        else:
            for _ in range(self.num_constraints - 1):
                cs.enforce_constraint(lc(a), lc(b), lc(c))
            cs.enforce_constraint(lc(), lc(), lc())
