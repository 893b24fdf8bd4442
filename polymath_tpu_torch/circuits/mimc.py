"""MiMC ``LongsightF322p3`` preimage circuit (tests/mimc.rs:46-143):
322 rounds, 2 constraints per round, image public.

``rounds`` is parameterizable (default matches the reference) so tests and
the multi-device dry run can use reduced instances of the same structure.
"""

from __future__ import annotations

from ..hostmath.bls12_381 import R
from ..frontend.r1cs import lc, ONE

MIMC_ROUNDS = 322


def mimc_hash(xl: int, xr: int, constants) -> int:
    for c in constants:
        t = (xl + c) % R
        xl, xr = (t * t % R * t + xr) % R, xl
    return xl


class MiMCDemo:
    def __init__(self, xl=None, xr=None, constants=None, rounds=None):
        self.xl = xl
        self.xr = xr
        self.constants = constants
        self.rounds = len(constants) if rounds is None else rounds

    def generate_constraints(self, cs):
        assert len(self.constants) == self.rounds
        xl_val, xr_val = self.xl, self.xr
        xl = cs.new_witness_variable(lambda: xl_val)
        xr = cs.new_witness_variable(lambda: xr_val)

        for i in range(self.rounds):
            ci = self.constants[i]
            tmp_val = None if xl_val is None else (xl_val + ci) ** 2 % R
            tmp = cs.new_witness_variable((lambda v: lambda: v)(tmp_val))
            cs.enforce_constraint(
                lc(xl, (ci, ONE)), lc(xl, (ci, ONE)), lc(tmp))

            if xl_val is None:
                new_xl_val = None
            else:
                new_xl_val = ((xl_val + ci) * tmp_val + xr_val) % R
            if i == self.rounds - 1:
                new_xl = cs.new_input_variable((lambda v: lambda: v)(new_xl_val))
            else:
                new_xl = cs.new_witness_variable((lambda v: lambda: v)(new_xl_val))
            cs.enforce_constraint(
                lc(tmp), lc(xl, (ci, ONE)), lc(new_xl) - xr)

            xr, xr_val = xl, xl_val
            xl, xl_val = new_xl, new_xl_val
