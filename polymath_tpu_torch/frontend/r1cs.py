"""R1CS constraint-system frontend.

Python-native equivalent of arkworks ``ark-relations`` as used by the
reference (generator.rs:31-54, prover.rs:33-57): instance/witness variable
allocation with deferred assignment closures, linear combinations, two
synthesis modes (Setup: matrices only; Prove: witness only), LC inlining,
and sparse matrix extraction.  All field values are canonical ints mod r.
"""

from __future__ import annotations

from .. import native
from ..hostmath.bls12_381 import R


class SynthesisError(Exception):
    pass


class AssignmentMissing(SynthesisError):
    pass


class Variable:
    """One | Instance(i) | Witness(i) | SymbolicLc(i)."""

    __slots__ = ("kind", "index")
    ONE = "one"
    INSTANCE = "instance"
    WITNESS = "witness"
    SYMBOLIC = "symbolic"

    def __init__(self, kind: str, index: int = 0):
        self.kind = kind
        self.index = index

    def __repr__(self):
        return f"Var({self.kind}, {self.index})"

    def __eq__(self, other):
        return isinstance(other, Variable) and self.kind == other.kind and self.index == other.index

    def __hash__(self):
        return hash((self.kind, self.index))

    # sugar: var arithmetic builds LinearCombinations
    def __add__(self, other):
        return LinearCombination.from_var(self) + other

    def __sub__(self, other):
        return LinearCombination.from_var(self) - other

    def __rmul__(self, coeff: int):
        return LinearCombination([(coeff % R, self)])

    def __neg__(self):
        return LinearCombination([(R - 1, self)])


ONE = Variable(Variable.ONE)


class LinearCombination:
    """Sparse sum of (coeff, Variable) terms."""

    __slots__ = ("terms",)

    def __init__(self, terms=None):
        self.terms = list(terms) if terms else []

    @classmethod
    def zero(cls):
        return cls()

    @classmethod
    def from_var(cls, v: Variable):
        return cls([(1, v)])

    def _coerce(self, other):
        if isinstance(other, LinearCombination):
            return other
        if isinstance(other, Variable):
            return LinearCombination.from_var(other)
        if isinstance(other, tuple):  # (coeff, var) like arkworks lc!() + (c, v)
            return LinearCombination([(other[0] % R, other[1])])
        if other == 0:
            return LinearCombination()
        raise TypeError(f"cannot combine LC with {other!r}")

    def __add__(self, other):
        o = self._coerce(other)
        return LinearCombination(self.terms + o.terms)

    def __sub__(self, other):
        o = self._coerce(other)
        return LinearCombination(self.terms + [((R - c) % R, v) for c, v in o.terms])

    def __mul__(self, coeff: int):
        return LinearCombination([(c * coeff % R, v) for c, v in self.terms])

    __rmul__ = __mul__

    def __neg__(self):
        return self * (R - 1)

    def compact(self):
        """Merge duplicate variables, drop zeros."""
        acc = {}
        for c, v in self.terms:
            acc[v] = (acc.get(v, 0) + c) % R
        return LinearCombination([(c, v) for v, c in acc.items() if c != 0])


def lc(*items) -> LinearCombination:
    """Convenience mirroring arkworks ``lc!()``: lc(), lc(v), lc((c, v))."""
    out = LinearCombination()
    for it in items:
        out = out + it
    return out


class ConstraintSystem:
    """Constraint system with Setup / Prove modes.

    Mode "setup": assignment closures are not invoked; matrices are built.
    Mode "prove": assignments are evaluated; matrices are not stored
    (mirrors ``SynthesisMode::Prove { construct_matrices: false }``).
    """

    SETUP = "setup"
    PROVE = "prove"

    def __init__(self, mode: str = SETUP):
        assert mode in (self.SETUP, self.PROVE)
        self.mode = mode
        self.instance_assignment: list[int] = [1]  # leading constant 1
        self.witness_assignment: list[int] = []
        self.num_instance_variables = 1
        self.num_witness_variables = 0
        self.constraints: list[tuple] = []  # (a_lc, b_lc, c_lc)
        self.symbolic_lcs: list[LinearCombination] = []

    # -- allocation -------------------------------------------------------
    def _value_of(self, f):
        v = f() if callable(f) else f
        if v is None:
            raise AssignmentMissing("assignment missing in prove mode")
        if hasattr(v, "v"):
            v = v.v
        return int(v) % R

    def new_input_variable(self, f=None) -> Variable:
        idx = self.num_instance_variables
        self.num_instance_variables += 1
        if self.mode == self.PROVE:
            self.instance_assignment.append(self._value_of(f))
        return Variable(Variable.INSTANCE, idx)

    def new_witness_variable(self, f=None) -> Variable:
        idx = self.num_witness_variables
        self.num_witness_variables += 1
        if self.mode == self.PROVE:
            self.witness_assignment.append(self._value_of(f))
        return Variable(Variable.WITNESS, idx)

    def alloc_witness_block(self, count: int, values=None) -> int:
        """Bulk witness allocation; returns the first index.

        The per-variable closure protocol (new_witness_variable) costs a
        Python call per variable — ~6 s for the 2^20-variable bench
        circuit.  Large circuits allocate filler/vector witnesses in one
        block instead; ``values`` is a list (or a callable returning one)
        of length ``count``, evaluated only in prove mode.  A list or tuple
        of exact ints in [0, r), checked in one native pass, is taken as
        given; anything else is reduced value by value.
        """
        start = self.num_witness_variables
        self.num_witness_variables += count
        if self.mode == self.PROVE:
            vals = values() if callable(values) else values
            if vals is None or len(vals) != count:
                raise AssignmentMissing("assignment missing in prove mode")
            if (isinstance(vals, (list, tuple))
                    and native.fr_all_canonical(vals)):
                self.witness_assignment.extend(vals)
            else:
                self.witness_assignment.extend(int(v) % R for v in vals)
        return start

    def new_lc(self, combination: LinearCombination) -> Variable:
        idx = len(self.symbolic_lcs)
        self.symbolic_lcs.append(combination)
        return Variable(Variable.SYMBOLIC, idx)

    # -- constraints ------------------------------------------------------
    def enforce_constraint(self, a, b, c):
        if self.mode == self.PROVE:
            # matrices are not constructed in prove mode
            self.constraints.append(None)
            return
        coerce = LinearCombination()._coerce
        self.constraints.append((coerce(a), coerce(b), coerce(c)))

    @property
    def num_constraints(self) -> int:
        return len(self.constraints)

    # -- finalize / extraction -------------------------------------------
    def _inline(self, combo: LinearCombination) -> LinearCombination:
        out = []
        for c, v in combo.terms:
            if v.kind == Variable.SYMBOLIC:
                inner = self._inline(self.symbolic_lcs[v.index])
                out.extend((c * ci % R, vi) for ci, vi in inner.terms)
            else:
                out.append((c, v))
        return LinearCombination(out).compact()

    def finalize(self):
        """Inline symbolic LCs (OptimizationGoal::Constraints path)."""
        if self.mode == self.PROVE:
            return
        self.constraints = [
            tuple(self._inline(x) for x in con) for con in self.constraints
        ]

    def _col(self, v: Variable) -> int:
        if v.kind == Variable.ONE:
            return 0
        if v.kind == Variable.INSTANCE:
            return v.index
        if v.kind == Variable.WITNESS:
            return self.num_instance_variables + v.index
        raise SynthesisError(f"unexpected variable in finalized LC: {v}")

    def to_matrices(self):
        """Sparse (A, B, C): each a list of rows of (coeff, col) pairs,
        columns ordered [instance (incl. ONE at 0) | witness]."""
        assert self.mode == self.SETUP
        a_rows, b_rows, c_rows = [], [], []
        for con in self.constraints:
            a_lc, b_lc, c_lc = con
            for lc_, rows in ((a_lc, a_rows), (b_lc, b_rows), (c_lc, c_rows)):
                row = sorted(
                    ((c, self._col(v)) for c, v in lc_.compact().terms),
                    key=lambda t: t[1],
                )
                rows.append(row)
        return a_rows, b_rows, c_rows

    def full_assignment(self) -> list[int]:
        return self.instance_assignment + self.witness_assignment


def synthesize(circuit, mode: str) -> ConstraintSystem:
    """Run ``circuit.generate_constraints(cs)`` in the given mode and
    finalize (reference generator.rs:31-41 / prover.rs:33-49)."""
    cs = ConstraintSystem(mode)
    circuit.generate_constraints(cs)
    cs.finalize()
    return cs
