# Frozen copy of the program's polymath_tpu_torch/hostmath/tower.py (the benchmark's reference
# imports nothing of the program).
"""Extension-field tower: generic quadratic and cubic extensions.

Used to build BLS12-381's Fq2 / Fq6 / Fq12 (replacing arkworks ``ark-ff``
QuadExtField/CubicExtField, SURVEY.md §2.2).  Multiplication uses Karatsuba /
Toom-style schoolbook; enough for the host-side verifier & setup glue (the
pairing is O(1) per proof).
"""

from __future__ import annotations

from .field import FieldElement


def quadratic_extension(Base, nonresidue, name: str):
    """Field Base[u] / (u^2 - nonresidue)."""

    class Quad(FieldElement):
        __slots__ = ("c0", "c1")

        BASE = Base
        NONRESIDUE = nonresidue
        NAME = name

        def __init__(self, c0, c1):
            self.c0 = c0
            self.c1 = c1

        @classmethod
        def zero(cls):
            return cls(Base.zero(), Base.zero())

        @classmethod
        def one(cls):
            return cls(Base.one(), Base.zero())

        @classmethod
        def from_base(cls, c0):
            return cls(c0, Base.zero())

        @classmethod
        def rand(cls, rng):
            return cls(Base.rand(rng), Base.rand(rng))

        def __add__(self, other):
            return Quad(self.c0 + other.c0, self.c1 + other.c1)

        def __sub__(self, other):
            return Quad(self.c0 - other.c0, self.c1 - other.c1)

        def __neg__(self):
            return Quad(-self.c0, -self.c1)

        def __mul__(self, other):
            # Karatsuba: (a0 + a1 u)(b0 + b1 u)
            v0 = self.c0 * other.c0
            v1 = self.c1 * other.c1
            c0 = v0 + v1 * Quad.NONRESIDUE
            c1 = (self.c0 + self.c1) * (other.c0 + other.c1) - v0 - v1
            return Quad(c0, c1)

        def mul_base(self, k):
            """Multiply by an element of the base field."""
            return Quad(self.c0 * k, self.c1 * k)

        def square(self):
            # (a0 + a1 u)^2 = a0^2 + NR*a1^2 + 2 a0 a1 u
            v0 = self.c0 * self.c1
            c0 = (self.c0 + self.c1) * (self.c0 + self.c1 * Quad.NONRESIDUE) \
                - v0 - v0 * Quad.NONRESIDUE
            return Quad(c0, v0 + v0)

        def conjugate(self):
            return Quad(self.c0, -self.c1)

        def norm(self):
            """c0^2 - NR * c1^2 (element of Base)."""
            return self.c0 * self.c0 - self.c1 * self.c1 * Quad.NONRESIDUE

        def inv(self):
            n = self.norm()
            ninv = n.inv()
            return Quad(self.c0 * ninv, -(self.c1 * ninv))

        def __eq__(self, other):
            return isinstance(other, Quad) and self.c0 == other.c0 and self.c1 == other.c1

        def __hash__(self):
            return hash((name, self.c0, self.c1))

        # arkworks QuadExtField sign convention: compare c1 first, then c0.
        def is_positive(self) -> bool:
            if not self.c1.is_zero():
                return self.c1.is_positive()
            return self.c0.is_positive()

        def sqrt(self):
            """Square root in a quadratic extension (used for G2
            decompression).  Classic norm-based algorithm; returns None when
            not a square."""
            if self.c1.is_zero():
                # sqrt of base element: either sqrt(c0) in base, or
                # sqrt(c0/NR) * u.
                r = self.c0.sqrt()
                if r is not None:
                    return Quad(r, Base.zero())
                r = (self.c0 * Quad.NONRESIDUE.inv()).sqrt()
                if r is not None:
                    return Quad(Base.zero(), r)
                return None
            alpha = self.norm()
            n = alpha.sqrt()
            if n is None:
                return None
            two_inv = (Base.one() + Base.one()).inv()
            delta = (self.c0 + n) * two_inv
            x0 = delta.sqrt()
            if x0 is None:
                delta = (self.c0 - n) * two_inv
                x0 = delta.sqrt()
                if x0 is None:
                    return None
            x1 = self.c1 * (x0 + x0).inv()
            cand = Quad(x0, x1)
            if cand.square() == self:
                return cand
            return None

        def __repr__(self):
            return f"{name}({self.c0!r}, {self.c1!r})"

    Quad.__name__ = name
    return Quad


def cubic_extension(Base, nonresidue, name: str):
    """Field Base[v] / (v^3 - nonresidue)."""

    class Cubic(FieldElement):
        __slots__ = ("c0", "c1", "c2")

        BASE = Base
        NONRESIDUE = nonresidue
        NAME = name

        def __init__(self, c0, c1, c2):
            self.c0 = c0
            self.c1 = c1
            self.c2 = c2

        @classmethod
        def zero(cls):
            z = Base.zero()
            return cls(z, z, z)

        @classmethod
        def one(cls):
            return cls(Base.one(), Base.zero(), Base.zero())

        @classmethod
        def from_base(cls, c0):
            return cls(c0, Base.zero(), Base.zero())

        @classmethod
        def rand(cls, rng):
            return cls(Base.rand(rng), Base.rand(rng), Base.rand(rng))

        def __add__(self, other):
            return Cubic(self.c0 + other.c0, self.c1 + other.c1, self.c2 + other.c2)

        def __sub__(self, other):
            return Cubic(self.c0 - other.c0, self.c1 - other.c1, self.c2 - other.c2)

        def __neg__(self):
            return Cubic(-self.c0, -self.c1, -self.c2)

        def __mul__(self, other):
            a0, a1, a2 = self.c0, self.c1, self.c2
            b0, b1, b2 = other.c0, other.c1, other.c2
            nr = Cubic.NONRESIDUE
            v0 = a0 * b0
            v1 = a1 * b1
            v2 = a2 * b2
            c0 = v0 + ((a1 + a2) * (b1 + b2) - v1 - v2) * nr
            c1 = (a0 + a1) * (b0 + b1) - v0 - v1 + v2 * nr
            c2 = (a0 + a2) * (b0 + b2) - v0 - v2 + v1
            return Cubic(c0, c1, c2)

        def mul_base(self, k):
            return Cubic(self.c0 * k, self.c1 * k, self.c2 * k)

        def square(self):
            return self * self

        def inv(self):
            a0, a1, a2 = self.c0, self.c1, self.c2
            nr = Cubic.NONRESIDUE
            t0 = a0 * a0 - a1 * a2 * nr
            t1 = a2 * a2 * nr - a0 * a1
            t2 = a1 * a1 - a0 * a2
            det = a0 * t0 + (a2 * t1 + a1 * t2) * nr
            dinv = det.inv()
            return Cubic(t0 * dinv, t1 * dinv, t2 * dinv)

        def __eq__(self, other):
            return (
                isinstance(other, Cubic)
                and self.c0 == other.c0
                and self.c1 == other.c1
                and self.c2 == other.c2
            )

        def __hash__(self):
            return hash((name, self.c0, self.c1, self.c2))

        def __repr__(self):
            return f"{name}({self.c0!r}, {self.c1!r}, {self.c2!r})"

    Cubic.__name__ = name
    return Cubic
