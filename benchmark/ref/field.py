# Frozen copy of the program's polymath_tpu_torch/hostmath/field.py (the benchmark's reference
# imports nothing of the program).
"""Host-side prime-field arithmetic over Python ints.

This is the scalar (non-batched) math substrate used by the protocol layer for
small O(1)/O(m0) work — transcript challenges, verifier algebra, trapdoor
sampling — and as the correctness oracle for the device kernels.  The reference gets this from arkworks ``ark-ff``
(see SURVEY.md §2.2); here it is a fresh implementation over Python ints.

Design notes:
  * Field elements are immutable wrappers around ``int`` in **canonical form**
    (0 <= v < p).  The device kernels use Montgomery limb form; conversion
    happens at the host/device boundary (ops/limbs.py).
  * ``PrimeField(p)`` manufactures a field class; BLS12-381 Fq/Fr instances
    live in ``bls12_381.py``.
"""

from __future__ import annotations


class FieldElement:
    """Base class for all field elements (prime and extension)."""

    __slots__ = ()

    # Subclasses implement: +, -, *, neg, inv, square, conjugate-ish helpers.
    def __sub__(self, other):
        return self + (-other)

    def __truediv__(self, other):
        return self * other.inv()

    def square(self):
        return self * self

    def pow(self, e: int):
        """Exponentiation by a (possibly negative) Python int."""
        if e < 0:
            return self.inv().pow(-e)
        result = self.one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def __pow__(self, e: int):
        return self.pow(e)

    def is_zero(self) -> bool:
        return self == self.zero()

    def is_one(self) -> bool:
        return self == self.one()


def prime_field(p: int, name: str, generator: int | None = None):
    """Create a prime-field class for modulus ``p``.

    ``generator`` is a multiplicative generator of the full group (used to
    derive two-adic roots of unity, cf. arkworks ``FpConfig::GENERATOR``).
    """

    assert p > 2 and p % 2 == 1

    class Fp(FieldElement):
        __slots__ = ("v",)

        MODULUS = p
        NAME = name
        GENERATOR = generator
        BITS = p.bit_length()
        # Number of bytes in the canonical little-endian serialization
        # (arkworks: ceil(MODULUS_BIT_SIZE / 8)).
        NUM_BYTES = (p.bit_length() + 7) // 8
        # 64-bit limb count (arkworks BigInt<N>); Montgomery R = 2^(64N).
        NUM_LIMBS_64 = (p.bit_length() + 63) // 64

        def __init__(self, v: int):
            self.v = v % p

        # -- constructors -------------------------------------------------
        @classmethod
        def zero(cls):
            return cls(0)

        @classmethod
        def one(cls):
            return cls(1)

        @classmethod
        def from_int(cls, v: int):
            return cls(v)

        @classmethod
        def rand(cls, rng):
            """Uniform field element; ``rng`` has ``randrange``."""
            return cls(rng.randrange(p))

        # -- arithmetic ---------------------------------------------------
        def __add__(self, other):
            return Fp((self.v + other.v) % p)

        def __neg__(self):
            return Fp(-self.v % p)

        def __sub__(self, other):
            return Fp((self.v - other.v) % p)

        def __mul__(self, other):
            return Fp((self.v * other.v) % p)

        def square(self):
            return Fp((self.v * self.v) % p)

        def inv(self):
            if self.v == 0:
                raise ZeroDivisionError(f"inverse of 0 in {name}")
            return Fp(pow(self.v, p - 2, p))

        def pow(self, e: int):
            if e < 0:
                return self.inv().pow(-e)
            return Fp(pow(self.v, e, p))

        # -- predicates / helpers ----------------------------------------
        def __eq__(self, other):
            return isinstance(other, Fp) and self.v == other.v

        def __hash__(self):
            return hash((name, self.v))

        def legendre(self) -> int:
            """0, 1 or -1."""
            if self.v == 0:
                return 0
            t = pow(self.v, (p - 1) // 2, p)
            return 1 if t == 1 else -1

        def sqrt(self):
            """Square root (canonically the returned root is not normalized;
            callers choose sign).  Returns None if not a QR."""
            if self.v == 0:
                return Fp(0)
            if self.legendre() != 1:
                return None
            if p % 4 == 3:
                return Fp(pow(self.v, (p + 1) // 4, p))
            # Tonelli-Shanks for completeness.
            q, s = p - 1, 0
            while q % 2 == 0:
                q //= 2
                s += 1
            z = 2
            while pow(z, (p - 1) // 2, p) != p - 1:
                z += 1
            m, c, t, r = s, pow(z, q, p), pow(self.v, q, p), pow(self.v, (q + 1) // 2, p)
            while t != 1:
                i, t2 = 0, t
                while t2 != 1:
                    t2 = t2 * t2 % p
                    i += 1
                b = pow(c, 1 << (m - i - 1), p)
                m, c = i, b * b % p
                t, r = t * c % p, r * b % p
            return Fp(r)

        # "Positive" per arkworks sign convention: the larger of {y, p-y}.
        def is_positive(self) -> bool:
            return self.v > (p - self.v) % p

        def __repr__(self):
            return f"{name}({hex(self.v)})"

    Fp.__name__ = name
    return Fp


def two_adicity(p: int) -> int:
    """Largest s with 2^s | p-1."""
    s, t = 0, p - 1
    while t % 2 == 0:
        t //= 2
        s += 1
    return s
