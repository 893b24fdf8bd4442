"""arkworks-compatible canonical serialization (compressed mode).

Byte formats gate Fiat–Shamir challenge equality with the Rust reference
(SURVEY.md §3.4): every byte absorbed into a transcript flows through
``serialize_compressed``.  Formats reproduced here:

  * ``Fp``: little-endian canonical integer, ceil(MODULUS_BITS/8) bytes
    (Fr: 32 B; Fq: 48 B).
  * G1 affine compressed: 48 B = LE(x) with 2 flag bits in the top bits of
    the LAST byte: bit7 = Y-is-positive (y > -y as canonical ints),
    bit6 = point-at-infinity (with x = 0).
  * G2 affine compressed: 96 B = LE(x.c0) || LE(x.c1), flags in last byte;
    sign convention compares (c1, c0) lexicographically.
  * ``Vec<T>`` / slices: u64 LE length prefix then elements.

Reference call sites: ``to_bytes!`` macro (macro.rs:7-12) used in
common.rs:26-34; struct derives in data_structures.rs.
"""

from __future__ import annotations

from ..hostmath import bls12_381 as bls
from ..hostmath.bls12_381 import Fq, Fq2, Fr

# flag masks (arkworks SWFlags, 2-bit BIT_SIZE)
_FLAG_Y_POSITIVE = 1 << 7
_FLAG_INFINITY = 1 << 6


# -- field elements ---------------------------------------------------------

def fr_to_bytes(v) -> bytes:
    """Fr (canonical int or Fr element) -> 32 bytes LE."""
    x = v.v if hasattr(v, "v") else int(v)
    return x.to_bytes(32, "little")


def fr_from_bytes(b: bytes) -> int:
    assert len(b) == 32
    x = int.from_bytes(b, "little")
    if x >= bls.R:
        raise ValueError("Fr deserialization: value >= modulus")
    return x


def fq_to_bytes(v) -> bytes:
    x = v.v if hasattr(v, "v") else int(v)
    return x.to_bytes(48, "little")


def fq_from_bytes(b: bytes) -> int:
    assert len(b) == 48
    x = int.from_bytes(b, "little")
    if x >= bls.Q:
        raise ValueError("Fq deserialization: value >= modulus")
    return x


# -- G1 ---------------------------------------------------------------------

def g1_to_bytes(pt) -> bytes:
    """Affine G1 point (tuple of Fq or None) -> 48-byte compressed."""
    if pt is None:
        buf = bytearray(48)
        buf[-1] |= _FLAG_INFINITY
        return bytes(buf)
    x, y = pt
    buf = bytearray(fq_to_bytes(x))
    if y.is_positive():
        buf[-1] |= _FLAG_Y_POSITIVE
    return bytes(buf)


def g1_from_bytes(b: bytes, validate: bool = True):
    assert len(b) == 48
    flags = b[-1] & 0xC0
    raw = bytearray(b)
    raw[-1] &= 0x3F
    x_int = int.from_bytes(raw, "little")
    if flags & _FLAG_INFINITY:
        if x_int != 0:
            raise ValueError("G1: infinity flag with nonzero x")
        return None
    if x_int >= bls.Q:
        raise ValueError("G1: x >= q")
    x = Fq(x_int)
    y2 = x * x * x + bls.G1.b
    y = y2.sqrt()
    if y is None:
        raise ValueError("G1: x not on curve")
    greatest = bool(flags & _FLAG_Y_POSITIVE)
    if y.is_positive() != greatest:
        y = -y
    pt = (x, y)
    if validate and not bls.G1.in_subgroup(pt):
        raise ValueError("G1: point not in subgroup")
    return pt


# -- G2 ---------------------------------------------------------------------

def g2_to_bytes(pt) -> bytes:
    if pt is None:
        buf = bytearray(96)
        buf[-1] |= _FLAG_INFINITY
        return bytes(buf)
    x, y = pt
    buf = bytearray(fq_to_bytes(x.c0) + fq_to_bytes(x.c1))
    if y.is_positive():
        buf[-1] |= _FLAG_Y_POSITIVE
    return bytes(buf)


def g2_from_bytes(b: bytes, validate: bool = True):
    assert len(b) == 96
    flags = b[-1] & 0xC0
    raw = bytearray(b)
    raw[-1] &= 0x3F
    c0 = int.from_bytes(raw[:48], "little")
    c1 = int.from_bytes(raw[48:], "little")
    if flags & _FLAG_INFINITY:
        if c0 != 0 or c1 != 0:
            raise ValueError("G2: infinity flag with nonzero x")
        return None
    if c0 >= bls.Q or c1 >= bls.Q:
        raise ValueError("G2: x coordinate >= q")
    x = Fq2(Fq(c0), Fq(c1))
    y2 = x * x * x + bls.G2.b
    y = y2.sqrt()
    if y is None:
        raise ValueError("G2: x not on curve")
    greatest = bool(flags & _FLAG_Y_POSITIVE)
    if y.is_positive() != greatest:
        y = -y
    pt = (x, y)
    if validate and not bls.G2.in_subgroup(pt):
        raise ValueError("G2: point not in subgroup")
    return pt


# -- composites -------------------------------------------------------------

def u64_to_bytes(v: int) -> bytes:
    return int(v).to_bytes(8, "little")


def vec_to_bytes(items, ser) -> bytes:
    """arkworks Vec<T>: u64 LE length then each element."""
    out = bytearray(u64_to_bytes(len(items)))
    for it in items:
        out += ser(it)
    return bytes(out)


def fr_vec_to_bytes(values) -> bytes:
    return vec_to_bytes(list(values), fr_to_bytes)


def g1_vec_to_bytes(points) -> bytes:
    return vec_to_bytes(list(points), g1_to_bytes)


class Reader:
    """Cursor over a byte string for canonical deserialization."""

    def __init__(self, buf: bytes, off: int = 0):
        self.buf = buf
        self.off = off

    def take(self, n: int) -> bytes:
        b = self.buf[self.off:self.off + n]
        if len(b) != n:
            raise ValueError("unexpected end of input")
        self.off += n
        return b

    def u64(self) -> int:
        return int.from_bytes(self.take(8), "little")

    def fr(self) -> int:
        return fr_from_bytes(self.take(32))

    def g1(self, validate: bool = True):
        return g1_from_bytes(self.take(48), validate=validate)

    def g2(self, validate: bool = True):
        return g2_from_bytes(self.take(96), validate=validate)

    def vec(self, de):
        return [de() for _ in range(self.u64())]
