"""SHA-256 gadgets over R1CS, and two Merkle authentication paths under one
anchor (Zcash Sprout's MerkleCRH: SHA256Compress(left || right), no
padding).

The structure follows bellman's ``gadgets/sha256.rs``, ``uint32.rs`` and
``boolean.rs``, and Sprout's input-note circuit:

* a boolean (``Bit``) is a constant, or a linear form of variables that the
  constraints hold to 0 or 1; a 32-bit word is 32 bits, least significant
  first.  ``rotr`` and ``shr`` move bits and cost nothing;
* an allocated boolean carries its booleanity constraint (1 - b) b = 0;
* ``xor``, ``ch`` and ``maj`` cost one constraint a bit, and nothing where
  the result follows from constant operands (xor with a constant; ch with a
  constant selector or two constant choices; maj with two constants);
* ``addmany`` allocates the bits of the whole sum of k words
  (bit length of k (2^32 - 1)), each with its booleanity constraint, and
  enforces 0 * 0 = (weighted operand bits) - (weighted result bits) in one
  constraint; the carries past bit 31 are dropped;
* the compression from the FIPS 180-4 IV defers additions as bellman's
  ``Maybe`` does: e and a are each one 6- and 7-operand ``addmany`` a round,
  and the final additions fold the IV into the last deferred sums.

Departures from bellman and Sprout, each to save constraints:

* ``maj`` is one constraint a bit, (4 m - s)(s - 1) = 2 m with
  s = a + b + c, whose one solution over booleans a, b, c is m = maj; bellman
  spends two (b and c, then the maj);
* the conditional swap allocates the left bit only, x = cur + p (sib - cur)
  in one constraint, and takes the right one as the linear form
  cur + sib - x; Sprout allocates both with booleanity and two constraints;
* the second path's root is held to the first one's bit by bit,
  (root2 - root1) * 1 = 0, with no value gate: both notes count as
  non-zero-value notes.

Counts (``COMPRESSION_CONSTRAINTS``, ``merkle_constraints``): one
compression from the IV is 24,044 constraints (message schedule 48 x 150,
rounds 1-63 200 each, ch and maj in rounds 2-63 64 each, final additions
276) and allocates 23,862 bits; a level adds the position bit, 256 sibling
bits and 256 swap constraints (513); two paths of depth d add their 2 x 256
leaf bits, 256 root equalities and the 2 packing constraints.

Bit order: a 256-bit node is its 32 bytes big-endian, each byte most
significant bit first (bellman's ``into_bits_be``); the anchor is packed
into public inputs in that order, 254 bits and then 2, bit i of a chunk
weighing 2^i (bellman's ``multipack::pack_into_inputs``).
"""

from __future__ import annotations

from ..frontend.r1cs import ONE, LinearCombination
from ..hostmath.bls12_381 import R

K = (0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
     0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
     0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
     0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
     0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
     0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
     0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
     0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
     0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
     0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
     0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2)
IV = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a, 0x510e527f, 0x9b05688c,
      0x1f83d9ab, 0x5be0cd19)
MASK = 0xFFFFFFFF
NEG1 = R - 1
#: the largest number of bits one public input packs (BLS12-381 Fr capacity)
CAPACITY = 254

COMPRESSION_CONSTRAINTS = 24044
LEVEL_CONSTRAINTS = 1 + 256 + 256 + COMPRESSION_CONSTRAINTS


def merkle_constraints(depth: int) -> int:
    """Constraints of ``MerkleTwoPaths(depth)``: two leaves and paths, the
    root equality and the anchor's packing."""
    return 2 * (256 + depth * LEVEL_CONSTRAINTS) + 256 + 2


# -- booleans and words ------------------------------------------------------

class Bit:
    """A constant (``lc`` None, ``value`` 0 or 1) or a tuple of (coeff,
    variable) terms held to 0 or 1; ``value`` is None at setup."""

    __slots__ = ("lc", "value")

    def __init__(self, lc, value):
        self.lc = lc
        self.value = value


FALSE, TRUE = Bit(None, 0), Bit(None, 1)


def const_word(value: int) -> list:
    return [TRUE if (value >> i) & 1 else FALSE for i in range(32)]


def rotr(word, k: int) -> list:
    return [word[(i + k) % 32] for i in range(32)]


def shr(word, k: int) -> list:
    return [word[i + k] if i + k < 32 else FALSE for i in range(32)]


def _terms(bit, scale: int = 1) -> list:
    """The bit's linear form times ``scale``, as terms."""
    if bit.lc is None:
        return [(scale % R, ONE)] if bit.value else []
    if scale == 1:
        return list(bit.lc)
    return [(c * scale % R, v) for c, v in bit.lc]


def _value(op, *bits):
    vals = [b.value for b in bits]
    return None if None in vals else op(*vals)


def _alloc(cs, value) -> tuple:
    """A new witness variable (no constraint), as a bit's terms."""
    return ((1, cs.new_witness_variable(value)),)


def bnot(bit) -> Bit:
    if bit.lc is None:
        return FALSE if bit.value else TRUE
    return Bit(((1, ONE),) + tuple((R - c, v) for c, v in bit.lc),
               None if bit.value is None else 1 - bit.value)


def alloc_bit(cs, value=None) -> Bit:
    """A boolean witness with its booleanity constraint (1 - b) b = 0."""
    lc = _alloc(cs, value)
    v = lc[0][1]
    cs.enforce_constraint(LinearCombination([(1, ONE), (NEG1, v)]),
                          LinearCombination(list(lc)), LinearCombination())
    return Bit(lc, value)


def xor(cs, a, b) -> Bit:
    """a xor b: (2a) b = a + b - c."""
    if a.lc is None:
        return bnot(b) if a.value else b
    if b.lc is None:
        return bnot(a) if b.value else a
    value = _value(lambda x, y: x ^ y, a, b)
    c = _alloc(cs, value)
    cs.enforce_constraint(LinearCombination(_terms(a, 2)),
                          LinearCombination(list(b.lc)),
                          LinearCombination(list(a.lc + b.lc)
                                            + [(NEG1, c[0][1])]))
    return Bit(c, value)


def ch(cs, e, f, g) -> Bit:
    """e ? f : g: (f - g) e = ch - g."""
    if e.lc is None:
        return f if e.value else g
    if f.lc is None and g.lc is None:
        if f.value == g.value:
            return f
        return e if f.value else bnot(e)
    value = _value(lambda x, y, z: y if x else z, e, f, g)
    c = _alloc(cs, value)
    neg_g = _terms(g, NEG1)
    cs.enforce_constraint(LinearCombination(_terms(f) + neg_g),
                          LinearCombination(list(e.lc)),
                          LinearCombination(list(c) + neg_g))
    return Bit(c, value)


def maj(cs, a, b, c) -> Bit:
    """The majority of a, b, c: (4m - s)(s - 1) = 2m, s = a + b + c."""
    consts = [x for x in (a, b, c) if x.lc is None]
    if len(consts) == 3:
        return TRUE if sum(x.value for x in consts) >= 2 else FALSE
    if len(consts) == 2:
        if consts[0].value == consts[1].value:
            return consts[0]
        return next(x for x in (a, b, c) if x.lc is not None)
    value = _value(lambda x, y, z: int(x + y + z >= 2), a, b, c)
    m = _alloc(cs, value)[0][1]
    s = _terms(a) + _terms(b) + _terms(c)
    cs.enforce_constraint(
        LinearCombination([(4, m)] + [(R - co, v) for co, v in s]),
        LinearCombination(s + [(NEG1, ONE)]),
        LinearCombination([(2, m)]))
    return Bit(((1, m),), value)


def xor_word(cs, x, y) -> list:
    return [xor(cs, a, b) for a, b in zip(x, y)]


def addmany(cs, words) -> list:
    """The sum of ``words`` mod 2^32 (module docstring)."""
    nbits = (len(words) * MASK).bit_length()
    terms, total, known, constant = [], 0, True, True
    for word in words:
        for j, bit in enumerate(word):
            if bit.lc is None:
                if bit.value:
                    terms.append((1 << j, ONE))
                    total += 1 << j
                continue
            constant = False
            terms.extend(((co << j) % R, v) for co, v in bit.lc)
            if bit.value is None:
                known = False
            elif bit.value:
                total += 1 << j
    if constant:
        return const_word(total & MASK)
    bits = [alloc_bit(cs, (total >> i) & 1 if known else None)
            for i in range(nbits)]
    terms.extend((R - (1 << i), b.lc[0][1]) for i, b in enumerate(bits))
    cs.enforce_constraint(LinearCombination(), LinearCombination(),
                          LinearCombination(terms))
    return bits[:32]


class _Deferred:
    """An addition not made yet (bellman's ``Maybe::Deferred``)."""

    __slots__ = ("words",)

    def __init__(self, words):
        self.words = words


def _compute(cs, x, extra=()) -> list:
    if isinstance(x, _Deferred):
        return addmany(cs, x.words + list(extra))
    return x


def _sigma(cs, word, r1, r2, r3) -> list:
    return xor_word(cs, xor_word(cs, rotr(word, r1), rotr(word, r2)),
                    rotr(word, r3))


def sha256_compress(cs, bits) -> list:
    """SHA256Compress of a 512-bit block (big-endian bits) from the IV, no
    padding: the 256 big-endian bits of the new state."""
    assert len(bits) == 512
    w = [bits[32 * i:32 * i + 32][::-1] for i in range(16)]
    for i in range(16, 64):
        x = w[i - 15]
        s0 = xor_word(cs, xor_word(cs, rotr(x, 7), rotr(x, 18)), shr(x, 3))
        x = w[i - 2]
        s1 = xor_word(cs, xor_word(cs, rotr(x, 17), rotr(x, 19)), shr(x, 10))
        w.append(addmany(cs, [w[i - 16], s0, w[i - 7], s1]))
    a, b, c, d, e, f, g, h = (const_word(v) for v in IV)
    for i in range(64):
        e = _compute(cs, e)
        s1 = _sigma(cs, e, 6, 11, 25)
        chw = [ch(cs, x, y, z) for x, y, z in zip(e, f, g)]
        temp1 = [h, s1, chw, const_word(K[i]), w[i]]
        a = _compute(cs, a)
        s0 = _sigma(cs, a, 2, 13, 22)
        majw = [maj(cs, x, y, z) for x, y, z in zip(a, b, c)]
        h, g, f, e = g, f, e, _Deferred(temp1 + [d])
        d, c, b, a = c, b, a, _Deferred(temp1 + [s0, majw])
    out = [_compute(cs, a, [const_word(IV[0])]),
           addmany(cs, [const_word(IV[1]), b]),
           addmany(cs, [const_word(IV[2]), c]),
           addmany(cs, [const_word(IV[3]), d]),
           _compute(cs, e, [const_word(IV[4])]),
           addmany(cs, [const_word(IV[5]), f]),
           addmany(cs, [const_word(IV[6]), g]),
           addmany(cs, [const_word(IV[7]), h])]
    return [bit for word in out for bit in word[::-1]]


# -- Merkle paths ------------------------------------------------------------

def alloc_u256(cs, value=None) -> list:
    """256 boolean witnesses, the big-endian bits of ``value``."""
    return [alloc_bit(cs, None if value is None else (value >> (255 - i)) & 1)
            for i in range(256)]


def conditional_swap(cs, cur, sib, right) -> tuple:
    """(cur, sib) when ``right`` is 0, (sib, cur) when 1: per bit pair the
    left bit x, p (sib - cur) = x - cur, and the right bit cur + sib - x."""
    left, rgt = [], []
    p = list(right.lc)
    for x, y in zip(cur, sib):
        value = _value(lambda q, u, v: v if q else u, right, x, y)
        lc = _alloc(cs, value)
        neg_x = _terms(x, NEG1)
        cs.enforce_constraint(LinearCombination(_terms(y) + neg_x),
                              LinearCombination(p),
                              LinearCombination(list(lc) + neg_x))
        left.append(Bit(lc, value))
        rgt.append(Bit(tuple(_terms(x) + _terms(y) + [(NEG1, lc[0][1])]),
                       _value(lambda q, u, v: u if q else v, right, x, y)))
    return left, rgt


def merkle_path(cs, leaf, siblings, position, depth: int) -> list:
    """The root bits over ``leaf`` (bits); ``siblings`` and ``position``
    are values, or None at setup."""
    cur = leaf
    for i in range(depth):
        p = alloc_bit(cs, None if position is None else (position >> i) & 1)
        sib = alloc_u256(cs, None if siblings is None else siblings[i])
        left, right = conditional_swap(cs, cur, sib, p)
        cur = sha256_compress(cs, left + right)
    return cur


def pack_into_inputs(cs, bits) -> None:
    """Public inputs packing ``bits`` (module docstring), each held to its
    bits by (sum 2^i b_i) * 1 = input."""
    for k in range(0, len(bits), CAPACITY):
        terms, value = [], 0
        for i, bit in enumerate(bits[k:k + CAPACITY]):
            terms += _terms(bit, 1 << i)
            value = None if value is None or bit.value is None else (
                value + (bit.value << i))
        x = cs.new_input_variable(value)
        cs.enforce_constraint(LinearCombination(terms),
                              LinearCombination([(1, ONE)]),
                              LinearCombination([(1, x)]))


class MerkleTwoPaths:
    """Two leaves' authentication paths of ``depth`` levels under one anchor,
    the anchor packed into two public inputs (Sprout's JoinSplit Merkle
    checks).  ``leaves`` (two ints), ``siblings`` (two lists of ``depth``
    ints, from the leaf up) and ``positions`` (two ints) are the witness;
    None at setup."""

    def __init__(self, depth: int, leaves=None, siblings=None,
                 positions=None):
        self.depth = depth
        self.leaves = leaves
        self.siblings = siblings
        self.positions = positions

    def generate_constraints(self, cs):
        roots = []
        for k in range(2):
            given = self.leaves is not None
            leaf = alloc_u256(cs, self.leaves[k] if given else None)
            roots.append(merkle_path(
                cs, leaf, self.siblings[k] if given else None,
                self.positions[k] if given else None, self.depth))
        pack_into_inputs(cs, roots[0])
        for x, y in zip(roots[1], roots[0]):
            cs.enforce_constraint(
                LinearCombination(_terms(x) + _terms(y, NEG1)),
                LinearCombination([(1, ONE)]), LinearCombination())
