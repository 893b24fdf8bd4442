"""The benchmark's plain reference: the Polymath verifier over Python ints.

It imports nothing of the program under test.  From the configuration's
setup seed it works out the verifying key that setup must have made, and
from each statement the public inputs; it reads the program's proofs only
as their 176 bytes, to judge them.

    vk = derive_vk(setup_seed, m0, num_constraints)
    rejected = verify_batch(vk, [(Statement(publics), proof_bytes), ...],
                            seed)

``verify_batch`` checks all proofs in one pairing product, each proof's
equation weighted by a random 128-bit factor (small-exponent batching:
a product that holds while one proof fails has probability under 2^-127).
Where the product fails, every proof is checked on its own, so the count
of rejected proofs is exact.  The algebra follows the Rust crate's
``src/verifier.rs`` and ``src/common.rs``.
"""

from __future__ import annotations

import random

from . import bls12_381 as bls
from .bls12_381 import FR_TWO_ADIC_ROOT, FR_TWO_ADICITY, Fq, R
from .strobe import MerlinTranscript

B_POLYMATH = b"polymath"
MINUS_ALPHA = 3
MINUS_GAMMA = 5
_FR_MASK = (1 << 255) - 1
_Y_POSITIVE = 1 << 7
_INFINITY = 1 << 6


# -- bytes (arkworks compressed serialization) --------------------------------

def _g1_bytes(pt) -> bytes:
    if pt is None:
        return bytes(47) + bytes([_INFINITY])
    x, y = pt
    buf = bytearray(x.v.to_bytes(48, "little"))
    if y.is_positive():
        buf[-1] |= _Y_POSITIVE
    return bytes(buf)


def _g2_bytes(pt) -> bytes:
    if pt is None:
        return bytes(95) + bytes([_INFINITY])
    x, y = pt
    buf = bytearray(x.c0.v.to_bytes(48, "little") + x.c1.v.to_bytes(48, "little"))
    if y.is_positive():
        buf[-1] |= _Y_POSITIVE
    return bytes(buf)


def _fr_bytes(v: int) -> bytes:
    return int(v).to_bytes(32, "little")


def _vec_bytes(items, ser) -> bytes:
    return len(items).to_bytes(8, "little") + b"".join(ser(i) for i in items)


def _g1_from_bytes(b: bytes):
    """48 compressed bytes -> affine G1 point (None: the identity); raises
    ValueError for bytes that are no point of the prime-order subgroup."""
    flags = b[-1] & 0xC0
    raw = bytearray(b)
    raw[-1] &= 0x3F
    x_int = int.from_bytes(raw, "little")
    if flags & _INFINITY:
        if x_int:
            raise ValueError("G1: infinity flag with nonzero x")
        return None
    if x_int >= bls.Q:
        raise ValueError("G1: x >= q")
    x = Fq(x_int)
    y = (x * x * x + bls.G1.b).sqrt()
    if y is None:
        raise ValueError("G1: x not on the curve")
    if y.is_positive() != bool(flags & _Y_POSITIVE):
        y = -y
    if not bls.G1.in_subgroup((x, y)):
        raise ValueError("G1: point not in the subgroup")
    return (x, y)


def decode_proof(b: bytes):
    """176 proof bytes -> (a_g1, c_g1, a_at_x1, d_g1)."""
    if len(b) != 176:
        raise ValueError(f"a proof is 176 bytes, not {len(b)}")
    a_at_x1 = int.from_bytes(b[96:128], "little")
    if a_at_x1 >= R:
        raise ValueError("Fr: value >= r")
    return (_g1_from_bytes(b[0:48]), _g1_from_bytes(b[48:96]), a_at_x1,
            _g1_from_bytes(b[128:176]))


# -- the verifying key ---------------------------------------------------------

def domain_size(m0: int, num_constraints: int) -> int:
    """The evaluation domain: the power of two holding the SAP's
    2 (m0 + constraints) rows (frontend/sap.py's layout)."""
    rows = 2 * (m0 + num_constraints)
    return 1 << max(rows - 1, 0).bit_length()


def _outside_domain(rng: random.Random, n: int) -> int:
    while True:
        t = rng.randrange(R)
        if pow(t, n, R) != 1:
            return t


class VerifyingKey:
    def __init__(self, x: int, z: int, n: int, m0: int):
        log_n = n.bit_length() - 1
        self.n, self.m0, self.sigma = n, m0, n + 3
        self.omega = pow(FR_TWO_ADIC_ROOT, 1 << (FR_TWO_ADICITY - log_n), R)
        self.x_g2 = bls.G2.mul(bls.G2.gen, x)
        self.z_g2 = bls.G2.mul(bls.G2.gen, z)

    def to_bytes(self) -> bytes:
        return (_g1_bytes(bls.G1.gen) + _g2_bytes(bls.G2.gen)
                + _g2_bytes(self.x_g2) + _g2_bytes(self.z_g2)
                + self.n.to_bytes(8, "little") + self.m0.to_bytes(8, "little")
                + self.sigma.to_bytes(8, "little") + _fr_bytes(self.omega))


def derive_vk(setup_seed: int, m0: int, num_constraints: int) -> VerifyingKey:
    """The key that setup draws from ``random.Random(setup_seed)``: the
    trapdoors x and z are its first two draws outside the domain
    (reference generator.rs:58-59)."""
    n = domain_size(m0, num_constraints)
    rng = random.Random(setup_seed)
    x = _outside_domain(rng, n)
    z = _outside_domain(rng, n)
    return VerifyingKey(x, z, n, m0)


# -- one proof's equation ------------------------------------------------------

def _challenge(t: MerlinTranscript, label: bytes) -> int:
    while True:
        x = int.from_bytes(t.challenge_bytes(label, 64)[:32], "little") & _FR_MASK
        if x < R:
            return x


def _inverses(values) -> list:
    """Every value's inverse mod r with one exponentiation (Montgomery's
    batch inversion)."""
    prefix, acc = [], 1
    for v in values:
        prefix.append(acc)
        acc = acc * v % R
    inv = pow(acc, R - 2, R)
    out = [0] * len(values)
    for i in range(len(values) - 1, -1, -1):
        out[i] = inv * prefix[i] % R
        inv = inv * values[i] % R
    return out


def _pi_at_x1(vk: VerifyingKey, inputs, x1: int, y1_gamma: int) -> int:
    """PI(x1): the 2 m0-term Lagrange sum of common.rs:49-97,
    sum_i z~_i w^i (x1^n - 1) / (n (x1 - w^i))."""
    m0 = len(inputs)
    powers, w = [], 1
    for _ in range(2 * m0):
        powers.append(w)
        w = w * vk.omega % R
    inv = _inverses([(x1 - p) % R for p in powers])
    acc = 0
    for i in range(2 * m0):
        if i == 0:
            zt = 2
        elif i < m0:
            zt = 1 + inputs[i]
        elif i == m0:
            zt = 0
        else:
            zt = 1 - inputs[i - m0]
        acc = (acc + zt * powers[i] * inv[i]) % R
    num = (pow(x1, vk.n, R) - 1) * pow(vk.n, R - 2, R) % R
    return acc * num % R * y1_gamma % R


class Statement:
    """The transcript state after one statement's public inputs, kept so
    that each proof of the statement only absorbs its commitments."""

    def __init__(self, publics):
        self.inputs = [1] + [int(v) % R for v in publics]
        self.t = MerlinTranscript(B_POLYMATH)
        self.t.append_message(b"public_inputs",
                              _vec_bytes(self.inputs, _fr_bytes))


def equation(vk: VerifyingKey, st: Statement, proof):
    """(P, d, x1) such that the proof holds iff
    e(P, z_g2) * e(-d, x_g2 - x1 g2) = 1 (verifier.rs:19-62)."""
    a_g1, c_g1, a_at_x1, d_g1 = proof
    t = st.t.clone()
    t.append_message(b"commitments", _vec_bytes([a_g1, c_g1], _g1_bytes))
    x1 = _challenge(t, b"x1")
    y1 = pow(x1, vk.sigma, R)
    y1_inv = pow(y1, R - 2, R)
    y1_gamma = pow(y1_inv, MINUS_GAMMA, R)
    y1_alpha = pow(y1_inv, MINUS_ALPHA, R)
    pi = _pi_at_x1(vk, st.inputs, x1, y1_gamma)
    c_at_x1 = ((a_at_x1 + y1_gamma) * a_at_x1 - pi) % R \
        * pow(y1_alpha, R - 2, R) % R
    t.append_message(b"x1", _fr_bytes(x1))
    t.append_message(b"values", _vec_bytes([a_at_x1, c_at_x1], _fr_bytes))
    x2 = _challenge(t, b"x2")
    p = bls.G1.msm([a_g1, c_g1, bls.G1.gen],
                   [1, x2, (-(a_at_x1 + x2 * c_at_x1)) % R])
    return p, d_g1, x1


def _holds(vk, terms) -> bool:
    """sum_i r_i [e(P_i, z_g2) e(-d_i, x_g2) e(x1_i d_i, g2)] = 1 for the
    (r_i, P_i, d_i, x1_i) in ``terms``."""
    p = bls.G1.msm([t[1] for t in terms], [t[0] for t in terms])
    ds = [t[2] for t in terms]
    d = bls.G1.msm(ds, [t[0] for t in terms])
    dx = bls.G1.msm(ds, [t[0] * t[3] % R for t in terms])
    f = bls.multi_pairing([p, bls.G1.neg(d), dx],
                          [vk.z_g2, vk.x_g2, bls.G2.gen])
    return f == bls.Fq12.one()


def verify_batch(vk: VerifyingKey, items, seed: int) -> list:
    """``items``: (Statement, proof bytes) pairs.  Returns the indices of
    the proofs that do not verify."""
    rng = random.Random(f"batch-{seed}")
    rejected, terms, where = [], [], []
    for i, (st, raw) in enumerate(items):
        try:
            p, d, x1 = equation(vk, st, decode_proof(raw))
        except ValueError:
            rejected.append(i)
            continue
        terms.append((rng.getrandbits(128) | 1, p, d, x1))
        where.append(i)
    if terms and not _holds(vk, terms):
        rejected += [i for i, t in zip(where, terms)
                     if not _holds(vk, [(1,) + t[1:]])]
    return sorted(rejected)
