"""Shared protocol math + Fiat–Shamir glue (reference ``src/common.rs``).

Constants, the challenge message schema, the public-input polynomial
evaluation, and the ``c_at_x1`` formula.  All Fr values are canonical ints.
"""

from __future__ import annotations

from ..hostmath.bls12_381 import R
from ..serial import codec
from .poly_host import batch_inverse

B_POLYMATH = b"polymath"
#: alpha = -3, gamma = -5, used as exponents of y (common.rs:8-14).
MINUS_ALPHA = 3
MINUS_GAMMA = 5


def compute_x1(t, public_inputs, commitments) -> int:
    """First challenge (common.rs:21-30): absorb serialized public inputs
    (Vec<Fr>) and commitments (Vec<G1>), squeeze ``x1``."""
    t.append_message(b"public_inputs", codec.fr_vec_to_bytes(public_inputs))
    t.append_message(b"commitments", codec.g1_vec_to_bytes(commitments))
    return t.challenge(b"x1")


def compute_x2(t, x1: int, values) -> int:
    """Second challenge (common.rs:32-37)."""
    t.append_message(b"x1", codec.fr_to_bytes(x1))
    t.append_message(b"values", codec.fr_vec_to_bytes(values))
    return t.challenge(b"x2")


def compute_y1(x1: int, sigma: int) -> int:
    return pow(x1, sigma, R)


def neg_power(y: int, minus_exp: int) -> int:
    """y^(-minus_exp) mod r."""
    return pow(pow(y, R - 2, R), minus_exp, R)


def z_tilde_i(public_inputs, i: int) -> int:
    """~z_i public-input encoding (common.rs:77-97)."""
    m0 = len(public_inputs)
    if i == 0:
        return 2
    if i < m0:
        return (1 + public_inputs[i]) % R
    if i == m0:
        return 0
    return (1 - public_inputs[i - m0]) % R


def compute_pi_at_x1(vk, public_inputs, x1: int, y1_gamma: int) -> int:
    """PI(x1) via the 2*m0-term Lagrange sum (common.rs:49-71), the
    denominators x1 - omega^i inverted in one batch.  A zero denominator
    (x1 = omega^i) gives its term 0."""
    n = vk.n
    m0 = len(public_inputs)
    dens = []
    omega_i = 1
    for _ in range(2 * m0):
        dens.append((x1 - omega_i) % R)
        omega_i = omega_i * vk.omega % R
    acc = 0
    num = (pow(x1, n, R) - 1) * pow(n, -1, R) % R
    for i, inv in enumerate(batch_inverse(dens)):
        acc = (acc + z_tilde_i(public_inputs, i) * (num * inv % R)) % R
        num = num * vk.omega % R
    return acc * y1_gamma % R


def compute_c_at_x1(y1_gamma: int, y1_alpha: int, a_at_x1: int, pi_at_x1: int) -> int:
    """((a + y1^gamma) * a - pi) / y1^alpha (common.rs:73-75)."""
    return ((a_at_x1 + y1_gamma) * a_at_x1 - pi_at_x1) % R * pow(y1_alpha, R - 2, R) % R
