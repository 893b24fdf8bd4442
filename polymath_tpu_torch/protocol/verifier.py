"""Verifier (reference ``src/verifier.rs``): O(m0) field work + two tiny
MSMs + a 2-pair pairing product.  Host-side by design (constant work per
proof; no benefit from the device)."""

from __future__ import annotations

from ..hostmath import bls12_381 as bls
from ..hostmath.bls12_381 import R, Fq12
from . import common
from .common import MINUS_ALPHA, MINUS_GAMMA


def verify_proof(vk, proof, public_inputs, transcript_cls) -> bool:
    """verifier.rs:19-62.  ``public_inputs`` excludes the leading 1."""
    inputs = [1] + [int(v) % R for v in public_inputs]

    t = transcript_cls(common.B_POLYMATH)
    x1 = common.compute_x1(t, inputs, [proof.a_g1, proof.c_g1])
    y1 = common.compute_y1(x1, vk.sigma)
    y1_gamma = common.neg_power(y1, MINUS_GAMMA)
    pi_at_x1 = common.compute_pi_at_x1(vk, inputs, x1, y1_gamma)
    y1_alpha = common.neg_power(y1, MINUS_ALPHA)
    c_at_x1 = common.compute_c_at_x1(y1_gamma, y1_alpha, proof.a_at_x1, pi_at_x1)
    x2 = common.compute_x2(t, x1, [proof.a_at_x1, c_at_x1])

    from ..native import multi_pairing_is_one, g1_msm, g2_msm
    commitments_minus_evals = g1_msm(
        [proof.a_g1, proof.c_g1, vk.e.one_g1],
        [1, x2, (-(proof.a_at_x1 + x2 * c_at_x1)) % R],
    )
    x_minus_x1_g2 = g2_msm([vk.e.x_g2, vk.e.one_g2], [1, (-x1) % R])

    return multi_pairing_is_one(
        [commitments_minus_evals, bls.G1.neg(proof.d_g1)],
        [vk.e.z_g2, x_minus_x1_g2],
    )
