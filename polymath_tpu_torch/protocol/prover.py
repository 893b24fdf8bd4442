"""Prover (reference ``src/prover.rs``) — host (oracle) implementation.

Follows the canonical pipeline (SURVEY.md §2.3, prover.rs:66-237) with the
reference's O(n·m) dense SAP materialization replaced by O(nnz) block
matvecs (frontend/sap.py).  Bulk work (NTTs, MSMs) goes through pluggable
callables so the device backend (ops/prover_jax.py) can reuse this exact
protocol skeleton.
"""

from __future__ import annotations

from ..hostmath import bls12_381 as bls
from ..hostmath.bls12_381 import R
from ..frontend.r1cs import synthesize, ConstraintSystem
from .poly_host import (
    Radix2Domain, poly_eval, poly_trim, divide_by_vanishing, synthetic_divide,
)
from . import common
from .common import MINUS_ALPHA, MINUS_GAMMA
from .data_structures import Proof


def create_proof(circuit, pk, rng, transcript_cls) -> Proof:
    """Synthesize the witness then prove (prover.rs:27-64)."""
    cs = synthesize(circuit, ConstraintSystem.PROVE)
    return create_proof_with_assignment(
        pk, cs.instance_assignment, cs.witness_assignment, rng, transcript_cls)


def create_proof_with_assignment(pk, instance, witness, rng, transcript_cls,
                                 msm=None) -> Proof:
    """Full proof pipeline (prover.rs:66-237).

    ``msm(scalars, points)``: variable-base G1 MSM returning an affine
    point; defaults to the host Pippenger.
    """
    sap = pk.sap_matrices
    if msm is None:
        msm = lambda scalars, points: bls.G1.msm(points, [s % R for s in scalars])

    rows, num_columns = sap.size()
    domain = Radix2Domain(rows)
    n = domain.n
    sigma = pk.vk.sigma
    m0 = len(instance)

    # -- SAP assignment and evaluation vectors (O(nnz)) -------------------
    z = sap.z_vector(instance, witness)
    u_evals = sap.u_evals(z, n)
    w_evals = sap.w_evals(z, n)
    u_coeffs = domain.ifft(u_evals)
    w_coeffs = domain.ifft(w_evals)

    # -- u^2 via size-2n FFT (prover.rs:315-328) --------------------------
    sq_domain = Radix2Domain(2 * n)
    u2_evals = sq_domain.fft(u_coeffs)
    u2_evals = [v * v % R for v in u2_evals]
    u2_coeffs = sq_domain.ifft(u2_evals)

    # -- h = (u^2 - w) / Z_H ----------------------------------------------
    h_num = [(u2_coeffs[i] if i < len(u2_coeffs) else 0)
             - (w_coeffs[i] if i < len(w_coeffs) else 0)
             for i in range(max(len(u2_coeffs), len(w_coeffs)))]
    h_num = [v % R for v in h_num]
    h_coeffs, rem = divide_by_vanishing(h_num, n)
    assert not poly_trim(list(rem)), "vanishing division must be exact"
    assert len(h_coeffs) - 1 <= n - 2, "deg h <= n-2"

    # -- blinding r_a (degree 1) ------------------------------------------
    r_a = [rng.randrange(R), rng.randrange(R)]

    # -- commitments ------------------------------------------------------
    u_trim = poly_trim(list(u_coeffs))
    a_g1 = bls.G1.add(
        msm(u_trim, pk.x_powers_g1),
        msm(r_a, pk.x_powers_y_alpha_g1),
    )

    two_ra_u = [0] * (len(u_trim) + 1)
    for i, c in enumerate(u_trim):
        two_ra_u[i] = (two_ra_u[i] + 2 * c * r_a[0]) % R
        two_ra_u[i + 1] = (two_ra_u[i + 1] + 2 * c * r_a[1]) % R
    r_a_sq = [r_a[0] * r_a[0] % R, 2 * r_a[0] * r_a[1] % R, r_a[1] * r_a[1] % R]
    r_g1 = bls.G1.add(
        bls.G1.add(
            msm(two_ra_u, pk.x_powers_g1),
            msm(r_a_sq, pk.x_powers_y_alpha_g1),
        ),
        msm(r_a, pk.x_powers_y_gamma_g1),
    )

    c_g1 = bls.G1.add(
        bls.G1.add(
            msm(z[m0:], pk.uj_wj_lcs_by_y_alpha_g1),
            msm(h_coeffs, pk.x_powers_zh_by_y_alpha_g1),
        ),
        r_g1,
    )

    # -- Fiat-Shamir round 1 ----------------------------------------------
    t = transcript_cls(common.B_POLYMATH)
    x1 = common.compute_x1(t, instance, [a_g1, c_g1])
    y1 = common.compute_y1(x1, sigma)
    y1_alpha = common.neg_power(y1, MINUS_ALPHA)
    y1_gamma = common.neg_power(y1, MINUS_GAMMA)

    a_at_x1 = (poly_eval(u_coeffs, x1) + poly_eval(r_a, x1) * y1_alpha) % R
    pi_at_x1 = common.compute_pi_at_x1(pk.vk, instance, x1, y1_gamma)
    c_at_x1 = common.compute_c_at_x1(y1_gamma, y1_alpha, a_at_x1, pi_at_x1)

    # -- witness-only u, w polynomials (prover.rs:156-166) ----------------
    wu_coeffs = domain.ifft(sap.witness_u_evals(z, n))
    ww_coeffs = domain.ifft(sap.witness_w_evals(z, n))

    # -- Fiat-Shamir round 2 ----------------------------------------------
    x2 = common.compute_x2(t, x1, [a_at_x1, c_at_x1])

    # -- assemble D(X)*Y^-gamma numerator (prover.rs:142-225) -------------
    # Support blocks at X-shifts:  0: x2*r_a;  2s: r_a*y_alpha terms;
    # 3s: x2*witness_u;  5s: u + 2*x2*r_a*u - evals;  8s: x2*(witness_w + h_num).
    d_max = 2 * (n - 1) + sigma * (MINUS_ALPHA + MINUS_GAMMA)
    dnum = [0] * (d_max + 1)

    def add_block(shift, coeffs, scale=1):
        for i, c in enumerate(coeffs):
            if c:
                dnum[shift + i] = (dnum[shift + i] + c * scale) % R

    s = sigma
    # A(X) * Y^-gamma: u at 5s, r_a at 2s  (gamma-alpha shift: s*(5-3))
    add_block(5 * s, u_trim)
    add_block(2 * s, r_a)
    # + x2 * C(X) * Y^-gamma
    add_block(3 * s, poly_trim(list(wu_coeffs)), x2)
    add_block(8 * s, poly_trim(list(ww_coeffs)), x2)
    add_block(8 * s, poly_trim(list(h_num)), x2)
    add_block(5 * s, two_ra_u, x2)
    add_block(2 * s, r_a_sq, x2)
    add_block(0, r_a, x2)
    # - (a_at_x1 + x2*c_at_x1) * Y^-gamma
    dnum[5 * s] = (dnum[5 * s] - a_at_x1 - x2 * c_at_x1) % R

    d_coeffs, rem_scalar = synthetic_divide(dnum, x1)
    assert rem_scalar == 0, "quotient division by (X - x1) must be exact"

    d_g1 = msm(d_coeffs, pk.x_powers_y_gamma_z_g1)

    return Proof(a_g1=a_g1, c_g1=c_g1, a_at_x1=a_at_x1, d_g1=d_g1)
