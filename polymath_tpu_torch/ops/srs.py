"""Trusted setup on the card: SRS scalar vectors and the fixed-base bulk
multiplication (counterpart of srs.py; the generator's hot path,
reference generator.rs:79-146).

Scalar vectors are computed on the card (powers by doubling, Lagrange
coefficients by batched Fermat inversion, column sums by segment sums)
and the SRS points stay there (``pk.device["srs"]``, (N, 24) affine
rows); the host never converts an O(n) point vector.
"""

from __future__ import annotations

import numpy as np
import torch

from ..hostmath import bls12_381 as bls
from ..hostmath.bls12_381 import R
from ..frontend.r1cs import synthesize, ConstraintSystem
from ..frontend.sap import SAPMatrices
from ..protocol.common import MINUS_ALPHA, MINUS_GAMMA
from ..protocol.data_structures import PairingVK, VerifyingKey, ProvingKey
from ..protocol.poly_host import Radix2Domain
from ..utils.timers import phase, sync
from .cuda_field import fr_mul
from .field import fr_add, fr_const, fr_from_mont, fr_inv, fr_sub
from .fixed_base import fixed_base_mul
from .limbs import FR_SPEC, ints_to_words
from .ntt import domain_omega, powers_of
from .sparse import segment_sum_mod

#: the SRS vectors built on the card, in ProvingKey field order
SRS_BIG = ("x_powers_g1", "x_powers_zh_by_y_alpha_g1",
           "x_powers_y_gamma_z_g1", "uj_wj_lcs_by_y_alpha_g1")


def generate_proving_key_device(circuit, rng, device) -> ProvingKey:
    """Full setup with scalar vectors and SRS on ``device``.

    Phase scopes mirror the reference generator's ark-std timers
    (generator.rs:28-148)."""
    with phase("setup::constraint synthesis"):
        cs = synthesize(circuit, ConstraintSystem.SETUP)
        sap = SAPMatrices.from_constraint_system(cs)
    rows, num_columns = sap.size()
    domain = Radix2Domain(rows)
    n = domain.n
    m0 = sap.num_instance_variables
    m = num_columns
    sigma = n + 3
    bnd_a = 1

    x = domain.sample_element_outside_domain(rng)
    z = domain.sample_element_outside_domain(rng)
    y = pow(x, sigma, R)
    y_inv = pow(y, R - 2, R)
    y_alpha = pow(y_inv, MINUS_ALPHA, R)
    y_to_minus_alpha = pow(y, MINUS_ALPHA, R)
    y_gamma = pow(y_inv, MINUS_GAMMA, R)

    d_max = 2 * (n - 1) + sigma * (MINUS_ALPHA + MINUS_GAMMA)

    def scaled(vec, const_int):
        return fr_mul(vec, fr_const(const_int, device))

    with phase("setup::x-power scalar vectors"):
        xm = fr_const(x, device)
        xp_all = powers_of(xm, d_max + 1)               # (8, d_max+1) mont
        sc = {}
        sc["x_powers_g1"] = xp_all[:, : n + bnd_a]
        sc["x_powers_y_gamma_z_g1"] = scaled(xp_all, y_gamma * z % R)
        zh_at_x = (pow(x, n, R) - 1) % R
        sc["x_powers_zh_by_y_alpha_g1"] = sync(scaled(
            xp_all[:, : n - 1], zh_at_x * y_to_minus_alpha % R))

    # l_i(x) = omega^i * (x^n - 1) / (n (x - omega^i))
    with phase("setup::lagrange coefficients at x"):
        omega = domain_omega(n)
        om_pows = powers_of(fr_const(omega, device), n)  # (8, n)
        denom = fr_sub(xm.expand(-1, n), om_pows)
        denom_inv = fr_inv(denom)                       # batched Fermat
        l_at_x = sync(scaled(fr_mul(om_pows, denom_inv),
                             zh_at_x * pow(n, R - 2, R) % R))

    with phase("setup::SAP column views"):
        u_cols = sap.u_columns_transposed()
        w_cols = sap.w_columns_transposed()

    def col_sums(cols_dict):
        seg, row, coeff = [], [], []
        for j, entries in cols_dict.items():
            for i, co in entries:
                seg.append(j - m0)
                row.append(i)
                coeff.append(co)
        if not seg:
            seg, row, coeff = [0], [0], [0]
        cmont = torch.from_numpy(ints_to_words(
            [FR_SPEC.to_mont_int(c) for c in coeff], FR_SPEC.L)).to(device)
        row_t = torch.as_tensor(np.asarray(row, np.int64), device=device)
        seg_t = torch.as_tensor(np.asarray(seg, np.int64), device=device)
        prods = fr_mul(l_at_x[:, row_t], cmont)
        return segment_sum_mod(prods, seg_t, m - m0)

    with phase("setup::u_j(x), w_j(x) column sums"):
        uj_x = col_sums(u_cols)
        wj_x = col_sums(w_cols)
        sc["uj_wj_lcs_by_y_alpha_g1"] = sync(scaled(
            fr_add(scaled(uj_x, y_gamma), wj_x), y_to_minus_alpha))

    del xp_all, om_pows, denom, denom_inv, l_at_x

    # one fixed-base pass over all four vectors (canonical scalars): the
    # per-launch cost is shared, and the rows split back afterwards
    with phase("setup::fixed-base mul"):
        lens = [sc[name].shape[-1] for name in SRS_BIG]
        allsc = fr_from_mont(torch.cat([sc.pop(name) for name in SRS_BIG],
                                       dim=1))
        rows_all = sync(fixed_base_mul(allsc))
        del allsc
        srs_device, off = {}, 0
        for name, ln in zip(SRS_BIG, lens):
            srs_device[name] = rows_all[off:off + ln]
            off += ln

    # small vectors on host (exact per generator.rs:85-91)
    with phase("setup::G2 + small host vectors"):
        from ..protocol.generator import FixedBaseTable
        table = FixedBaseTable(bls.G1, bls.G1.gen, c=8)
        x_powers_y_alpha = [table.mul(pow(x, j, R) * y_alpha % R)
                            for j in range(2 * bnd_a + 1)]
        x_powers_y_gamma = [table.mul(pow(x, j, R) * y_gamma % R)
                            for j in range(bnd_a + 1)]

    e = PairingVK(
        one_g1=bls.G1.gen, one_g2=bls.G2.gen,
        x_g2=bls.G2.mul(bls.G2.gen, x), z_g2=bls.G2.mul(bls.G2.gen, z))
    vk = VerifyingKey(e=e, n=n, m0=m0, sigma=sigma, omega=omega)

    pk = ProvingKey(
        vk=vk, sap_matrices=sap,
        x_powers_g1=None,
        x_powers_y_alpha_g1=x_powers_y_alpha,
        x_powers_zh_by_y_alpha_g1=None,
        x_powers_y_gamma_g1=x_powers_y_gamma,
        x_powers_y_gamma_z_g1=None,
        uj_wj_lcs_by_y_alpha_g1=None,
    )
    pk.device["srs"] = srs_device
    return pk
