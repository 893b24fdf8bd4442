"""Trusted setup: SRS / key generation (reference ``src/generator.rs``).

Host (oracle) implementation over Python ints with a shared fixed-base
window table — already an asymptotic improvement over the reference's
one-full-scalar-mul-per-element ``generate()`` (generator.rs:169-177).
The device (TPU) implementation lives in ops/srs.py and is dispatched by
``api.Polymath``; both produce identical keys given the same trapdoors.
"""

from __future__ import annotations

from ..hostmath import bls12_381 as bls
from ..hostmath.bls12_381 import R
from ..frontend.r1cs import synthesize, ConstraintSystem
from ..frontend.sap import SAPMatrices
from .poly_host import Radix2Domain
from .common import MINUS_ALPHA, MINUS_GAMMA
from .data_structures import PairingVK, VerifyingKey, ProvingKey


class FixedBaseTable:
    """Windowed fixed-base scalar multiplication table for one base point."""

    def __init__(self, group, base_affine, c: int = 8, bits: int = 256):
        self.group = group
        self.c = c
        self.windows = (bits + c - 1) // c
        self.table = []  # [window][digit] jacobian points; digit 0 unused
        b = group.to_jacobian(base_affine)
        for _ in range(self.windows):
            row = [None]
            acc = None
            for _ in range((1 << c) - 1):
                acc = b if acc is None else group.jac_add(acc, b)
                row.append(acc)
            self.table.append(row)
            for _ in range(c):
                b = group.jac_double(b)

    def mul(self, scalar: int):
        g = self.group
        acc = (g.K.one(), g.K.one(), g.K.zero())
        for w in range(self.windows):
            d = (scalar >> (w * self.c)) & ((1 << self.c) - 1)
            if d:
                acc = g.jac_add(acc, self.table[w][d])
        return g.from_jacobian(acc)


def compute_srs_scalars(sap: SAPMatrices, domain: Radix2Domain, x: int, z: int):
    """All SRS exponents as plain Fr ints, given trapdoors (x, z).

    Returns a dict of scalar vectors matching ProvingKey fields, plus vk
    numbers.  This is the backend-independent part of setup; turning
    scalars into G1 points is the bulk fixed-base work.
    """
    rows, num_columns = sap.size()
    n = domain.n
    m = num_columns
    m0 = sap.num_instance_variables
    bnd_a = 1
    sigma = n + 3

    y = pow(x, sigma, R)
    y_inv = pow(y, R - 2, R)
    y_alpha = pow(y_inv, MINUS_ALPHA, R)          # y^alpha  (alpha = -3)
    y_to_minus_alpha = pow(y, MINUS_ALPHA, R)     # y^3
    y_gamma = pow(y_inv, MINUS_GAMMA, R)          # y^gamma  (gamma = -5)

    # power vectors
    def x_powers(count):
        out = [1] * count
        for j in range(1, count):
            out[j] = out[j - 1] * x % R
        return out

    xp = x_powers(max(n + bnd_a, 2 * (n - 1) + sigma * (MINUS_ALPHA + MINUS_GAMMA) + 1))

    scalars = {}
    scalars["x_powers_g1"] = xp[: n + bnd_a]                      # j = 0..n
    scalars["x_powers_y_alpha_g1"] = [xp[j] * y_alpha % R for j in range(2 * bnd_a + 1)]
    scalars["x_powers_y_gamma_g1"] = [xp[j] * y_gamma % R for j in range(bnd_a + 1)]
    d_max = 2 * (n - 1) + sigma * (MINUS_ALPHA + MINUS_GAMMA)
    ygz = y_gamma * z % R
    scalars["x_powers_y_gamma_z_g1"] = [xp[j] * ygz % R for j in range(d_max + 1)]
    zh_at_x = domain.evaluate_vanishing_polynomial(x)
    zh_ya = zh_at_x * y_to_minus_alpha % R
    scalars["x_powers_zh_by_y_alpha_g1"] = [xp[j] * zh_ya % R for j in range(n - 1)]

    # u_j(x), w_j(x) for witness columns j in [m0, m): via transposed
    # sparse columns and Lagrange coefficients at x  (O(nnz), vs the
    # reference's O(n * m) loops at generator.rs:115-135).
    l_at_x = domain.evaluate_all_lagrange_coefficients(x)
    u_cols = sap.u_columns_transposed()
    w_cols = sap.w_columns_transposed()
    uj_wj = []
    for j in range(m0, m):
        uj_x = 0
        for i, coeff in u_cols.get(j, ()):
            uj_x += coeff * l_at_x[i]
        wj_x = 0
        for i, coeff in w_cols.get(j, ()):
            wj_x += coeff * l_at_x[i]
        uj_wj.append((uj_x % R * y_gamma + wj_x) % R * y_to_minus_alpha % R)
    scalars["uj_wj_lcs_by_y_alpha_g1"] = uj_wj

    meta = dict(n=n, m0=m0, sigma=sigma, omega=domain.omega, m=m)
    return scalars, meta


def generate_proving_key(circuit, rng, scalar_mul_backend=None) -> ProvingKey:
    """Full setup (generator.rs:24-167).

    ``scalar_mul_backend``: optional callable ``(scalar_vectors: dict) ->
    dict of affine point lists`` to offload the fixed-base bulk work (the
    TPU path); defaults to the host fixed-base table.
    """
    from ..utils.timers import phase

    with phase("setup::constraint synthesis"):
        cs = synthesize(circuit, ConstraintSystem.SETUP)
        sap = SAPMatrices.from_constraint_system(cs)
    rows, _ = sap.size()
    domain = Radix2Domain(rows)

    x = domain.sample_element_outside_domain(rng)
    z = domain.sample_element_outside_domain(rng)

    with phase("setup::SRS scalar vectors"):
        scalars, meta = compute_srs_scalars(sap, domain, x, z)

    with phase("setup::fixed-base scalar muls"):
        if scalar_mul_backend is None:
            table = FixedBaseTable(bls.G1, bls.G1.gen, c=8)
            vectors = {
                name: [table.mul(s) for s in vec]
                for name, vec in scalars.items()
            }
        else:
            vectors = scalar_mul_backend(scalars)

    g2 = bls.G2
    e = PairingVK(
        one_g1=bls.G1.gen,
        one_g2=g2.gen,
        x_g2=g2.mul(g2.gen, x),
        z_g2=g2.mul(g2.gen, z),
    )
    vk = VerifyingKey(e=e, n=meta["n"], m0=meta["m0"], sigma=meta["sigma"],
                      omega=meta["omega"])
    return ProvingKey(
        vk=vk,
        sap_matrices=sap,
        x_powers_g1=vectors["x_powers_g1"],
        x_powers_y_alpha_g1=vectors["x_powers_y_alpha_g1"],
        x_powers_zh_by_y_alpha_g1=vectors["x_powers_zh_by_y_alpha_g1"],
        x_powers_y_gamma_g1=vectors["x_powers_y_gamma_g1"],
        x_powers_y_gamma_z_g1=vectors["x_powers_y_gamma_z_g1"],
        uj_wj_lcs_by_y_alpha_g1=vectors["uj_wj_lcs_by_y_alpha_g1"],
    )
