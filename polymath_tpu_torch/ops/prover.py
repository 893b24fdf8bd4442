"""Prover pipeline on the card (counterpart of prover_jax.py).

Same protocol skeleton as protocol/prover.py (reference prover.rs:66-237)
with all bulk math on the card: sparse SAP matvecs, NTTs, the size-2n
squaring, the ~10n-coefficient quotient scan, and all large MSMs.  The
host keeps witness synthesis, the two Fiat-Shamir rounds and the
O(1)/O(m0) algebra.  Every vector is (8, N) Montgomery Fr words.

``prove`` is the pipeline; the transforms, the MSMs and the blinding draw
come from an ops object: ``LocalOps`` here (one device), or
parallel/prover_sharded.py's ``ShardedOps`` (a process group), which is
the whole difference between the two provers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..hostmath import bls12_381 as bls
from ..hostmath.bls12_381 import R
from ..frontend.r1cs import synthesize, ConstraintSystem
from ..protocol import common
from ..protocol.common import MINUS_ALPHA, MINUS_GAMMA
from ..protocol.data_structures import Proof
from ..protocol.poly_host import Radix2Domain
from ..utils.timers import phase, sync
from .cuda_field import fr_mul, fr_sqr
from .field import fr_add, fr_const, fr_neg, fr_sub, fr_to_mont, fr_zeros
from .limbs import FR_SPEC, words_to_ints
from .msm import msm_device
from .ntt import ntt, poly_eval_device
from .poly import synthetic_divide_device
from .sparse import CooMatrix, coo_matvec


def fr_ints_to_mont_device(values, device) -> torch.Tensor:
    """list of canonical ints -> (8, N) Montgomery words on ``device``
    (the canonical words travel, ``to_mont`` runs there)."""
    n = len(values)
    buf = b"".join((int(v) % R).to_bytes(32, "little") for v in values)
    u32 = np.frombuffer(buf, dtype="<u4").reshape(n, FR_SPEC.W)
    words = torch.from_numpy(np.array(u32.T, order="C").view(np.int32))
    return fr_to_mont(words.to(device))


def mont_to_int(t: torch.Tensor) -> int:
    return FR_SPEC.from_mont_int(words_to_ints(
        t.reshape(FR_SPEC.W, -1)[:, :1].cpu().numpy())[0])


class DeviceArtifacts:
    """Per-proving-key state on one device: COO matrices and SRS rows."""

    def __init__(self, pk, device):
        sap = pk.sap_matrices
        m0, m, n_r = sap.m0_m_n()
        self.m0, self.m, self.n_r = m0, m, n_r
        rows, self.cols = sap.size()
        self.n = Radix2Domain(rows).n
        self.sigma = pk.vk.sigma
        coo = pk.device.get("coo")
        if coo is not None:            # loaded keys (protocol/keys.py)
            self.coo_a, self.coo_b, self.coo_c = coo["a"], coo["b"], coo["c"]
        else:
            self.coo_a = CooMatrix.from_sparse_rows(sap.a, m, device)
            self.coo_b = CooMatrix.from_sparse_rows(sap.b, m, device)
            self.coo_c = CooMatrix.from_sparse_rows(sap.c, m, device)
        srs = pk.device.get("srs")
        if srs is None:
            raise ValueError("the proving key holds no device SRS: make it "
                             "with Polymath.setup or protocol.keys.load_dir")
        self.srs = {name: t.to(device) for name, t in srs.items()}


def get_artifacts(pk, device) -> DeviceArtifacts:
    key = ("artifacts", str(torch.device(device)))
    art = pk.device.get(key)
    if art is None:
        art = DeviceArtifacts(pk, device)
        pk.device[key] = art
    return art


class LocalOps:
    """The single-device transforms, MSM and blinding draw of ``prove``.
    ``scope`` prefixes its phase labels."""

    scope = "prover"

    def __init__(self, device):
        self.device = torch.device(device)

    def coeffs(self, evals: torch.Tensor) -> torch.Tensor:
        """Coefficients of the polynomial with these (8, n) evaluations."""
        return ntt(evals, inverse=True)

    def square(self, u: torch.Tensor) -> torch.Tensor:
        """u^2's 2n coefficients from u's n: the size-2n transform of u
        padded with zeros, squared, and back."""
        n = u.shape[1]
        u_pad = torch.cat([u, fr_zeros(n, self.device)], dim=1)
        return ntt(fr_sqr(ntt(u_pad)), inverse=True)

    def msm(self, bases, scalars, **kw):
        return msm_device(bases, scalars, **kw)

    def blinding(self, rng) -> tuple:
        """r_a's two coefficients."""
        return rng.randrange(R), rng.randrange(R)


def _stage1(art, x_m, z_r, ops):
    """z, u/w coefficient polys, h and the exactness count: everything
    between witness synthesis and the first Fiat-Shamir round."""
    n, m0, n_r = art.n, art.m0, art.n_r
    device = ops.device
    az = coo_matvec(art.coo_a, z_r)
    bz = coo_matvec(art.coo_b, z_r)
    cz = coo_matvec(art.coo_c, z_r)
    amb = fr_sub(az, bz)
    apb = fr_add(az, bz)
    y_n = fr_sqr(amb)

    one = fr_const(1, device)
    x0 = x_m[:, :1]
    # y = [0] || (1-x_j)^2 for j=1..m0 || y_n
    one_minus_x = fr_sub(one, x_m[:, 1:m0])
    y_m0 = fr_mul(one_minus_x, one_minus_x)
    y = torch.cat([fr_zeros(1, device), y_m0, y_n], dim=1)
    z = torch.cat([x_m, x_m, z_r[:, m0:], y], dim=1)        # (8, cols)

    # u_evals blocks (SAP row structure, frontend/sap.py)
    u_b1 = fr_add(x0, x_m)                                  # rows [0, m0)
    u_b2 = torch.cat([fr_zeros(1, device), fr_sub(x0, x_m[:, 1:m0])], dim=1)
    pad = fr_zeros(n - 2 * m0 - 2 * n_r, device)
    u_evals = torch.cat([u_b1, u_b2, apb, amb, pad], dim=1)

    four = fr_const(4, device)
    w_b1 = fr_add(fr_mul(four, x_m), y[:, :m0])
    w_b3 = fr_add(fr_mul(four, cz), y[:, m0:])
    w_evals = torch.cat([w_b1, y[:, :m0], w_b3, y[:, m0:], pad], dim=1)

    u_coeffs = ops.coeffs(u_evals)
    w_coeffs = ops.coeffs(w_evals)

    # u^2 via the 2n transform
    u2 = ops.square(u_coeffs)
    h_num = fr_sub(u2, torch.cat([w_coeffs, fr_zeros(n, device)], dim=1))
    # vanishing-division exactness (prover.rs:107-108): dividing p
    # (deg < 2n) by X^n - 1 gives q = p[n:], r = p[:n] + p[n:]; the
    # protocol requires r == 0
    vanish_rem_nz = int(torch.count_nonzero(
        fr_add(h_num[:, :n], h_num[:, n:])))

    # witness-only u: rows < 2*m0 zeroed (instance columns live there)
    wu_evals = torch.cat([fr_zeros(2 * m0, device), apb, amb, pad], dim=1)
    wu_coeffs = ops.coeffs(wu_evals)
    return dict(z=z, u_coeffs=u_coeffs, w_coeffs=w_coeffs, h_num=h_num,
                wu_coeffs=wu_coeffs, vanish_rem_nz=vanish_rem_nz)


def _stage2(s1, n, sigma, d_len, ra0, ra1, x2_m, eval_sum, device):
    """The D(X) * Y^-gamma numerator, (8, d_len) words."""
    s = sigma
    dnum = fr_zeros(d_len, device)

    def addb(off, coeffs):
        k = coeffs.shape[-1]
        dnum[:, off:off + k] = fr_add(dnum[:, off:off + k], coeffs)

    u = s1["u_coeffs"]
    two = fr_const(2, device)
    z1 = fr_zeros(1, device)
    u_sh = torch.cat([z1, u], dim=1)                         # x * u
    u_lo = torch.cat([u, z1], dim=1)
    two_ra_u = fr_add(fr_mul(fr_mul(two, ra0), u_lo),
                      fr_mul(fr_mul(two, ra1), u_sh))
    ra = torch.cat([ra0, ra1], dim=1)
    ra_sq = torch.cat([fr_mul(ra0, ra0), fr_mul(two, fr_mul(ra0, ra1)),
                       fr_mul(ra1, ra1)], dim=1)

    # A(X) Y^-gamma: u at 5s, r_a at 2s
    addb(5 * s, u)
    addb(2 * s, ra)
    # + x2 * C(X) Y^-gamma
    addb(3 * s, fr_mul(x2_m, s1["wu_coeffs"]))
    addb(8 * s, fr_mul(x2_m, s1["w_coeffs"]))
    # h_num's top coefficient (index 2n-1) is structurally zero; drop it so
    # the block stays inside the d_len buffer
    addb(8 * s, fr_mul(x2_m, s1["h_num"][:, :2 * n - 1]))
    addb(5 * s, fr_mul(x2_m, two_ra_u))
    addb(2 * s, fr_mul(x2_m, ra_sq))
    addb(0, fr_mul(x2_m, ra))
    # - (a_at_x1 + x2 c_at_x1) at 5s
    addb(5 * s, fr_neg(eval_sum))
    return dnum


def create_proof_device(circuit, pk, rng, transcript_cls, device) -> Proof:
    return prove(circuit, pk, rng, transcript_cls, LocalOps(device))


def prove(circuit, pk, rng, transcript_cls, ops) -> Proof:
    """The proof pipeline with ``ops``'s transforms, MSMs and blinding
    draw; its phases are scoped ``<ops.scope>::<phase>``."""
    device, scope = ops.device, ops.scope
    art = get_artifacts(pk, device)
    n, m0, cols, sigma = art.n, art.m0, art.cols, art.sigma

    with phase(f"{scope}::witness synthesis"):
        cs = synthesize(circuit, ConstraintSystem.PROVE)
    instance = cs.instance_assignment
    witness = cs.witness_assignment
    assert len(instance) == m0

    with phase(f"{scope}::h2d assignment"):
        x_m = fr_ints_to_mont_device(instance, device)
        z_r = sync(fr_ints_to_mont_device(instance + witness, device))

    with phase(f"{scope}::stage1 (matvecs+NTTs+h)"):
        s1 = _stage1(art, x_m, z_r, ops)
    # device analogue of prover.rs:107-108 (a kernel or witness bug must
    # surface as a clean error here, not as an invalid proof)
    assert s1["vanish_rem_nz"] == 0, \
        "vanishing division (u^2 - w) / Z_H must be exact"

    # -- blinding + commitments ------------------------------------------
    ra0_i, ra1_i = ops.blinding(rng)

    # x-power SRS bases are distinct by construction -> fast madd mode;
    # uj_wj columns CAN repeat (structurally identical circuit columns,
    # e.g. the bench a/b witnesses): that MSM runs fast optimistically and
    # reruns safe only if the collision flag fired.  All four MSMs are
    # queued on the card before any host combine reads a result.
    xp = art.srs["x_powers_g1"]
    with phase(f"{scope}::msm a+r+c dispatch"):
        u = s1["u_coeffs"]
        p_a = ops.msm(xp, u, mont=True, fast=True, n_eff=n, defer=True)
        z1 = fr_zeros(1, device)
        two_ra_u = fr_add(
            fr_mul(fr_const(2 * ra0_i % R, device), torch.cat([u, z1], 1)),
            fr_mul(fr_const(2 * ra1_i % R, device), torch.cat([z1, u], 1)))
        p_r = ops.msm(xp, two_ra_u, mont=True, fast=True, n_eff=n + 1,
                      defer=True)
        del two_ra_u
        ujwj = art.srs["uj_wj_lcs_by_y_alpha_g1"]
        p_cw = ops.msm(ujwj, s1["z"][:, m0:], mont=True, fast=True,
                       n_eff=cols - m0, defer=True)
        zh = art.srs["x_powers_zh_by_y_alpha_g1"]
        p_ch = ops.msm(zh, s1["h_num"][:, n:2 * n - 1], mont=True,
                       fast=True, n_eff=n - 1, defer=True)

    with phase(f"{scope}::msm a+r+c finalize"):
        a_u = p_a.result()
        # host: tiny r_a MSMs over the 3/2-element SRS vectors
        a_ra = bls.G1.msm(pk.x_powers_y_alpha_g1, [ra0_i, ra1_i])
        a_g1 = bls.G1.add(a_u, a_ra)
        r_big = p_r.result()
        ra_sq = [ra0_i * ra0_i % R, 2 * ra0_i * ra1_i % R,
                 ra1_i * ra1_i % R]
        r_small = bls.G1.add(
            bls.G1.msm(pk.x_powers_y_alpha_g1, ra_sq),
            bls.G1.msm(pk.x_powers_y_gamma_g1, [ra0_i, ra1_i]))
        r_g1 = bls.G1.add(r_big, r_small)
        try:
            c_w = p_cw.result()
        except AssertionError:
            c_w = ops.msm(ujwj, s1["z"][:, m0:], mont=True,
                          n_eff=cols - m0)
        c_h = p_ch.result()
    c_g1 = bls.G1.add(bls.G1.add(c_w, c_h), r_g1)

    # -- Fiat-Shamir round 1 ---------------------------------------------
    t = transcript_cls(common.B_POLYMATH)
    x1 = common.compute_x1(t, instance, [a_g1, c_g1])
    y1 = common.compute_y1(x1, sigma)
    y1_alpha = common.neg_power(y1, MINUS_ALPHA)
    y1_gamma = common.neg_power(y1, MINUS_GAMMA)

    x1_m = fr_const(x1, device)
    u_at_x1 = mont_to_int(poly_eval_device(s1["u_coeffs"], x1_m))
    a_at_x1 = (u_at_x1 + (ra0_i + ra1_i * x1) * y1_alpha) % R
    pi_at_x1 = common.compute_pi_at_x1(pk.vk, instance, x1, y1_gamma)
    c_at_x1 = common.compute_c_at_x1(y1_gamma, y1_alpha, a_at_x1, pi_at_x1)

    # -- Fiat-Shamir round 2 ---------------------------------------------
    x2 = common.compute_x2(t, x1, [a_at_x1, c_at_x1])

    d_len = 2 * (n - 1) + sigma * (MINUS_ALPHA + MINUS_GAMMA) + 1
    with phase(f"{scope}::stage2a (D numerator)"):
        dnum = sync(_stage2(
            s1, n, sigma, d_len, fr_const(ra0_i, device),
            fr_const(ra1_i, device), fr_const(x2, device),
            fr_const((a_at_x1 + x2 * c_at_x1) % R, device), device))
    # stage-1 polynomials are consumed: free them before the divide and
    # the 10n-point d-MSM
    s1.clear()
    with phase(f"{scope}::stage2b (quotient scan)"):
        q_mont, rem = synthetic_divide_device(dnum, x1_m)
        sync(q_mont)
    del dnum
    # prover.rs:221: the quotient division by (X - x1) must be exact
    assert mont_to_int(rem) == 0, \
        "quotient division by (X - x1) must be exact"

    ygz = art.srs["x_powers_y_gamma_z_g1"]
    with phase(f"{scope}::msm d_g1 (~10n)"):
        d_g1 = ops.msm(ygz, q_mont, mont=True, fast=True,
                       n_eff=d_len - 1)

    return Proof(a_g1=a_g1, c_g1=c_g1, a_at_x1=a_at_x1, d_g1=d_g1)
