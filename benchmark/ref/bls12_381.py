# Frozen copy of the program's polymath_tpu_torch/hostmath/bls12_381.py (the benchmark's reference
# imports nothing of the program).
"""BLS12-381 curve constants, groups, and the pairing (host side).

The reference obtains all of this from ``ark-bls12-381`` / ``ark-ec``
(SURVEY.md §2.2); the verifier's 2-pair product (reference verifier.rs:50-61)
maps onto :func:`multi_pairing` here.  The pairing is O(1) per proof and stays
host-side by design.
"""

from __future__ import annotations

from .field import prime_field, two_adicity
from .tower import quadratic_extension, cubic_extension
from .curve import CurveGroup

# ---------------------------------------------------------------------------
# Moduli and curve parameters.
# ---------------------------------------------------------------------------

#: Base-field modulus q (381 bits).
Q = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

#: Scalar-field modulus r (255 bits).
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

#: BLS parameter x (negative): q, r are polynomials in x.
BLS_X = -0xD201000000010000

#: G1 cofactor and G2 cofactor.
G1_COFACTOR = 0x396C8C005555E1568C00AAAB0000AAAB
G2_COFACTOR = 0x5D543A95414E7F1091D50792876A202CD91DE4547085ABAA68A205B2E5A7DDFA628F1CB4D9E82EF21537E293A6691AE1616EC6E786F0C70CF1C38E31C7238E5

Fq = prime_field(Q, "Fq", generator=2)
Fr = prime_field(R, "Fr", generator=7)

#: Two-adicity of r - 1 (arkworks: 32) and canonical 2^s-th root of unity,
#: derived exactly as arkworks does: GENERATOR^((r-1) / 2^s).
FR_TWO_ADICITY = two_adicity(R)
assert FR_TWO_ADICITY == 32
FR_TWO_ADIC_ROOT = pow(7, (R - 1) >> FR_TWO_ADICITY, R)

# ---------------------------------------------------------------------------
# Extension tower: Fq2 = Fq[u]/(u^2+1); Fq6 = Fq2[v]/(v^3-(u+1));
# Fq12 = Fq6[w]/(w^2-v).   (arkworks ark-bls12-381 tower.)
# ---------------------------------------------------------------------------

Fq2 = quadratic_extension(Fq, Fq(Q - 1), "Fq2")  # u^2 = -1
XI = Fq2(Fq(1), Fq(1))  # u + 1, the Fq6 nonresidue
Fq6 = cubic_extension(Fq2, XI, "Fq6")
Fq12 = quadratic_extension(Fq6, Fq6(Fq2.zero(), Fq2.one(), Fq2.zero()), "Fq12")  # w^2 = v

# ---------------------------------------------------------------------------
# Group generators (standard BLS12-381 generators, as in ark-bls12-381).
# ---------------------------------------------------------------------------

G1_GEN_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_GEN_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1

G2_GEN_X_C0 = 0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8
G2_GEN_X_C1 = 0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E
G2_GEN_Y_C0 = 0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801
G2_GEN_Y_C1 = 0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE

G1 = CurveGroup(
    Fq,
    Fq(4),
    (Fq(G1_GEN_X), Fq(G1_GEN_Y)),
    R,
    G1_COFACTOR,
    "G1",
)

G2 = CurveGroup(
    Fq2,
    XI.mul_base(Fq(4)),  # b' = 4(u+1), M-type twist
    (
        Fq2(Fq(G2_GEN_X_C0), Fq(G2_GEN_X_C1)),
        Fq2(Fq(G2_GEN_Y_C0), Fq(G2_GEN_Y_C1)),
    ),
    R,
    G2_COFACTOR,
    "G2",
)

# ---------------------------------------------------------------------------
# Pairing: ate pairing via Miller loop over E(Fq12) + final exponentiation.
# ---------------------------------------------------------------------------

# Untwist: map (x', y') on E'(Fq2) to E(Fq12).  With the M-type twist
# (E': y^2 = x^3 + 4*xi), the embedding is  (x, y) -> (x * w^2 / xi^? ...).
# We use the direct computation: w^2 = v, w^3 = v*w; for the M twist used by
# BLS12-381, psi(x', y') = (x' * w^2, y' * w^3) lands on  y^2 = x^3 + 4*xi*v^3/w^6...
# Rather than rely on memorized twist identities, we solve it programmatically
# below and assert the image is on E(Fq12): y^2 = x^3 + 4.


def _fq2_to_fq12(a) -> "Fq12":
    return Fq12(Fq6(a, Fq2.zero(), Fq2.zero()), Fq6.zero())


_W = Fq12(Fq6.zero(), Fq6.one())          # w
_W2 = _W * _W                              # w^2 = v
_W3 = _W2 * _W                             # v*w
_B_FQ12 = _fq2_to_fq12(Fq2(Fq(4), Fq.zero()))


def _untwist(pt):
    """Map an affine E'(Fq2) point into affine E(Fq12)."""
    if pt is None:
        return None
    x, y = pt
    # Try the two sextic-twist embeddings; exactly one lands on E: y^2=x^3+4.
    for xm, ym in (
        (_W2, _W3),                       # divide-style (D): x/w^2, y/w^3
        (_W2.inv(), _W3.inv()),           # multiply-style (M): x*w^2, y*w^3
    ):
        X = _fq2_to_fq12(x) * xm.inv()
        Y = _fq2_to_fq12(y) * ym.inv()
        if Y * Y == X * X * X + _B_FQ12:
            return (X, Y)
    raise AssertionError("untwist failed: point not on either sextic twist image")


def _line_eval(T, Qp, P):
    """Line through T and Qp (or tangent at T if equal), evaluated at P.

    All points affine over Fq12; P is the (embedded) G1 point.
    Returns (value, T+Qp).
    """
    xT, yT = T
    xQ, yQ = Qp
    xP, yP = P
    if T == Qp:
        three = Fq12.one() + Fq12.one() + Fq12.one()
        lam = three * xT * xT * (yT + yT).inv()
    elif xT == xQ:
        # vertical line x - xT
        return (xP - xT), None
    else:
        lam = (yQ - yT) * (xQ - xT).inv()
    value = yP - yT - lam * (xP - xT)
    x3 = lam * lam - xT - xQ
    y3 = lam * (xT - x3) - yT
    return value, (x3, y3)


def miller_loop(p1, p2) -> "Fq12":
    """Miller loop f_{|x|, Q}(P) with the standard BLS12 conjugation for x<0.

    ``p1`` is an affine G1 point (over Fq), ``p2`` an affine G2 point (over
    Fq2).  Returns an Fq12 element (pre final-exponentiation).
    """
    if p1 is None or p2 is None:
        return Fq12.one()
    P = (_fq2_to_fq12(Fq2(p1[0], Fq.zero())), _fq2_to_fq12(Fq2(p1[1], Fq.zero())))
    Qp = _untwist(p2)
    x = -BLS_X
    f = Fq12.one()
    T = Qp
    for bit in bin(x)[3:]:  # from second-highest bit down
        val, T = _line_eval(T, T, P)
        f = f * f * val
        if T is None:
            T = (Fq12.zero(), Fq12.zero())  # unreachable for valid inputs
        if bit == "1":
            val, T = _line_eval(T, Qp, P)
            f = f * val
    # x < 0: conjugate (equivalent to inversion after final exponentiation).
    return Fq12(f.c0, -f.c1)


# -- Frobenius helpers for the final exponentiation -------------------------

def _frobenius_fq2(a):
    return a.conjugate()


_XI_Q_THIRD = XI.pow((Q - 1) // 3)
_XI_Q_2THIRD = XI.pow(2 * (Q - 1) // 3)
_XI_Q_SIXTH = XI.pow((Q - 1) // 6)


def _frobenius_fq6(a):
    return Fq6(
        _frobenius_fq2(a.c0),
        _frobenius_fq2(a.c1) * _XI_Q_THIRD,
        _frobenius_fq2(a.c2) * _XI_Q_2THIRD,
    )


def _frobenius_fq12(a):
    c0 = _frobenius_fq6(a.c0)
    c1 = _frobenius_fq6(a.c1)
    # w^q = w * xi^((q-1)/6); multiply c1 coefficients by gamma in Fq2.
    c1 = Fq6(c1.c0 * _XI_Q_SIXTH, c1.c1 * _XI_Q_SIXTH, c1.c2 * _XI_Q_SIXTH)
    return Fq12(c0, c1)


def final_exponentiation(f: "Fq12") -> "Fq12":
    """f^((q^12 - 1) / r)  via easy part + generic hard part."""
    # Easy part: f^(q^6 - 1) then ^(q^2 + 1).
    f1 = Fq12(f.c0, -f.c1)  # f^(q^6) (conjugation)
    f = f1 * f.inv()
    f = _frobenius_fq12(_frobenius_fq12(f)) * f
    # Hard part: ^( (q^4 - q^2 + 1) / r ), plain square-and-multiply.
    e = (Q ** 4 - Q ** 2 + 1) // R
    return f.pow(e)


def pairing(p1, p2) -> "Fq12":
    return final_exponentiation(miller_loop(p1, p2))


def multi_pairing(g1_points, g2_points) -> "Fq12":
    """Product of pairings with a single shared final exponentiation
    (reference verifier.rs:50-61 ``E::multi_pairing``)."""
    f = Fq12.one()
    for p1, p2 in zip(g1_points, g2_points):
        f = f * miller_loop(p1, p2)
    return final_exponentiation(f)
