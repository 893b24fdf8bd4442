# Frozen copy of the program's polymath_tpu_torch/hostmath/curve.py (the benchmark's reference
# imports nothing of the program).
"""Host-side short-Weierstrass curve groups (a = 0), affine + Jacobian.

Replaces arkworks ``ark-ec`` group law for host-scale work (SRS assembly,
verifier's tiny MSMs, oracle prover for small circuits).  Bulk G1 arithmetic
runs on the device in the program under test.
"""

from __future__ import annotations


class CurveGroup:
    """Group of points on y^2 = x^3 + b over field ``K``.

    Points are represented as ``(x, y)`` affine tuples of K-elements, or
    ``None`` for the identity.  Jacobian tuples ``(X, Y, Z)`` are used
    internally for inversion-free chains.
    """

    def __init__(self, K, b, generator_affine, scalar_order: int, cofactor: int, name: str):
        self.K = K
        self.b = b
        self.gen = generator_affine
        self.order = scalar_order
        self.cofactor = cofactor
        self.name = name

    # -- predicates -------------------------------------------------------
    def is_on_curve(self, pt) -> bool:
        if pt is None:
            return True
        x, y = pt
        return y * y == x * x * x + self.b

    def in_subgroup(self, pt) -> bool:
        return self.mul(pt, self.order) is None

    # -- affine group law -------------------------------------------------
    def neg(self, pt):
        if pt is None:
            return None
        x, y = pt
        return (x, -y)

    def add(self, p, q):
        if p is None:
            return q
        if q is None:
            return p
        x1, y1 = p
        x2, y2 = q
        if x1 == x2:
            if y1 == y2:
                if y1.is_zero():
                    return None
                return self.double(p)
            return None
        lam = (y2 - y1) / (x2 - x1)
        x3 = lam * lam - x1 - x2
        y3 = lam * (x1 - x3) - y1
        return (x3, y3)

    def double(self, p):
        if p is None:
            return None
        x, y = p
        if y.is_zero():
            return None
        three = self.K.one() + self.K.one() + self.K.one()
        lam = three * x * x / (y + y)
        x3 = lam * lam - x - x
        y3 = lam * (x - x3) - y
        return (x3, y3)

    # -- Jacobian (X/Z^2, Y/Z^3); identity is Z == 0 ----------------------
    def to_jacobian(self, pt):
        if pt is None:
            return (self.K.one(), self.K.one(), self.K.zero())
        return (pt[0], pt[1], self.K.one())

    def from_jacobian(self, pt):
        X, Y, Z = pt
        if Z.is_zero():
            return None
        zinv = Z.inv()
        z2 = zinv * zinv
        return (X * z2, Y * z2 * zinv)

    def jac_double(self, p):
        X1, Y1, Z1 = p
        if Z1.is_zero():
            return p
        A = X1 * X1
        B = Y1 * Y1
        C = B * B
        t = X1 + B
        D = (t * t - A - C)
        D = D + D
        E = A + A + A
        F = E * E
        X3 = F - D - D
        eight_c = C + C
        eight_c = eight_c + eight_c
        eight_c = eight_c + eight_c
        Y3 = E * (D - X3) - eight_c
        Z3 = (Y1 + Y1) * Z1
        return (X3, Y3, Z3)

    def jac_add(self, p, q):
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        if Z1.is_zero():
            return q
        if Z2.is_zero():
            return p
        Z1Z1 = Z1 * Z1
        Z2Z2 = Z2 * Z2
        U1 = X1 * Z2Z2
        U2 = X2 * Z1Z1
        S1 = Y1 * Z2 * Z2Z2
        S2 = Y2 * Z1 * Z1Z1
        if U1 == U2:
            if S1 == S2:
                return self.jac_double(p)
            return (self.K.one(), self.K.one(), self.K.zero())
        H = U2 - U1
        I = H + H
        I = I * I
        J = H * I
        r = S2 - S1
        r = r + r
        V = U1 * I
        X3 = r * r - J - V - V
        Y3 = r * (V - X3) - (S1 + S1) * J
        Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) * H
        return (X3, Y3, Z3)

    # -- scalar ops -------------------------------------------------------
    def mul(self, pt, k: int):
        """Scalar multiplication (double-and-add over Jacobian)."""
        if pt is None or k == 0:
            return None
        if k < 0:
            return self.neg(self.mul(pt, -k))
        acc = (self.K.one(), self.K.one(), self.K.zero())
        base = self.to_jacobian(pt)
        while k:
            if k & 1:
                acc = self.jac_add(acc, base)
            base = self.jac_double(base)
            k >>= 1
        return self.from_jacobian(acc)

    def msm(self, points, scalars):
        """Variable-base MSM (host scale; Pippenger with 8-bit windows).

        Mirrors ``VariableBaseMSM::msm_unchecked`` (reference prover.rs:379-384)
        for host-side use: the verifier's 2-3 term MSMs and the small-circuit
        oracle prover.
        """
        assert len(scalars) <= len(points)
        n = len(scalars)
        if n == 0:
            return None
        if n < 16:
            acc = None
            for p, s in zip(points, scalars):
                acc = self.add(acc, self.mul(p, s))
            return acc
        c = 8
        nbits = max(s.bit_length() for s in scalars) if scalars else 1
        nwin = (max(nbits, 1) + c - 1) // c
        zero_j = (self.K.one(), self.K.one(), self.K.zero())
        window_sums = []
        jac_pts = [self.to_jacobian(p) for p in points[:n]]
        for w in range(nwin):
            buckets = [None] * ((1 << c) - 1)
            shift = w * c
            for i in range(n):
                d = (scalars[i] >> shift) & ((1 << c) - 1)
                if d:
                    b = buckets[d - 1]
                    buckets[d - 1] = jac_pts[i] if b is None else self.jac_add(b, jac_pts[i])
            # running-sum trick: sum_d d * bucket_d
            run = zero_j
            tot = zero_j
            for d in range(len(buckets) - 1, -1, -1):
                if buckets[d] is not None:
                    run = self.jac_add(run, buckets[d])
                tot = self.jac_add(tot, run)
            window_sums.append(tot)
        acc = zero_j
        for w in range(nwin - 1, -1, -1):
            for _ in range(c):
                acc = self.jac_double(acc)
            acc = self.jac_add(acc, window_sums[w])
        return self.from_jacobian(acc)

    def rand(self, rng):
        return self.mul(self.gen, rng.randrange(1, self.order))
