"""Host-side radix-2 evaluation domain + polynomial helpers over Fr ints.

Mirrors arkworks ``Radix2EvaluationDomain`` semantics (SURVEY.md §2.2):
natural-order DFT ``evals[i] = sum_j coeffs[j] w^(ij)``, iFFT with 1/n
scaling, vanishing polynomial ``X^n - 1``, Lagrange coefficients, and
element sampling outside the domain.  Used by the protocol oracle and for
small n; bulk NTTs run on-device (ops/ntt.py).
"""

from __future__ import annotations

from ..hostmath.bls12_381 import R, FR_TWO_ADICITY, FR_TWO_ADIC_ROOT


class Radix2Domain:
    def __init__(self, min_size: int):
        n = 1
        log_n = 0
        while n < min_size:
            n <<= 1
            log_n += 1
        if log_n > FR_TWO_ADICITY:
            raise ValueError("domain too large for Fr two-adicity")
        self.n = n
        self.log_n = log_n
        self.omega = pow(FR_TWO_ADIC_ROOT, 1 << (FR_TWO_ADICITY - log_n), R)
        self.omega_inv = pow(self.omega, R - 2, R)
        self.n_inv = pow(n, R - 2, R)

    # -- FFT --------------------------------------------------------------
    def _ntt(self, values, omega):
        n = self.n
        a = list(values) + [0] * (n - len(values))
        # bit-reversal
        j = 0
        for i in range(1, n):
            bit = n >> 1
            while j & bit:
                j ^= bit
                bit >>= 1
            j |= bit
            if i < j:
                a[i], a[j] = a[j], a[i]
        length = 2
        while length <= n:
            w_len = pow(omega, n // length, R)
            for start in range(0, n, length):
                w = 1
                half = length // 2
                for k in range(start, start + half):
                    u, v = a[k], a[k + half] * w % R
                    a[k] = (u + v) % R
                    a[k + half] = (u - v) % R
                    w = w * w_len % R
            length <<= 1
        return a

    def fft(self, coeffs):
        """coeffs -> evaluations on [w^0, w^1, ...]."""
        return self._ntt(coeffs, self.omega)

    def ifft(self, evals):
        out = self._ntt(evals, self.omega_inv)
        return [v * self.n_inv % R for v in out]

    # -- domain utilities -------------------------------------------------
    def evaluate_vanishing_polynomial(self, x: int) -> int:
        return (pow(x, self.n, R) - 1) % R

    def sample_element_outside_domain(self, rng) -> int:
        while True:
            t = rng.randrange(R)
            if self.evaluate_vanishing_polynomial(t) != 0:
                return t

    def evaluate_all_lagrange_coefficients(self, x: int) -> list[int]:
        """L_i(x) = w^i * (x^n - 1) / (n * (x - w^i))."""
        n = self.n
        zh = self.evaluate_vanishing_polynomial(x)
        if zh == 0:
            # x in domain: indicator vector
            out = [0] * n
            cur = 1
            for i in range(n):
                if cur == x:
                    out[i] = 1
                cur = cur * self.omega % R
            return out
        # batch-invert (x - w^i)
        diffs = []
        cur = 1
        for i in range(n):
            diffs.append((x - cur) % R)
            cur = cur * self.omega % R
        invs = batch_inverse(diffs)
        c = zh * self.n_inv % R
        out = []
        cur = 1
        for i in range(n):
            out.append(c * cur % R * invs[i] % R)
            cur = cur * self.omega % R
        return out


def batch_inverse(values):
    """Montgomery batch inversion of ints mod R.  A zero is left out of
    the product and keeps 0, as its Fermat power does."""
    n = len(values)
    prefix = [1] * (n + 1)
    for i, v in enumerate(values):
        prefix[i + 1] = prefix[i] * v % R if v else prefix[i]
    inv_all = pow(prefix[n], R - 2, R)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        if values[i]:
            out[i] = prefix[i] * inv_all % R
            inv_all = inv_all * values[i] % R
    return out


# -- dense polynomial helpers (coefficient lists, ints mod R) ---------------

def poly_eval(coeffs, x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % R
    return acc


def poly_add(a, b):
    n = max(len(a), len(b))
    return [((a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0)) % R
            for i in range(n)]


def poly_scale(a, k):
    return [c * k % R for c in a]


def poly_mul(a, b):
    if not a or not b:
        return []
    out = [0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        if ai:
            for j, bj in enumerate(b):
                out[i + j] = (out[i + j] + ai * bj) % R
    return out


def poly_trim(a):
    while a and a[-1] == 0:
        a.pop()
    return a


def divide_by_vanishing(coeffs, n: int):
    """Divide by X^n - 1: returns (quotient, remainder).

    q_i = a_{i+n} + a_{i+2n} + ...; r_i = a_i + q_i  (i < n).
    """
    a = list(coeffs)
    if len(a) <= n:
        return [], a
    q = [0] * (len(a) - n)
    for i in range(len(a) - n - 1, -1, -1):
        q[i] = (a[i + n] + (q[i + n] if i + n < len(q) else 0)) % R
    r = [(a[i] + (q[i] if i < len(q) else 0)) % R for i in range(n)]
    return poly_trim(q), poly_trim(r)


def synthetic_divide(coeffs, x1: int):
    """Divide by (X - x1): returns (quotient, remainder scalar)."""
    a = list(coeffs)
    if not a:
        return [], 0
    q = [0] * (len(a) - 1)
    acc = a[-1]
    for i in range(len(a) - 2, -1, -1):
        q[i] = acc
        acc = (a[i] + acc * x1) % R
    return q, acc
