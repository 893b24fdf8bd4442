"""R1CS -> SAP (square arithmetic program) lazy matrix views.

Reproduces the semantics of the reference ``SAPMatrices`` (common.rs:112-230):
SAP is ``Uz ∘ Uz = Wz`` built from R1CS ``Az ∘ Bz = Cz`` via the identity
``ab = ((a+b)^2 - (a-b)^2) / 4``.  The matrices are never materialized; this
module provides:

  * elementwise ``u(i,j)`` / ``w(i,j)`` (test oracle parity with the Rust);
  * O(nnz) row-structured products ``u_evals(z)`` / ``w_evals(z)`` —
    replacing the reference's O(n·m·nnz) dense materialization
    (prover.rs:87-88, 245-252) with sparse block matvecs;
  * O(nnz) transposed column structure for the generator's per-column
    ``u_j(x), w_j(x)`` sums (generator.rs:111-137);
  * the SAP witness extension ``y`` vector (prover.rs:279-302).

Row/column layout (rows = 2(m0+n), cols = 2*m0 + m + n, m = m0 + m_w):
  rows   [0, m0): (1+x)-selectors;  [m0, 2m0): (1-x)-selectors (row m0 = 0);
         [2m0, 2m0+n): A+B / 4C;    [2m0+n, 2m0+2n): A-B / y-selectors.
  cols   [0, m0): instance x;  [m0, 2m0): second x copy;  [2m0, m0+m): w;
         [m0+m, ...): y.
"""

from __future__ import annotations

from ..hostmath.bls12_381 import R


def sparse_matvec(rows, z, modulus=R):
    """rows: list of [(coeff, col)]; returns [sum_j coeff*z_col mod r]."""
    out = []
    for row in rows:
        acc = 0
        for coeff, col in row:
            acc += coeff * z[col]
        out.append(acc % modulus)
    return out


def m_at(rows, i, j):
    """Sparse element lookup (reference common.rs:100-105)."""
    for coeff, col in rows[i]:
        if col == j:
            return coeff
    return 0


class SAPMatrices:
    """Holds R1CS sparse matrices + dimensions; exposes SAP views."""

    def __init__(self, num_instance_variables, num_r1cs_witness_variables,
                 num_r1cs_constraints, a, b, c):
        self.num_instance_variables = num_instance_variables
        self.num_r1cs_witness_variables = num_r1cs_witness_variables
        self.num_r1cs_constraints = num_r1cs_constraints
        self.a = a
        self.b = b
        self.c = c

    @classmethod
    def from_constraint_system(cls, cs):
        a, b, c = cs.to_matrices()
        return cls(cs.num_instance_variables, cs.num_witness_variables,
                   cs.num_constraints, a, b, c)

    # -- dimensions -------------------------------------------------------
    def m0_m_n(self):
        m0 = self.num_instance_variables
        m = m0 + self.num_r1cs_witness_variables
        n = self.num_r1cs_constraints
        return m0, m, n

    def size(self):
        """(rows, cols) of the SAP matrices (common.rs:131-135)."""
        m0, m, n = self.m0_m_n()
        return (m0 + n) * 2, m0 * 2 + m + n

    # -- elementwise oracle (parity with common.rs:138-207) ---------------
    def u(self, i, j):
        m0, m, n = self.m0_m_n()
        dm0, dm0n, dm0dn, m0m = 2 * m0, 2 * m0 + n, 2 * m0 + 2 * n, m0 + m
        if i == 0 and j == 0:
            return 2
        if i < m0 and j == 0:
            return 1
        if i < m0 and j == i:
            return 1
        if i < m0:
            return 0
        if i == m0 and j == 0:
            return 0
        if i < dm0 and j == 0:
            return 1
        if i < dm0 and j == i - m0:
            return R - 1
        if i < dm0:
            return 0
        if j < m0:
            return 0
        if i < dm0n and j < m0m:
            return (m_at(self.a, i - dm0, j - m0) + m_at(self.b, i - dm0, j - m0)) % R
        if i < dm0dn and j < m0m:
            return (m_at(self.a, i - dm0n, j - m0) - m_at(self.b, i - dm0n, j - m0)) % R
        return 0

    def w(self, i, j):
        m0, m, n = self.m0_m_n()
        dm0, dm0n, dm0dn, m0m = 2 * m0, 2 * m0 + n, 2 * m0 + 2 * n, m0 + m
        if i < m0 and j == i + m0:
            return 4
        if i < m0 and j == i + m0m:
            return 1
        if i < m0:
            return 0
        if i < dm0 and j == i + m:
            return 1
        if i < dm0:
            return 0
        if j < m0:
            return 0
        if i < dm0n and j < m0m:
            return 4 * m_at(self.c, i - dm0, j - m0) % R
        if i < dm0n and j == i + m:
            return 1
        if i < dm0n:
            return 0
        if i < dm0dn and j == i - n + m:
            return 1
        return 0

    # -- SAP witness extension (prover.rs:279-302) ------------------------
    def y_vec(self, x, w):
        """y = [0] || [(1-x_j)^2, j=1..m0) || [((A-B) z_r)_i^2, i=0..n)."""
        m0, m, n = self.m0_m_n()
        z_r = list(x) + list(w)
        assert len(z_r) == m
        y = [0]
        for j in range(1, m0):
            v = (1 - x[j]) % R
            y.append(v * v % R)
        az = sparse_matvec(self.a, z_r)
        bz = sparse_matvec(self.b, z_r)
        for i in range(n):
            v = (az[i] - bz[i]) % R
            y.append(v * v % R)
        return y

    def z_vector(self, x, w):
        """Full SAP assignment z = [x || x || w || y] (prover.rs:75-80)."""
        return list(x) + list(x) + list(w) + self.y_vec(x, w)

    # -- O(nnz) row products ---------------------------------------------
    def u_evals(self, z, domain_n):
        """(U z) padded with zeros to domain_n."""
        m0, m, n = self.m0_m_n()
        x = z[:m0]
        z_r = z[m0:m0 + m]  # second x copy + witness = r1cs assignment
        az = sparse_matvec(self.a, z_r)
        bz = sparse_matvec(self.b, z_r)
        out = []
        for i in range(m0):
            out.append((x[0] + x[i]) % R)
        for i in range(m0):
            out.append(0 if i == 0 else (x[0] - x[i]) % R)
        for i in range(n):
            out.append((az[i] + bz[i]) % R)
        for i in range(n):
            out.append((az[i] - bz[i]) % R)
        out.extend([0] * (domain_n - len(out)))
        return out

    def w_evals(self, z, domain_n):
        m0, m, n = self.m0_m_n()
        x = z[:m0]
        z_r = z[m0:m0 + m]
        y = z[m0 + m:]
        cz = sparse_matvec(self.c, z_r)
        out = []
        for i in range(m0):
            out.append((4 * x[i] + y[i]) % R)
        for i in range(m0):
            out.append(y[i])
        for i in range(n):
            out.append((4 * cz[i] + y[m0 + i]) % R)
        for i in range(n):
            out.append(y[m0 + i])
        out.extend([0] * (domain_n - len(out)))
        return out

    def witness_u_evals(self, z, domain_n):
        """(U z) restricted to SAP columns >= m0 (prover.rs:156-160):
        identical to u_evals with the first 2*m0 rows zeroed (instance
        columns only touch those rows)."""
        full = self.u_evals(z, domain_n)
        m0, _, _ = self.m0_m_n()
        for i in range(2 * m0):
            full[i] = 0
        return full

    def witness_w_evals(self, z, domain_n):
        """W has no entries in columns < m0, so this equals w_evals."""
        return self.w_evals(z, domain_n)

    # -- transposed column structure (generator) --------------------------
    def u_columns_transposed(self):
        """dict col -> list of (row, coeff) for SAP witness columns
        (j >= m0), built in O(nnz)."""
        m0, m, n = self.m0_m_n()
        cols: dict[int, list] = {}

        def put(j, i, coeff):
            coeff %= R
            if coeff:
                cols.setdefault(j, []).append((i, coeff))

        # block rows [2m0, 2m0+n): A+B on cols m0+jr; [2m0+n, ...): A-B
        for i in range(n):
            row_ab = {}
            for coeff, jr in self.a[i]:
                row_ab[jr] = row_ab.get(jr, 0) + coeff
            row_amb = dict(row_ab)
            for coeff, jr in self.b[i]:
                row_ab[jr] = row_ab.get(jr, 0) + coeff
                row_amb[jr] = row_amb.get(jr, 0) - coeff
            for jr, coeff in row_ab.items():
                put(m0 + jr, 2 * m0 + i, coeff)
            for jr, coeff in row_amb.items():
                put(m0 + jr, 2 * m0 + n + i, coeff)
        return cols

    def w_columns_transposed(self):
        m0, m, n = self.m0_m_n()
        cols: dict[int, list] = {}

        def put(j, i, coeff):
            coeff %= R
            if coeff:
                cols.setdefault(j, []).append((i, coeff))

        # selector 4's: rows i<m0 at col i+m0 (cols m0..2m0 are >= m0)
        for i in range(m0):
            put(i + m0, i, 4)
        # 4*C block: rows 2m0+i at cols m0+jr
        for i in range(n):
            for coeff, jr in self.c[i]:
                put(m0 + jr, 2 * m0 + i, 4 * coeff)
        # y columns: j = m0 + m + iy
        for iy in range(m0 + n):
            j = m0 + m + iy
            if iy < m0:
                put(j, iy, 1)          # rows i<m0, col i+m0+m
                put(j, m0 + iy, 1)     # rows [m0,2m0), col i+m
            else:
                put(j, m0 + iy, 1)         # rows [2m0, 2m0+n), col i+m
                put(j, m0 + n + iy, 1)     # rows [2m0+n, ...), col i-n+m
        return cols
