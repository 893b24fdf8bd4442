"""Proof / key data structures + arkworks-compatible byte round-trips.

Mirrors reference ``src/data_structures.rs``: Proof{a_g1, c_g1, a_at_x1,
d_g1}; PairingVK{one_g1, one_g2, x_g2, z_g2}; VerifyingKey{e, n, m0, sigma,
omega}; ProvingKey{vk, sap_matrices, 6 G1 power vectors}.  Host-side points
are affine tuples; the proving key's big G1 vectors may also live on device
(see ops/srs.py) — serialization always goes through the host form.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from ..serial import codec
from ..frontend.sap import SAPMatrices


@dataclass
class Proof:
    a_g1: object           # affine G1 (tuple of Fq) or None
    c_g1: object
    a_at_x1: int           # Fr canonical int
    d_g1: object

    def to_bytes(self) -> bytes:
        return (codec.g1_to_bytes(self.a_g1) + codec.g1_to_bytes(self.c_g1)
                + codec.fr_to_bytes(self.a_at_x1) + codec.g1_to_bytes(self.d_g1))

    @classmethod
    def from_bytes(cls, b: bytes) -> "Proof":
        assert len(b) == 176, "Polymath proof is 176 bytes compressed"
        return cls(
            a_g1=codec.g1_from_bytes(b[0:48]),
            c_g1=codec.g1_from_bytes(b[48:96]),
            a_at_x1=codec.fr_from_bytes(b[96:128]),
            d_g1=codec.g1_from_bytes(b[128:176]),
        )


@dataclass
class PairingVK:
    one_g1: object
    one_g2: object
    x_g2: object
    z_g2: object

    def to_bytes(self) -> bytes:
        return (codec.g1_to_bytes(self.one_g1) + codec.g2_to_bytes(self.one_g2)
                + codec.g2_to_bytes(self.x_g2) + codec.g2_to_bytes(self.z_g2))

    @classmethod
    def from_bytes(cls, b: bytes) -> "PairingVK":
        assert len(b) == 48 + 3 * 96
        return cls(
            one_g1=codec.g1_from_bytes(b[0:48]),
            one_g2=codec.g2_from_bytes(b[48:144]),
            x_g2=codec.g2_from_bytes(b[144:240]),
            z_g2=codec.g2_from_bytes(b[240:336]),
        )


@dataclass
class VerifyingKey:
    e: PairingVK
    n: int
    m0: int
    sigma: int
    omega: int  # Fr canonical int

    def to_bytes(self) -> bytes:
        return (self.e.to_bytes() + codec.u64_to_bytes(self.n)
                + codec.u64_to_bytes(self.m0) + codec.u64_to_bytes(self.sigma)
                + codec.fr_to_bytes(self.omega))

    @classmethod
    def from_bytes(cls, b: bytes) -> "VerifyingKey":
        e = PairingVK.from_bytes(b[:336])
        off = 336
        n = int.from_bytes(b[off:off + 8], "little")
        m0 = int.from_bytes(b[off + 8:off + 16], "little")
        sigma = int.from_bytes(b[off + 16:off + 24], "little")
        omega = codec.fr_from_bytes(b[off + 24:off + 56])
        return cls(e=e, n=n, m0=m0, sigma=sigma, omega=omega)


# arkworks derives CanonicalSerialize on SAPMatrices (reference
# common.rs:111-124): three u64 dims then a, b, c as Vec<Vec<(F, u64)>>.

def sap_to_bytes(sap: SAPMatrices) -> bytes:
    def row_to_bytes(row):
        return codec.vec_to_bytes(
            row, lambda t: codec.fr_to_bytes(t[0]) + codec.u64_to_bytes(t[1]))

    out = bytearray()
    out += codec.u64_to_bytes(sap.num_instance_variables)
    out += codec.u64_to_bytes(sap.num_r1cs_witness_variables)
    out += codec.u64_to_bytes(sap.num_r1cs_constraints)
    for mat in (sap.a, sap.b, sap.c):
        out += codec.vec_to_bytes(mat, row_to_bytes)
    return bytes(out)


def sap_from_reader(r: "codec.Reader") -> SAPMatrices:
    m0 = r.u64()
    m_w = r.u64()
    n_r = r.u64()

    def term():
        coeff = r.fr()
        col = r.u64()
        return (coeff, col)

    mats = [r.vec(lambda: r.vec(term)) for _ in range(3)]
    return SAPMatrices(m0, m_w, n_r, *mats)


_PK_VECTORS = (
    "x_powers_g1", "x_powers_y_alpha_g1", "x_powers_zh_by_y_alpha_g1",
    "x_powers_y_gamma_g1", "x_powers_y_gamma_z_g1", "uj_wj_lcs_by_y_alpha_g1",
)

# big vectors kept as packed device arrays; small ones decode to host points
_PK_BIG = ("x_powers_g1", "x_powers_zh_by_y_alpha_g1",
           "x_powers_y_gamma_z_g1", "uj_wj_lcs_by_y_alpha_g1")
_PK_SMALL = ("x_powers_y_alpha_g1", "x_powers_y_gamma_g1")


class SAPDims:
    """Dimension-only stand-in for SAPMatrices (ProvingKey.load_dir).

    The device prover only reads dimensions from pk.sap_matrices (the
    sparse content is consumed via the pre-planned COO arrays); this
    avoids re-parsing ~nnz terms of sap bytes on every process start.
    """

    def __init__(self, m0: int, m_w: int, n_r: int):
        self.num_instance_variables = m0
        self.num_r1cs_witness_variables = m_w
        self.num_r1cs_constraints = n_r
        self.a = self.b = self.c = None

    def m0_m_n(self):
        m0 = self.num_instance_variables
        return m0, m0 + self.num_r1cs_witness_variables, \
            self.num_r1cs_constraints

    def size(self):
        m0, m, n = self.m0_m_n()
        return (m0 + n) * 2, m0 * 2 + m + n


@dataclass
class ProvingKey:
    vk: VerifyingKey
    sap_matrices: SAPMatrices
    # G1 SRS vectors; host form: lists of affine points.  When the device
    # backend is active these also carry packed device arrays (set lazily by
    # ops/srs.py) — the `device` attribute caches them.
    x_powers_g1: list
    x_powers_y_alpha_g1: list
    x_powers_zh_by_y_alpha_g1: list
    x_powers_y_gamma_g1: list
    x_powers_y_gamma_z_g1: list
    uj_wj_lcs_by_y_alpha_g1: list
    device: dict = field(default_factory=dict, repr=False, compare=False)

    def to_bytes(self) -> bytes:
        """arkworks-compatible compressed bytes (field order matches the
        CanonicalSerialize derive, reference data_structures.rs:56-73)."""
        out = bytearray(self.vk.to_bytes())
        out += sap_to_bytes(self.sap_matrices)
        for name in _PK_VECTORS:
            out += codec.g1_vec_to_bytes(getattr(self, name))
        return bytes(out)

    @classmethod
    def from_bytes(cls, b: bytes, validate: bool = False) -> "ProvingKey":
        """Inverse of to_bytes.  `validate` runs the (slow) subgroup check
        per point; the default trusts locally-produced keys, matching
        arkworks' `deserialize_*_unchecked` fast path."""
        vk_len = 336 + 24 + 32
        vk = VerifyingKey.from_bytes(b[:vk_len])
        r = codec.Reader(b, vk_len)
        sap = sap_from_reader(r)
        vecs = [r.vec(lambda: r.g1(validate=validate)) for _ in _PK_VECTORS]
        return cls(vk, sap, *vecs)
