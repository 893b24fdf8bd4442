"""Limb and word representations of big field elements.

Two layouts, both little-endian with the limb axis leading and the batch
on the trailing axes:

* **16-bit limbs** ``(L, ...)`` — Fr L = 16, Fq L = 24.  The layout of the
  JAX reference and of the port's plain (kernel-free) arithmetic, which
  computes in ``int64`` so every 16x16 product and lazy sum is exact.
* **32-bit words** ``(L/2, ...)`` — Fr (8, N), Fq (12, N), stored as
  ``int32`` bit patterns.  The port's data format on the card and the
  argument format of every CUDA kernel.  Word k = limb 2k | limb 2k+1 << 16,
  which is exactly the reference's "packed" layout (``pack_limbs``).

The Montgomery radix stays 2^256 (Fr) / 2^384 (Fq) whatever the limb width,
so Montgomery values are bit-identical between the two layouts.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..hostmath.bls12_381 import Q, R

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def int_to_limbs(v: int, L: int) -> np.ndarray:
    """Python int -> (L,) uint32 of 16-bit limbs, little-endian."""
    return np.array([(v >> (LIMB_BITS * i)) & LIMB_MASK for i in range(L)],
                    dtype=np.uint32)


def limbs_to_int(limbs) -> int:
    v = 0
    arr = np.asarray(limbs, dtype=np.uint64)
    for i in range(arr.shape[0] - 1, -1, -1):
        v = (v << LIMB_BITS) | int(arr[i])
    return v


def ints_to_limbs(values, L: int) -> np.ndarray:
    """list[int] -> (L, N) uint32 limb array (vectorized via bytes)."""
    n = len(values)
    nbytes = 2 * L
    buf = b"".join(int(v).to_bytes(nbytes, "little") for v in values)
    u16 = np.frombuffer(buf, dtype="<u2").reshape(n, L)
    return np.ascontiguousarray(u16.T).astype(np.uint32)


def limbs_to_ints(arr) -> list[int]:
    """(L, N) limb array -> list[int]."""
    a = np.asarray(arr)
    L, n = a.shape[0], int(np.prod(a.shape[1:], dtype=np.int64))
    u16 = a.reshape(L, n).T.astype("<u2")
    raw = u16.tobytes()
    nbytes = 2 * L
    return [int.from_bytes(raw[i * nbytes:(i + 1) * nbytes], "little")
            for i in range(n)]


# -- 32-bit words -------------------------------------------------------------

def ints_to_words(values, L: int) -> np.ndarray:
    """list[int] -> (L/2, N) int32 word array (L counts 16-bit limbs)."""
    n = len(values)
    buf = b"".join(int(v).to_bytes(2 * L, "little") for v in values)
    u32 = np.frombuffer(buf, dtype="<u4").reshape(n, L // 2)
    return u32.T.copy().view(np.int32)


def words_to_ints(arr) -> list[int]:
    """(K, ...) int32/uint32 word array -> list[int] over the batch."""
    a = np.ascontiguousarray(np.asarray(arr)).view(np.uint32)
    K, n = a.shape[0], int(np.prod(a.shape[1:], dtype=np.int64))
    raw = a.reshape(K, n).T.astype("<u4").tobytes()
    nb = 4 * K
    return [int.from_bytes(raw[i * nb:(i + 1) * nb], "little")
            for i in range(n)]


def pack_np(limbs: np.ndarray) -> np.ndarray:
    """(L, ...) 16-bit limbs (numpy) -> (L/2, ...) int32 words."""
    a = np.asarray(limbs).astype(np.uint32)
    return (a[0::2] | (a[1::2] << np.uint32(16))).view(np.int32)


def words_to_limbs(w: torch.Tensor) -> torch.Tensor:
    """(K, ...) int32 words -> (2K, ...) int64 16-bit limbs (any device)."""
    u = w.to(torch.int64) & 0xFFFFFFFF
    out = torch.stack([u & LIMB_MASK, u >> LIMB_BITS], dim=1)
    return out.reshape((2 * w.shape[0],) + tuple(w.shape[1:]))


def limbs_to_words(a: torch.Tensor) -> torch.Tensor:
    """(L, ...) canonical 16-bit limbs (int64) -> (L/2, ...) int32 words."""
    w = a[0::2] | (a[1::2] << LIMB_BITS)
    # int64 -> int32 keeps the low 32 bits (two's complement wrap)
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


@dataclass(frozen=True)
class FieldSpec:
    """Static per-field constants baked into the kernels."""

    name: str
    modulus: int
    L: int
    p_limbs: np.ndarray = field(compare=False)
    n0inv: int = 0                 # -p^-1 mod 2^16
    r_mont: int = 0                # 2^(16 L) mod p
    r_inv: int = 0                 # 2^(-16 L) mod p
    r2: np.ndarray = field(default=None, compare=False)   # R^2 mod p, limbs
    one_mont: np.ndarray = field(default=None, compare=False)  # R mod p, limbs

    @classmethod
    def make(cls, name: str, p: int, L: int) -> "FieldSpec":
        r_mont = (1 << (LIMB_BITS * L)) % p
        r2 = (r_mont * r_mont) % p
        n0inv = (-pow(p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
        return cls(
            name=name, modulus=p, L=L,
            p_limbs=int_to_limbs(p, L),
            n0inv=n0inv,
            r_mont=r_mont,
            r_inv=pow(r_mont, -1, p),
            r2=int_to_limbs(r2, L),
            one_mont=int_to_limbs(r_mont, L),
        )

    @property
    def W(self) -> int:
        """Number of 32-bit words."""
        return self.L // 2

    # host-side Montgomery codecs ------------------------------------------
    def to_mont_int(self, v: int) -> int:
        return v * self.r_mont % self.modulus

    def from_mont_int(self, v: int) -> int:
        return v * self.r_inv % self.modulus


FR_SPEC = FieldSpec.make("Fr", R, 16)
FQ_SPEC = FieldSpec.make("Fq", Q, 24)
