"""Host-side (Python int) math substrate: fields, curves, pairing."""

from .field import prime_field, two_adicity, FieldElement
from .bls12_381 import (
    Fq, Fr, Fq2, Fq6, Fq12, G1, G2, Q, R, BLS_X,
    FR_TWO_ADICITY, FR_TWO_ADIC_ROOT,
    pairing, multi_pairing, miller_loop, final_exponentiation,
)

__all__ = [
    "prime_field", "two_adicity", "FieldElement",
    "Fq", "Fr", "Fq2", "Fq6", "Fq12", "G1", "G2", "Q", "R", "BLS_X",
    "FR_TWO_ADICITY", "FR_TWO_ADIC_ROOT",
    "pairing", "multi_pairing", "miller_loop", "final_exponentiation",
]
