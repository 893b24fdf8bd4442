# Frozen copy of the program's polymath_tpu_torch/transcript/keccak.py (the benchmark's reference
# imports nothing of the program).
"""Keccak-f[1600] permutation and Keccak-256 (original padding 0x01).

Used by two transcript backends (reference ``src/transcript/keccak256.rs``
uses the ``sha3`` crate's ``Keccak256``; ``merlin.rs`` uses STROBE-128 whose
duplex is Keccak-f[1600]).  Note Keccak-256 != SHA3-256: the domain padding
byte is 0x01, not 0x06.
"""

from __future__ import annotations

_MASK = (1 << 64) - 1

# Round constants for Keccak-f[1600] (24 rounds).
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# Rotation offsets r[x][y].
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


def _rotl(v: int, n: int) -> int:
    n %= 64
    return ((v << n) | (v >> (64 - n))) & _MASK


def keccak_f1600(lanes):
    """In-place-style permutation of a 5x5 list-of-lists of 64-bit ints.

    Returns the permuted 5x5 state (lane [x][y]).
    """
    a = [row[:] for row in lanes]
    for rnd in range(24):
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x][y] ^= d[x]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(a[x][y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x][y] = b[x][y] ^ ((~b[(x + 1) % 5][y] & _MASK) & b[(x + 2) % 5][y])
        # iota
        a[0][0] ^= _RC[rnd]
    return a


def keccak_f1600_bytes(state: bytes) -> bytes:
    """Permute a 200-byte state (little-endian lane order, lane (x,y) at
    offset 8*(x + 5*y))."""
    assert len(state) == 200
    lanes = [[0] * 5 for _ in range(5)]
    for y in range(5):
        for x in range(5):
            off = 8 * (x + 5 * y)
            lanes[x][y] = int.from_bytes(state[off:off + 8], "little")
    lanes = keccak_f1600(lanes)
    out = bytearray(200)
    for y in range(5):
        for x in range(5):
            off = 8 * (x + 5 * y)
            out[off:off + 8] = lanes[x][y].to_bytes(8, "little")
    return bytes(out)


def keccak256(data: bytes) -> bytes:
    """Keccak-256 digest (Ethereum-style, pad byte 0x01)."""
    rate = 136  # 1088-bit rate
    state = bytearray(200)
    # absorb
    pos = 0
    msg = bytearray(data)
    # pad10*1 with leading domain byte 0x01
    pad_len = rate - (len(msg) % rate)
    msg += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len >= 2 else b"\x81"
    for block_start in range(0, len(msg), rate):
        for i in range(rate):
            state[i] ^= msg[block_start + i]
        state = bytearray(keccak_f1600_bytes(bytes(state)))
    # squeeze 32 bytes
    return bytes(state[:32])
