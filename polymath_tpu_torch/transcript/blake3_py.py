"""BLAKE3 hash (plain hashing mode), implemented from the public spec.

Backs the reference's third transcript flavor (``src/transcript/blake3.rs``,
which uses the ``blake3`` crate's default 32-byte digest).
"""

from __future__ import annotations

_MASK32 = 0xFFFFFFFF

_IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]

_MSG_PERM = [2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8]

CHUNK_START = 1
CHUNK_END = 2
PARENT = 4
ROOT = 8

_CHUNK_LEN = 1024
_BLOCK_LEN = 64


def _rotr(v, n):
    return ((v >> n) | (v << (32 - n))) & _MASK32


def _g(state, a, b, c, d, mx, my):
    state[a] = (state[a] + state[b] + mx) & _MASK32
    state[d] = _rotr(state[d] ^ state[a], 16)
    state[c] = (state[c] + state[d]) & _MASK32
    state[b] = _rotr(state[b] ^ state[c], 12)
    state[a] = (state[a] + state[b] + my) & _MASK32
    state[d] = _rotr(state[d] ^ state[a], 8)
    state[c] = (state[c] + state[d]) & _MASK32
    state[b] = _rotr(state[b] ^ state[c], 7)


def _compress(cv, block_words, counter, block_len, flags):
    state = [
        cv[0], cv[1], cv[2], cv[3], cv[4], cv[5], cv[6], cv[7],
        _IV[0], _IV[1], _IV[2], _IV[3],
        counter & _MASK32, (counter >> 32) & _MASK32, block_len, flags,
    ]
    m = list(block_words)
    for r in range(7):
        _g(state, 0, 4, 8, 12, m[0], m[1])
        _g(state, 1, 5, 9, 13, m[2], m[3])
        _g(state, 2, 6, 10, 14, m[4], m[5])
        _g(state, 3, 7, 11, 15, m[6], m[7])
        _g(state, 0, 5, 10, 15, m[8], m[9])
        _g(state, 1, 6, 11, 12, m[10], m[11])
        _g(state, 2, 7, 8, 13, m[12], m[13])
        _g(state, 3, 4, 9, 14, m[14], m[15])
        if r < 6:
            m = [m[_MSG_PERM[i]] for i in range(16)]
    return [
        (state[i] ^ state[i + 8]) & _MASK32 if i < 8 else (state[i] ^ cv[i - 8]) & _MASK32
        for i in range(16)
    ]


def _words_from_block(block: bytes):
    assert len(block) == _BLOCK_LEN
    return [int.from_bytes(block[4 * i:4 * i + 4], "little") for i in range(16)]


def _chunk_cv(chunk: bytes, chunk_counter: int, is_root_candidate: bool):
    """Process one chunk; returns (cv, last_block_info) where last_block_info
    lets the caller redo the final compression with the ROOT flag."""
    cv = list(_IV)
    blocks = [chunk[i:i + _BLOCK_LEN] for i in range(0, max(len(chunk), 1), _BLOCK_LEN)]
    if not blocks:
        blocks = [b""]
    n = len(blocks)
    last_info = None
    for i, blk in enumerate(blocks):
        flags = 0
        if i == 0:
            flags |= CHUNK_START
        if i == n - 1:
            flags |= CHUNK_END
        block_len = len(blk)
        padded = blk + b"\x00" * (_BLOCK_LEN - block_len)
        words = _words_from_block(padded)
        if i == n - 1:
            last_info = (list(cv), words, chunk_counter, block_len, flags)
        cv = _compress(cv, words, chunk_counter, block_len, flags)[:8]
    return cv, last_info


def blake3(data: bytes, out_len: int = 32) -> bytes:
    """BLAKE3 digest (hash mode, default key)."""
    chunks = [data[i:i + _CHUNK_LEN] for i in range(0, max(len(data), 1), _CHUNK_LEN)]
    if not chunks:
        chunks = [b""]

    if len(chunks) == 1:
        _, (cv, words, counter, block_len, flags) = _chunk_cv(chunks[0], 0, True)
        return _root_output(cv, words, block_len, flags | ROOT, out_len)

    # Build the binary tree over chunk chaining values.
    cvs = [(_chunk_cv(c, i, False))[0] for i, c in enumerate(chunks)]

    def parent_words(l, r):
        return l + r

    # Combine bottom-up; BLAKE3's tree is left-leaning: combine pairs, odd
    # node carries up unchanged.
    while len(cvs) > 2:
        nxt = []
        for i in range(0, len(cvs) - 1, 2):
            words = parent_words(cvs[i], cvs[i + 1])
            nxt.append(_compress(list(_IV), words, 0, _BLOCK_LEN, PARENT)[:8])
        if len(cvs) % 2 == 1:
            nxt.append(cvs[-1])
        cvs = nxt
    words = parent_words(cvs[0], cvs[1])
    return _root_output(list(_IV), words, _BLOCK_LEN, PARENT | ROOT, out_len)


def _root_output(cv, words, block_len, flags, out_len: int) -> bytes:
    out = bytearray()
    counter = 0
    while len(out) < out_len:
        res = _compress(cv, words, counter, block_len, flags)
        for w in res:
            out += w.to_bytes(4, "little")
        counter += 1
    return bytes(out[:out_len])
