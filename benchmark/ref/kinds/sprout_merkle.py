"""Two Sprout Merkle paths under one anchor: the anchor, packed into two
field elements, is the public input.

SHA256Compress is FIPS 180-4 section 6.2.2 on one 512-bit block from the
initial hash value of section 5.3.3, without the padding of section 5.1
(Zcash's MerkleCRH^Sprout(left, right) = SHA256Compress(left || right)).
A node is an int of its 32 big-endian bytes.  The anchor's 256 bits,
most significant first, are packed 254 and then 2 into field elements,
bit i of a chunk weighing 2^i.
"""

K = [
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2]
H0 = [0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a, 0x510e527f, 0x9b05688c,
      0x1f83d9ab, 0x5be0cd19]
M32 = 0xFFFFFFFF


def rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & M32


def compress(block: bytes, h=H0) -> bytes:
    """SHA256Compress: section 6.2.2, steps 1-4, for one 64-byte block."""
    w = [int.from_bytes(block[4 * t:4 * t + 4], "big") for t in range(16)]
    for t in range(16, 64):
        sigma0 = rotr(w[t - 15], 7) ^ rotr(w[t - 15], 18) ^ (w[t - 15] >> 3)
        sigma1 = rotr(w[t - 2], 17) ^ rotr(w[t - 2], 19) ^ (w[t - 2] >> 10)
        w.append((sigma1 + w[t - 7] + sigma0 + w[t - 16]) & M32)
    a, b, c, d, e, f, g, hh = h
    for t in range(64):
        big_sigma1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)
        ch = (e & f) ^ ((e ^ M32) & g)
        t1 = (hh + big_sigma1 + ch + K[t] + w[t]) & M32
        big_sigma0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (big_sigma0 + maj) & M32
        hh, g, f, e, d, c, b, a = g, f, e, (d + t1) & M32, c, b, a, \
            (t1 + t2) & M32
    return b"".join(((x + y) & M32).to_bytes(4, "big")
                    for x, y in zip(h, (a, b, c, d, e, f, g, hh)))


def merkle_crh(left: int, right: int) -> int:
    return int.from_bytes(compress(left.to_bytes(32, "big")
                                   + right.to_bytes(32, "big")), "big")


def root(leaf: int, siblings, position: int) -> int:
    """Bit i of ``position`` set: the node at height i is a right child."""
    node = leaf
    for i, sib in enumerate(siblings):
        node = (merkle_crh(sib, node) if position >> i & 1
                else merkle_crh(node, sib))
    return node


def pack(node: int) -> list:
    bits = [node >> (255 - i) & 1 for i in range(256)]
    return [sum(bit << i for i, bit in enumerate(bits[:254])),
            bits[254] + 2 * bits[255]]


def shape(cfg) -> tuple:
    """(m0, constraints): the constant and the 2 packed inputs; per
    compression from the IV the message schedule (48 words: two 32-bit
    xors, a 29- and a 22-bit xor against a shift, a 4-word sum of 34
    bits and its constraint), rounds 1-63 (the 6- and 7-word sums of 35
    bits each with its constraint, two 64-bit sigma xors), ch and maj in
    rounds 2-63 (32 each), the final sums (two of 35 bits, six of 33, each
    with its constraint); per level a position bit, 256 sibling bits and
    256 swap constraints; per path 256 leaf bits; then 256 root
    equalities and 2 packing constraints."""
    compression = (48 * (32 + 29 + 32 + 22 + 34 + 1)
                   + 63 * (2 * (35 + 1) + 4 * 32) + 62 * (32 + 32)
                   + 2 * (35 + 1) + 6 * (33 + 1))
    level = 1 + 256 + 256 + compression
    return 3, 2 * (256 + cfg["depth"] * level) + 256 + 2


def publics(cfg, statement) -> list:
    """The anchor of path 1, packed; path 2 must reach it."""
    roots = [root(statement["leaves"][k], statement["siblings"][k],
                  statement["positions"][k]) for k in range(2)]
    if roots[0] != roots[1]:
        raise ValueError("the statement's second path misses the anchor")
    return pack(roots[0])
