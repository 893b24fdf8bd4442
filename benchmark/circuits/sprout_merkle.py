"""Zcash Sprout's JoinSplit Merkle checks: two input notes' authentication
paths of ``depth`` levels in the note commitment tree, under one public
anchor (MerkleCRH = SHA256Compress(left || right), no padding).  A
statement is two distinct leaf positions, two random 256-bit leaves and
each path's siblings.

Setup composes the port's gadget (``circuits.sha256.MerkleTwoPaths``).
Prove mode assigns the same variables in bulk: the harness computes the
witness in set-up (``prepare``), in the order the gadget allocates it:
per path the leaf's 256 bits, then per level the position bit, the
sibling's 256 bits, the swap's 256 left bits and the compression's 23,862
bits; each compression's bits come from its word-level values (a word's
low k bits, least significant first), unpacked with numpy.
"""

from __future__ import annotations

import numpy as np

from polymath_tpu_torch.circuits.sha256 import (
    CAPACITY, IV, K, MASK, MerkleTwoPaths, merkle_constraints)


def _rotr(x: int, k: int) -> int:
    return ((x >> k) | (x << (32 - k))) & MASK


def _segments(block) -> tuple:
    """One compression of 16 block words from the IV: ([(value, k)] of its
    allocations in the gadget's order, each allocating the value's low k
    bits; the 8 output words)."""
    segs = []
    w = list(block)
    for i in range(16, 64):
        x, y = w[i - 15], w[i - 2]
        s0a = _rotr(x, 7) ^ _rotr(x, 18)
        s0 = s0a ^ (x >> 3)
        s1a = _rotr(y, 17) ^ _rotr(y, 19)
        s1 = s1a ^ (y >> 10)
        total = w[i - 16] + s0 + w[i - 7] + s1
        segs += [(s0a, 32), (s0, 29), (s1a, 32), (s1, 22), (total, 34)]
        w.append(total & MASK)
    a, b, c, d, e, f, g, h = IV
    a_sum = e_sum = None
    for i in range(64):
        if i:
            e = e_sum & MASK
            segs.append((e_sum, 35))
        big_s1a = _rotr(e, 6) ^ _rotr(e, 11)
        big_s1 = big_s1a ^ _rotr(e, 25)
        chv = (e & f) ^ (~e & g & MASK)
        if i:
            segs += [(big_s1a, 32), (big_s1, 32)]
        if i > 1:
            segs.append((chv, 32))
        t1 = h + big_s1 + chv + K[i] + w[i]
        if i:
            a = a_sum & MASK
            segs.append((a_sum, 35))
        big_s0a = _rotr(a, 2) ^ _rotr(a, 13)
        big_s0 = big_s0a ^ _rotr(a, 22)
        majv = (a & b) ^ (a & c) ^ (b & c)
        if i:
            segs += [(big_s0a, 32), (big_s0, 32)]
        if i > 1:
            segs.append((majv, 32))
        h, g, f, e_sum = g, f, e, d + t1
        d, c, b, a_sum = c, b, a, t1 + big_s0 + majv
    sums = [(a_sum + IV[0], 35), (IV[1] + b, 33), (IV[2] + c, 33),
            (IV[3] + d, 33), (e_sum + IV[4], 35), (IV[5] + f, 33),
            (IV[6] + g, 33), (IV[7] + h, 33)]
    return segs + sums, [v & MASK for v, _ in sums]


def _words(block: int) -> list:
    return [(block >> (32 * (15 - j))) & MASK for j in range(16)]


def _node(words) -> int:
    out = 0
    for word in words:
        out = (out << 32) | word
    return out


def merkle_root(leaf: int, siblings, position: int) -> int:
    """The node over ``leaf`` at ``position`` (bit i: the node at height i
    is a right child) with ``siblings`` from the leaf up."""
    cur = leaf
    for i, sib in enumerate(siblings):
        pair = (sib, cur) if (position >> i) & 1 else (cur, sib)
        cur = _node(_segments(_words((pair[0] << 256) | pair[1]))[1])
    return cur


def _bits(value: int) -> np.ndarray:
    """A node's 256 big-endian bits."""
    return np.unpackbits(np.frombuffer(value.to_bytes(32, "big"), np.uint8))


def _path_witness(leaf: int, siblings, position: int) -> tuple:
    """(the path's witness bits in allocation order, its root)."""
    parts = [_bits(leaf)]
    cur = leaf
    for i, sib in enumerate(siblings):
        right = (position >> i) & 1
        sib_bits, cur_bits = _bits(sib), _bits(cur)
        block = (sib << 256) | cur if right else (cur << 256) | sib
        segs, out = _segments(_words(block))
        ks = np.asarray([k for _, k in segs], np.int64)
        values = np.repeat(np.asarray([v for v, _ in segs], np.uint64), ks)
        shift = np.arange(len(values)) - np.repeat(np.cumsum(ks) - ks, ks)
        parts += [np.asarray([right], np.uint8), sib_bits,
                  sib_bits if right else cur_bits,
                  ((values >> shift.astype(np.uint64))
                   & np.uint64(1)).astype(np.uint8)]
        cur = _node(out)
    return np.concatenate(parts), cur


def pack_anchor(root: int) -> list:
    """The anchor's public inputs: its big-endian bits in chunks of 254,
    bit i of a chunk weighing 2^i."""
    bits = [(root >> (255 - i)) & 1 for i in range(256)]
    return [sum(b << i for i, b in enumerate(bits[k:k + CAPACITY]))
            for k in range(0, 256, CAPACITY)]


class SproutMerkle:
    def __init__(self, cfg, witness=None, inputs=None):
        self.cfg = cfg
        self.witness = witness
        self.inputs = inputs

    def generate_constraints(self, cs):
        depth = self.cfg["depth"]
        if cs.mode == cs.SETUP:
            MerkleTwoPaths(depth).generate_constraints(cs)
            return
        cs.alloc_witness_block(len(self.witness), self.witness)
        for x in self.inputs:
            cs.new_input_variable(x)
        cs.constraints.extend([None] * merkle_constraints(depth))


def setup_circuit(cfg):
    return SproutMerkle(cfg)


def draw_statement(cfg, rng) -> dict:
    """Two distinct positions and leaves; every sibling off the two paths a
    random node, and at the level where the paths meet each path's sibling
    the other's node, so that both reach one root."""
    depth = cfg["depth"]
    p1 = rng.randrange(1 << depth)
    p2 = p1
    while p2 == p1:
        p2 = rng.randrange(1 << depth)
    meet = (p1 ^ p2).bit_length() - 1
    leaves = [rng.getrandbits(256), rng.getrandbits(256)]
    sib1 = [rng.getrandbits(256) for _ in range(depth)]
    sib2 = [rng.getrandbits(256) for _ in range(meet)]
    node1 = merkle_root(leaves[0], sib1[:meet], p1)
    sib1[meet] = merkle_root(leaves[1], sib2, p2)
    sib2 += [node1] + sib1[meet + 1:]
    return {"positions": [p1, p2], "leaves": leaves, "siblings": [sib1, sib2]}


def prepare(cfg, statement) -> dict:
    """The whole witness (ints 0 and 1, in the gadget's order) and the
    anchor's two public inputs."""
    parts, roots = [], []
    for k in range(2):
        bits, root = _path_witness(statement["leaves"][k],
                                   statement["siblings"][k],
                                   statement["positions"][k])
        parts.append(bits)
        roots.append(root)
    assert roots[0] == roots[1], "the two paths reach different roots"
    return {"witness": np.concatenate(parts).tolist(),
            "inputs": pack_anchor(roots[0])}


def prove_circuit(cfg, prepared):
    return SproutMerkle(cfg, prepared["witness"], prepared["inputs"])
