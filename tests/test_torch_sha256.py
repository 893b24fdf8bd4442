"""The port's SHA-256 gadgets and two-path Merkle circuit
(polymath_tpu_torch/circuits/sha256.py) on the CPU: SHA256Compress against
hashlib and a plain compression of this file's own, R1CS satisfaction and
its failure on a wrong witness, the closed-form constraint counts, and a
CPU prove of every gadget that the port's verifier accepts.  The
benchmark's circuit kind and reference are held to the gadget in
benchmark/tests/test_bench_sprout_merkle.py."""

import hashlib
import random

import pytest
import torch

from polymath_tpu_torch.circuits import sha256 as S
from polymath_tpu_torch.frontend.r1cs import ConstraintSystem, synthesize
from polymath_tpu_torch.hostmath.bls12_381 import R
from polymath_tpu_torch.protocol import Polymath, Proof, Rng, VerifyingKey
from polymath_tpu_torch.transcript import MerlinFieldTranscript


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _padded_block(seed: int) -> tuple:
    """(message, its one padded 64-byte block) for a seeded message of at
    most 55 bytes."""
    rng = random.Random(seed)
    msg = rng.randbytes(rng.randrange(56))
    block = (msg + b"\x80" + b"\x00" * (55 - len(msg))
             + (8 * len(msg)).to_bytes(8, "big"))
    return msg, block


def _rotr(x, k):
    return (x >> k | x << (32 - k)) & S.MASK


def _plain_compress(block: bytes) -> bytes:
    """FIPS 180-4 section 6.2.2 on one 64-byte block from the IV, no
    padding."""
    w = [int.from_bytes(block[4 * t:4 * t + 4], "big") for t in range(16)]
    for t in range(16, 64):
        s0 = _rotr(w[t - 15], 7) ^ _rotr(w[t - 15], 18) ^ w[t - 15] >> 3
        s1 = _rotr(w[t - 2], 17) ^ _rotr(w[t - 2], 19) ^ w[t - 2] >> 10
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & S.MASK)
    a, b, c, d, e, f, g, h = S.IV
    for t in range(64):
        t1 = (h + (_rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25))
              + (e & f ^ ~e & g) + S.K[t] + w[t]) & S.MASK
        t2 = ((_rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22))
              + (a & b ^ a & c ^ b & c)) & S.MASK
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & S.MASK, c, b, a, \
            (t1 + t2) & S.MASK
    return b"".join(((x + y) & S.MASK).to_bytes(4, "big")
                    for x, y in zip(S.IV, (a, b, c, d, e, f, g, h)))


def _root(leaf: int, siblings, position: int) -> int:
    """Bit i of ``position`` set: the node at height i is a right child."""
    for i, sib in enumerate(siblings):
        pair = (sib, leaf) if position >> i & 1 else (leaf, sib)
        leaf = int.from_bytes(_plain_compress(
            b"".join(v.to_bytes(32, "big") for v in pair)), "big")
    return leaf


def _publics(st) -> list:
    """Path 1's root, its bits most significant first, packed 254 and 2."""
    node = _root(st["leaves"][0], st["siblings"][0], st["positions"][0])
    bits = [node >> (255 - i) & 1 for i in range(256)]
    return [sum(b << i for i, b in enumerate(bits[:254])),
            bits[254] + 2 * bits[255]]


def _statement(depth: int, rng) -> dict:
    """Two distinct positions whose paths meet and reach one root."""
    p1, p2 = rng.sample(range(1 << depth), 2)
    meet = (p1 ^ p2).bit_length() - 1
    leaves = [rng.getrandbits(256), rng.getrandbits(256)]
    sib1 = [rng.getrandbits(256) for _ in range(depth)]
    sib2 = [rng.getrandbits(256) for _ in range(meet)]
    node1 = _root(leaves[0], sib1[:meet], p1)
    sib1[meet] = _root(leaves[1], sib2, p2)
    sib2 += [node1] + sib1[meet + 1:]
    return {"positions": [p1, p2], "leaves": leaves, "siblings": [sib1, sib2]}


class Compress:
    """One SHA256Compress of 512 allocated block bits."""

    def __init__(self, block=None):
        self.block = block

    def generate_constraints(self, cs):
        v = None if self.block is None else int.from_bytes(self.block, "big")
        bits = [S.alloc_bit(cs, None if v is None else (v >> (511 - i)) & 1)
                for i in range(512)]
        self.out = S.sha256_compress(cs, bits)


def _rows(cs):
    cs_a, cs_b, cs_c = cs.to_matrices()
    return list(zip(cs_a, cs_b, cs_c))


def _unsatisfied(rows, z) -> int:
    def ev(row):
        return sum(c * z[j] for c, j in row) % R
    return sum(1 for a, b, c in rows if ev(a) * ev(b) % R != ev(c))


@pytest.fixture(scope="module")
def compress_rows():
    return _rows(synthesize(Compress(), ConstraintSystem.SETUP))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_compress_matches_hashlib_and_the_reference(seed):
    msg, block = _padded_block(seed)
    circuit = Compress(block)
    synthesize(circuit, ConstraintSystem.PROVE)
    digest = sum(b.value << (255 - i) for i, b in enumerate(circuit.out))
    want = hashlib.sha256(msg).digest()
    assert digest.to_bytes(32, "big") == want
    assert _plain_compress(block) == want


def test_compress_r1cs_is_satisfied_and_a_flipped_bit_breaks_it(
        compress_rows):
    _, block = _padded_block(4)
    cs = synthesize(Compress(block), ConstraintSystem.PROVE)
    assert len(compress_rows) == 512 + S.COMPRESSION_CONSTRAINTS
    assert cs.num_witness_variables == 512 + 23862
    z = cs.full_assignment()
    assert _unsatisfied(compress_rows, z) == 0
    first = cs.num_instance_variables
    rng = random.Random(5)
    # an input bit, then allocations of the schedule, the rounds and the
    # final sums
    for k in [7, 512 + 40, 512 + 9000, 512 + 20000, len(z) - first - 1] + [
            rng.randrange(512, len(z) - first) for _ in range(3)]:
        bad = list(z)
        bad[first + k] ^= 1
        assert _unsatisfied(compress_rows, bad) > 0, k


@pytest.fixture(scope="module")
def two_paths():
    """Depth 2: the setup's rows, a statement and its honest assignment."""
    rows = _rows(synthesize(S.MerkleTwoPaths(2), ConstraintSystem.SETUP))
    st = _statement(2, random.Random(2 ** 33 + 7))
    assert _root(st["leaves"][1], st["siblings"][1], st["positions"][1]) \
        == _root(st["leaves"][0], st["siblings"][0], st["positions"][0])
    return rows, st


def _assign(st, flip=None):
    """The gadget's assignment for ``st``, with one value xor 1 where
    ``flip`` = (field, path, level or None) says."""
    st = {k: [list(x) if isinstance(x, list) else x for x in v]
          for k, v in st.items()}
    if flip is not None:
        field, path, level = flip
        if level is None:
            st[field][path] ^= 1
        else:
            st[field][path][level] ^= 1
    return synthesize(S.MerkleTwoPaths(len(st["siblings"][0]), st["leaves"],
                                       st["siblings"], st["positions"]),
                      ConstraintSystem.PROVE)


def test_two_paths_are_satisfied_under_the_reference_anchor(two_paths):
    rows, st = two_paths
    assert len(rows) == S.merkle_constraints(2)
    cs = _assign(st)
    assert cs.instance_assignment[1:] == _publics(st)
    assert _unsatisfied(rows, cs.full_assignment()) == 0


@pytest.mark.parametrize("flip", [("siblings", 1, 0), ("siblings", 1, 1),
                                  ("positions", 1, None)])
def test_a_wrong_second_path_is_unsatisfied(two_paths, flip):
    """Path 2 with a sibling bit or its position bit 0 flipped reaches
    another root than the anchor path 1 gives."""
    rows, st = two_paths
    assert _unsatisfied(rows, _assign(st, flip).full_assignment()) > 0


def test_a_wrong_first_path_misses_the_public_anchor(two_paths):
    rows, st = two_paths
    z = _assign(st, ("siblings", 0, 0)).full_assignment()
    z[1:3] = _publics(st)
    assert _unsatisfied(rows, z) > 0


@pytest.mark.parametrize("depth", [1, 2])
def test_closed_form_counts_equal_synthesis(depth):
    """The counts of the module's docstring, term by term."""
    cs = synthesize(S.MerkleTwoPaths(depth), ConstraintSystem.SETUP)
    compression = (48 * (32 + 29 + 32 + 22 + 34 + 1)
                   + 63 * (2 * (35 + 1) + 4 * 32) + 62 * (32 + 32)
                   + 2 * (35 + 1) + 6 * (33 + 1))
    assert compression == S.COMPRESSION_CONSTRAINTS
    cons = 2 * (256 + depth * (1 + 256 + 256 + compression)) + 256 + 2
    assert (cs.num_instance_variables, cs.num_constraints) == (3, cons)
    assert cons == S.merkle_constraints(depth)
    assert cs.num_witness_variables == 2 * (256 + depth * (513 + 23862))


class EveryGadget:
    """Three words whose 4 low bits are witnesses and whose high bits are
    constants; the sum of two, and the xor, ch and maj of all three (free
    on the constant bits); a conditional swap of the xor and ch low bits;
    the sum, the swap's outputs and the maj's low bits packed into one
    public input."""

    HIGH = (0xA5A5A5A0, 0x3C3C3C30, 0xF0F0F0F0)

    def __init__(self, lows=None, right=None):
        self.lows, self.right = lows, right

    def generate_constraints(self, cs):
        x, y, z = [[S.alloc_bit(cs, None if self.lows is None
                                else (self.lows[k] >> i) & 1)
                    for i in range(4)] + S.const_word(high)[4:]
                   for k, high in enumerate(self.HIGH)]
        total = S.addmany(cs, [x, y])
        xo = S.xor_word(cs, x, y)
        chw = [S.ch(cs, a, b, c) for a, b, c in zip(x, y, z)]
        majw = [S.maj(cs, a, b, c) for a, b, c in zip(x, y, z)]
        p = S.alloc_bit(cs, self.right)
        left, right = S.conditional_swap(cs, xo[:4], chw[:4], p)
        S.pack_into_inputs(cs, total + left + right + majw[:4])


def _every_gadget_publics(lows, right) -> list:
    x, y, z = (h | lo for h, lo in zip(EveryGadget.HIGH, lows))
    xo, chv = (x ^ y) & 15, ((x & y) | (~x & z)) & 15
    majv = ((x & y) | (x & z) | (y & z)) & 15
    left, rgt = (chv, xo) if right else (xo, chv)
    return [((x + y) & S.MASK) | left << 32 | rgt << 36 | majv << 40]


def test_every_gadget_proves_on_the_cpu_and_both_verifiers_accept():
    """The port's verifier accepts the proof both as objects and as the
    bytes a verifier receives, and refuses a wrong public input."""
    pm = Polymath(transcript=MerlinFieldTranscript, device="cpu")
    pk, vk = pm.setup(EveryGadget(), Rng(2 ** 31 + 99))
    lows = [11, 6, 13]
    publics = _every_gadget_publics(lows, 1)
    proof = pm.prove(pk, EveryGadget(lows, 1), Rng(4))
    assert pm.verify(vk, publics, proof)
    vk_w = VerifyingKey.from_bytes(vk.to_bytes())
    proof_w = Proof.from_bytes(proof.to_bytes())
    assert pm.verify(vk_w, publics, proof_w)
    assert not pm.verify(vk_w, [publics[0] ^ 1], proof_w)
