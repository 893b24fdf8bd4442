"""The Sprout Merkle circuit kind: drawn statements reach one anchor; the
reference's SHA256Compress agrees with hashlib; its shape and public
inputs agree with the program's synthesis at depths 1 and 2; the bulk
witness equals the gadget's own assignment; and the reference verifier
accepts a CPU proof of a circuit built from the gadgets."""

import hashlib
import random

import pytest

from benchmark.circuits import sprout_merkle
from benchmark.ref import verify
from benchmark.ref.kinds import sprout_merkle as ref_kind


@pytest.mark.parametrize("seed", [2 ** 31 + 3, 2 ** 32 + 5, 17])
def test_statements_reach_one_anchor(seed):
    cfg = {"depth": 29}
    st = sprout_merkle.draw_statement(cfg, random.Random(seed))
    p1, p2 = st["positions"]
    assert p1 != p2 and max(p1, p2) < 2 ** 29
    meet = (p1 ^ p2).bit_length() - 1
    sib1, sib2 = st["siblings"]
    assert sib1[meet + 1:] == sib2[meet + 1:]
    assert sib2[meet] == ref_kind.root(st["leaves"][0], sib1[:meet], p1)
    roots = [ref_kind.root(st["leaves"][k], st["siblings"][k],
                           st["positions"][k]) for k in range(2)]
    assert roots[0] == roots[1]
    assert ref_kind.publics(cfg, st) == ref_kind.pack(roots[0])
    assert sprout_merkle.prepare(cfg, st)["inputs"] == ref_kind.pack(roots[0])


def test_a_statement_off_the_anchor_is_refused():
    cfg = {"depth": 3}
    st = sprout_merkle.draw_statement(cfg, random.Random(9))
    st["siblings"][1][2] ^= 1
    with pytest.raises(ValueError):
        ref_kind.publics(cfg, st)


@pytest.mark.parametrize("depth", [1, 2])
def test_shape_and_publics_agree_with_the_program(depth):
    from polymath_tpu_torch.frontend.r1cs import ConstraintSystem, synthesize
    cfg = {"depth": depth}
    setup = synthesize(sprout_merkle.setup_circuit(cfg),
                       ConstraintSystem.SETUP)
    assert ref_kind.shape(cfg) == (setup.num_instance_variables,
                                   setup.num_constraints)
    st = sprout_merkle.draw_statement(cfg, random.Random(depth))
    cs = synthesize(sprout_merkle.prove_circuit(
        cfg, sprout_merkle.prepare(cfg, st)), ConstraintSystem.PROVE)
    assert cs.instance_assignment[1:] == ref_kind.publics(cfg, st)
    assert cs.num_witness_variables == setup.num_witness_variables


def test_domain_at_depth_29():
    """About 1.43M constraints and 2.85M SAP rows: n = 2^22."""
    m0, cons = ref_kind.shape({"depth": 29})
    assert (m0, cons) == (3, 1425076)
    assert verify.domain_size(m0, cons) == 1 << 22


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_reference_compress_matches_hashlib(seed):
    rng = random.Random(seed)
    msg = rng.randbytes(rng.randrange(56))
    block = (msg + b"\x80" + b"\x00" * (55 - len(msg))
             + (8 * len(msg)).to_bytes(8, "big"))
    assert ref_kind.compress(block) == hashlib.sha256(msg).digest()


@pytest.mark.parametrize("depth", [1, 2])
def test_bulk_witness_equals_the_gadget_assignment(depth):
    from polymath_tpu_torch.circuits import sha256 as S
    from polymath_tpu_torch.frontend.r1cs import ConstraintSystem, synthesize
    cfg = {"depth": depth}
    st = sprout_merkle.draw_statement(cfg, random.Random(2 ** 40 + depth))
    want = synthesize(S.MerkleTwoPaths(depth, st["leaves"], st["siblings"],
                                       st["positions"]),
                      ConstraintSystem.PROVE)
    got = synthesize(sprout_merkle.prove_circuit(
        cfg, sprout_merkle.prepare(cfg, st)), ConstraintSystem.PROVE)
    assert got.witness_assignment == want.witness_assignment
    assert got.instance_assignment == want.instance_assignment
    assert got.num_constraints == want.num_constraints


class _Gadgets:
    """Two words of 4 witness bits under constant high bits: their sum,
    xor, ch and maj with a constant third word, and a conditional swap,
    packed into one public input."""

    HIGH = (0xA5A5A5A0, 0x3C3C3C30)
    Z = 0xF0F0F0F5

    def __init__(self, lows=None, right=None):
        self.lows, self.right = lows, right

    def generate_constraints(self, cs):
        from polymath_tpu_torch.circuits import sha256 as S
        x, y = [[S.alloc_bit(cs, None if self.lows is None
                             else self.lows[k] >> i & 1) for i in range(4)]
                + S.const_word(high)[4:] for k, high in enumerate(self.HIGH)]
        z = S.const_word(self.Z)
        total = S.addmany(cs, [x, y])
        xo = S.xor_word(cs, x, y)
        chw = [S.ch(cs, a, b, c) for a, b, c in zip(x, y, z)]
        majw = [S.maj(cs, a, b, c) for a, b, c in zip(x, y, z)]
        left, right = S.conditional_swap(cs, xo[:4], chw[:4],
                                         S.alloc_bit(cs, self.right))
        S.pack_into_inputs(cs, total + left + right + majw[:4])

    @classmethod
    def publics(cls, lows, right) -> list:
        x, y = (h | lo for h, lo in zip(cls.HIGH, lows))
        z = cls.Z
        xo, chv = (x ^ y) & 15, ((x & y) | (~x & z)) & 15
        majv = ((x & y) | (x & z) | (y & z)) & 15
        left, rgt = (chv, xo) if right else (xo, chv)
        return [((x + y) & 0xFFFFFFFF) | left << 32 | rgt << 36 | majv << 40]


def test_reference_verifier_accepts_a_gadget_proof():
    from polymath_tpu_torch.protocol import Polymath, Rng
    from polymath_tpu_torch.transcript import MerlinFieldTranscript
    seed = 2 ** 31 + 99
    pm = Polymath(transcript=MerlinFieldTranscript, device="cpu")
    pk, vk = pm.setup(_Gadgets(), Rng(seed))
    m0, _, cons = pk.sap_matrices.m0_m_n()
    ref_vk = verify.derive_vk(seed, m0, cons)
    assert vk.to_bytes() == ref_vk.to_bytes()
    lows = [11, 6]
    publics = _Gadgets.publics(lows, 1)
    proof = pm.prove(pk, _Gadgets(lows, 1), Rng(4)).to_bytes()
    items = [(verify.Statement(publics), proof),
             (verify.Statement([publics[0] ^ 1]), proof)]
    assert verify.verify_batch(ref_vk, items, 1) == [1]
