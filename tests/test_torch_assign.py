"""The assignment's canonical Fr words, on the CPU: the native pack
(``native/assign.cpp`` through ``ops.prover.fr_words``) against the Python
conversion it replaced, value for value and word for word.

* ``fr_words`` equals ``(int(v) % r).to_bytes(32, "little")`` in the (8, N)
  layout for edge values (0, r - 1, r, 2^256, negatives, bool, numpy ints,
  an int subclass, an object with only ``__int__``), empty, single-element
  and odd-length lists, and the instance/witness two-list form; its
  ``fallback`` count is exactly the values that are not exact ints in
  [0, r).  The same with the library absent (``native.get_lib`` -> None).
* ``ConstraintSystem.alloc_witness_block`` keeps ``[int(v) % r for v in
  vals]``, every element an exact int, with and without the library.
* A small BenchCircuit-shaped prove whose unconstrained block holds the
  edge values gives the same proof bytes with the library, without it, and
  with the block reduced beforehand.
"""

import random

import numpy as np
import pytest
import torch

from polymath_tpu_torch import native
from polymath_tpu_torch.frontend.r1cs import ConstraintSystem, lc
from polymath_tpu_torch.hostmath.bls12_381 import R
from polymath_tpu_torch.ops import prover
from polymath_tpu_torch.ops.prover import ASSIGN_COUNTS, fr_words
from polymath_tpu_torch.protocol import Polymath, Rng
from polymath_tpu_torch.protocol.data_structures import Proof
from polymath_tpu_torch.transcript import MerlinFieldTranscript


class IntSub(int):
    pass


class OnlyInt:
    """Defines ``__int__`` and nothing else of an int."""

    def __init__(self, v):
        self.v = v

    def __int__(self):
        return self.v


EDGE = [0, 1, R - 1, R, R + 1, 2 ** 255, 2 ** 256 - 1, 2 ** 256, 2 ** 300,
        -1, -R, True, np.uint8(1), IntSub(5), OnlyInt(R + 7),
        np.int64(-3), 2 ** 64, 2 ** 128 - 1, R - 2 ** 200]


def _spread(n, seed):
    rng = random.Random(seed)
    return [rng.randrange(R) for _ in range(n)]


CASES = {
    "edge": [EDGE],
    "empty": [[]],
    "single": [[R - 1]],
    "odd_length": [_spread(7, 1)],
    "mixed": [_spread(5, 2) + EDGE + _spread(3, 3)],
    "bits": [[random.Random(4).randrange(2) for _ in range(33)]],
    "two_lists": [[1, 2 ** 253 + 5, -7], _spread(9, 5) + [R, True]],
    "two_lists_empty_instance": [[], EDGE],
    "tuple": [tuple(EDGE)],
}


def _canonical(v) -> bool:
    return type(v) is int and 0 <= v < R


def _python_words(lists) -> np.ndarray:
    """The conversion the pack replaced."""
    vals = [v for values in lists for v in values]
    buf = b"".join((int(v) % R).to_bytes(32, "little") for v in vals)
    u32 = np.frombuffer(buf, dtype="<u4").reshape(len(vals), 8)
    return np.array(u32.T, order="C").view(np.int32)


@pytest.fixture(params=["native", "python"])
def route(request, monkeypatch):
    """The library loaded, or absent (the pure-Python paths)."""
    if request.param == "native":
        assert native._assign_lib() is not None, \
            "the native library (g++, Python.h) did not load"
    else:
        monkeypatch.setattr(native, "get_lib", lambda: None)
    return request.param


@pytest.fixture
def counts():
    """ASSIGN_COUNTS from zero, restored afterwards."""
    saved = dict(ASSIGN_COUNTS)
    ASSIGN_COUNTS.update(native=0, fallback=0)
    yield ASSIGN_COUNTS
    ASSIGN_COUNTS.update(saved)


@pytest.mark.parametrize("case", list(CASES))
def test_fr_words_match_the_python_conversion(case, route, counts):
    lists = CASES[case]
    words = fr_words(lists)
    n = sum(len(v) for v in lists)
    assert words.shape == (8, n) and words.dtype == torch.int32
    assert np.array_equal(words.numpy(), _python_words(lists))
    odd = sum(not _canonical(v) for values in lists for v in values)
    if route == "native":
        assert counts == {"native": n - odd, "fallback": odd}
    else:
        assert counts == {"native": 0, "fallback": n}


def test_fr_words_into_a_buffer_and_the_mont_upload(route):
    lists = CASES["two_lists"]
    n = sum(len(v) for v in lists)
    out = torch.full((8, n), -1, dtype=torch.int32)
    assert fr_words(lists, out=out) is out
    assert np.array_equal(out.numpy(), _python_words(lists))
    with pytest.raises(ValueError):
        fr_words(lists, out=torch.empty((8, n + 1), dtype=torch.int32))
    with pytest.raises(ValueError):
        fr_words(lists, out=torch.empty((n, 8), dtype=torch.int32).T)
    # upload_words on the CPU, then to Montgomery form as prove does
    staging = {}
    z = prover.fr_to_mont(prover.upload_words(lists, "cpu", staging))
    want = prover.fr_ints_to_mont_device(
        [int(v) % R for values in lists for v in values], "cpu")
    assert torch.equal(z, want) and staging == {}


@pytest.mark.parametrize("bad, exc", [(None, TypeError), ("x1", ValueError),
                                      (1.5e300 * 1e300, OverflowError)],
                         ids=["none", "str", "inf"])
def test_fr_words_raise_as_int_does(route, bad, exc):
    with pytest.raises(exc):
        fr_words([[1, 2], [3, bad, 4]])


def test_fr_pack_stops_when_int_changes_the_list():
    """int(v) that grows the list under the native loop: an error, not a
    read past the list's old items."""
    values = [1, 2]

    class Grows:
        def __int__(self):
            values.append(0)
            return 3

    values.insert(1, Grows())
    out = torch.empty((8, 3), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="changed size"):
        native.fr_pack([values], out.data_ptr(), 3)


@pytest.mark.parametrize("case", ["edge", "mixed", "bits", "empty", "tuple",
                                  "array"])
def test_alloc_witness_block_keeps_reduced_ints(case, route):
    vals = (np.arange(5, dtype=np.uint64) if case == "array"
            else CASES[case][0])
    cs = ConstraintSystem(ConstraintSystem.PROVE)
    start = cs.alloc_witness_block(len(vals), lambda: vals)
    assert start == 0 and cs.num_witness_variables == len(vals)
    assert cs.witness_assignment == [int(v) % R for v in vals]
    assert all(type(v) is int for v in cs.witness_assignment)


def test_fr_all_canonical():
    assert native.fr_all_canonical(CASES["odd_length"][0]) is True
    assert native.fr_all_canonical(()) is True
    for v in EDGE:
        assert native.fr_all_canonical([0, v, 1]) is _canonical(v), v


class BlockCircuit:
    """BenchCircuit's shape at 8 constraints: a * b = c, and an
    unconstrained witness block (the bench circuit's filler) of ``block``."""

    def __init__(self, a=None, b=None, block=None):
        self.a, self.b, self.block = a, b, block

    def generate_constraints(self, cs):
        a = cs.new_witness_variable(lambda: self.a)
        b = cs.new_witness_variable(lambda: self.b)
        c = cs.new_input_variable(
            lambda: None if self.a is None else self.a * self.b % R)
        cs.alloc_witness_block(len(EDGE), lambda: self.block)
        for _ in range(7):
            cs.enforce_constraint(lc(a), lc(b), lc(c))
        cs.enforce_constraint(lc(), lc(), lc())


@pytest.fixture(scope="module")
def block_key():
    """The key, and the proof bytes of (3, 5) with the block reduced
    beforehand and the library loaded."""
    pm = Polymath(transcript=MerlinFieldTranscript, device="cpu")
    pk, vk = pm.setup(BlockCircuit(), Rng(77))
    reduced = [int(v) % R for v in EDGE]
    want = pm.prove(pk, BlockCircuit(3, 5, reduced), Rng(9)).to_bytes()
    assert pm.verify(vk, [15], Proof.from_bytes(want))
    return pk, want


@pytest.mark.parametrize("block", ["edge", "reduced"])
def test_prove_bytes_with_and_without_the_library(block_key, block, route):
    pk, want = block_key
    vals = EDGE if block == "edge" else [int(v) % R for v in EDGE]
    pm = Polymath(transcript=MerlinFieldTranscript, device="cpu")
    proof = pm.prove(pk, BlockCircuit(3, 5, list(vals)), Rng(9))
    assert proof.to_bytes() == want
