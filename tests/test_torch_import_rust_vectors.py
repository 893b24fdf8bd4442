"""The port's importer of the Rust reference crate's vectors
(polymath_tpu_torch/tools/import_rust_vectors.py), on the CPU.

A file in the crate's format is written from the golden DummyCircuit
vectors (tests/fixtures/golden_dummy.json: the JAX package's bytes for
Rng(1234), a = 5, b = 7, so the public input is 35): ``check`` passes it,
and rejects it under each transcript with one byte of the proof flipped
or a public input of 36; ``main`` installs it.  The crate's own file,
tests/fixtures/rust_dummy.json, is not in the repository (making it needs
cargo and crates from the network); the test that reads it skips while it
is absent, as the reference's does.
"""

import json
import os

import pytest

from polymath_tpu_torch.serial import codec
from polymath_tpu_torch.tools import import_rust_vectors as IRV
from polymath_tpu_torch.transcript import ALL_TRANSCRIPTS

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
RUST_FIXTURE = os.path.join(FIXTURES, "rust_dummy.json")
NAMES = [t.name for t in ALL_TRANSCRIPTS]
#: the first byte of the proof's a_at_x1 (the low byte of an Fr, so the
#: flipped value still deserializes)
A_AT_X1 = 96


def write_vectors(path, public=35, flip=None):
    """The golden DummyCircuit vectors in the crate's format; ``flip``
    names a transcript whose proof gets byte A_AT_X1 flipped."""
    with open(os.path.join(FIXTURES, "golden_dummy.json")) as fh:
        golden = json.load(fh)
    vecs = {}
    for name in NAMES:
        proof = bytearray.fromhex(golden[name]["proof"])
        if name == flip:
            proof[A_AT_X1] ^= 1
        vecs[name] = {"vk": golden[name]["vk"], "proof": proof.hex(),
                      "public_input": codec.fr_to_bytes(public).hex()}
    with open(path, "w") as fh:
        json.dump(vecs, fh)
    return str(path)


def test_check_passes_the_golden_vectors(tmp_path):
    lines = IRV.check(write_vectors(tmp_path / "v.json"))
    assert lines == [f"{n}: reference proof verifies under this repo's "
                     f"verifier OK" for n in NAMES]


@pytest.mark.parametrize("tamper", ["flipped_byte", "public_input_36"])
@pytest.mark.parametrize("name", NAMES)
def test_check_rejects_a_tampered_vector(tmp_path, name, tamper):
    if tamper == "flipped_byte":
        path = write_vectors(tmp_path / "v.json", flip=name)
    else:
        path = write_vectors(tmp_path / "v.json", public=36)
    # a public input of 36 is wrong for every transcript; the first one
    # checked is named
    want = name if tamper == "flipped_byte" else NAMES[0]
    with pytest.raises(AssertionError, match=f"REJECTED under {want}:"):
        IRV.check(path)


def test_main_installs_a_checked_file(tmp_path, monkeypatch, capsys):
    src = write_vectors(tmp_path / "v.json")
    dest = tmp_path / "fixtures" / "rust_dummy.json"
    dest.parent.mkdir()
    monkeypatch.setattr(IRV, "DEST", str(dest))
    out = IRV.main([src])
    assert dest.read_bytes() == open(src, "rb").read()
    assert out == {"checked": IRV.check(src), "installed": str(dest)}
    assert f"installed {dest}" in capsys.readouterr().out


def test_main_installs_nothing_when_check_fails(tmp_path, monkeypatch):
    src = write_vectors(tmp_path / "v.json", public=36)
    dest = tmp_path / "rust_dummy.json"
    monkeypatch.setattr(IRV, "DEST", str(dest))
    with pytest.raises(AssertionError):
        IRV.main([src])
    assert not dest.exists()


@pytest.mark.skipif(not os.path.exists(RUST_FIXTURE),
                    reason="Rust reference vectors not imported (cargo is "
                           "unavailable here; see tools/rust_vectors/)")
def test_rust_reference_vectors():
    """Proofs made by the Rust reference crate verify under the port's
    verifier (the twin of tests/test_golden_vectors.py's test)."""
    IRV.check(RUST_FIXTURE)
