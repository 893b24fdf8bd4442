"""Cross-validation vectors made by the Rust reference crate
(tools/rust_vectors/) through the port's stack (counterpart of the
reference's tools/import_rust_vectors.py):

* the VerifyingKey and the 176-byte proof are read from the crate's
  compressed bytes (serial/codec.py must agree bit for bit on flags,
  endianness and length prefixes);
* the proof is verified by the port's verifier under the matching
  transcript: any byte-level disagreement in the codec, the Fiat-Shamir
  label schema or a transcript's state machine changes the challenges and
  rejects the proof.

On success the file is installed at tests/fixtures/rust_dummy.json
(``DEST``), where the golden-vector tests pick it up; they skip while it
is absent.  Host only: the pairing check runs on the host.

    python3 -m polymath_tpu_torch.tools.import_rust_vectors rust_dummy.json

The file holds, for each of ``merlin``, ``keccak256`` and ``blake3``, the
hex of ``vk``, ``proof`` and ``public_input`` (one Fr, 32 bytes little
endian).  ``main(argv=None) -> dict`` returns what it printed.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

from ..protocol import verifier
from ..protocol.data_structures import Proof, VerifyingKey
from ..serial import codec
from ..transcript import ALL_TRANSCRIPTS

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
#: where ``main`` installs a file that passed ``check``
DEST = os.path.join(ROOT, "tests", "fixtures", "rust_dummy.json")


def check(path: str) -> list:
    """Verify each transcript's proof in ``path`` under the port's
    verifier; raises AssertionError naming the transcript whose proof is
    rejected.  Returns the lines it printed."""
    with open(path) as fh:
        vecs = json.load(fh)
    lines = []
    for tcls in ALL_TRANSCRIPTS:
        v = vecs[tcls.name]
        vk = VerifyingKey.from_bytes(bytes.fromhex(v["vk"]))
        proof = Proof.from_bytes(bytes.fromhex(v["proof"]))
        public = codec.fr_from_bytes(bytes.fromhex(v["public_input"]))
        if not verifier.verify_proof(vk, proof, [public], tcls):
            raise AssertionError(
                f"reference proof REJECTED under {tcls.name}: codec or "
                f"transcript divergence from arkworks")
        lines.append(f"{tcls.name}: reference proof verifies under this "
                     f"repo's verifier OK")
        print(lines[-1])
    return lines


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", nargs="?", default="rust_dummy.json")
    args = ap.parse_args(argv)
    lines = check(args.path)
    shutil.copy(args.path, DEST)
    lines.append(f"installed {DEST}")
    print(lines[-1])
    return {"checked": lines[:-1], "installed": DEST}


if __name__ == "__main__":
    main()
