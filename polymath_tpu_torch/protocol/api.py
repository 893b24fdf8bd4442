"""Public SNARK API (reference ``src/lib.rs`` ``Polymath<E, T>``).

    pm = Polymath(transcript=MerlinFieldTranscript)       # on the card
    pk, vk = pm.setup(circuit, rng)
    proof = pm.prove(pk, circuit, rng)
    assert pm.verify(vk, [public_input, ...], proof)

Setup and prove run on one device: the first CUDA card unless the caller
passes ``device`` (``"cpu"`` runs the kernels' plain versions).  Without
a card and without ``device="cpu"`` the constructor raises.  Verification
is host-side (native pairing check).
"""

from __future__ import annotations

import random
import secrets

from ..transcript.transcripts import MerlinFieldTranscript
from ..utils.config import resolve_device
from . import verifier as _verifier


class PolymathError(Exception):
    pass


class Rng:
    """RNG façade (replaces the caller-supplied ``impl Rng`` of reference
    prover.rs:110 / generator.rs:72-77).

    Default (seed=None) is a CSPRNG (`secrets.SystemRandom`): the trapdoors
    x, z and the blinding poly r_a protect zero-knowledge, so predictable
    randomness is a soundness/privacy bug.  Pass a seed ONLY for
    reproducible tests/fixtures — that mode uses a Mersenne Twister and is
    not cryptographically secure."""

    def __init__(self, seed=None):
        self._r = secrets.SystemRandom() if seed is None else random.Random(seed)

    def randrange(self, *args):
        return self._r.randrange(*args)


class Polymath:
    def __init__(self, transcript=MerlinFieldTranscript, device=None):
        self.transcript = transcript
        self.device = resolve_device(device)

    # -- setup ------------------------------------------------------------
    def setup(self, circuit, rng=None):
        from ..ops.srs import generate_proving_key_device
        pk = generate_proving_key_device(circuit, rng or Rng(), self.device)
        return pk, pk.vk

    # -- prove ------------------------------------------------------------
    def prove(self, pk, circuit, rng=None):
        from ..ops.prover import create_proof_device
        return create_proof_device(circuit, pk, rng or Rng(),
                                   self.transcript, self.device)

    # -- verify -----------------------------------------------------------
    def process_vk(self, vk):
        return vk

    def verify(self, vk, public_inputs, proof) -> bool:
        return _verifier.verify_proof(vk, proof, public_inputs, self.transcript)
