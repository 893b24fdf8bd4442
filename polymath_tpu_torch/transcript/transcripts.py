"""The three Fiat–Shamir transcript flavors of the reference.

Mirrors ``src/transcript/{mod,merlin,keccak256,blake3}.rs``: a common
``Transcript`` interface with ``new(name) / append_message / challenge``
producing Fr challenges.

Challenge derivations:
  * Merlin: 64-byte PRF squeeze; take the first 32 bytes LE, mask down to
    255 bits (arkworks ``from_random_bytes``: shave bits above
    MODULUS_BIT_SIZE), accept iff < r, else squeeze again
    (merlin.rs:27-35 rejection loop).
  * Keccak256 / Blake3: running byte buffer; challenge = H(buf || label)
    interpreted big-endian mod r; buffer := hash (keccak256.rs:26-41,
    blake3.rs:26-41).
"""

from __future__ import annotations

from ..hostmath.bls12_381 import R
from .strobe import MerlinTranscript
from .keccak import keccak256
from .blake3_py import blake3

_FR_MASK = (1 << 255) - 1  # shave to MODULUS_BIT_SIZE bits


class Transcript:
    """Abstract transcript interface (reference transcript/mod.rs:17-29)."""

    name = "abstract"

    def __init__(self, name: bytes):
        raise NotImplementedError

    def append_message(self, label: bytes, message: bytes):
        raise NotImplementedError

    def challenge(self, label: bytes) -> int:
        """Return an Fr challenge as a canonical int."""
        raise NotImplementedError


class MerlinFieldTranscript(Transcript):
    """Default transcript (STROBE-128 Merlin), reference merlin.rs.
    Uses the native C STROBE when available (bit-identical)."""

    name = "merlin"

    def __init__(self, name: bytes):
        try:
            from ..native import NativeStrobe, native_available
            if native_available():
                self.t = _NativeMerlin(name)
            else:
                self.t = MerlinTranscript(name)
        except Exception:
            self.t = MerlinTranscript(name)

    def append_message(self, label: bytes, message: bytes):
        self.t.append_message(label, message)

    def challenge(self, label: bytes) -> int:
        while True:
            buf = self.t.challenge_bytes(label, 64)
            x = int.from_bytes(buf[:32], "little") & _FR_MASK
            if x < R:
                return x


class _NativeMerlin:
    """merlin::Transcript over the native STROBE implementation."""

    def __init__(self, label: bytes):
        from ..native import NativeStrobe
        self.strobe = NativeStrobe(MerlinTranscript.MERLIN_PROTOCOL_LABEL)
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes):
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(len(message).to_bytes(4, "little"), True)
        self.strobe.ad(message, False)

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(n.to_bytes(4, "little"), True)
        return self.strobe.prf(n, False)


class _BufferHashTranscript(Transcript):
    """Shared state machine of the Keccak256 and Blake3 transcripts."""

    _hash = None  # staticmethod(bytes -> 32 bytes)

    def __init__(self, name: bytes):
        # NB: the reference ignores `name` for these transcripts.
        self.buf = bytearray()

    def append_message(self, label: bytes, message: bytes):
        self.buf += label
        self.buf += message

    def challenge(self, label: bytes) -> int:
        digest = type(self)._hash(bytes(self.buf) + label)
        self.buf = bytearray(digest)
        return int.from_bytes(digest, "big") % R


def _keccak_dispatch(data: bytes) -> bytes:
    from .. import native
    return native.keccak256(data)  # native when available, Python otherwise


def _blake3_dispatch(data: bytes) -> bytes:
    from .. import native
    return native.blake3(data)


class Keccak256Transcript(_BufferHashTranscript):
    name = "keccak256"
    _hash = staticmethod(_keccak_dispatch)


class Blake3Transcript(_BufferHashTranscript):
    name = "blake3"
    _hash = staticmethod(_blake3_dispatch)


ALL_TRANSCRIPTS = [MerlinFieldTranscript, Keccak256Transcript, Blake3Transcript]
