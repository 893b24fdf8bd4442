# Frozen copy of the program's polymath_tpu_torch/transcript/strobe.py (the benchmark's reference
# imports nothing of the program).
"""STROBE-128 duplex and a Merlin-compatible transcript.

Reproduces the behavior of the ``merlin`` crate v3 (used by the reference's
default transcript, ``src/transcript/merlin.rs``): STROBE-128 over
Keccak-f[1600] with the ``"Merlin v1.0"`` protocol label, ``append_message``
= meta-AD(label) + meta-AD(LE32(len)) + AD(data), ``challenge_bytes`` =
meta-AD(label) + meta-AD(LE32(len)) + PRF.
"""

from __future__ import annotations

from .keccak import keccak_f1600_bytes

_STROBE_R = 166  # rate for sec=128: 200 - 32 - 2

_FLAG_I = 1
_FLAG_A = 1 << 1
_FLAG_C = 1 << 2
_FLAG_T = 1 << 3
_FLAG_M = 1 << 4
_FLAG_K = 1 << 5


class Strobe128:
    """Minimal STROBE-128 supporting meta-AD / AD / PRF / KEY."""

    __slots__ = ("state", "pos", "pos_begin", "cur_flags")

    def __init__(self, protocol_label: bytes):
        state = bytearray(200)
        state[0:6] = bytes([1, _STROBE_R + 2, 1, 0, 1, 96])
        state[6:18] = b"STROBEv1.0.2"
        self.state = bytearray(keccak_f1600_bytes(bytes(state)))
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    # -- internals --------------------------------------------------------
    def _run_f(self):
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[_STROBE_R + 1] ^= 0x80
        self.state = bytearray(keccak_f1600_bytes(bytes(self.state)))
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes):
        for b in data:
            self.state[self.pos] ^= b
            self.pos += 1
            if self.pos == _STROBE_R:
                self._run_f()

    def _overwrite(self, data: bytes):
        for b in data:
            self.state[self.pos] = b
            self.pos += 1
            if self.pos == _STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == _STROBE_R:
                self._run_f()
        return bytes(out)

    def _begin_op(self, flags: int, more: bool):
        if more:
            assert self.cur_flags == flags, "cannot continue op with different flags"
            return
        assert not (flags & _FLAG_T), "transport ops not implemented"
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = bool(flags & (_FLAG_C | _FLAG_K))
        if force_f and self.pos != 0:
            self._run_f()

    # -- public ops -------------------------------------------------------
    def meta_ad(self, data: bytes, more: bool):
        self._begin_op(_FLAG_M | _FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool):
        self._begin_op(_FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(_FLAG_I | _FLAG_A | _FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool):
        self._begin_op(_FLAG_A | _FLAG_C, more)
        self._overwrite(data)

    def clone(self) -> "Strobe128":
        c = object.__new__(Strobe128)
        c.state = bytearray(self.state)
        c.pos = self.pos
        c.pos_begin = self.pos_begin
        c.cur_flags = self.cur_flags
        return c


class MerlinTranscript:
    """Behavioral clone of ``merlin::Transcript`` (v3)."""

    MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"

    def __init__(self, label: bytes):
        self.strobe = Strobe128(self.MERLIN_PROTOCOL_LABEL)
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes):
        data_len = len(message).to_bytes(4, "little")
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(data_len, True)
        self.strobe.ad(message, False)

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        data_len = n.to_bytes(4, "little")
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(data_len, True)
        return self.strobe.prf(n, False)

    def clone(self) -> "MerlinTranscript":
        c = object.__new__(MerlinTranscript)
        c.strobe = self.strobe.clone()
        return c
