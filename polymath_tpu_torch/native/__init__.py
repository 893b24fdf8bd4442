"""Native (C++) host module: hashes, STROBE, and the pairing check.

Built lazily with g++ into ``libpolymath_native.so``; all entry points have
pure-Python fallbacks, so the package works without a toolchain.  Use
``native_available()`` to check, ``ensure_built()`` to force a build.

The library is compiled for the host's own CPU (``-march=native``), so a
sidecar beside it (``libpolymath_native.so.build.json``) records the g++
command and the host's CPU flags (from /proc/cpuinfo); a library whose
sidecar differs, as on a host with another CPU, is rebuilt.
"""

from __future__ import annotations

import ctypes
import fcntl
import json
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libpolymath_native.so")
_SIDECAR = _SO + ".build.json"
_SOURCES = [os.path.join(_DIR, "hashes.cpp"), os.path.join(_DIR, "pairing.cpp")]

_lock = threading.Lock()
_lib = None
_build_failed = False


def _command(out: str) -> list:
    # -march=native: the pairing/MSM hot loops are 64x64->128 mul chains
    # (CIOS); letting gcc use ADX/BMI2 on the build host is worth ~15-20% of
    # verify latency.  The .so is machine-local (never shipped), and the
    # sidecar ties it to this host's CPU.
    return ["g++", "-O3", "-march=native", "-funroll-loops", "-shared",
            "-fPIC", "-o", out] + _SOURCES


def _cpu_flags() -> list:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return sorted(line.split(":", 1)[1].split())
    except OSError:
        pass
    return []


def _build_id() -> dict:
    """What the library must have been built with to be reused here."""
    return {"command": _command(_SO), "cpu_flags": _cpu_flags()}


def _fresh(newest_src: float) -> bool:
    if not os.path.exists(_SO) or os.path.getmtime(_SO) < newest_src:
        return False
    try:
        with open(_SIDECAR) as f:
            return json.load(f) == _build_id()
    except (OSError, ValueError):
        return False


def _build() -> bool:
    try:
        newest_src = max(os.path.getmtime(s) for s in _SOURCES)
        if _fresh(newest_src):
            return True
        # one build per checkout: processes that need the library at the
        # same time (parallel test workers) wait on the lock file, and the
        # library appears under its name only once it is complete
        with open(_SO + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if _fresh(newest_src):
                return True
            tmp = f"{_SO}.{os.getpid()}.tmp"
            subprocess.run(_command(tmp), check=True, capture_output=True,
                           timeout=300)
            os.replace(tmp, _SO)
            with open(tmp, "w") as f:
                json.dump(_build_id(), f)
            os.replace(tmp, _SIDECAR)
        return True
    except Exception:
        return False


def get_lib():
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        if not _build():
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            _build_failed = True
            return None
        lib.pm_keccak256.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                     ctypes.c_char_p]
        lib.pm_blake3.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                  ctypes.c_char_p]
        lib.pm_strobe_init.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                       ctypes.c_size_t]
        lib.pm_strobe_meta_ad.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                          ctypes.c_size_t, ctypes.c_int]
        lib.pm_strobe_ad.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                     ctypes.c_size_t, ctypes.c_int]
        lib.pm_strobe_prf.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                      ctypes.c_size_t, ctypes.c_int]
        lib.pm_multi_pairing_is_one.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t]
        lib.pm_multi_pairing_is_one.restype = ctypes.c_int
        for name in ("pm_g1_msm", "pm_g2_msm"):
            fn = getattr(lib, name, None)
            if fn is not None:
                fn.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                               ctypes.c_int, ctypes.c_char_p]
                fn.restype = ctypes.c_int
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def keccak256(data: bytes) -> bytes:
    lib = get_lib()
    if lib is None:
        from ..transcript.keccak import keccak256 as py
        return py(data)
    out = ctypes.create_string_buffer(32)
    lib.pm_keccak256(data, len(data), out)
    return out.raw


def blake3(data: bytes) -> bytes:
    lib = get_lib()
    if lib is None:
        from ..transcript.blake3_py import blake3 as py
        return py(data, 32)
    out = ctypes.create_string_buffer(32)
    lib.pm_blake3(data, len(data), out)
    return out.raw


class NativeStrobe:
    """merlin-flavor STROBE-128 backed by the C implementation."""

    def __init__(self, protocol_label: bytes, _blob=None):
        lib = get_lib()
        assert lib is not None
        self._lib = lib
        if _blob is not None:
            self._blob = ctypes.create_string_buffer(_blob, 204)
            return
        self._blob = ctypes.create_string_buffer(204)
        lib.pm_strobe_init(self._blob, protocol_label, len(protocol_label))

    def meta_ad(self, data: bytes, more: bool):
        self._lib.pm_strobe_meta_ad(self._blob, data, len(data), int(more))

    def ad(self, data: bytes, more: bool):
        self._lib.pm_strobe_ad(self._blob, data, len(data), int(more))

    def prf(self, n: int, more: bool) -> bytes:
        out = ctypes.create_string_buffer(n)
        self._lib.pm_strobe_prf(self._blob, out, n, int(more))
        return out.raw

    def key(self, data: bytes, more: bool):
        raise NotImplementedError

    def clone(self) -> "NativeStrobe":
        return NativeStrobe(b"", _blob=self._blob.raw)


# -- pairing ----------------------------------------------------------------

_FROB_CACHE = None
_HARD_EXP_CACHE = None


def _pairing_consts():
    global _FROB_CACHE, _HARD_EXP_CACHE
    if _FROB_CACHE is None:
        from ..hostmath import bls12_381 as bls
        fb = b""
        for el in (bls._XI_Q_THIRD, bls._XI_Q_2THIRD, bls._XI_Q_SIXTH):
            fb += el.c0.v.to_bytes(48, "little") + el.c1.v.to_bytes(48, "little")
        _FROB_CACHE = fb
        hard = (bls.Q ** 4 - bls.Q ** 2 + 1) // bls.R
        _HARD_EXP_CACHE = hard.to_bytes((hard.bit_length() + 7) // 8, "little")
    return _FROB_CACHE, _HARD_EXP_CACHE


def multi_pairing_is_one(g1_points, g2_points) -> bool:
    """Native product-of-pairings == 1 check; falls back to Python."""
    lib = get_lib()
    if lib is None:
        from ..hostmath import bls12_381 as bls
        return bls.multi_pairing(g1_points, g2_points) == bls.Fq12.one()
    g1b = b""
    for p in g1_points:
        if p is None:
            g1b += bytes(96) + b"\x01"
        else:
            g1b += (p[0].v.to_bytes(48, "little")
                    + p[1].v.to_bytes(48, "little") + b"\x00")
    g2b = b""
    for p in g2_points:
        if p is None:
            g2b += bytes(192) + b"\x01"
        else:
            g2b += (p[0].c0.v.to_bytes(48, "little")
                    + p[0].c1.v.to_bytes(48, "little")
                    + p[1].c0.v.to_bytes(48, "little")
                    + p[1].c1.v.to_bytes(48, "little") + b"\x00")
    frob, hard = _pairing_consts()
    res = lib.pm_multi_pairing_is_one(g1b, g2b, len(g1_points), frob,
                                      hard, len(hard))
    if res < 0:
        from ..hostmath import bls12_381 as bls
        return bls.multi_pairing(g1_points, g2_points) == bls.Fq12.one()
    return bool(res)


# -- verifier MSMs ----------------------------------------------------------
# The verifier's 3-term G1 / 2-term G2 MSMs (reference verifier.rs:44-48)
# cost ~55 ms of the 83 ms verify in pure Python; the native double-and-add
# runs them in ~0.1 ms.  The pure-Python G1.msm/G2.msm stay the test oracle.

def g1_msm(points, scalars) -> "object":
    """Host affine G1 points (or None) + int scalars -> affine point."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "pm_g1_msm"):
        from ..hostmath import bls12_381 as bls
        return bls.G1.msm(points, [s % bls.R for s in scalars])
    from ..hostmath import bls12_381 as bls
    buf = b""
    sb = b""
    pairs = list(zip(points, scalars))
    for p, s in pairs:
        if p is None:
            buf += bytes(96) + b"\x01"
        else:
            buf += (p[0].v.to_bytes(48, "little")
                    + p[1].v.to_bytes(48, "little") + b"\x00")
        sb += (s % bls.R).to_bytes(32, "little")
    out = ctypes.create_string_buffer(97)
    lib.pm_g1_msm(buf, sb, len(pairs), out)
    raw = out.raw
    if raw[96]:
        return None
    return (bls.Fq(int.from_bytes(raw[:48], "little")),
            bls.Fq(int.from_bytes(raw[48:96], "little")))


def g2_msm(points, scalars) -> "object":
    lib = get_lib()
    if lib is None or not hasattr(lib, "pm_g2_msm"):
        from ..hostmath import bls12_381 as bls
        return bls.G2.msm(points, [s % bls.R for s in scalars])
    from ..hostmath import bls12_381 as bls
    buf = b""
    sb = b""
    pairs = list(zip(points, scalars))
    for p, s in pairs:
        if p is None:
            buf += bytes(192) + b"\x01"
        else:
            buf += (p[0].c0.v.to_bytes(48, "little")
                    + p[0].c1.v.to_bytes(48, "little")
                    + p[1].c0.v.to_bytes(48, "little")
                    + p[1].c1.v.to_bytes(48, "little") + b"\x00")
        sb += (s % bls.R).to_bytes(32, "little")
    out = ctypes.create_string_buffer(193)
    lib.pm_g2_msm(buf, sb, len(pairs), out)
    raw = out.raw
    if raw[192]:
        return None
    x = bls.Fq2(bls.Fq(int.from_bytes(raw[:48], "little")),
                bls.Fq(int.from_bytes(raw[48:96], "little")))
    y = bls.Fq2(bls.Fq(int.from_bytes(raw[96:144], "little")),
                bls.Fq(int.from_bytes(raw[144:192], "little")))
    return (x, y)
