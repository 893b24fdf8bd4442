"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/<name>.cu`` compiles on its own into ``build/lib<name>.so`` at
first use, with a plain C interface (no PyTorch headers, so a build takes
seconds).  ``build_all()`` starts one ``nvcc`` per source at once.

A build is safe across processes: each library is built under an
exclusive file lock (``build/lib<name>.lock``), compiled to a temporary
name and renamed into place, so no process loads a half-written file and
two processes never both compile it.  Beside each library lie its ptxas
report (``build/lib<name>.ptxas.txt``) and its stamp
(``build/lib<name>.stamp.json``): the full nvcc command, the output of
``nvcc --version`` and a SHA-256 of the ``.cu`` source and of every
``csrc/*.cuh`` header.  A library whose stamp differs from the one the
current sources, flags and toolkit would give is stale and is rebuilt.
Nothing here runs at import time: this module is imported on machines
without nvcc.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import json
import math
import os
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(os.path.dirname(_PKG), "build")
SOURCES = ("field", "g1", "scan", "tree", "ntt", "poly", "primbench",
           "gather_variants")
#: the sources setup and the prover load (the others serve the
#: measurement tools)
PATH_SOURCES = SOURCES[:6]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}
#: per-source (seconds, ptxas report) of builds done by this process
build_log: dict = {}


def cuda_tool(tool: str) -> str:
    """A CUDA toolkit program (nvcc, cuobjdump): under CUDA_HOME
    (/usr/local/cuda by default), else on PATH."""
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", tool)
    return cand if os.path.exists(cand) else tool


def library_path(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}.so")


def report_path(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}.ptxas.txt")


def ptxas_report(name: str) -> str:
    """nvcc's output (ptxas -v: registers and spills of every kernel) from
    the build of the current ``build/lib<name>.so``, whichever process made
    it."""
    with open(report_path(name)) as f:
        return f.read()


def stamp_path(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}.stamp.json")


def _command(name: str, out: str) -> list:
    return [cuda_tool("nvcc")] + NVCC_FLAGS + [
        "-o", out, os.path.join(CSRC, f"{name}.cu")]


_nvcc_version: dict = {}


def _toolkit() -> str:
    """``nvcc --version`` of the nvcc that builds, read once a process."""
    nvcc = cuda_tool("nvcc")
    if nvcc not in _nvcc_version:
        _nvcc_version[nvcc] = subprocess.run(
            [nvcc, "--version"], capture_output=True, text=True,
            check=True).stdout
    return _nvcc_version[nvcc]


def stamp(name: str) -> dict:
    """What a fresh ``lib<name>.so`` was built from: the command (with the
    final library path), the toolkit, and the hash of the source and of
    every header."""
    digest = hashlib.sha256()
    deps = [f"{name}.cu"] + sorted(h for h in os.listdir(CSRC)
                                   if h.endswith(".cuh"))
    for dep in deps:
        with open(os.path.join(CSRC, dep), "rb") as f:
            digest.update(dep.encode() + b"\0" + f.read() + b"\0")
    return {"command": _command(name, library_path(name)),
            "nvcc_version": _toolkit(), "sources_sha256": digest.hexdigest()}


def _stale(name: str) -> bool:
    if not (os.path.exists(library_path(name))
            and os.path.exists(report_path(name))):
        return True
    try:
        with open(stamp_path(name)) as f:
            return json.load(f) != stamp(name)
    except (OSError, ValueError):
        return True


def _write(path: str, text: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def build_all(names=SOURCES) -> dict:
    """Compile every stale source in parallel, each under its file lock;
    raises on any failure.  Returns {name: seconds} for the sources this
    process built (a source another process built meanwhile is skipped)."""
    os.makedirs(BUILD, exist_ok=True)
    t0 = time.time()
    locks, procs = [], {}
    try:
        for n in names:
            if not _stale(n):
                continue
            lock = open(os.path.join(BUILD, f"lib{n}.lock"), "w")
            locks.append(lock)
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not _stale(n):  # built by another process while we waited
                continue
            tmp = f"{library_path(n)}.{os.getpid()}.tmp"
            procs[n] = (tmp, stamp(n), subprocess.Popen(
                _command(n, tmp), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))

        def finish(n, tmp, made_from, p):
            out, _ = p.communicate()
            build_log[n] = (time.time() - t0, out)
            if p.returncode == 0:
                os.replace(tmp, library_path(n))
                _write(report_path(n), out)
                _write(stamp_path(n), json.dumps(made_from, indent=1))
            elif os.path.exists(tmp):
                os.remove(tmp)

        waits = [threading.Thread(target=finish, args=(n,) + item)
                 for n, item in procs.items()]
        for w in waits:
            w.start()
        for w in waits:
            w.join()
    finally:
        for lock in locks:
            lock.close()
    failed = [f"{n}.cu:\n{build_log[n][1]}" for n, (_, _, p) in procs.items()
              if p.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {n: build_log[n][0] for n in procs}


def lib(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    with _lock:
        if name not in _libs:
            if _stale(name):
                build_all((name,))
            _libs[name] = ctypes.CDLL(library_path(name))
        return _libs[name]


def declare(fn, nargs: int):
    """All exported kernels take pointers and longs (both 64-bit) and
    return cudaGetLastError() as an int."""
    fn.argtypes = [ctypes.c_void_p] * nargs
    fn.restype = ctypes.c_int
    return fn


def stream(t) -> int:
    """The stream of ``t``'s card, for a launch on the current device's
    context (ctypes launches there): raises unless they are one card, as
    they are on a rank that called ``torch.cuda.set_device`` first."""
    import torch
    current = torch.cuda.current_device()
    if t.device.index != current:
        raise RuntimeError(f"kernel operand on {t.device} but the current "
                           f"device is cuda:{current}: call "
                           f"torch.cuda.set_device({t.device.index}) first")
    return torch.cuda.current_stream(t.device).cuda_stream


def operand(t, shape, what: str):
    """A kernel operand broadcastable to ``shape`` = (K, ...batch) as a
    (K, M) or (K, 1) view whose lanes are contiguous (the row stride is
    passed to the kernel).  Returns (view, lane step): step 0 reads one
    element for the whole batch."""
    import torch
    if t.dtype != torch.int32:
        raise TypeError(f"{what}: expected int32 words, got {t.dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"{what}: operand on {t.device}, not on the card")
    K, m = shape[0], math.prod(shape[1:])
    if math.prod(t.shape[1:]) == 1 and m != 1:
        return t.reshape(K, 1), 0
    t2 = t.expand(shape).reshape(K, m)
    if t2.stride(1) != 1 and m > 1:
        t2 = t2.contiguous()
    return t2, 1


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
