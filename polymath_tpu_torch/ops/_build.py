"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/<name>.cu`` compiles on its own into ``build/lib<name>.so`` at
first use, with a plain C interface (no PyTorch headers, so a build takes
seconds).  ``build_all()`` starts one ``nvcc`` per source at once; a
library is rebuilt only when it is older than its sources or its ptxas
report (``build/lib<name>.ptxas.txt``, kept beside it) is missing.
Nothing here runs at import time: this module is imported on machines
without nvcc.
"""

from __future__ import annotations

import ctypes
import math
import os
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(os.path.dirname(_PKG), "build")
SOURCES = ("field", "g1", "scan", "ntt", "primbench", "gather_variants")
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


def _stale(name: str) -> bool:
    so = library_path(name)
    if not os.path.exists(so) or not os.path.exists(report_path(name)):
        return True
    deps = [os.path.join(CSRC, f"{name}.cu")] + [
        os.path.join(CSRC, h) for h in os.listdir(CSRC) if h.endswith(".cuh")]
    return os.path.getmtime(so) < max(os.path.getmtime(d) for d in deps)


def _start(name: str):
    os.makedirs(BUILD, exist_ok=True)
    cmd = [cuda_tool("nvcc")] + NVCC_FLAGS + [
        "-o", library_path(name), os.path.join(CSRC, f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_all(names=SOURCES) -> dict:
    """Compile every stale source in parallel; raises on any failure.
    Returns {name: seconds} for the sources it built."""
    t0 = time.time()
    procs = {n: _start(n) for n in names if _stale(n)}

    def finish(n, p):
        out, _ = p.communicate()
        build_log[n] = (time.time() - t0, out)
        if p.returncode == 0:
            with open(report_path(n), "w") as f:
                f.write(out)

    waits = [threading.Thread(target=finish, args=item)
             for item in procs.items()]
    for w in waits:
        w.start()
    for w in waits:
        w.join()
    failed = [f"{n}.cu:\n{build_log[n][1]}" for n, p in procs.items()
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
    import torch
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
