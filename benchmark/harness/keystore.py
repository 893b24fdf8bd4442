"""The proving key of a configuration, made once a checkout and then loaded.

A prover makes its key once a circuit and proves many statements with it,
so the first run of a cell in a checkout runs setup from the
configuration's setup seed and writes the key; every later run loads it.
Keys live in ``benchmark/.cache/keys/`` (a fixed path inside the
checkout, kept out of git), named by configuration, setup seed and a hash
of the program's sources, of the configuration's file and of the circuit
kind's module: a key made by other code is never loaded.  A key is
written under an exclusive lock to ``<name>.partial`` and renamed when
whole; a ``.partial`` left by a run that was cut is removed.
"""

from __future__ import annotations

import fcntl
import gc
import hashlib
import os
import shutil
import time

from .spec import HERE, ROOT

KEYS = os.path.join(HERE, ".cache", "keys")
PROGRAM = "polymath_tpu_torch"
#: the program's files that make a key: sources, never build outputs
SOURCE_SUFFIXES = (".py", ".cu", ".cuh", ".cpp", ".h")


def source_hash(extra_files=(), program_dir: str | None = None) -> str:
    """SHA-256 (16 hex digits) of every source file of the program, by
    relative path and content, and of ``extra_files``, by file name and
    content."""
    top = program_dir or os.path.join(ROOT, PROGRAM)
    digest = hashlib.sha256()
    files = []
    for d, dirs, names in os.walk(top):
        dirs[:] = sorted(x for x in dirs if x != "__pycache__")
        files += [os.path.join(d, n) for n in names
                  if n.endswith(SOURCE_SUFFIXES)]
    named = [(os.path.relpath(p, top), p) for p in sorted(files)]
    named += [(os.path.basename(p), p) for p in extra_files]
    for name, path in named:
        with open(path, "rb") as f:
            digest.update(name.encode() + b"\0" + f.read() + b"\0")
    return digest.hexdigest()[:16]


def key_dir(config_name: str, setup_seed: int, digest: str,
            keys: str = KEYS) -> str:
    return os.path.join(keys, f"{config_name}_s{setup_seed}_{digest}.dir")


def sync(device) -> None:
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def load_or_make(path: str, make, device) -> tuple:
    """(proving key, seconds to load it, whether this run made it).
    ``make()`` returns a fresh key from setup; it is written to ``path``
    and then loaded, so that every run proves with a key read from disk."""
    from polymath_tpu_torch.protocol import keys
    made = False
    if not os.path.isdir(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path + ".lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not os.path.isdir(path):
                partial = path + ".partial"
                shutil.rmtree(partial, ignore_errors=True)
                pk = make()
                keys.save_dir(pk, partial)
                del pk
                gc.collect()
                os.rename(partial, path)
                made = True
    sync(device)
    t0 = time.perf_counter()
    pk = keys.load_dir(path, device)
    sync(device)
    return pk, time.perf_counter() - t0, made
