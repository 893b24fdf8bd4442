"""Start the ranks of a multi-device run: the port's stand-in for the
reference's single-process JAX mesh.

    results = run_ranks(fn, ranks, device, timeout_s, *args)

calls ``fn(mesh, *args)`` on every rank (``mesh``: parallel/mesh.py) and
returns the ranks' results in rank order.

* One rank runs in the caller's process (its arguments and result may be
  anything); more ranks are processes started with the ``spawn`` method
  (never ``fork``), so ``fn`` must be a module-level function of an
  importable module, and its arguments and result must pickle.  A CPU
  rank runs one intra-op thread.
* The group meets through a ``torch.distributed.FileStore`` in a fresh
  temporary directory, not a TCP port, so concurrent runs cannot collide;
  ``init_process_group`` gets ``timeout=timeout_s``.
* A rank that raises or exits without a result, or a run still going
  after ``timeout_s``, kills every rank and raises in the caller.
* On cuda, rank r calls ``torch.cuda.set_device(r)`` before its group
  exists and before any kernel (the kernel wrappers launch on the current
  device and raise for an operand on another card).
* No fallback: cuda takes NCCL and the CPU gloo (``mesh.BACKENDS``); more
  cuda ranks than visible cards, or a missing backend, raises.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from .mesh import BACKENDS, make_mesh


def check_ranks(ranks: int, device) -> str:
    """The backend for ``ranks`` ranks on ``device``'s type; raises if this
    machine cannot run them."""
    device = torch.device(device)
    if device.type not in BACKENDS:
        raise ValueError(f"run_ranks: no backend for {device}")
    if ranks < 1:
        raise ValueError(f"run_ranks: {ranks} ranks")
    backend = BACKENDS[device.type]
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("run_ranks: cuda ranks asked for and no CUDA "
                               "card is visible")
        if ranks > torch.cuda.device_count():
            raise RuntimeError(f"run_ranks: {ranks} cuda ranks asked for, "
                               f"{torch.cuda.device_count()} cards visible")
        available = dist.is_nccl_available()
    else:
        available = dist.is_gloo_available()
    if not available:
        raise RuntimeError(f"run_ranks: torch.distributed has no {backend}")
    return backend


def _join_group(rank: int, ranks: int, device_type: str, store_path: str,
                timeout_s: float):
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    store = dist.FileStore(store_path, ranks)
    dist.init_process_group(
        BACKENDS[device_type], store=store, rank=rank, world_size=ranks,
        timeout=datetime.timedelta(seconds=timeout_s))
    device = torch.device("cuda", rank) if device_type == "cuda" else "cpu"
    return make_mesh(device)


def _run(rank, ranks, device_type, store_path, timeout_s, fn, args):
    mesh = _join_group(rank, ranks, device_type, store_path, timeout_s)
    try:
        return fn(mesh, *args)
    finally:
        dist.destroy_process_group()


def _rank_main(rank, ranks, device_type, store_path, timeout_s, call_path,
               results):
    """A spawned rank: runs the pickled ``(fn, args)`` of ``call_path`` and
    reports (rank, ok, result or traceback) to the caller."""
    if device_type == "cpu":
        torch.set_num_threads(1)
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        out = _run(rank, ranks, device_type, store_path, timeout_s, fn, args)
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, out))


def _collect(procs, results, timeout_s: float) -> list:
    deadline = time.monotonic() + timeout_s
    got = {}
    while len(got) < len(procs):
        left = deadline - time.monotonic()
        if left <= 0:
            missing = sorted(set(range(len(procs))) - set(got))
            raise TimeoutError(f"run_ranks: ranks {missing} gave no result "
                               f"within {timeout_s} s; all ranks killed")
        try:
            rank, ok, value = results.get(timeout=min(left, 0.5))
        except queue.Empty:
            dead = {r: p.exitcode for r, p in enumerate(procs)
                    if r not in got and p.exitcode not in (None, 0)}
            if dead:
                raise RuntimeError(f"run_ranks: ranks exited without a "
                                   f"result (rank: exit code) {dead}")
            continue
        if not ok:
            raise RuntimeError(f"run_ranks: rank {rank} raised; all ranks "
                               f"killed:\n{value}")
        got[rank] = value
    return [got[r] for r in range(len(procs))]


def run_ranks(fn, ranks: int, device, timeout_s: float, *args) -> list:
    """``fn(mesh, *args)`` on each of ``ranks`` ranks on ``device``'s type
    (see the module docstring); returns the results in rank order."""
    device_type = torch.device(device).type
    check_ranks(ranks, device)
    store_dir = tempfile.mkdtemp(prefix="polymath_ranks.")
    store_path = os.path.join(store_dir, "store")
    try:
        if ranks == 1:
            return [_run(0, 1, device_type, store_path, timeout_s, fn,
                         args)]
        # the call goes through a file: a start blocks until its child has
        # read what spawn sends it, so large arguments there would start
        # the ranks one after another
        call_path = os.path.join(store_dir, "call.pickle")
        with open(call_path, "wb") as f:
            pickle.dump((fn, args), f)
        ctx = multiprocessing.get_context("spawn")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, ranks, device_type, store_path, timeout_s, call_path,
            results)) for r in range(ranks)]
        try:
            for p in procs:
                p.start()
            return _collect(procs, results, timeout_s)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=30)
            results.close()
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
