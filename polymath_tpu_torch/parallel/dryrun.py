"""Dry run of multi-device proving (counterpart of parallel/dryrun.py and
__graft_entry__.py:dryrun_multichip).

    python3 -m polymath_tpu_torch.parallel.dryrun [--device {cuda,cpu}]
        [--ranks D] [--constraints N [--pk-dir DIR]] [--timeout S]

Runs d ranks through parallel/launch.py: every visible card on cuda (the
default; it raises without a card, or for more ranks than cards), 4 gloo
ranks with ``--device cpu``.  Checks, each raising on a mismatch (exit
code 1):

1. the reference's shapes (dryrun.py:22-92), n = max(64, d^2) and 8
   points a rank: the sharded NTT forward, and back from its block
   layout, against the host Radix2Domain; the sharded MSM over 8 points
   repeated (safe mode) against the host MSM;
2. the sharded NTT at n = 4096, where each rank holds several columns of
   both Bailey factors: forward, inverse and the stage-1 chain (inverse,
   pad to 2n, forward, square, inverse: ``ShardedOps``) bit for bit
   against ops/ntt.py:ntt on one device, the forward against the host;
3. the reduced MiMC prove (15 rounds, n = 64, dryrun.py:95-121): every
   rank sets up from Rng(3) and proves from its own Rng(4 + rank); every
   rank's proof must have the bytes of ``create_proof_device``'s from
   Rng(4) (rank 0's: r_a is broadcast from rank 0), verify, and reject a
   wrong public input;
4. with ``--constraints N``: BenchCircuit at N constraints, a and b drawn
   from Rng(0) as bench.py does, the key read by ``keys.load_dir`` from
   ``--pk-dir`` or set up on every rank; a warm and two steady sharded
   proves from Rng(7), each byte-equal to ``create_proof_device``'s from
   Rng(7) and verified.

Prints one JSON line: ``ranks``, ``device``, the seconds of each step,
the COLLECTIVES (parallel/mesh.py) of each step and of one proof, and
``ok``.  The rank bodies (``transforms``, ``msm``, ``prove_rank``, and
``steps`` to run several in one group) are module-level so that spawned
ranks can import them.
"""

from __future__ import annotations

import argparse
import copy
import json
import random
import time

import numpy as np
import torch

from ..hostmath import bls12_381 as bls
from ..hostmath.bls12_381 import R
from ..ops.curve import points_to_device
from ..ops.limbs import FR_SPEC, ints_to_words, words_to_ints
from ..ops.ntt import ntt
from ..ops.prover import create_proof_device, fr_ints_to_mont_device
from .launch import run_ranks
from .mesh import COLLECTIVES
from .msm_sharded import msm_sharded
from .ntt_sharded import columns_of, gather, ntt_sharded, to_columns
from .prover_sharded import ShardedOps, create_proof_sharded

CHECK_SEED = 11        # the reference's run_sharded_check seed
MIMC_SEED = 3          # the reference's run_sharded_prove seed
MIMC_ROUNDS = 15
BENCH_PROVE_SEED = 7   # the proof Rng of the BenchCircuit step


def canonical(words: np.ndarray) -> list:
    """(8, n) Montgomery Fr words -> canonical ints."""
    return [FR_SPEC.from_mont_int(v) for v in words_to_ints(words)]


def point_ints(p):
    """A host affine point as picklable ints (None: the identity)."""
    return None if p is None else (p[0].v, p[1].v)


def check_inputs(n: int, npts: int, seed: int = CHECK_SEED):
    """The reference check's inputs: n coefficients, and npts points that
    repeat 8 random multiples of G, with their scalars (host ints)."""
    rng = random.Random(seed)
    coeffs = [rng.randrange(R) for _ in range(n)]
    base = [bls.G1.mul(bls.G1.gen, rng.randrange(R)) for _ in range(8)]
    pts = (base * ((npts + 7) // 8))[:npts]
    scalars = [rng.randrange(R) for _ in range(npts)]
    return coeffs, pts, scalars


# -- rank bodies (run_ranks calls each with the rank's mesh first) ----------

def transforms(mesh, coeffs: list) -> dict:
    """The sharded NTT of the (8, n) Montgomery vector of ``coeffs``:
    forward; back from the forward's block layout; inverse; and the
    stage-1 chain ``ShardedOps.square(ShardedOps.coeffs(.))``; each made
    whole, as (8, n) or (8, 2n) int32 numpy words."""
    a = fr_ints_to_mont_device(coeffs, mesh.device)
    fwd = ntt_sharded(columns_of(a, mesh), mesh)
    back = ntt_sharded(to_columns(fwd, mesh), mesh, inverse=True)
    inv = ntt_sharded(columns_of(a, mesh), mesh, inverse=True)
    ops = ShardedOps(mesh)
    chain = ops.square(ops.coeffs(a))
    out = {"forward": gather(fwd, mesh), "back": gather(back, mesh),
           "inverse": gather(inv, mesh), "chain": chain}
    return {k: v.cpu().numpy() for k, v in out.items()}


def msm(mesh, rows: np.ndarray, scalars: np.ndarray, fast: bool = False,
        n_eff: int | None = None) -> dict:
    """``msm_sharded`` of (N, 24) affine rows and (8, M) canonical scalar
    words; with ``fast``, a collision flag makes every rank rerun safe, as
    the prover does.  Returns the point as ints and whether it reran."""
    rows_t = torch.from_numpy(rows).to(mesh.device)
    sc = torch.from_numpy(scalars).to(mesh.device)
    rerun = False
    try:
        p = msm_sharded(rows_t, sc, mesh, n_eff=n_eff, fast=fast)
    except AssertionError:
        rerun = True
        p = msm_sharded(rows_t, sc, mesh, n_eff=n_eff)
    return {"point": point_ints(p), "rerun": rerun}


def steps(mesh, calls) -> list:
    """Several rank bodies in one run: ``calls`` holds (fn, args, env)
    triples, each run as ``fn(mesh, *args)`` with the environment
    variables of ``env`` set around it (utils/config.py:environ)."""
    from ..utils.config import environ
    out = []
    for fn, args, env in calls:
        with environ(**env):
            out.append(fn(mesh, *args))
    return out


def job_circuit(kind: str, size: int):
    """(circuit factory, public inputs, setup Rng, proof seed) of the
    reduced MiMC (``size`` rounds, as the reference's dry run) or
    BenchCircuit (``size`` constraints, as bench.py)."""
    from ..circuits import BenchCircuit, MiMCDemo
    from ..circuits.mimc import mimc_hash
    from ..protocol import Rng
    if kind == "mimc":
        crng = random.Random(MIMC_SEED)
        consts = [crng.randrange(R) for _ in range(size)]
        xl, xr = crng.randrange(R), crng.randrange(R)

        def circuit(witness=True):
            return MiMCDemo(xl, xr, consts) if witness else \
                MiMCDemo(constants=consts)
        return (circuit, [mimc_hash(xl, xr, consts)], Rng(MIMC_SEED),
                MIMC_SEED + 1)
    rng = Rng(0)
    a, b = rng.randrange(R), rng.randrange(R)

    def circuit(witness=True):
        return BenchCircuit(a, b, num_variables=size, num_constraints=size)
    return circuit, [a * b % R], rng, BENCH_PROVE_SEED


def _since(before: dict) -> dict:
    """COLLECTIVES counted since the snapshot ``before``."""
    return {k: {f: COLLECTIVES[k][f] - before[k][f] for f in v}
            for k, v in COLLECTIVES.items()}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def prove_rank(mesh, kind: str, size: int, pk_dir: str | None = None,
               proves: int = 1, rank_rngs: bool = False,
               single: bool = True) -> dict:
    """Sharded proves of ``job_circuit(kind, size)`` on this rank: the key
    read from ``pk_dir`` or set up here; ``proves`` proofs, each from a
    fresh Rng(seed), or Rng(seed + rank) with ``rank_rngs``; and, with
    ``single``, ``create_proof_device``'s from Rng(seed) on the same key.
    Returns the proof bytes, host verification, seconds and COLLECTIVES
    of the last sharded proof."""
    from ..protocol import Polymath, Rng, keys
    from ..transcript import MerlinFieldTranscript
    circuit, public, setup_rng, seed = job_circuit(kind, size)
    pm = Polymath(transcript=MerlinFieldTranscript, device=mesh.device)
    t0 = _sync(mesh.device)
    pk = keys.load_dir(pk_dir, mesh.device) if pk_dir else \
        pm.setup(circuit(witness=False), setup_rng)[0]
    out = {"key_s": _sync(mesh.device) - t0, "prove_s": [],
           "sharded": []}
    for _ in range(proves):
        rng = Rng(seed + mesh.rank if rank_rngs else seed)
        before = copy.deepcopy(COLLECTIVES)
        t0 = _sync(mesh.device)
        proof = create_proof_sharded(circuit(), pk, rng,
                                     MerlinFieldTranscript, mesh)
        out["prove_s"].append(_sync(mesh.device) - t0)
        out["sharded"].append(proof.to_bytes())
        out["collectives"] = _since(before)
    out["verified"] = pm.verify(pk.vk, public, proof)
    out["wrong_public_rejected"] = not pm.verify(
        pk.vk, [(public[0] + 1) % R], proof)
    if single:
        t0 = _sync(mesh.device)
        out["single"] = create_proof_device(
            circuit(), pk, Rng(seed), MerlinFieldTranscript,
            mesh.device).to_bytes()
        out["single_s"] = _sync(mesh.device) - t0
    return out


def check_rank(mesh, constraints: int | None, pk_dir: str | None) -> dict:
    """Every check's rank part (module docstring), with its seconds."""
    d = mesh.size
    n = max(64, d * d)
    coeffs, pts, scalars = check_inputs(n, 8 * d)
    rows = points_to_device(pts).T.contiguous().numpy()
    sc = ints_to_words(scalars, FR_SPEC.L)
    out = {"seconds": {}, "collectives": {}}

    def step(name, fn, *args, **kw):
        before = copy.deepcopy(COLLECTIVES)
        t0 = _sync(mesh.device)
        out[name] = fn(mesh, *args, **kw)
        out["seconds"][name] = _sync(mesh.device) - t0
        out["collectives"][name] = _since(before)

    step("ntt_check", transforms, coeffs)
    step("msm_check", msm, rows, sc)
    step("ntt_4096", transforms, check_inputs(4096, 0)[0])
    step("mimc", prove_rank, "mimc", MIMC_ROUNDS, rank_rngs=True,
         single=mesh.rank == 0)
    if constraints:
        step("bench", prove_rank, "bench", constraints, pk_dir, proves=3,
             single=True)
    return out


# -- the caller's side ---------------------------------------------------------

def _same(results, key: str, what: str):
    """Rank 0's value of ``key``, after checking that every rank has it."""
    first = results[0][key]
    for r, res in enumerate(results):
        if isinstance(first, np.ndarray):
            equal = np.array_equal(res[key], first)
        else:
            equal = res[key] == first
        if not equal:
            raise AssertionError(f"{what}: rank {r} differs from rank 0")
    return first


def check_transforms(results, coeffs: list, what: str, words: bool) -> None:
    """Every rank's ``transforms`` of ``coeffs`` against the host
    Radix2Domain, and with ``words`` bit for bit against ops/ntt.py:ntt
    on one device (the CPU) and the single-device stage-1 chain."""
    from ..ops.prover import LocalOps
    from ..protocol.poly_host import Radix2Domain
    res = [r[what] for r in results]
    got = {k: _same(res, k, f"{what} {k}") for k in res[0]}
    if canonical(got["forward"]) != Radix2Domain(len(coeffs)).fft(coeffs):
        raise AssertionError(f"{what}: sharded NTT != host Radix2Domain")
    if canonical(got["back"]) != coeffs:
        raise AssertionError(f"{what}: sharded inverse NTT did not return "
                             f"the coefficients")
    if words:
        a = fr_ints_to_mont_device(coeffs, "cpu")
        local = LocalOps("cpu")
        want = {"forward": ntt(a), "back": a, "inverse": ntt(a, True),
                "chain": local.square(local.coeffs(a))}
        for k, w in want.items():
            if not np.array_equal(got[k], w.numpy()):
                raise AssertionError(f"{what} {k}: words differ from "
                                     f"ops/ntt.py on one device")


def check_proofs(results, what: str, single_rank=None) -> dict:
    """Every rank's sharded proofs: byte-equal to the single-device proof
    (``single_rank``'s, or each rank's own), verified, a wrong public
    input rejected.  Returns rank 0's times and collectives."""
    for r, res in enumerate(results):
        job = res[what]
        want = results[single_rank][what]["single"] \
            if single_rank is not None else job["single"]
        if any(p != want for p in job["sharded"]):
            raise AssertionError(f"{what}: rank {r}'s sharded proof differs "
                                 f"from the single-device proof")
        if not job["verified"] or not job["wrong_public_rejected"]:
            raise AssertionError(f"{what}: rank {r}: verified "
                                 f"{job['verified']}, wrong public input "
                                 f"rejected {job['wrong_public_rejected']}")
    job = results[0][what]
    return {k: job[k] for k in ("key_s", "prove_s", "single_s",
                                "collectives") if k in job}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ranks", type=int, default=None,
                    help="default: every visible card on cuda, 4 on cpu")
    ap.add_argument("--constraints", type=int, default=None,
                    help="also prove BenchCircuit at this many constraints")
    ap.add_argument("--pk-dir", default=None,
                    help="with --constraints: the key (keys.save_dir) to "
                         "load instead of running setup on every rank")
    ap.add_argument("--timeout", type=float, default=900.0)
    args = ap.parse_args(argv)
    from ..utils.config import resolve_device
    device = resolve_device(None if args.device == "cuda" else "cpu")
    ranks = args.ranks or (torch.cuda.device_count()
                           if device.type == "cuda" else 4)
    t0 = time.perf_counter()
    results = run_ranks(check_rank, ranks, device.type, args.timeout,
                        args.constraints, args.pk_dir)
    wall = time.perf_counter() - t0
    n = max(64, ranks * ranks)
    coeffs, pts, scalars = check_inputs(n, 8 * ranks)
    check_transforms(results, coeffs, "ntt_check", words=False)
    if _same(results, "msm_check", "msm_check")["point"] != \
            point_ints(bls.G1.msm(pts, scalars)):
        raise AssertionError("sharded MSM != host MSM")
    check_transforms(results, check_inputs(4096, 0)[0], "ntt_4096",
                     words=True)
    line = {"ranks": ranks, "device": device.type,
            "seconds": dict(results[0]["seconds"], wall=wall),
            "mimc": check_proofs(results, "mimc", single_rank=0),
            "collectives": results[0]["collectives"]}
    if args.constraints:
        line["bench"] = dict(check_proofs(results, "bench"),
                             constraints=args.constraints)
    line["ok"] = True
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
