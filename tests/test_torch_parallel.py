"""Multi-device proving (polymath_tpu_torch/parallel/) on the CPU: gloo
ranks through parallel/launch.py, one in this process or several spawned,
held against the JAX package's JAX-free oracles and its host prover:

* ``ntt_sharded`` forward and inverse at d in {1, 2, 4}, n in {64, 4096},
  against poly_host.Radix2Domain and bit for bit against the port's
  ops.ntt.ntt, with the stage-1 chain (inverse, pad to 2n, forward,
  square, inverse);
* the sharded MSM at d in {1, 2, 4} against hostmath G1.msm: a point
  count that leaves the last rank short, the host tail on and off, the
  chunk, window and scan overrides, a rank with no points, and the
  collision flag firing on one rank only (every rank reruns safe);
* the sharded prove of reduced MiMC (15 rounds, n = 64) at d in
  {1, 2, 4}, each rank from its own Rng: every rank's bytes equal the JAX
  package's host prover's and the port's create_proof_device's for the
  same key and rank 0's Rng; it verifies and a wrong public input fails;
* run_ranks raising for failing ranks and past its timeout, and no
  fallback: the dry run without a card, more cuda ranks than cards, no
  NCCL, and a kernel operand on another card than the current one.

At most five tests spawn ranks; each run has a timeout of 120 s or less.
"""

import functools
import random
import time

import numpy as np
import pytest
import torch

from polymath_tpu.circuits.mimc import MiMCDemo as RefMiMC
from polymath_tpu.frontend.r1cs import (
    ConstraintSystem as RefCS, synthesize as ref_synthesize,
)
from polymath_tpu.hostmath import bls12_381 as ref_bls
from polymath_tpu.native import g1_msm as ref_g1_msm
from polymath_tpu.protocol import Polymath as RefPolymath, Rng as RefRng
from polymath_tpu.protocol.poly_host import Radix2Domain
from polymath_tpu.protocol.prover import (
    create_proof_with_assignment as ref_create_proof,
)
from polymath_tpu.transcript import MerlinFieldTranscript as RefMerlin

from polymath_tpu_torch.hostmath import bls12_381 as bls
from polymath_tpu_torch.hostmath.bls12_381 import R
from polymath_tpu_torch.ops import _build
from polymath_tpu_torch.ops.curve import points_to_device
from polymath_tpu_torch.ops.limbs import FR_SPEC, ints_to_words
from polymath_tpu_torch.ops.ntt import ntt
from polymath_tpu_torch.ops.prover import (
    LocalOps, create_proof_device, fr_ints_to_mont_device,
)
from polymath_tpu_torch.parallel import dryrun, launch, mesh as mesh_mod
from polymath_tpu_torch.parallel.ntt_sharded import bailey_split
from polymath_tpu_torch.protocol import Rng, keys
from polymath_tpu_torch.transcript import MerlinFieldTranscript

TIMEOUT = 120


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _coeffs(n, seed):
    rng = random.Random(seed)
    return tuple(rng.randrange(R) for _ in range(n))


@functools.lru_cache(maxsize=None)
def _expected_transforms(n):
    """What ``dryrun.transforms`` of ``_coeffs(n, n)`` must give: canonical
    ints from the host domain, words from the port on one device."""
    coeffs = list(_coeffs(n, n))
    dom = Radix2Domain(n)
    a = fr_ints_to_mont_device(coeffs, "cpu")
    local = LocalOps("cpu")
    words = {"forward": ntt(a), "inverse": ntt(a, inverse=True), "back": a,
             "chain": local.square(local.coeffs(a))}
    return ({"forward": dom.fft(coeffs), "inverse": dom.ifft(coeffs),
             "back": coeffs}, {k: w.numpy() for k, w in words.items()})


def _check_transforms(got, n):
    """One rank's ``dryrun.transforms`` of ``_coeffs(n, n)``: the host
    domain, and the port's single-device words."""
    host, words = _expected_transforms(n)
    for k, want in host.items():
        assert dryrun.canonical(got[k]) == want, k
    for k, want in words.items():
        assert np.array_equal(got[k], want), k


def _ref_points(n, seed):
    """n distinct points of the JAX package's G1 (host)."""
    rng = random.Random(seed)
    cur = ref_bls.G1.mul(ref_bls.G1.gen, rng.randrange(1, R))
    step = ref_bls.G1.mul(ref_bls.G1.gen, rng.randrange(1, R))
    pts = []
    for _ in range(n):
        pts.append(cur)
        cur = ref_bls.G1.add(cur, step)
    return pts


def _rows(ref_pts):
    port = [None if p is None else (bls.Fq(p[0].v), bls.Fq(p[1].v))
            for p in ref_pts]
    return points_to_device(port).T.contiguous().numpy()


def _ints(p):
    return None if p is None else (p[0].v, p[1].v)


def _msm_cases(d):
    """(call, expected point) pairs for one group of d ranks: 33d + 3
    points in chunks of 32, so that every rank peels a host tail of 1-4
    points and the last rank's block is shorter, with the tail on and off
    and with other c and seq; 5 points (at d = 4 a rank has none); and 2d
    points whose last two, in the last rank's block, are one point with
    equal scalars (its collision flag fires, the others' do not)."""
    m = 33 * d + 3
    pts = _ref_points(m, 5)
    sc = list(_coeffs(m, 6))
    rows, words = _rows(pts), ints_to_words(sc, FR_SPEC.L)
    want = _ints(ref_bls.G1.msm(pts, sc))
    cases = []
    for env in ({}, {"POLYMATH_MSM_TAIL": "0"},
                {"POLYMATH_MSM_C": "5", "POLYMATH_MSM_SEQ": "2"}):
        env = dict(env, POLYMATH_MSM_CHUNK="32")
        cases.append(((dryrun.msm, (rows, words), env), (want, False)))
    cases.append(((dryrun.msm, (rows, words, False, 5), {}),
                  (_ints(ref_bls.G1.msm(pts[:5], sc[:5])), False)))
    dup = pts[:2 * d - 2] + [pts[0], pts[0]]
    dsc = sc[:2 * d - 2] + [5, 5]
    cases.append(((dryrun.msm, (_rows(dup), ints_to_words(dsc, FR_SPEC.L),
                                True), {}),
                  (_ints(ref_g1_msm(dup, dsc)), True)))
    return cases


def test_ntt_sharded_one_rank():
    """d = 1 in this process: n = 64 and 4096, and the 2n chain."""
    for n in (64, 4096):
        got = launch.run_ranks(dryrun.transforms, 1, "cpu", TIMEOUT,
                               list(_coeffs(n, n)))[0]
        _check_transforms(got, n)


def test_msm_sharded_one_rank():
    cases = _msm_cases(1)
    got = launch.run_ranks(dryrun.steps, 1, "cpu", TIMEOUT,
                           [call for call, _ in cases])[0]
    assert got == [{"point": point, "rerun": rerun}
                   for _, (point, rerun) in cases]


@pytest.mark.parametrize("d", [2, 4])
def test_ntt_and_msm_sharded_across_ranks(d):
    """One group of d spawned ranks: the transforms at n = 64 and 4096
    (each rank holds several columns of both Bailey factors at 4096), then
    the MSM cases; every rank must give the expected words and points."""
    sizes = (64, 4096)
    msm = _msm_cases(d)
    calls = [(dryrun.transforms, (list(_coeffs(n, n)),), {}) for n in sizes]
    calls += [call for call, _ in msm]
    t0 = time.monotonic()
    results = launch.run_ranks(dryrun.steps, d, "cpu", TIMEOUT, calls)
    assert time.monotonic() - t0 < TIMEOUT
    assert len(results) == d
    for res in results:
        for got, n in zip(res, sizes):
            _check_transforms(got, n)
        for got, (_, (point, rerun)) in zip(res[len(sizes):], msm):
            assert got == {"point": point, "rerun": rerun}


def test_bailey_split_limits():
    assert bailey_split(1 << 21, 1) == (1 << 10, 1 << 11)
    assert bailey_split(1 << 22, 4) == (1 << 11, 1 << 11)
    assert bailey_split(64, 4) == (8, 8)
    with pytest.raises(ValueError, match="n <= 2\\^22"):
        bailey_split(1 << 23, 1)
    with pytest.raises(ValueError, match="multiples of the 4 ranks"):
        bailey_split(8, 4)
    with pytest.raises(ValueError, match="power of two"):
        bailey_split(96, 2)


@pytest.fixture(scope="module")
def mimc_case(tmp_path_factory):
    """The dry run's reduced MiMC (15 rounds) keyed by the JAX package's
    host setup from Rng(3) and written by its save_dir; the JAX host
    prover's proof from Rng(4) (the native G1 MSM in its MSM hook, as
    tests/test_torch_prover.py), and the port's single-device proof from
    the same key read by keys.load_dir."""
    circuit, public, _, seed = dryrun.job_circuit("mimc", dryrun.MIMC_ROUNDS)
    c = circuit()
    ref_circuit = RefMiMC(c.xl, c.xr, c.constants)
    pk_dir = str(tmp_path_factory.mktemp("mimc_key"))
    ref = RefPolymath(transcript=RefMerlin, backend="host")
    ref_pk, _ = ref.setup(RefMiMC(constants=c.constants),
                          RefRng(dryrun.MIMC_SEED))
    ref_pk.save_dir(pk_dir)
    cs = ref_synthesize(ref_circuit, RefCS.PROVE)
    want = ref_create_proof(ref_pk, cs.instance_assignment,
                            cs.witness_assignment, RefRng(seed), RefMerlin,
                            msm=lambda s, p: ref_g1_msm(p[:len(s)], s))
    pk = keys.load_dir(pk_dir, "cpu")
    single = create_proof_device(circuit(), pk, Rng(seed),
                                 MerlinFieldTranscript, "cpu")
    assert single.to_bytes() == want.to_bytes()
    return pk_dir, want.to_bytes()


@pytest.mark.parametrize("d", [1, 2, 4])
def test_sharded_prove_equals_the_host_proof(mimc_case, d):
    """Rank r proves from Rng(4 + r); r_a comes from rank 0, so every
    rank's proof is the one made from Rng(4)."""
    pk_dir, want = mimc_case
    results = launch.run_ranks(dryrun.prove_rank, d, "cpu", TIMEOUT,
                               "mimc", dryrun.MIMC_ROUNDS, pk_dir, 1, True,
                               False)
    assert len(results) == d
    for res in results:
        assert res["sharded"] == [want]
        assert res["verified"] and res["wrong_public_rejected"]
        calls = {k: v["calls"] for k, v in res["collectives"].items()}
        assert calls == {"all_to_all": 11, "all_gather": 9, "broadcast": 1}


def test_run_ranks_raises_for_failing_ranks_and_past_its_timeout(tmp_path):
    """Ranks that raise (a key dir that is not there) make run_ranks raise
    well within its timeout, naming the error; a run still going at its
    timeout is killed and raises."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="FileNotFoundError|No such"):
        launch.run_ranks(dryrun.prove_rank, 2, "cpu", 60, "mimc", 15,
                         str(tmp_path / "missing"), 1, False, False)
    assert time.monotonic() - t0 < 60
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="all ranks killed"):
        launch.run_ranks(dryrun.transforms, 2, "cpu", 0.3,
                         list(_coeffs(64, 1)))
    assert time.monotonic() - t0 < 40


def test_dry_run_needs_a_card_or_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun.main([])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        launch.run_ranks(dryrun.transforms, 1, "cuda", 10, [1, 2])


def test_no_fallback_for_more_ranks_than_cards(monkeypatch):
    """More cuda ranks than cards raise before any rank starts; so does a
    torch without NCCL; nothing drops to gloo or to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 cuda ranks asked for, 1 "
                                           "cards visible"):
        dryrun.main(["--ranks", "2"])
    monkeypatch.setattr(torch.distributed, "is_nccl_available",
                        lambda: False)
    with pytest.raises(RuntimeError, match="no nccl"):
        launch.check_ranks(1, "cuda")
    assert launch.check_ranks(4, "cpu") == "gloo"


def test_make_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="no process group"):
        mesh_mod.make_mesh()


def test_kernel_operand_on_another_card_raises(monkeypatch):
    """The wrappers launch through _build.stream, which refuses an
    operand that is not on the current card (a rank that skipped
    torch.cuda.set_device)."""
    class Operand:
        device = torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(RuntimeError, match="current device is cuda:0"):
        _build.stream(Operand())
