"""The port's bench entry, its MSM tuning overrides and the MSM sweep, on
the CPU through the kernels' plain versions:

* each of POLYMATH_MSM_C, _SEQ, _CHUNK and _TAIL=0, set in turn: the MSM
  of a few hundred distinct points equals the native host MSM; values the
  kernels cannot take raise; unset, the schedule is today's;
* ``python3 -m polymath_tpu_torch.bench --device cpu`` on BenchCircuit at
  4 constraints (n = 16; a CPU prove through the plain versions takes
  2-3 s even there, 8 s at 60 constraints), reps 1 and 2 verifies, run
  twice: the first run sets up and writes its key dir, the second loads
  it; both print one JSON line whose proofs verified and whose fused
  proof equals the split one;
* ``tools.msmtime`` at N = 256 with two configurations: one point.
"""

import contextlib
import io
import json
import os
import random

import pytest
import torch

from polymath_tpu_torch import bench
from polymath_tpu_torch.hostmath import bls12_381 as bls
from polymath_tpu_torch.hostmath.bls12_381 import R
from polymath_tpu_torch.native import g1_msm
from polymath_tpu_torch.ops import msm as M
from polymath_tpu_torch.ops.curve import points_to_device
from polymath_tpu_torch.ops.limbs import FR_SPEC, ints_to_words
from polymath_tpu_torch.tools import msmtime

ENV = ("POLYMATH_MSM_C", "POLYMATH_MSM_SEQ", "POLYMATH_MSM_CHUNK",
       "POLYMATH_MSM_TAIL", "POLYMATH_MSM_FUSED")
BENCH_CONSTRAINTS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain PyTorch ops here are small: one intra-op thread is as fast
    and leaves the other cores to parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_overrides(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("POLYMATH_TRACE", "0")


@pytest.fixture(scope="module")
def msm_case():
    """200 distinct points (a chain of host adds), random scalars, and
    their MSM by the native host Pippenger."""
    rng = random.Random(11)
    cur = bls.G1.mul(bls.G1.gen, rng.randrange(1, R))
    step = bls.G1.mul(bls.G1.gen, rng.randrange(1, R))
    pts = []
    for _ in range(200):
        pts.append(cur)
        cur = bls.G1.add(cur, step)
    sc = [rng.randrange(R) for _ in range(200)]
    rows = points_to_device(pts).T.contiguous()
    words = torch.from_numpy(ints_to_words(sc, FR_SPEC.L))
    return rows, words, g1_msm(pts, sc)


@pytest.mark.parametrize("name, value, chunk, tails", [
    ("POLYMATH_MSM_C", "5", None, 0),
    ("POLYMATH_MSM_SEQ", "4", None, 0),
    ("POLYMATH_MSM_CHUNK", "64", None, 1),
    ("POLYMATH_MSM_TAIL", "0", 64, 0),
])
def test_override_gives_the_host_msm(msm_case, monkeypatch, name, value,
                                     chunk, tails):
    """Each override alone changes the shape the MSM runs at (200 points:
    one 256-point chunk, c = 5 and seq 16 by default), not its sum.  200 =
    3 x 64 + 8: at 64-point chunks the 8-point tail goes to the host (the
    POLYMATH_MSM_CHUNK case) unless POLYMATH_MSM_TAIL=0 keeps it on the
    device."""
    rows, words, want = msm_case
    calls = []
    host_tail = M._host_tail
    monkeypatch.setattr(M, "_host_tail",
                        lambda *a: calls.append(1) or host_tail(*a))
    monkeypatch.setenv(name, value)
    if name == "POLYMATH_MSM_C":
        assert M.window_params(256) == (5, 51)
        monkeypatch.setenv(name, "7")
        assert M.window_params(256) == (7, 37)
    elif name == "POLYMATH_MSM_SEQ":
        assert M.scan_seq(256) == 4
        monkeypatch.setenv(name, "1024")          # past the chunk: one row
        assert M.scan_seq(256) == 256
        monkeypatch.setenv(name, value)
    elif name == "POLYMATH_MSM_CHUNK":
        assert M.choose_chunk(200) == 64
    assert M.msm_device(rows, words, chunk=chunk) == want
    assert len(calls) == tails


@pytest.mark.parametrize("name, value", [
    ("POLYMATH_MSM_C", "0"), ("POLYMATH_MSM_C", "17"),
    ("POLYMATH_MSM_C", "x"), ("POLYMATH_MSM_SEQ", "3"),
    ("POLYMATH_MSM_SEQ", "0"), ("POLYMATH_MSM_SEQ", "-8"),
    ("POLYMATH_MSM_CHUNK", "100"), ("POLYMATH_MSM_CHUNK", "1"),
    ("POLYMATH_MSM_CHUNK", str(1 << 23)), ("POLYMATH_MSM_TAIL", "maybe"),
])
def test_unsupported_override_raises(msm_case, monkeypatch, name, value):
    rows, words, _ = msm_case
    monkeypatch.setenv(name, value)
    with pytest.raises(ValueError, match=name):
        M.msm_device(rows, words)


def test_schedule_unset_is_todays():
    c = [4] * 7 + [5, 6, 7, 8, 8, 8, 8, 9, 10, 11, 12, 13, 14, 14, 14, 14]
    seq = [2, 2, 4, 4, 8, 8, 16, 16, 32, 32, 64, 64, 128, 128] + [256] * 9
    for k in range(1, 24):
        assert M.window_params(1 << k) == (c[k - 1], -(-255 // c[k - 1]))
        assert M.scan_seq(1 << k) == seq[k - 1]
    assert [M.choose_chunk(m) for m in
            (1, 2, 3, 100, 4097, 1 << 19, (1 << 19) + 1, 1 << 22)] == \
        [2, 2, 4, 128, 8192, 1 << 19, 1 << 19, 1 << 19]
    assert M.default_chunk() == M.DEFAULT_CHUNK == 1 << 19
    assert M.tail_mode()


def _bench(cache):
    """One run of the bench entry; returns its line, checked against what
    it printed."""
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        for name in ENV:
            mp.delenv(name, raising=False)
        mp.setenv("POLYMATH_TRACE", "0")
        mp.setenv("POLYMATH_BENCH_CONSTRAINTS", str(BENCH_CONSTRAINTS))
        mp.setenv("POLYMATH_BENCH_REPS", "1")
        mp.setenv("POLYMATH_BENCH_VERIFY_REPS", "2")
        line = bench.main(["--device", "cpu", "--cache-dir", cache])
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == line
    d = line["detail"]
    assert line["metric"] == "prove_ns_per_constraint"
    assert d["verify"] is True and d["fused_equals_split"] is True
    assert d["device"] == "cpu" and d["peak_gib"] is None
    assert d["domain_n"] == 16 and d["num_constraints"] == BENCH_CONSTRAINTS
    for k in ("prove_seconds", "fused_prove_seconds", "warm_prove_seconds"):
        assert d[k] > 0
    return line


@pytest.fixture(scope="module")
def first_run(tmp_path_factory):
    """The bench's first run in a fresh cache dir: (dir, its line)."""
    cache = str(tmp_path_factory.mktemp("bench"))
    return cache, _bench(cache)


def test_bench_first_run_sets_up_and_writes_the_key(first_run):
    cache, line = first_run
    d = line["detail"]
    assert d["setup_seconds"] > 0 and d["pk_load_seconds"] == 0
    assert os.listdir(cache) == [f"torch_pk_{BENCH_CONSTRAINTS}_0.dir"]
    assert os.path.isfile(os.path.join(cache, os.listdir(cache)[0],
                                       "meta.json"))


def test_bench_second_run_loads_the_key(first_run):
    d = _bench(first_run[0])["detail"]
    assert d["setup_seconds"] == 0 and d["pk_load_seconds"] > 0


def test_msmtime_gives_one_point():
    res = msmtime.main(["--device", "cpu", "--n", "256", "--configs",
                        "256:4;256:6:8", "--reps", "1"])
    assert res["same_point"] and res["device"] == "cpu"
    assert [(r["chunk"], r["c"], r["seq"]) for r in res["configs"]] == \
        [(256, 4, 16), (256, 6, 8)]
    assert "POLYMATH_MSM_C" not in os.environ


def test_msmtime_raises_on_differing_points(monkeypatch):
    monkeypatch.setattr(msmtime, "fixed_base_mul", lambda sc: sc.T)
    monkeypatch.setattr(M, "msm_device",
                        lambda *a, **k: os.environ["POLYMATH_MSM_C"])
    with pytest.raises(AssertionError, match="differs"):
        msmtime.main(["--device", "cpu", "--n", "4", "--configs",
                      "4:4;4:5", "--reps", "1"])
