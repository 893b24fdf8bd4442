"""Port MSM (polymath_tpu_torch.ops.msm) against the host Pippenger
(hostmath G1.msm) and the native g1_msm (itself held against G1.msm in the
first test), on the CPU through the kernels' plain versions: identities,
zero scalars, duplicate bases (the safe form and the fast-mode collision
flag), the peeled host tail, bases longer than the scalars, Montgomery
scalars and deferred results.  The MSM tuning overrides: each of
POLYMATH_MSM_C, _SEQ, _CHUNK and _TAIL=0, set in turn, gives the native
host MSM of a few hundred distinct points; values the kernels cannot take
raise; unset, the schedule is today's."""

import random

import pytest
import torch

from polymath_tpu_torch.hostmath import bls12_381 as bls
from polymath_tpu_torch.hostmath.bls12_381 import R
from polymath_tpu_torch.native import g1_msm
from polymath_tpu_torch.ops import msm as M
from polymath_tpu_torch.ops.curve import points_to_device
from polymath_tpu_torch.ops.limbs import FR_SPEC, ints_to_words


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain PyTorch ops here are small: one intra-op thread is as fast
    and leaves the other cores to parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(points):
    return points_to_device(points).T.contiguous()


def _scalars(values, mont=False):
    if mont:
        values = [FR_SPEC.to_mont_int(v % R) for v in values]
    return torch.from_numpy(ints_to_words(values, FR_SPEC.L))


def _distinct_points(n, seed):
    rng = random.Random(seed)
    cur = bls.G1.mul(bls.G1.gen, rng.randrange(1, R))
    step = bls.G1.mul(bls.G1.gen, rng.randrange(1, R))
    pts = []
    for _ in range(n):
        pts.append(cur)
        cur = bls.G1.add(cur, step)
    return pts


@pytest.fixture(scope="module")
def points():
    return _distinct_points(80, 21)


def test_window_and_chunk_schedule():
    assert M.window_params(1 << 19) == (13, 20)
    assert M.scan_seq(1 << 19) == 256
    assert M.choose_chunk(100) == 128 and M.choose_chunk(1) == 2
    assert M.choose_chunk(1 << 22) == M.DEFAULT_CHUNK
    for chunk in (2, 64, 4096, 1 << 19):
        c, w = M.window_params(chunk)
        assert c * w >= 255 and c * (w - 1) < 255


def test_msm_matches_host_with_identities_and_zero_scalars(points):
    rng = random.Random(5)
    pts = list(points[:40])
    pts[3] = None
    pts[17] = None
    sc = [rng.randrange(R) for _ in pts]
    sc[5] = 0
    sc[6] = 1
    sc[7] = R - 1
    want = bls.G1.msm(pts, sc)
    assert want == g1_msm(pts, sc)
    # more points than scalars: both take the zipped pairs only
    assert g1_msm(pts, sc[:7]) == bls.G1.msm(pts, sc[:7])
    assert M.msm_device(_rows(pts), _scalars(sc)) == want
    # Montgomery scalars, a deferred result, and an explicit small chunk
    pend = M.msm_device(_rows(pts), _scalars(sc, mont=True), mont=True,
                        defer=True, chunk=16)
    assert isinstance(pend, M.MsmPending)
    assert pend.result() == want


def test_msm_tail_peel_and_long_bases(points):
    """m = k*chunk + t with 0 < t <= 64 peels the tail to the host; bases
    longer than the scalars take zero scalars (msm.py tail split)."""
    rng = random.Random(31)
    chunk = 16
    n = 2 * chunk + 11
    pts = list(points[:n])
    pts[-3] = None                    # identity inside the host tail
    sc = [rng.randrange(R) for _ in range(n)]
    sc[-1] = 0                        # zero scalar inside the host tail
    rows = _rows(pts)
    assert M.msm_device(rows, _scalars(sc), chunk=chunk) == \
        g1_msm(pts, sc)
    short = sc[:n - 20]
    assert M.msm_device(rows, _scalars(short), chunk=chunk) == \
        g1_msm(pts[:n - 20], short)
    assert M.msm_device(rows, _scalars(sc), n_eff=9) == \
        g1_msm(pts[:9], sc[:9])


def test_msm_duplicate_bases_safe_and_fast_flag(points):
    """Repeated bases: the safe form doubles where a bucket's partial sum
    meets its own base; the fast form raises on the collision flag (the
    prover then reruns safe)."""
    base = points[:8]
    pts = (base * 6)[:45]
    rng = random.Random(7)
    sc = [rng.randrange(R) for _ in pts]
    want = g1_msm(pts, sc)
    assert M.msm_device(_rows(pts), _scalars(sc)) == want
    p = points[0]
    with pytest.raises(AssertionError, match="collision"):
        M.msm_device(_rows([p, p]), _scalars([5, 5]), fast=True)
    assert M.msm_device(_rows([p, p]), _scalars([5, 5])) == \
        g1_msm([p, p], [5, 5])
    assert M.msm_device(_rows([p]), _scalars([0])) is None


def test_deferred_msm_parts_before_result(points):
    """A deferred MSM's window sums, collision flag, window shape and
    peeled tail are there before ``result()`` (parallel/msm_sharded.py
    gathers them), and composing them gives msm_device's point."""
    rng = random.Random(43)
    chunk = 16
    n = 2 * chunk + 5
    pts = list(points[:n])
    sc = [rng.randrange(R) for _ in range(n)]
    pend = M.msm_device(_rows(pts), _scalars(sc), chunk=chunk, fast=True,
                        defer=True)
    c, windows = M.window_params(chunk)
    assert (pend.c, pend.windows) == (c, windows)
    assert tuple(pend.wsums.shape) == (36, windows)
    assert pend.err is not None and not bool(pend.err)
    rows, tail_sc = pend.tail
    assert tuple(rows.shape) == (5, 24) and tuple(tail_sc.shape) == (8, 5)
    body = M.MsmPending(pend.wsums, None, c, windows, None).result()
    tail = M.MsmPending(pend.wsums, None, c, windows, pend.tail).result()
    assert body == g1_msm(pts[:2 * chunk], sc[:2 * chunk])
    assert tail == pend.result() == g1_msm(pts, sc)


@pytest.mark.parametrize("tail", [False, True])
def test_msm_of_five_chunks_sums_them_in_one_call(monkeypatch, tail):
    """Five chunks of 16 (the last ragged with POLYMATH_MSM_TAIL=0, or
    whole with a peeled tail of 7 on the host): the host MSM's point, the
    chunks' window sums added by one ``sum_sets`` call over a (5, 36, W)
    buffer that ``window_fold`` wrote, and no ``jac_add``."""
    from polymath_tpu_torch.ops import cuda_curve, cuda_tree
    n = 5 * 16 + 7 if tail else 4 * 16 + 9
    pts = _distinct_points(n, 77)
    pts[5] = None
    rng = random.Random(n)
    sc = [rng.randrange(R) for _ in pts]
    calls = {"sum_sets": [], "jac_add": 0, "window_fold": 0}

    def sum_sets(parts):
        calls["sum_sets"].append(tuple(parts.shape))
        return cuda_tree.sum_sets(parts)

    def window_fold(*args):
        calls["window_fold"] += 1
        return cuda_tree.window_fold(*args)

    def jac_add(p, q):
        calls["jac_add"] += 1
        return cuda_curve.jac_add(p, q)

    monkeypatch.setattr(M, "sum_sets", sum_sets)
    monkeypatch.setattr(M, "window_fold", window_fold)
    monkeypatch.setattr(cuda_curve, "jac_add", jac_add)
    monkeypatch.setenv("POLYMATH_MSM_TAIL", "1" if tail else "0")
    runs = M.RUNS["multi_chunk"]
    pend = M.msm_device(_rows(pts), _scalars(sc), chunk=16, defer=True)
    assert (pend.tail is not None) == tail
    assert pend.result() == g1_msm(pts, sc)
    assert calls == {"sum_sets": [(5, 36, M.window_params(16)[1])],
                     "jac_add": 0, "window_fold": 5}
    assert M.RUNS["multi_chunk"] == runs + 1
    # one chunk: its window sums as the fold left them, no sum_sets
    assert M.msm_device(_rows(pts[:16]), _scalars(sc[:16]), chunk=16) == \
        g1_msm(pts[:16], sc[:16])
    assert len(calls["sum_sets"]) == 1 and calls["window_fold"] == 6
    assert M.RUNS["multi_chunk"] == runs + 1


# -- the MSM tuning overrides -------------------------------------------------

OVERRIDES = ("POLYMATH_MSM_C", "POLYMATH_MSM_SEQ", "POLYMATH_MSM_CHUNK",
             "POLYMATH_MSM_TAIL", "POLYMATH_MSM_FUSED")


@pytest.fixture
def no_overrides(monkeypatch):
    for name in OVERRIDES:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def msm_case():
    """200 distinct points, random scalars, and their MSM by the native
    host Pippenger."""
    pts = _distinct_points(200, 11)
    rng = random.Random(12)
    sc = [rng.randrange(R) for _ in pts]
    return _rows(pts), _scalars(sc), g1_msm(pts, sc)


@pytest.mark.parametrize("name, value, chunk, tails", [
    ("POLYMATH_MSM_C", "5", None, 0),
    ("POLYMATH_MSM_SEQ", "4", None, 0),
    ("POLYMATH_MSM_CHUNK", "64", None, 1),
    ("POLYMATH_MSM_TAIL", "0", 64, 0),
])
@pytest.mark.usefixtures("no_overrides")
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
@pytest.mark.usefixtures("no_overrides")
def test_unsupported_override_raises(msm_case, monkeypatch, name, value):
    rows, words, _ = msm_case
    monkeypatch.setenv(name, value)
    with pytest.raises(ValueError, match=name):
        M.msm_device(rows, words)


@pytest.mark.usefixtures("no_overrides")
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
