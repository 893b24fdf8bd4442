"""Port fused MSM bucket scan (polymath_tpu_torch.ops.cuda_scan) and the
fused-scan MSM configuration, on the CPU through the plain versions.

The reference for the scan is the split pair that the reference's fused
kernel replaces (pallas_scan.py: "drop-in for the gather_rows +
_scan_local_madd pair"): leaves gathered with numpy from the same host
points, then curve_jax.jac_madd_core run eagerly step by step.  Every
local prefix and the collision flag of the fused scan, and of the split
configuration's one-launch madd scan on the same leaves, must agree bit
for bit, fast and safe, with dead leaves, an all-dead lane, a duplicate
base, a leaf equal to the running sum and P + (-P).  The MSM in its fused
configuration is held against the split one and the native g1_msm.
"""

import random

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from polymath_tpu.ops import curve_jax as CJ
from polymath_tpu_torch.hostmath import bls12_381 as bls
from polymath_tpu_torch.hostmath.bls12_381 import R
from polymath_tpu_torch.native import g1_msm
from polymath_tpu_torch.ops import curve as C
from polymath_tpu_torch.ops import cuda_scan
from polymath_tpu_torch.ops import msm as M
from polymath_tpu_torch.ops.limbs import FR_SPEC, ints_to_words

SEQ, W, ROWS = 4, 2, 8
LANES = W * ROWS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain PyTorch ops here are small: one intra-op thread is as fast
    and leaves the other cores to parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan_inputs():
    """table (11, 24) rows: row k - 1 = k G for k = 1..10, row 10 = -5 G;
    idx (SEQ, W, ROWS) step-major, index 11 = dead.  Planted lanes
    (lane = w * ROWS + r): 0 all dead; 1 G, 2G, 3G (the leaf equals the
    running sum, Z != 1); 2 5G, 5G (a duplicate base, Z = 1); 3 5G, -5G
    (P + (-P)), then 7G; the rest random with dead leaves."""
    pts = [bls.G1.mul(bls.G1.gen, k) for k in range(1, 11)]
    pts.append(bls.G1.neg(pts[4]))
    table = C.points_to_device(pts).T.contiguous()
    t = table.shape[0]
    rng = np.random.default_rng(11)
    idx = rng.integers(0, t + 1, size=(SEQ, LANES))
    idx[:, 0] = t
    idx[:3, 1] = [0, 1, 2]
    idx[:2, 2] = [4, 4]
    idx[:3, 3] = [4, 10, 6]
    idx[1::2, 9] = t
    return table, torch.from_numpy(idx.reshape(SEQ, W, ROWS))


def _jax(words, coords):
    return tuple(jnp.asarray(c.numpy().astype(np.uint32))
                 for c in C.split_words(words, coords))


def _words(coords):
    return C.join_words(tuple(torch.from_numpy(np.asarray(c).astype(np.int64))
                              for c in coords))


@pytest.mark.parametrize("fast", [False, True])
def test_fused_scan_matches_reference_split_pair(fast):
    table, idx = _scan_inputs()
    local, err = cuda_scan.fused_scan_msm(table, idx, fast)
    assert local.shape == (C.JAC, SEQ, W, ROWS)
    assert (err is not None) == fast

    ext = np.concatenate([table.numpy(), np.zeros((1, C.AFF), np.int32)])
    leaves = ext[idx.numpy().reshape(SEQ, LANES)]           # (SEQ, LANES, 24)
    # the split configuration's one-launch scan on the same leaves
    split, split_err = cuda_scan.madd_scan(torch.from_numpy(
        np.ascontiguousarray(leaves.transpose(2, 0, 1))).reshape(
            C.AFF, SEQ, W, ROWS), fast)
    acc = CJ.jac_identity((LANES,))
    want_err = np.zeros(LANES, bool)
    for s in range(SEQ):
        leaf = torch.from_numpy(np.ascontiguousarray(leaves[s].T))
        acc, e = CJ.jac_madd_core(acc, _jax(leaf, 2), fast)
        assert torch.equal(local[:, s].reshape(C.JAC, LANES), _words(acc)), s
        assert torch.equal(split[:, s].reshape(C.JAC, LANES), _words(acc)), s
        if fast:
            want_err |= np.asarray(e)
    if fast:
        assert err.bool().tolist() == want_err.tolist()
        assert split_err.bool().tolist() == want_err.tolist()
        assert bool(err[1]) and bool(err[2])

    safe = local if not fast else cuda_scan.fused_scan_msm(table, idx,
                                                           False)[0]
    host = C.jac_to_host(safe[:, :, 0, :4].reshape(C.JAC, -1))
    host = [host[4 * s:4 * s + 4] for s in range(SEQ)]
    g = bls.G1.gen
    assert [h[0] for h in host] == [None] * SEQ
    assert host[2][1] == bls.G1.mul(g, 6)                   # G + 2G + 3G
    assert host[1][2] == bls.G1.mul(g, 10)                  # 5G + 5G
    assert host[1][3] is None and host[2][3] == bls.G1.mul(g, 7)


def test_fused_scan_out_err_and_checks():
    table, idx = _scan_inputs()
    want, want_err = cuda_scan.fused_scan_msm(table, idx, True)
    out = torch.empty((C.JAC,) + tuple(idx.shape), dtype=torch.int32)
    err = torch.zeros(LANES, dtype=torch.int32)
    err[5] = 1                                              # OR-ed into
    got, got_err = cuda_scan.fused_scan_msm(table, idx, True, out=out,
                                            err=err)
    assert got is out and got_err is err
    assert torch.equal(out, want)
    assert torch.equal(err, want_err | (torch.arange(LANES) == 5).int())
    with pytest.raises(TypeError):
        cuda_scan.fused_scan_msm(table, idx.to(torch.int32), False)
    with pytest.raises(ValueError):
        cuda_scan.fused_scan_msm(table[:, :12], idx, False)
    with pytest.raises(ValueError):
        cuda_scan.fused_scan_msm(table, idx, False, out=out[:, :2])
    assert cuda_scan.LAUNCHES["fused_scan"] == 0  # no kernel on the CPU


def _rows(points):
    return C.points_to_device(points).T.contiguous()


def _scalars(values, mont=False):
    if mont:
        values = [FR_SPEC.to_mont_int(v % R) for v in values]
    return torch.from_numpy(ints_to_words(values, FR_SPEC.L))


def _points(n, seed):
    rng = random.Random(seed)
    cur = bls.G1.mul(bls.G1.gen, rng.randrange(1, R))
    step = bls.G1.mul(bls.G1.gen, rng.randrange(1, R))
    pts = []
    for _ in range(n):
        pts.append(cur)
        cur = bls.G1.add(cur, step)
    return pts


@pytest.mark.parametrize("chunk, n, mont", [(16, 2 * 16 + 5, True),
                                            (64, 50, False)])
def test_msm_fused_matches_split_and_native(chunk, n, mont):
    """Chunk 16 with a peeled host tail and Montgomery scalars; chunk 64
    with one padded chunk and an identity base."""
    pts = _points(n, chunk)
    pts[7] = None
    rng = random.Random(n)
    sc = [rng.randrange(R) for _ in pts]
    sc[3] = 0
    want = g1_msm(pts, sc)
    rows, s = _rows(pts), _scalars(sc, mont)
    assert M.msm_device(rows, s, chunk=chunk, mont=mont, fused=True) == want
    assert M.msm_device(rows, s, chunk=chunk, mont=mont, fused=False) == want


def test_msm_fused_duplicate_bases_and_switch(monkeypatch):
    """Repeated bases: the fused fast form raises on the collision flag,
    the fused safe form is exact.  fused=None follows POLYMATH_MSM_FUSED
    at call time; the default is the split scan."""
    base = _points(6, 3)
    pts = (base * 4)[:21]
    rng = random.Random(9)
    sc = [rng.randrange(R) for _ in pts]
    rows, s = _rows(pts), _scalars(sc)
    with pytest.raises(AssertionError, match="collision"):
        M.msm_device(_rows([base[0]] * 2), _scalars([5, 5]), fast=True,
                     fused=True)

    calls = []
    real = M.fused_scan_msm

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(M, "fused_scan_msm", spy)
    monkeypatch.delenv("POLYMATH_MSM_FUSED", raising=False)
    assert M.msm_device(rows[:2], s[:, :2]) == g1_msm(pts[:2], sc[:2])
    assert not calls
    monkeypatch.setenv("POLYMATH_MSM_FUSED", "1")
    assert M.msm_device(rows, s) == g1_msm(pts, sc)
    assert calls
    n_calls = len(calls)
    assert M.msm_device(rows[:2], s[:, :2], fused=False) == \
        g1_msm(pts[:2], sc[:2])
    assert len(calls) == n_calls
