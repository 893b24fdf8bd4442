"""The MSM's one-launch bucket scan and group-law tree on the CPU, through
the plain versions of polymath_tpu_torch.ops.cuda_scan.madd_scan and
ops.cuda_tree (row_offsets, window_fold, sum_sets).

The tree's inputs are points k G with small seeded k (numpy;
tests/torch_cases.py:tree_case, which the card's tests use too), so the
hostmath oracle is (sum of k) G.  Row totals hold an identity, a P + P
pair and a P + (-P) pair; thresholds hold a P + P and a P + (-P) with their row
offset, and some counts of 0.  The Jacobian inputs carry Z != 1.  The tree
is held, as affine points, against the reference's
curve_jax.prefix_scan_jac_tree, select_point and tree_sum_jac run eagerly,
and against hostmath at shapes that are not powers of two; the scan word
for word against the per-step jac_madd loop it replaces and against the
fused scan (tests/test_torch_scan.py holds both against the reference's
eager madd scan).

The sum of sets (polymath_tpu_torch.tools.cases.sum_sets_case: an
identity set, P + P and P + (-P) planted where the serial sum and the
kernel's first level meet them, a window of one repeated point) is held
against the hostmath sum, and the kernel body of csrc/tree.cu's
g1_sum_sets_kernel, built with g++ and run under a host emulation of a
CUDA block (as tests/test_torch_poly.py runs poly.cu's), against the plain
version, as affine points.
"""

import shutil
import subprocess

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from polymath_tpu.ops import curve_jax as CJ
from polymath_tpu_torch.ops import _build, cuda_curve, cuda_scan, cuda_tree
from polymath_tpu_torch.ops import curve as C
from polymath_tpu_torch.ops import msm as M
from polymath_tpu_torch.tools.cases import (host_point, jac_words,
                                            sum_sets_case, sum_sets_inputs)
from torch_cases import tree_case


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain PyTorch ops here are small: one intra-op thread is as fast
    and leaves the other cores to parallel test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(words):
    return C.jac_to_host(words.reshape(C.JAC, -1))


def _points(ks):
    return [host_point(int(k)) for k in np.asarray(ks).reshape(-1)]


def _want_sums(ps, cnt, r_of, offs):
    live = (cnt > 0) * (ps + np.take_along_axis(offs, r_of, axis=1))
    return _points(live.sum(axis=1))


@pytest.mark.parametrize("windows, rows, n", [(3, 6, 16), (3, 8, 16),
                                              (2, 5, 13), (4, 3, 9),
                                              (2, 1, 7)])
def test_tree_matches_hostmath(windows, rows, n):
    tot, ps, cnt, r_of, offs = tree_case(windows, rows, n, rows * n)
    t_w, ps_w = jac_words(tot, n), jac_words(ps, n + 1)
    local = t_w[:, None]                                # seq 1
    got_offs = M.row_offsets(local)
    if rows == 1:
        assert got_offs is None
    else:
        assert got_offs.shape == (C.JAC, windows, rows)
        assert _host(got_offs) == _points(offs)
    wsum = cuda_tree.window_fold(ps_w, torch.from_numpy(cnt),
                                 torch.from_numpy(r_of), got_offs)
    assert wsum.shape == (C.JAC, windows)
    assert _host(wsum) == _want_sums(ps, cnt, r_of, offs)
    assert cuda_tree.LAUNCHES == {"row_offsets": 0, "window_fold": 0,
                                  "sum_sets": 0}


def _jax(words):
    return tuple(jnp.asarray(c.numpy().astype(np.uint32))
                 for c in C.split_words(words, 3))


def _words(coords):
    return C.join_words(tuple(torch.from_numpy(np.asarray(c).astype(np.int64))
                              for c in coords))


def test_tree_matches_reference_prefix_and_fold(monkeypatch):
    """W = 3 at rows 4 and W = 3 at rows 3 (padded with an identity total
    to 4 for the reference, which runs one batch of six windows), 8
    thresholds: six eager reference adds (each costs seconds here).
    POLYMATH_PALLAS=1 sends the reference's tree_sum_jac down its halving
    path; its batches are below the Pallas kernel's 128 lanes, so every add
    is curve_jax.jac_add_core."""
    cases = [tree_case(3, rows, 8, 40 + rows) for rows in (4, 3)]
    words = [(jac_words(t, 3), jac_words(p, 4)) for t, p, *_ in cases]
    totals = torch.cat([words[0][0], torch.cat(
        [words[1][0], C.jac_identity_words((3, 1))], dim=2)], dim=1)
    ps = torch.cat([w[1] for w in words], dim=1)             # (36, 6, 8)
    cnt = np.concatenate([c[2] for c in cases])
    r_of = np.concatenate([c[3] for c in cases])

    monkeypatch.setenv("POLYMATH_PALLAS", "1")
    row_ps = CJ.prefix_scan_jac_tree(_jax(totals))
    offs_ref = tuple(jnp.concatenate([i, a[..., :-1]], axis=-1)
                     for i, a in zip(CJ.jac_identity((6, 1)), row_ps))
    off_g = tuple(jnp.take_along_axis(a, jnp.asarray(r_of)[None], axis=-1)
                  for a in offs_ref)
    ps_g = CJ.jac_add(_jax(ps), off_g)
    ps_g = CJ.select_point(jnp.asarray(cnt) > 0, ps_g,
                           CJ.jac_identity((6, 8)))
    wsum_ref = _host(_words(CJ.tree_sum_jac(ps_g))[..., 0])
    offs_ref = _host(_words(offs_ref))

    for k, ((t_w, ps_w), (_, ps_k, c, r, o)) in enumerate(zip(words, cases)):
        rows = t_w.shape[2]
        got = cuda_tree.row_offsets(t_w)
        want = [offs_ref[(3 * k + w) * 4 + j] for w in range(3)
                for j in range(rows)]
        assert _host(got) == want == _points(o)
        wsum = cuda_tree.window_fold(ps_w, torch.from_numpy(c),
                                     torch.from_numpy(r), got)
        assert _host(wsum) == wsum_ref[3 * k:3 * k + 3] == \
            _want_sums(ps_k, c, r, o)


def test_jac_equal_and_plain_add():
    ks = np.array([3, 3, 0, 0, 5, -5])
    a, b = jac_words(ks, 5), jac_words(ks, 6)
    assert not torch.equal(a[:, 0], b[:, 0])           # other Z, same point
    assert cuda_tree.jac_equal(a, b).tolist() == [True] * 6
    assert cuda_tree.jac_equal(a[:, :4], b[:, [0, 4, 3, 5]]).tolist() == \
        [True, False, True, False]
    s = cuda_tree.add_plain(a, b)
    assert torch.equal(s, cuda_curve.jac_add(a, b))
    assert _host(s) == _points(2 * ks)


def test_tree_wrappers_reject_bad_shapes():
    ps = C.jac_identity_words((2, 4)).contiguous()
    cnt = torch.zeros((2, 4), dtype=torch.int64)
    with pytest.raises(ValueError):
        cuda_tree.row_offsets(ps[:24])
    with pytest.raises(ValueError):
        cuda_tree.window_fold(ps, cnt[:1], cnt, None)
    assert cuda_tree.jac_equal(cuda_tree.window_fold(ps, cnt, cnt, None),
                               C.jac_identity_words((2,))).all()


@pytest.mark.parametrize("k", [1, 2, 3, 4, 40])
def test_sum_sets_matches_hostmath(k):
    """The sets' sum per window is (sum of the ks) G, with the identity,
    P + P, P + (-P) and a repeated point planted; a strided operand (sets
    further apart than 36 W words, as the ranks' gathered sums lie) gives
    the same."""
    parts, ks = sum_sets_inputs("cpu", k, 5, 100 + k)
    got = cuda_tree.sum_sets(parts)
    assert got.shape == (C.JAC, 5)
    assert _host(got) == _points(ks.sum(axis=0))
    wide = torch.cat([parts.reshape(k, -1),
                      torch.zeros((k, 7), dtype=torch.int32)], dim=1)
    strided = wide.as_strided((k, C.JAC, 5), (C.JAC * 5 + 7, 5, 1))
    assert torch.equal(cuda_tree.sum_sets(strided), got)
    assert cuda_tree.LAUNCHES["sum_sets"] == 0              # no kernel here


def test_sum_sets_levels_and_refusals():
    """A launch takes at most THREADS sets; more take a launch a level.
    Bad shapes, no set, and words other than int32 are refused."""
    assert cuda_tree.sum_levels(1) == [(1, 1)]
    assert cuda_tree.sum_levels(40) == [(40, 40)]
    assert cuda_tree.sum_levels(128) == [(128, 128)]
    assert cuda_tree.sum_levels(129) == [(129, 128), (2, 2)]
    assert cuda_tree.sum_levels(20_000) == [(20_000, 128), (157, 128),
                                            (2, 2)]
    parts = C.jac_identity_words((3, 4)).permute(1, 0, 2).contiguous()
    for bad in (parts[0], parts[:, :24], parts[:0]):
        with pytest.raises(ValueError, match=r"\(k >= 1, 36, W\)"):
            cuda_tree.sum_sets(bad)
    with pytest.raises(ValueError, match="int32"):
        cuda_tree.sum_sets(parts.to(torch.int64))


# -- csrc/tree.cu's sum of sets under a host emulation of a CUDA block ------

TREE_HARNESS = r"""
#include <atomic>
#include <barrier>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

struct PmDim {
  unsigned x, y;
};
thread_local PmDim threadIdx, blockIdx, gridDim;
static std::barrier<>* pm_block;
#define __global__
#define __shared__ static
#define __launch_bounds__(...)
inline void __syncthreads() { pm_block->arrive_and_wait(); }
template <class T>
inline T __ldcg(const T* p) { return *p; }
inline void __threadfence() {}
inline int atomicAdd(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_add(v);
}
#include "tree.cu"

// argv: k, per, windows, set stride, input file, output file.  Input: the
// k sets, set s at word s * stride; output: the ceil(k / per) block sums
// (groups, 36, windows), one block (j, w) after another.
int main(int argc, char** argv) {
  const long k = atol(argv[1]), per = atol(argv[2]);
  const long windows = atol(argv[3]), stride = atol(argv[4]);
  const long groups = (k + per - 1) / per;
  std::vector<uint32_t> parts(k * stride);
  FILE* in = fopen(argv[5], "rb");
  size_t got = fread(parts.data(), 4, parts.size(), in);
  fclose(in);
  if (got != parts.size()) return 2;
  std::vector<uint32_t> out(groups * 36 * windows);
  for (long w = 0; w < windows; ++w)
    for (long j = 0; j < groups; ++j) {
      std::barrier<> bar(kTreeThreads);
      pm_block = &bar;
      std::vector<std::thread> threads;
      for (int t = 0; t < kTreeThreads; ++t)
        threads.emplace_back([&, t, j, w] {
          threadIdx.x = t;
          blockIdx.x = (unsigned)j;
          blockIdx.y = (unsigned)w;
          g1_sum_sets_kernel(parts.data(), stride, k, per, out.data(),
                             windows);
        });
      for (auto& th : threads) th.join();
    }
  FILE* o = fopen(argv[6], "wb");
  fwrite(out.data(), 4, out.size(), o);
  fclose(o);
  return 0;
}
"""


@pytest.fixture(scope="module")
def tree_harness(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build tree.cu's kernel bodies for the host")
    d = tmp_path_factory.mktemp("tree")
    (d / "harness.cpp").write_text(TREE_HARNESS)
    exe = d / "harness"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-I",
                    _build.CSRC, "-o", str(exe), str(d / "harness.cpp")],
                   check=True)
    return exe, d


def run_sum_sets_body(harness, parts, per, pad=0):
    """One launch of g1_sum_sets_kernel over parts (k, 36, W) with blocks
    of ``per`` sets, the sets ``pad`` words further apart than 36 W ->
    (ceil(k / per), 36, W)."""
    exe, d = harness
    k, _, windows = parts.shape
    stride = C.JAC * windows + pad
    flat = torch.cat([parts.reshape(k, -1),
                      torch.zeros((k, pad), dtype=torch.int32)], dim=1)
    src, dst = d / "in.bin", d / "out.bin"
    src.write_bytes(flat.numpy().tobytes())
    subprocess.run([str(exe), str(k), str(per), str(windows), str(stride),
                    str(src), str(dst)], check=True)
    groups = -(-k // per)
    return torch.from_numpy(np.fromfile(dst, dtype=np.int32).reshape(
        groups, C.JAC, windows))


@pytest.mark.parametrize("k", [1, 2, 3, 4, 40, 130])
def test_sum_sets_kernel_body_matches_plain_version(tree_harness, k):
    """Each launch of ``sum_levels(k)`` (130 sets: two blocks of 128 and 2,
    then their two sums), as affine points against the serial sum of each
    block's sets, and the last against the hostmath sum."""
    parts, ks = sum_sets_inputs("cpu", k, 4, 200 + k)
    for i, (n, per) in enumerate(cuda_tree.sum_levels(k)):
        got = run_sum_sets_body(tree_harness, parts, per, pad=5 * i)
        for j in range(got.shape[0]):
            want = cuda_tree.sum_sets_plain(parts[j * per:(j + 1) * per])
            assert cuda_tree.jac_equal(got[j], want).all(), (n, per, j)
        parts = got
    assert parts.shape[0] == 1
    assert _host(parts[0]) == _points(ks.sum(axis=0))


def test_sum_sets_case_plants():
    """The planted windows of cases.sum_sets_case at k = 40 (the
    kernel's first level pairs set t with set t + 32)."""
    ks = sum_sets_case(40, 20, 1)
    assert ks[0, 0] == 0
    assert ks[0, 1] == ks[1, 1] == ks[32, 1] != 0
    assert ks[0, 2] == -ks[1, 2] == -ks[32, 2] != 0
    assert (ks[:, 3] == ks[0, 3]).all()


def _scan_leaves(seq, windows, rows, seed):
    """Gathered leaves (24, seq, W, rows): k G for random small k, dead
    (0, 0) leaves, and in lane 1 a repeated leaf (the fast flag fires)."""
    rng = np.random.default_rng(seed)
    lanes = windows * rows
    ks = rng.integers(1, 30, (seq, lanes))
    ks[rng.random((seq, lanes)) < 0.2] = 0
    ks[:2, 1] = 7
    pts = C.points_to_device(_points(ks))                    # (24, seq*lanes)
    return pts.reshape(C.AFF, seq, windows, rows).contiguous()


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("seq, windows, rows", [(5, 2, 3), (8, 3, 4)])
def test_madd_scan_matches_per_step_loop(seq, windows, rows, fast):
    """Word for word the loop of one jac_madd per step it replaces, and the
    fused scan on the same leaves (a table of the leaves, identity
    indices)."""
    leaves = _scan_leaves(seq, windows, rows, seq * rows)
    lanes = windows * rows
    local, err = M.madd_scan(leaves, fast)
    assert local.shape == (C.JAC, seq, windows, rows)
    acc = C.jac_identity_words((lanes,))
    want_err = torch.zeros(lanes, dtype=torch.int32)
    for s in range(seq):
        acc, e = cuda_curve.jac_madd(acc, leaves[:, s].reshape(C.AFF, lanes),
                                     fast)
        assert torch.equal(local[:, s].reshape(C.JAC, lanes), acc), s
        if fast:
            want_err |= e
    if fast:
        assert torch.equal(err, want_err) and bool(err[1])
    else:
        assert err is None
    table = leaves.reshape(C.AFF, -1).T.contiguous()
    idx = torch.arange(seq * lanes).reshape(seq, windows, rows)
    f_local, f_err = cuda_scan.fused_scan_msm(table, idx, fast)
    assert torch.equal(f_local, local)
    assert (f_err is None and err is None) or torch.equal(f_err, err)


def test_madd_scan_out_err_and_checks():
    leaves = _scan_leaves(4, 2, 3, 1)
    want, want_err = cuda_scan.madd_scan(leaves, True)
    out = torch.empty((C.JAC, 4, 2, 3), dtype=torch.int32)
    err = torch.zeros(6, dtype=torch.int32)
    err[4] = 1                                              # OR-ed into
    got, got_err = cuda_scan.madd_scan(leaves, True, out=out, err=err)
    assert got is out and got_err is err
    assert torch.equal(out, want)
    assert torch.equal(err, want_err | (torch.arange(6) == 4).int())
    with pytest.raises(ValueError):
        cuda_scan.madd_scan(leaves[:12], False)
    with pytest.raises(ValueError):
        cuda_scan.madd_scan(leaves, False, out=out[:, :2])
    with pytest.raises(ValueError):
        cuda_scan.madd_scan(leaves, True, err=err[:3])
    assert cuda_scan.LAUNCHES["madd_scan"] == 0             # no kernel here
