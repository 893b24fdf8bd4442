"""The port's quotient scan (ops/poly.py, ops/cuda_poly.py, csrc/poly.cu)
on the CPU.

* ``synthetic_divide_device`` against the reference's host division
  (``polymath_tpu.protocol.poly_host.synthetic_divide``), quotient and
  remainder bit for bit, at lengths whose scans cross 0 to 3 levels and
  leave ragged last rows, with the Fr edge words (0, 1, r - 1, R mod r,
  ...) planted in the coefficients and as the multiplier;
* the forward ``affine_scan`` against ``polymath_tpu.ops.poly_jax``'s;
* the level planner's host powers against the port's fr_mul chain;
* the kernel body of csrc/poly.cu, built with g++ and run under a host
  emulation of a CUDA block (one host thread a CUDA thread, a barrier for
  ``__syncthreads``, fields.cuh's emulated carry chains), against the
  wrappers' plain versions launch by launch: the staging tile, the
  reversed indexing, the padding of the ragged row and the carry-in.

On the CPU the wrappers run their plain versions, so the first three hold
the level planner, the padding, the reversal and the carries; the card
test is in tests/test_torch_cuda.py.
"""

import random
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polymath_tpu.ops.limbs import ints_to_limbs as ref_ints_to_limbs
from polymath_tpu.ops.limbs import limbs_to_ints as ref_limbs_to_ints
from polymath_tpu.ops.poly_jax import affine_scan as ref_affine_scan
from polymath_tpu.protocol.poly_host import synthetic_divide
from polymath_tpu_torch.ops import _build, cuda_poly
from polymath_tpu_torch.ops.cuda_field import fr_mul
from polymath_tpu_torch.ops.field import fr_const
from polymath_tpu_torch.ops.limbs import FR_SPEC, ints_to_words, words_to_ints
from polymath_tpu_torch.tools.cases import edge_values
from polymath_tpu_torch.ops.poly import (
    affine_scan, plan_levels, synthetic_divide_device)

R = FR_SPEC.modulus
S = cuda_poly.ROW
EDGES = edge_values(R, FR_SPEC.W)       # stored (Montgomery) words


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stored_words(n: int, seed: int) -> list:
    """n stored Fr words from numpy default_rng(seed), the edge words
    planted at both ends (a reversed scan reads the top end first)."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(40), "little") % R for _ in range(n)]
    for k, e in enumerate(EDGES[:n]):
        vals[k] = e
        vals[n - 1 - k] = EDGES[-1 - k]
    return vals


def to_tensor(stored: list) -> torch.Tensor:
    return torch.from_numpy(ints_to_words(stored, FR_SPEC.L))


def canon(words) -> list:
    return [FR_SPEC.from_mont_int(v) for v in words_to_ints(words.numpy())]


@pytest.mark.parametrize("length", [1, 2, S - 1, S, S + 1, S * S + 5,
                                    2 * S * S + 17, S ** 3 + 7])
def test_synthetic_divide_matches_host_across_levels(length):
    stored = stored_words(length, length)
    coeffs = [FR_SPEC.from_mont_int(v) for v in stored]
    rng = random.Random(length)
    x1s = [rng.randrange(R), 0, 1, R - 1] + [
        FR_SPEC.from_mont_int(e) for e in (EDGES[3], EDGES[-2])]
    for x1 in x1s:
        q_want, r_want = synthetic_divide(coeffs, x1)
        q, r = synthetic_divide_device(
            to_tensor(stored), to_tensor([FR_SPEC.to_mont_int(x1)]))
        assert q.shape == (8, length - 1) and r.shape == (8, 1)
        assert canon(r) == [r_want], hex(x1)
        assert canon(q) == q_want, hex(x1)


def test_affine_scan_matches_reference_jax():
    """The forward scan at 150 elements (three rows, the last ragged)
    against poly_jax.affine_scan on the same Montgomery words."""
    stored = stored_words(150, 7)
    m = FR_SPEC.to_mont_int(random.Random(7).randrange(R))
    want = jax.jit(ref_affine_scan)(
        jnp.asarray(ref_ints_to_limbs(stored, FR_SPEC.L)),
        jnp.asarray(ref_ints_to_limbs([m], FR_SPEC.L)))
    got = affine_scan(to_tensor(stored), to_tensor([m]))
    assert words_to_ints(got.numpy()) == ref_limbs_to_ints(np.asarray(want))


def test_level_plan_powers_match_the_fr_mul_chain():
    """The quotient scan's levels at the bench workload (D + 1 =
    20,971,543 coefficients) and each level's multiplier m^(16^l), taken
    on the host, against four squarings a level by the port's fr_mul."""
    assert S == 16
    m = random.Random(5).randrange(R)
    levels = plan_levels(20_971_543, m)
    assert [k for k, _ in levels] == [20_971_543, 1_310_722, 81_921, 5_121,
                                      321, 21, 2]
    w = fr_const(m)
    for _, ml in levels:
        assert words_to_ints(w.numpy()) == [FR_SPEC.to_mont_int(ml)]
        for _ in range(4):
            w = fr_mul(w, w)


def test_wrappers_refuse_bad_operands():
    x = to_tensor(stored_words(2 * S + 1, 3))
    with pytest.raises(ValueError):
        cuda_poly.affine_scan_apply(x, 3)             # 3 rows, no carry
    with pytest.raises(ValueError):
        cuda_poly.affine_scan_apply(x, 3, x[:, :2])   # carry of 2 rows
    with pytest.raises(ValueError):
        cuda_poly.affine_scan_reduce(x.to(torch.int64), 3)
    with pytest.raises(ValueError):
        affine_scan(x[None], to_tensor([1]))


# -- the kernel body under a host emulation of a CUDA block ------------------

HARNESS = r"""
#include <barrier>
#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

struct PmDim {
  unsigned x;
};
thread_local PmDim threadIdx, blockIdx;
static std::barrier<>* pm_block;
#define __global__
#define __shared__ static
#define __launch_bounds__(...)
inline void __syncthreads() { pm_block->arrive_and_wait(); }
#include "poly.cu"

// argv: mode (r | a), n, rev, input file, output file.  Input: 8 words of
// the multiplier, x (8, n), then for mode a the carry (8, rows).  x is
// copied to planes of stride n + 1, so the kernel's stride is exercised.
int main(int argc, char** argv) {
  const bool apply = argv[1][0] == 'a';
  const long n = atol(argv[2]), rows = (n + kRow - 1) / kRow;
  const int rev = atoi(argv[3]);
  FILE* in = fopen(argv[4], "rb");
  Mult m;
  std::vector<uint32_t> x(N * (n + 1)), carry(N * rows + 1);
  size_t got = fread(m.w, 4, N, in);
  for (int w = 0; w < N; ++w) got += fread(&x[w * (n + 1)], 4, n, in);
  if (apply) got += fread(carry.data(), 4, N * rows, in);
  fclose(in);
  if (got != (size_t)(N + N * n + (apply ? N * rows : 0))) return 2;
  const long out_len = apply ? n : rows;
  std::vector<uint32_t> out(N * out_len + 1);
  for (long b = 0; b * kThreads < rows; ++b) {
    std::barrier<> bar(kThreads);
    pm_block = &bar;
    std::vector<std::thread> threads;
    for (int t = 0; t < kThreads; ++t)
      threads.emplace_back([&, t, b] {
        threadIdx.x = t;
        blockIdx.x = (unsigned)b;
        if (apply)
          affine_rows_kernel<true>(x.data(), n + 1, n, rev, m, carry.data(),
                                   rows, out.data(), out_len);
        else
          affine_rows_kernel<false>(x.data(), n + 1, n, rev, m, nullptr, 0,
                                    out.data(), out_len);
      });
    for (auto& th : threads) th.join();
  }
  FILE* o = fopen(argv[5], "wb");
  fwrite(out.data(), 4, N * out_len, o);
  fclose(o);
  return 0;
}
"""


@pytest.fixture(scope="module")
def block_harness(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build poly.cu's kernel body for the host")
    d = tmp_path_factory.mktemp("poly")
    (d / "harness.cpp").write_text(HARNESS)
    exe = d / "harness"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-I",
                    _build.CSRC, "-o", str(exe), str(d / "harness.cpp")],
                   check=True)
    return exe, d


def run_block_harness(harness, mode, x, mult, rev, carry=None):
    exe, d = harness
    n = x.shape[1]
    src, dst = d / "in.bin", d / "out.bin"
    with open(src, "wb") as f:
        f.write(cuda_poly._mult_words(mult))
        f.write(x.numpy().tobytes())
        if carry is not None:
            f.write(carry.numpy().tobytes())
    subprocess.run([str(exe), mode, str(n), str(int(rev)), str(src),
                    str(dst)], check=True)
    cols = n if mode == "a" else cuda_poly.rows_of(n)
    return torch.from_numpy(np.fromfile(dst, dtype=np.int32).reshape(8, cols))


@pytest.mark.parametrize("n, rev", [(1, True), (S, False), (S + 1, True),
                                    (128 * S + 5, True),
                                    (128 * S + 5, False)])
def test_kernel_body_matches_plain_versions(block_harness, n, rev):
    """Each launch's outputs word for word: one row, one full row, a
    ragged second row, and 129 rows (three blocks of 64, the last row
    ragged) in both orders; the multiplier and the carries hold edge
    words."""
    x = to_tensor(stored_words(n, n))
    rows = cuda_poly.rows_of(n)
    # rolled, so that row 1 starts from an edge word and not from 0
    carry = to_tensor(stored_words(rows, n + 1)).roll(1, 1)
    for mult in (random.Random(n).randrange(R), FR_SPEC.from_mont_int(R - 1),
                 FR_SPEC.from_mont_int(EDGES[4])):
        got = run_block_harness(block_harness, "r", x, mult, rev)
        assert torch.equal(got, cuda_poly.affine_scan_reduce_plain(x, mult,
                                                                   rev))
        got = run_block_harness(block_harness, "a", x, mult, rev, carry)
        assert torch.equal(got, cuda_poly.affine_scan_apply_plain(
            x, mult, carry, rev))
