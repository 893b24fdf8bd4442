"""The carry-chain field arithmetic of ``polymath_tpu_torch/csrc/fields.cuh``
on the CPU.

Built with g++ instead of nvcc, ``fields.cuh`` runs each PTX carry-chain
instruction (add.cc, subc, mad.lo.cc, madc.hi.cc, ...) through a host
emulation of the same instruction and the same carry flag, so this holds
the kernels' exact instruction schedule for the Montgomery product, the
square, the sum and the difference against Python integers.  A carry-chain
fault shows only when carries ripple across many words, so besides random
values every pair of edge values is tried: 0, 1, p - 1, p - 2, R mod p,
R^2 mod p, and values with many 0xffffffff words below p
(``polymath_tpu_torch.tools.cases.edge_values``, which the card tests and
the kernel table plant in the kernels' inputs).  The words are the stored
(Montgomery) words, as the kernels read them.
"""

import shutil
import subprocess

import numpy as np
import pytest

from polymath_tpu_torch.ops import _build
from polymath_tpu_torch.tools.cases import edge_values

FR = 0x73eda753299d7d483339d80809a1d80553bda402fffe5bfeffffffff00000001
FQ = int("1a0111ea397fe69a4b1ba7b6434bacd764774b84f38512bf6730d2a0f6b0f624"
         "1eabfffeb153ffffb9feffffffffaaab", 16)
FIELDS = {"fr": (FR, 8), "fq": (FQ, 12)}

HARNESS = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "fields.cuh"

template <class F>
void run(FILE* in, FILE* out, long n) {
  const int N = F::N;
  std::vector<uint32_t> a(n * N), b(n * N);
  if (fread(a.data(), 4, n * N, in) != (size_t)(n * N) ||
      fread(b.data(), 4, n * N, in) != (size_t)(n * N)) return;
  for (long i = 0; i < n; ++i) {
    Fe<F> x, y;
    for (int k = 0; k < N; ++k) {
      x.w[k] = a[i * N + k];
      y.w[k] = b[i * N + k];
    }
    const Fe<F> r[4] = {fe_mul<F>(x, y), fe_sqr<F>(x), fe_add<F>(x, y),
                        fe_sub<F>(x, y)};
    for (const Fe<F>& v : r) fwrite(v.w, 4, N, out);
  }
}

int main(int argc, char** argv) {
  FILE* in = fopen(argv[2], "rb");
  FILE* out = fopen(argv[3], "wb");
  long n = atol(argv[4]);
  if (argv[1][1] == 'r') run<FrP>(in, out, n); else run<FqP>(in, out, n);
  fclose(out);
  return 0;
}
"""


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build fields.cuh for the host")
    d = tmp_path_factory.mktemp("fields")
    (d / "harness.cpp").write_text(HARNESS)
    exe = d / "harness"
    subprocess.run(["g++", "-std=c++17", "-O1", "-I", _build.CSRC, "-o",
                    str(exe), str(d / "harness.cpp")], check=True)
    return exe, d


def to_words(vals, n_words):
    return np.array([[(v >> (32 * k)) & 0xFFFFFFFF for k in range(n_words)]
                     for v in vals], dtype=np.uint32)


def run_harness(harness, field, a_vals, b_vals):
    exe, d = harness
    p, nw = FIELDS[field]
    src, dst = d / f"in_{field}.bin", d / f"out_{field}.bin"
    with open(src, "wb") as f:
        f.write(to_words(a_vals, nw).tobytes())
        f.write(to_words(b_vals, nw).tobytes())
    subprocess.run([str(exe), field, str(src), str(dst), str(len(a_vals))],
                   check=True)
    out = np.fromfile(dst, dtype=np.uint32).reshape(len(a_vals), 4, nw)
    return [[sum(int(w) << (32 * k) for k, w in enumerate(row))
             for row in lane] for lane in out]


def inputs(field, kind):
    p, nw = FIELDS[field]
    if kind == "edge":
        e = edge_values(p, nw)
        return [x for x in e for _ in e], [y for _ in e for y in e]
    rng = np.random.default_rng(11 if field == "fr" else 12)
    vals = [int.from_bytes(rng.bytes(8 * nw), "little") % p
            for _ in range(800)]
    return vals[:400], vals[400:]


@pytest.mark.parametrize("kind", ["edge", "random"])
@pytest.mark.parametrize("field", ["fr", "fq"])
def test_carry_chain_arithmetic_matches_integers(harness, field, kind):
    p, nw = FIELDS[field]
    r_inv = pow(1 << (32 * nw), -1, p)
    a, b = inputs(field, kind)
    got = run_harness(harness, field, a, b)
    for x, y, (mul, sqr, add, sub) in zip(a, b, got):
        assert mul == x * y * r_inv % p, (hex(x), hex(y))
        assert sqr == x * x * r_inv % p, hex(x)
        assert add == (x + y) % p, (hex(x), hex(y))
        assert sub == (x - y) % p, (hex(x), hex(y))


def test_edge_values_ripple_carries():
    """The planted values hold long runs of 0xffffffff words, so a carry
    from word 0 crosses most of the element."""
    for p, nw in FIELDS.values():
        e = edge_values(p, nw)
        assert len(set(e)) == len(e) and all(0 <= v < p for v in e)
        runs = [sum(1 for k in range(nw)
                    if (v >> (32 * k)) & 0xFFFFFFFF == 0xFFFFFFFF) for v in e]
        assert max(runs) >= nw - 1
