// The quotient scan: the inclusive affine recurrence p_k = x_k + m p_(k-1)
// over (8, n) Fr Montgomery words, as two kernels of one launch a level.
//
// Replaces polymath_tpu/ops/poly_jax.py:affine_scan (:23-75) and the Pallas
// fr_mul that adds its row carries (pallas_field.py:_mul_kernel, B1, at
// poly_jax.py:70-72).  The reference scans rows of 64 in lock step, one
// product and one sum over all rows a step, recurses on the row totals
// with m^64, and adds each row's carry with one broadcast product: 84
// products a level, each its own pass over device memory.  Here a thread
// owns a row of kRow = 16 consecutive elements and runs its 16 dependent
// steps acc = acc m + x_k in registers:
//
//   reduce, affine_rows_kernel<false>: from zero; writes only the row
//     total (8, rows).  A row's elements past n count as zeros, so the
//     ragged last row's total is its scan carried on to 16 steps (no carry
//     ever reads it).
//   apply, affine_rows_kernel<true>: from the row's carry-in,
//     carry[:, row - 1] (the inclusive value at the end of the row before,
//     which the level above computed; zero for row 0); writes every p_k.
//
// ops/cuda_poly.py and ops/poly.py chain them: level l + 1 scans level l's
// totals with m^(16^(l+1)) until one row is left; then the applies run from
// the top level down.  The arithmetic is exact, so any blocking gives the
// canonical words of the sequential recurrence.
//
// Order: with rev, logical element k is physical element n - 1 - k, for
// the input and the output alike.  The quotient scan reads the (8, D + 1)
// numerator top down and writes its values in natural order, so the
// reference's two flips of the whole array are gone.
//
// Memory: the words are word-major (8, n), so threads on consecutive rows
// read at a stride of kRow elements.  A block's 64 rows, 1,024 consecutive
// elements, are staged whole through shared memory instead: for each of
// the 8 word planes the block reads 4 KB in one coalesced sweep (a warp
// copies 2 rows x 16 elements), and the step reads tile[w][j][row],
// consecutive rows on consecutive banks.  The apply writes its values back
// into the tile it read and stores it with the same sweep.
//
// Why a row of 16 and not 64: with 64, a block staged 8 columns of its 64
// rows at a time (the tile that fits), so each sweep read 32 bytes in
// every 256 across 16 KB of each plane; the reduce moved 0.78 TB/s and the
// apply 0.57 TB/s, and copying the next columns during the steps
// (cp.async, two tiles) did not change that (PERF.md §6).  The price of 16
// is more levels (7 for the prover's 20,971,543 coefficients, 13 launches)
// and row totals of 1/16 of the input.
//
// Bound on the H100: bytes.  An element is one Fr product (264 32-bit
// multiply-adds, 1.6e-11 s at 16.7e12/s) against 32 bytes read by the
// reduce and 64 moved by the apply (1.0e-11 and 1.9e-11 s at 3.35e12 B/s).
// 6 blocks of 64 threads an SM (33,792 bytes of tile each; 12 warps, 3 a
// scheduler, enough to keep the multipliers busy through a step's
// dependent chain).  The design reads the coefficients twice (reduce, then
// apply): 96 bytes an element at level 0 where the recurrence needs 64.
//
// Built with a host compiler instead of nvcc, only the kernel body is
// compiled (the launch code needs nvcc): tests/test_torch_poly.py runs it
// under a host emulation of a block (one host thread a CUDA thread, a
// barrier for __syncthreads) against the wrapper's plain version.
#include <string.h>
#include "fields.cuh"
#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int kRow = 16;       // elements a thread scans
constexpr int kThreads = 64;   // rows a block
// A tile row of kThreads + 2 words: the staging copies of a warp (2 rows x
// 16 columns) then land on 32 distinct banks, (2 j + r) mod 32.
constexpr int kPitch = kThreads + 2;
constexpr int N = FrP::N;

struct Mult {
  uint32_t w[N];
};

template <bool kApply>
__global__ void __launch_bounds__(kThreads)
    affine_rows_kernel(const uint32_t* __restrict__ x, long x_stride, long n,
                       int rev, Mult mult, const uint32_t* __restrict__ carry,
                       long carry_stride, uint32_t* __restrict__ out,
                       long out_stride) {
  __shared__ uint32_t tile[N][kRow][kPitch];
  const int t = threadIdx.x;
  const long row = (long)blockIdx.x * kThreads + t;
  // the block's elements are first .. first + kThreads kRow - 1; element
  // first + f is column f % kRow of row f / kRow
  const long first = (long)blockIdx.x * kThreads * kRow;
#pragma unroll 4
  for (int f = t; f < kThreads * kRow; f += kThreads) {
    const long k = first + f;
    const long i = rev ? n - 1 - k : k;
#pragma unroll
    for (int w = 0; w < N; ++w)
      tile[w][f % kRow][f / kRow] = k < n ? x[w * x_stride + i] : 0u;
  }
  Fe<FrP> m;
#pragma unroll
  for (int w = 0; w < N; ++w) m.w[w] = mult.w[w];
  Fe<FrP> acc = fe_zero<FrP>();
  if (kApply && row > 0 && row * kRow < n)
    acc = fe_load<FrP>(carry, carry_stride, row - 1);
  __syncthreads();
  for (int j = 0; j < kRow; ++j) {
    Fe<FrP> v;
#pragma unroll
    for (int w = 0; w < N; ++w) v.w[w] = tile[w][j][t];
    acc = fe_add<FrP>(fe_mul<FrP>(acc, m), v);
    if (kApply) {
#pragma unroll
      for (int w = 0; w < N; ++w) tile[w][j][t] = acc.w[w];
    }
  }
  if (!kApply) {
    if (row * kRow < n) fe_store<FrP>(out, out_stride, row, acc);
    return;
  }
  __syncthreads();
#pragma unroll 4
  for (int f = t; f < kThreads * kRow; f += kThreads) {
    const long k = first + f;
    if (k < n) {
      const long i = rev ? n - 1 - k : k;
#pragma unroll
      for (int w = 0; w < N; ++w)
        out[w * out_stride + i] = tile[w][f % kRow][f / kRow];
    }
  }
}

}  // namespace

#ifdef __CUDACC__
namespace {

// The most shared memory an SM can give its blocks, so that 6 tiles fit.
template <class K>
int carve(K kernel) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
}

template <bool kApply>
int launch(const void* x, long x_stride, long n, long rev, const void* mult,
           const void* carry, long carry_stride, void* out, long out_stride,
           void* stream) {
  if (const int e = carve(affine_rows_kernel<kApply>)) return e;
  Mult m;
  memcpy(m.w, mult, sizeof m.w);
  const long rows = (n + kRow - 1) / kRow;
  if (n > 0)
    affine_rows_kernel<kApply>
        <<<(unsigned)((rows + kThreads - 1) / kThreads), kThreads, 0,
           (cudaStream_t)stream>>>((const uint32_t*)x, x_stride, n, (int)rev,
                                   m, (const uint32_t*)carry, carry_stride,
                                   (uint32_t*)out, out_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// ``mult``: a host pointer to the multiplier's 8 Montgomery words.
extern "C" int pm_affine_scan_reduce(const void* x, long x_stride, long n,
                                     long rev, const void* mult, void* totals,
                                     long totals_stride, void* stream) {
  return launch<false>(x, x_stride, n, rev, mult, nullptr, 0, totals,
                       totals_stride, stream);
}

extern "C" int pm_affine_scan_apply(const void* x, long x_stride, long n,
                                    long rev, const void* mult,
                                    const void* carry, long carry_stride,
                                    void* out, long out_stride,
                                    void* stream) {
  return launch<true>(x, x_stride, n, rev, mult, carry, carry_stride, out,
                      out_stride, stream);
}
#endif  // __CUDACC__
