// The fused MSM bucket scan: replaces polymath_tpu/ops/pallas_scan.py:
// _fused_kernel (B7).  Kept apart from g1.cu so that the two sources, each
// inlining the madd of g1.cuh, compile in parallel.
#include <cuda_runtime.h>
#include "g1.cuh"

namespace {

// Fused MSM bucket scan (B7): for every lane i of a chunk (lanes = W *
// rows), the inclusive mixed-add scan of its seq sorted leaves, read
// straight from the affine point table.  It computes what the split pair
// does (g1_gather_kernel into a leaf buffer, then seq launches of
// g1_madd_kernel), in one launch and without writing the leaves.
//
//   table (T, 24) words as 16-byte vectors; idx (seq, lanes) int64, step
//   major; an index outside [0, T) is the affine identity (a dead leaf).
//   local (36, seq, lanes): step s holds each lane's prefix after s + 1
//   leaves, so local[:, seq - 1] are the lane totals.  err (lanes,) gets 1
//   where the fast form skipped a doubling (never cleared: OR-ed).
//
// The reference's sequential grid axis (t) becomes the loop inside the
// thread: the Jacobian accumulator stays in registers for all seq steps,
// and the next step's index is loaded before this step's madd.  Stores of
// one step are coalesced (neighbouring lanes, neighbouring words).
//
// Bound on the H100: integer multiplies.  One 2^19-point chunk at c = 13
// is 20 x 2^19 = 10.5M madds x 6,072 32-bit multiply-adds at 16.7e12/s,
// about 3.8 ms; its bytes (the 50 MB table, 8 B of index and 144 B of
// prefix a madd) take about 0.5 ms.  The table about fits the 50 MB L2.
// 64 threads a block spread the 40,960 lanes of a chunk evenly over the
// 132 SMs (640 blocks, at most 5 on one SM).
constexpr int kScanThreads = 64;

__global__ void __launch_bounds__(kScanThreads)
g1_scan_msm_kernel(const uint4* table, long T, const int64_t* idx,
                   uint32_t* local, int32_t* err, long fast, long seq,
                   long lanes) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= lanes) return;
  const long stride = seq * lanes;
  Jac acc = jac_identity();
  bool coll = false;
  long r = idx[i];
  for (long s = 0; s < seq; ++s) {
    const long r_next = s + 1 < seq ? idx[(s + 1) * lanes + i] : T;
    Fq x2, y2;
    if (r >= 0 && r < T) {
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        const uint4 qx = table[r * 6 + v];
        const uint4 qy = table[r * 6 + 3 + v];
        x2.w[4 * v] = qx.x;
        x2.w[4 * v + 1] = qx.y;
        x2.w[4 * v + 2] = qx.z;
        x2.w[4 * v + 3] = qx.w;
        y2.w[4 * v] = qy.x;
        y2.w[4 * v + 1] = qy.y;
        y2.w[4 * v + 2] = qy.z;
        y2.w[4 * v + 3] = qy.w;
      }
    } else {
      x2 = fe_zero<FqP>();
      y2 = fe_zero<FqP>();
    }
    acc = jac_madd(acc, x2, y2, fast != 0, &coll);
    store_jac(local + s * lanes, stride, i, acc);
    r = r_next;
  }
  if (coll) err[i] = 1;
}

inline unsigned blocks_for(long m, int threads) {
  return (unsigned)((m + threads - 1) / threads);
}

}  // namespace

extern "C" int pm_g1_scan_msm(const void* table, long T, const void* idx,
                              void* local, void* err, long fast, long seq,
                              long lanes, void* stream) {
  if (seq > 0 && lanes > 0)
    g1_scan_msm_kernel<<<blocks_for(lanes, kScanThreads), kScanThreads, 0,
                         (cudaStream_t)stream>>>(
        (const uint4*)table, T, (const int64_t*)idx, (uint32_t*)local,
        (int32_t*)err, fast, seq, lanes);
  return (int)cudaGetLastError();
}
