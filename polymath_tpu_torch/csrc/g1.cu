// G1 (BLS12-381) Jacobian point kernels on Fq as 12 x 32-bit words.
//
// Replaces, from polymath_tpu/ops:
//   pallas_curve.py:_madd_kernel(fast, packed)  -> g1_madd_kernel   (B3)
//   pallas_gather.py:_gather_kernel            -> g1_gather_kernel (B4)
//   pallas_curve.py:_add_kernel                -> g1_add_kernel    (B5)
//   pallas_curve.py:_double_kernel             -> g1_double_kernel (B8)
// and adds g1_to_affine_kernel, a port-only kernel with no TPU counterpart:
// the reference inverts Z by Fermat in XLA (fixed_base.jac_to_affine_batch);
// in eager PyTorch that is ~570 Fq products per point as separate launches.
// The fused MSM bucket scan (B7) is in scan.cu; the formulas in g1.cuh.
//
// One thread per point, but for the gather (below).
//
// Bound on the H100: integer multiplies.  A madd is 11 Fq products (8M+3S),
// a general add 16, each ~2*144 wide 32x32 products; the 36+24 words of
// traffic per madd are ~240 bytes, far below the multiply time.  The madd
// holds ~130 live words per thread, so expect register spills (nvcc -Xptxas
// -v prints them); tuning them is later work.
#include <cuda_runtime.h>
#include "g1.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
g1_add_kernel(const uint32_t* p, long p_stride, long p_step,
              const uint32_t* q, long q_stride, long q_step, uint32_t* out,
              long out_stride, long m) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  Jac a = load_jac(p, p_stride, i * p_step);
  Jac b = load_jac(q, q_stride, i * q_step);
  store_jac(out, out_stride, i, jac_add(a, b));
}

__global__ void __launch_bounds__(kThreads)
g1_madd_kernel(const uint32_t* p, long p_stride, const uint32_t* leaf,
               long leaf_stride, uint32_t* out, long out_stride,
               int32_t* err, long fast, long m) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  Jac a = load_jac(p, p_stride, i);
  Fq x2 = fe_load<FqP>(leaf, leaf_stride, i);
  Fq y2 = fe_load<FqP>(leaf + 12 * leaf_stride, leaf_stride, i);
  bool coll = false;
  Jac r = jac_madd(a, x2, y2, fast != 0, &coll);
  store_jac(out, out_stride, i, r);
  if (coll) err[i] = 1;
}

// B4: out[:, j] = table[idx[j], :] (limb-major); an index outside [0, T)
// (the prover's T for a dead leaf) gives the zero row, the affine identity.
// Bound: bytes (the rows read, 96 B a row, and written limb-major, plus
// 8 B of index a row).  The layout is T1's rowload (gather_variants.cu,
// measured faster than a thread per row): a block is 32 rows x 6 warps, a
// warp per 16-byte vector of the 96-byte row, so a warp reads one vector
// of 32 rows and stores 4 words of each row coalesced, across the warp.
// Each thread puts U = 2 rows' loads in flight before its first store
// (2, 4 and 8 measured within 1-3% of each other at the prover's shape,
// 16 slower; 2 takes the fewest registers).
constexpr int kGatherU = 2;

__global__ void __launch_bounds__(32 * 6)
g1_gather_kernel(const uint4* __restrict__ table, long T,
                 const int64_t* __restrict__ idx, uint32_t* __restrict__ out,
                 long out_stride, long m) {
  const int r = threadIdx.x, v = threadIdx.y;
  const long base = (long)blockIdx.x * (32 * kGatherU) + r;
  uint4 w[kGatherU];
#pragma unroll
  for (int u = 0; u < kGatherU; ++u) {
    const long j = base + u * 32;
    const long row = j < m ? idx[j] : T;
    w[u] = row >= 0 && row < T ? table[row * 6 + v] : make_uint4(0, 0, 0, 0);
  }
  uint32_t* o = out + 4 * v * out_stride;
#pragma unroll
  for (int u = 0; u < kGatherU; ++u) {
    const long j = base + u * 32;
    if (j < m) {
      o[j] = w[u].x;
      o[out_stride + j] = w[u].y;
      o[2 * out_stride + j] = w[u].z;
      o[3 * out_stride + j] = w[u].w;
    }
  }
}

// Jacobian -> affine by a per-thread Fermat inversion of Z (Z^(q-2));
// Z == 0 gives (0, 0), the affine identity.  X and Y are loaded only
// after the inversion, so that they hold no registers across its loop.
__global__ void __launch_bounds__(kThreads)
g1_to_affine_kernel(const uint32_t* p, long p_stride, uint32_t* out,
                    long out_stride, long m) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const Fq z = fe_load<FqP>(p + 24 * p_stride, p_stride, i);
  Fq zinv = fq_one();
  // q - 2, most significant word first; left-to-right square-and-multiply
  for (int k = FqP::N - 1; k >= 0; --k) {
    const uint32_t e = FqP::p(k) - (k == 0 ? 2u : 0u);
    for (int b = 31; b >= 0; --b) {
      zinv = fe_sqr<FqP>(zinv);
      if ((e >> b) & 1u) zinv = fe_mul<FqP>(zinv, z);
    }
  }
  const Fq zinv2 = fe_sqr<FqP>(zinv);
  const Fq x = fe_load<FqP>(p, p_stride, i);
  fe_store<FqP>(out, out_stride, i, fe_mul<FqP>(x, zinv2));
  const Fq y = fe_load<FqP>(p + 12 * p_stride, p_stride, i);
  fe_store<FqP>(out + 12 * out_stride, out_stride, i,
                fe_mul<FqP>(y, fe_mul<FqP>(zinv2, zinv)));
}

// dbl-2009-l on every lane, with no early return: an identity input
// (Z = 0) gets the formula's X3 and Y3 and Z3 = 2 Y Z = 0, bit for bit what
// ll.py:ll_jac_double and curve_jax.jac_double_core return.  Bound:
// integer multiplies (2M + 5S against 288 bytes a point).
__global__ void __launch_bounds__(kThreads)
g1_double_kernel(const uint32_t* p, long p_stride, uint32_t* out,
                 long out_stride, long m) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  store_jac(out, out_stride, i, jac_double(load_jac(p, p_stride, i)));
}

inline unsigned blocks_for(long m, int threads) {
  return (unsigned)((m + threads - 1) / threads);
}

}  // namespace

extern "C" int pm_g1_add(const void* p, long p_stride, long p_step,
                         const void* q, long q_stride, long q_step, void* out,
                         long out_stride, long m, void* stream) {
  if (m > 0)
    g1_add_kernel<<<blocks_for(m, kThreads), kThreads, 0,
                    (cudaStream_t)stream>>>(
        (const uint32_t*)p, p_stride, p_step, (const uint32_t*)q, q_stride,
        q_step, (uint32_t*)out, out_stride, m);
  return (int)cudaGetLastError();
}

extern "C" int pm_g1_madd(const void* p, long p_stride, const void* leaf,
                          long leaf_stride, void* out, long out_stride,
                          void* err, long fast, long m, void* stream) {
  if (m > 0)
    g1_madd_kernel<<<blocks_for(m, kThreads), kThreads, 0,
                     (cudaStream_t)stream>>>(
        (const uint32_t*)p, p_stride, (const uint32_t*)leaf, leaf_stride,
        (uint32_t*)out, out_stride, (int32_t*)err, fast, m);
  return (int)cudaGetLastError();
}

extern "C" int pm_g1_gather(const void* table, long T, const void* idx,
                            void* out, long out_stride, long m,
                            void* stream) {
  if (m > 0)
    g1_gather_kernel<<<blocks_for(m, 32 * kGatherU), dim3(32, 6), 0,
                       (cudaStream_t)stream>>>(
        (const uint4*)table, T, (const int64_t*)idx, (uint32_t*)out,
        out_stride, m);
  return (int)cudaGetLastError();
}

extern "C" int pm_g1_to_affine(const void* p, long p_stride, void* out,
                               long out_stride, long m, void* stream) {
  if (m > 0)
    g1_to_affine_kernel<<<blocks_for(m, kThreads), kThreads, 0,
                          (cudaStream_t)stream>>>(
        (const uint32_t*)p, p_stride, (uint32_t*)out, out_stride, m);
  return (int)cudaGetLastError();
}

extern "C" int pm_g1_double(const void* p, long p_stride, void* out,
                            long out_stride, long m, void* stream) {
  if (m > 0)
    g1_double_kernel<<<blocks_for(m, kThreads), kThreads, 0,
                       (cudaStream_t)stream>>>(
        (const uint32_t*)p, p_stride, (uint32_t*)out, out_stride, m);
  return (int)cudaGetLastError();
}
