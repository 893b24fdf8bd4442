// Elementwise Fr Montgomery product, square and radix-2 butterfly on
// (8, M) 32-bit words.
//
// Replaces polymath_tpu/ops/pallas_field.py:_mul_kernel (B1),
// _sqr_kernel (B2) and _bfly_kernel (B9).  The TPU kernels tile (16, 8, 256) blocks of 16-bit
// limbs because the TPU has no 64-bit multiplier; on Hopper each thread
// owns one element and runs 8x32-bit CIOS (mul) or SOS (sqr) with
// 32x32->64 products.
//
// Bound on the H100: memory.  An element moves 96 bytes (mul: two 32-byte
// elements in, one out) or 64 (sqr) against 128 (mul) or 100 (sqr) wide 32x32
// products: at 3.35 TB/s and 16.7e12 32-bit multiply-adds/s the bytes take
// 1.5 to 1.8 times as long as the products, so the kernel only has to
// stream (coalesced word planes, one element per thread).
// A broadcast operand (one element for the whole batch) is passed with
// lane step 0, so the prover's "vector times scalar" calls read one value.
#include <cuda_runtime.h>
#include "fields.cuh"

namespace {

__global__ void fr_mul_kernel(const uint32_t* a, long a_stride, long a_step,
                              const uint32_t* b, long b_stride, long b_step,
                              uint32_t* out, long out_stride, long m) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  Fe<FrP> x = fe_load<FrP>(a, a_stride, i * a_step);
  Fe<FrP> y = fe_load<FrP>(b, b_stride, i * b_step);
  fe_store<FrP>(out, out_stride, i, fe_mul<FrP>(x, y));
}

__global__ void fr_sqr_kernel(const uint32_t* a, long a_stride,
                              uint32_t* out, long out_stride, long m) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  Fe<FrP> x = fe_load<FrP>(a, a_stride, i);
  fe_store<FrP>(out, out_stride, i, fe_sqr<FrP>(x));
}

// (lo + tw hi, lo - tw hi).  Bound on the H100: memory, as fr_mul: 160
// bytes a pair (three elements in, two out) against one product.
__global__ void fr_bfly_kernel(const uint32_t* lo, long lo_stride,
                               long lo_step, const uint32_t* hi,
                               long hi_stride, long hi_step,
                               const uint32_t* tw, long tw_stride,
                               long tw_step, uint32_t* out_lo,
                               uint32_t* out_hi, long out_stride, long m) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  Fe<FrP> a = fe_load<FrP>(lo, lo_stride, i * lo_step);
  Fe<FrP> t = fe_mul<FrP>(fe_load<FrP>(hi, hi_stride, i * hi_step),
                          fe_load<FrP>(tw, tw_stride, i * tw_step));
  fe_store<FrP>(out_lo, out_stride, i, fe_add<FrP>(a, t));
  fe_store<FrP>(out_hi, out_stride, i, fe_sub<FrP>(a, t));
}

constexpr int kThreads = 256;

inline unsigned blocks_for(long m) {
  return (unsigned)((m + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int pm_fr_mul(const void* a, long a_stride, long a_step,
                         const void* b, long b_stride, long b_step, void* out,
                         long out_stride, long m, void* stream) {
  if (m > 0)
    fr_mul_kernel<<<blocks_for(m), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, a_stride, a_step, (const uint32_t*)b, b_stride,
        b_step, (uint32_t*)out, out_stride, m);
  return (int)cudaGetLastError();
}

extern "C" int pm_fr_sqr(const void* a, long a_stride, void* out,
                         long out_stride, long m, void* stream) {
  if (m > 0)
    fr_sqr_kernel<<<blocks_for(m), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, a_stride, (uint32_t*)out, out_stride, m);
  return (int)cudaGetLastError();
}

extern "C" int pm_fr_butterfly(const void* lo, long lo_stride, long lo_step,
                               const void* hi, long hi_stride, long hi_step,
                               const void* tw, long tw_stride, long tw_step,
                               void* out_lo, void* out_hi, long out_stride,
                               long m, void* stream) {
  if (m > 0)
    fr_bfly_kernel<<<blocks_for(m), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)lo, lo_stride, lo_step, (const uint32_t*)hi,
        hi_stride, hi_step, (const uint32_t*)tw, tw_stride, tw_step,
        (uint32_t*)out_lo, (uint32_t*)out_hi, out_stride, m);
  return (int)cudaGetLastError();
}
