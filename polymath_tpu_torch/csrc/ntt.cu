// Batched local radix-2 NTT over Fr (8 x 32-bit words), nl <= 2048.
//
// Replaces polymath_tpu/ops/ntt.py:_local_ntt_kernel (B6).  The TPU kernel
// keeps an (8, nl) block of 16-bit limbs in VMEM and forms butterflies with
// lane rolls and selects; here one thread block owns one transform, holds
// it in dynamic shared memory as 8 word planes of nl words (64 KB at
// nl = 2048, above the 48 KB default, hence cudaFuncSetAttribute), and runs
// all log2(nl) decimation-in-time stages with a __syncthreads between
// them.  Stage s (half-width m = 2^s) pairs i0 = 2m*g + j with i0 + m and
// multiplies by w_nl^(j * nl/(2m)) from a twiddle table in global memory.
//
// Contract (matches the reference): the input is already bit-reversed by
// the caller and the inverse's 1/nl scale is applied outside.
//
// Bound on the H100: integer multiplies -- nl/2 * log2(nl) Fr products per
// transform against 64 bytes of traffic per element.
#include <cuda_runtime.h>
#include "fields.cuh"

namespace {

typedef Fe<FrP> Fr;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ntt_local_kernel(const uint32_t* x, uint32_t* out, const uint32_t* tw,
                 long tw_stride, long batch, int log_nl) {
  extern __shared__ uint32_t sm[];  // [8][nl]
  const int nl = 1 << log_nl;
  const long plane = batch * (long)nl;
  const long base = (long)blockIdx.x * nl;
  for (int j = threadIdx.x; j < nl; j += blockDim.x) {
#pragma unroll
    for (int k = 0; k < FrP::N; ++k) sm[k * nl + j] = x[k * plane + base + j];
  }
  __syncthreads();
  for (int s = 0; s < log_nl; ++s) {
    const int m = 1 << s;
    const int tstep = nl >> (s + 1);  // nl / (2m)
    for (int idx = threadIdx.x; idx < nl / 2; idx += blockDim.x) {
      const int j = idx & (m - 1);
      const int i0 = ((idx >> s) << (s + 1)) + j;
      const int i1 = i0 + m;
      Fr u, v, w;
#pragma unroll
      for (int k = 0; k < FrP::N; ++k) {
        u.w[k] = sm[k * nl + i0];
        v.w[k] = sm[k * nl + i1];
        w.w[k] = tw[k * tw_stride + (long)j * tstep];
      }
      Fr t = fe_mul<FrP>(v, w);
      Fr lo = fe_add<FrP>(u, t);
      Fr hi = fe_sub<FrP>(u, t);
#pragma unroll
      for (int k = 0; k < FrP::N; ++k) {
        sm[k * nl + i0] = lo.w[k];
        sm[k * nl + i1] = hi.w[k];
      }
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < nl; j += blockDim.x) {
#pragma unroll
    for (int k = 0; k < FrP::N; ++k) out[k * plane + base + j] = sm[k * nl + j];
  }
}

}  // namespace

// x, out: (8, batch, nl) contiguous words; tw: (8, nl/2) rows of stride
// tw_stride holding w_nl^k in Montgomery form.
extern "C" int pm_ntt_local(const void* x, void* out, const void* tw,
                            long tw_stride, long batch, long log_nl,
                            void* stream) {
  if (batch <= 0 || log_nl <= 0) return (int)cudaGetLastError();
  const int smem = FrP::N * 4 << log_nl;
  cudaError_t e = cudaFuncSetAttribute(
      ntt_local_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  ntt_local_kernel<<<(unsigned)batch, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (uint32_t*)out, (const uint32_t*)tw, tw_stride,
      batch, (int)log_nl);
  return (int)cudaGetLastError();
}
