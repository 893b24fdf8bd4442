// Primitive-cost chains: o = body^K(x) elementwise, K = 512 dependent steps
// of one 32-bit (or 16-bit) operation per element, with a = x and b = x to
// start.
//
// Replaces tools/primbench.py:bench (the pl.pallas_call at :38, bodies at
// :58-66): one templated kernel, one instantiation per row, in the tool's
// row order.
//
// Bound on the H100: operations.  2^17 elements x 512 steps = 2^26
// dependent operations: 4.0 us at 16.7e12 integer operations/s (64 INT32
// lanes x 132 SMs x 1.98 GHz), 2.0 us at 33.5e12 fp32 instructions/s; the
// 1 MB of input and output is 0.3 us.  A launch costs a few us as well, so
// at this size the launch sets a floor under the measured time.
//
// Each step is inline PTX in an `asm volatile`, so NVVM cannot fold the
// chain (512 `b + a` into one multiply-add, the select chain into a
// constant).  ptxas still optimises the PTX it is given: it pairs two
// dependent adds into one three-input IADD3, and with b = a it folds
// `a > 1 ? b : a` to a.  So the kernel takes `zero`, an argument that is 0
// at run time and that ptxas cannot see: the add row alternates two
// predicates made from it (zero == 0, zero != 1), so no two neighbouring
// adds share a guard, and the select row starts from b0 = a ^ zero, which
// it uses once more after the chain (adding b0 - a = 0).  The function is
// unchanged.  chip_smoke.py counts the row's SASS instruction
// in each instantiation (cuobjdump -sass) and fails if any has fewer than
// K.  One thread per element; the i32 row multiplies as unsigned words
// (signed overflow is undefined in C++) and the u16 row uses PTX's 16-bit
// multiply, whose result is the low 16 bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 512;
constexpr int kThreads = 256;

template <int Row> struct Chain;

// 0: u32 add, the steps under two alternating (true) predicates
template <> struct Chain<0> {
  using T = uint32_t;
  __device__ static T run(T a, uint32_t zero) {
    T b = a;
#pragma unroll
    for (int k = 0; k < K; k += 2) {
      asm volatile(
          "{\n\t.reg .pred p;\n\tsetp.eq.u32 p, %2, 0;\n\t"
          "@p add.u32 %0, %0, %1;\n\t}"
          : "+r"(b) : "r"(a), "r"(zero));
      asm volatile(
          "{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %2, 1;\n\t"
          "@p add.u32 %0, %0, %1;\n\t}"
          : "+r"(b) : "r"(a), "r"(zero));
    }
    return b;
  }
};

// 1: u32 mul
template <> struct Chain<1> {
  using T = uint32_t;
  __device__ static T run(T a, uint32_t) {
    T b = a;
#pragma unroll
    for (int k = 0; k < K; ++k)
      asm volatile("mul.lo.u32 %0, %0, %1;" : "+r"(b) : "r"(a));
    return b;
  }
};

// 2: u32 mul (a<2^16 hint?): (b & 0xFFFF) * a
template <> struct Chain<2> {
  using T = uint32_t;
  __device__ static T run(T a, uint32_t) {
    T b = a;
#pragma unroll
    for (int k = 0; k < K; ++k)
      asm volatile("and.b32 %0, %0, 65535;\n\tmul.lo.u32 %0, %0, %1;"
                   : "+r"(b) : "r"(a));
    return b;
  }
};

// 3: u32 shift+and: (b >> 1) ^ (a & 0xFFFF); a & 0xFFFF is loop-invariant
template <> struct Chain<3> {
  using T = uint32_t;
  __device__ static T run(T a, uint32_t) {
    T b = a;
    const T lo = a & 0xFFFFu;
#pragma unroll
    for (int k = 0; k < K; ++k)
      asm volatile("shr.b32 %0, %0, 1;\n\txor.b32 %0, %0, %1;"
                   : "+r"(b) : "r"(lo));
    return b;
  }
};

// 4: i32 mul, as unsigned words (the low 32 bits are the same)
template <> struct Chain<4> {
  using T = uint32_t;
  __device__ static T run(T a, uint32_t z) { return Chain<1>::run(a, z); }
};

// 5: f32 mul, one rounding per step
template <> struct Chain<5> {
  using T = float;
  __device__ static T run(T a, uint32_t) {
    T b = a;
#pragma unroll
    for (int k = 0; k < K; ++k)
      asm volatile("mul.rn.f32 %0, %0, %1;" : "+f"(b) : "f"(a));
    return b;
  }
};

// 6: f32 fma-ish: b * a + a as one fused multiply-add (one rounding; the
// plain version rounds twice, hence the relative tolerance)
template <> struct Chain<6> {
  using T = float;
  __device__ static T run(T a, uint32_t) {
    T b = a;
#pragma unroll
    for (int k = 0; k < K; ++k)
      asm volatile("fma.rn.f32 %0, %0, %1, %1;" : "+f"(b) : "f"(a));
    return b;
  }
};

// 7: u16 mul
template <> struct Chain<7> {
  using T = unsigned short;
  __device__ static T run(T a, uint32_t) {
    T b = a;
#pragma unroll
    for (int k = 0; k < K; ++k)
      asm volatile("mul.lo.u16 %0, %0, %1;" : "+h"(b) : "h"(a));
    return b;
  }
};

// 8: u32 select: a > 1 ? b : a
template <> struct Chain<8> {
  using T = uint32_t;
  __device__ static T run(T a, uint32_t zero) {
    const T b0 = a ^ zero;
    T b = b0;
#pragma unroll
    for (int k = 0; k < K; ++k)
      asm volatile(
          "{\n\t.reg .pred p;\n\tsetp.gt.u32 p, %1, 1;\n\t"
          "selp.b32 %0, %0, %1, p;\n\t}"
          : "+r"(b) : "r"(a));
    // + 0: a second use of b0, so that ptxas cannot fold the first select
    // into a predicated definition of b0
    return b + (b0 - a);
  }
};

template <int Row>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const typename Chain<Row>::T* x, typename Chain<Row>::T* o,
             long n, uint32_t zero) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  o[i] = Chain<Row>::run(x[i], zero);
}

template <int Row>
cudaError_t launch(const void* x, void* o, long n, cudaStream_t s) {
  using T = typename Chain<Row>::T;
  chain_kernel<Row><<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                      s>>>((const T*)x, (T*)o, n, 0u);
  return cudaGetLastError();
}

}  // namespace

// Row `row` (0-8, the tool's order) over n elements of its type.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unknown row.
extern "C" int pm_primbench(long row, const void* x, void* o, long n,
                            void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (row) {
    case 0: return (int)launch<0>(x, o, n, s);
    case 1: return (int)launch<1>(x, o, n, s);
    case 2: return (int)launch<2>(x, o, n, s);
    case 3: return (int)launch<3>(x, o, n, s);
    case 4: return (int)launch<4>(x, o, n, s);
    case 5: return (int)launch<5>(x, o, n, s);
    case 6: return (int)launch<6>(x, o, n, s);
    case 7: return (int)launch<7>(x, o, n, s);
    case 8: return (int)launch<8>(x, o, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
