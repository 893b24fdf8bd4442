// Montgomery arithmetic over the BLS12-381 fields on 32-bit words.
//
// Elements are N little-endian 32-bit words in Montgomery form with the
// radix R = 2^(32 N): Fr N = 8 (R = 2^256), Fq N = 12 (R = 2^384).  That
// is the reference's radix, so every Montgomery value is bit-identical to
// the JAX package's 16-bit-limb arrays (word k = limb 2k | limb 2k+1 << 16).
//
// Every function returns a canonical (fully reduced) value from canonical
// inputs.  Both moduli leave spare top bits (2p < R), so a + b and every
// partial sum of the Montgomery product fit N words and a carry word.
//
// The arithmetic is written in PTX carry chains: add.cc / addc,
// sub.cc / subc and mad.lo.cc / madc.hi.cc, whose carry flag (CC.CF) runs
// from one instruction to the next.  Each helper below is one instruction;
// a chain is a run of them with nothing between that touches the flag
// (asm volatile keeps their order).  Built with a host compiler instead of
// nvcc, the same helpers emulate the instructions on a host carry flag, so
// the CPU tests run this exact schedule (tests/test_torch_fields.py).
//
// Data layout in device memory: "limb-major" -- word k of element i of a
// (K, M) tensor sits at ptr[k * stride + i], so neighbouring threads read
// neighbouring addresses for every word.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define PM_CHAIN(op, ...)                                         \
  uint32_t r;                                                     \
  asm volatile(op : "=r"(r) : __VA_ARGS__);                       \
  return r;
__device__ __forceinline__ uint32_t add_cc(uint32_t a, uint32_t b) {
  PM_CHAIN("add.cc.u32 %0, %1, %2;", "r"(a), "r"(b))
}
__device__ __forceinline__ uint32_t addc_cc(uint32_t a, uint32_t b) {
  PM_CHAIN("addc.cc.u32 %0, %1, %2;", "r"(a), "r"(b))
}
__device__ __forceinline__ uint32_t addc(uint32_t a, uint32_t b) {
  PM_CHAIN("addc.u32 %0, %1, %2;", "r"(a), "r"(b))
}
__device__ __forceinline__ uint32_t sub_cc(uint32_t a, uint32_t b) {
  PM_CHAIN("sub.cc.u32 %0, %1, %2;", "r"(a), "r"(b))
}
__device__ __forceinline__ uint32_t subc_cc(uint32_t a, uint32_t b) {
  PM_CHAIN("subc.cc.u32 %0, %1, %2;", "r"(a), "r"(b))
}
__device__ __forceinline__ uint32_t subc(uint32_t a, uint32_t b) {
  PM_CHAIN("subc.u32 %0, %1, %2;", "r"(a), "r"(b))
}
__device__ __forceinline__ uint32_t mad_lo_cc(uint32_t a, uint32_t b,
                                              uint32_t c) {
  PM_CHAIN("mad.lo.cc.u32 %0, %1, %2, %3;", "r"(a), "r"(b), "r"(c))
}
__device__ __forceinline__ uint32_t madc_lo_cc(uint32_t a, uint32_t b,
                                               uint32_t c) {
  PM_CHAIN("madc.lo.cc.u32 %0, %1, %2, %3;", "r"(a), "r"(b), "r"(c))
}
__device__ __forceinline__ uint32_t madc_hi_cc(uint32_t a, uint32_t b,
                                               uint32_t c) {
  PM_CHAIN("madc.hi.cc.u32 %0, %1, %2, %3;", "r"(a), "r"(b), "r"(c))
}
__device__ __forceinline__ uint32_t madc_hi(uint32_t a, uint32_t b,
                                            uint32_t c) {
  PM_CHAIN("madc.hi.u32 %0, %1, %2, %3;", "r"(a), "r"(b), "r"(c))
}
#undef PM_CHAIN
__device__ __forceinline__ uint32_t mul_hi(uint32_t a, uint32_t b) {
  return __umulhi(a, b);
}
#else  // host emulation of the same instructions (the CPU tests)
#define __device__
#define __forceinline__ inline
inline thread_local uint32_t pm_cf = 0;  // CC.CF, one a thread as on the card
inline uint32_t pm_set(uint64_t s) {
  pm_cf = (uint32_t)(s >> 32) & 1;
  return (uint32_t)s;
}
inline uint32_t pm_lo(uint32_t a, uint32_t b) { return a * b; }
inline uint32_t mul_hi(uint32_t a, uint32_t b) {
  return (uint32_t)(((uint64_t)a * b) >> 32);
}
inline uint32_t add_cc(uint32_t a, uint32_t b) {
  return pm_set((uint64_t)a + b);
}
inline uint32_t addc_cc(uint32_t a, uint32_t b) {
  return pm_set((uint64_t)a + b + pm_cf);
}
inline uint32_t addc(uint32_t a, uint32_t b) { return a + b + pm_cf; }
inline uint32_t sub_cc(uint32_t a, uint32_t b) {  // CF = borrow out
  return pm_set((uint64_t)a - b);
}
inline uint32_t subc_cc(uint32_t a, uint32_t b) {
  return pm_set((uint64_t)a - b - pm_cf);
}
inline uint32_t subc(uint32_t a, uint32_t b) { return a - b - pm_cf; }
inline uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return pm_set((uint64_t)pm_lo(a, b) + c);
}
inline uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) {
  return pm_set((uint64_t)pm_lo(a, b) + c + pm_cf);
}
inline uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) {
  return pm_set((uint64_t)mul_hi(a, b) + c + pm_cf);
}
inline uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) {
  return mul_hi(a, b) + c + pm_cf;
}
#endif

struct FrP {
  static constexpr int N = 8;
  __device__ static inline uint32_t p(int i) {
    constexpr uint32_t P[8] = {0x00000001u, 0xffffffffu, 0xfffe5bfeu,
                               0x53bda402u, 0x09a1d805u, 0x3339d808u,
                               0x299d7d48u, 0x73eda753u};
    return P[i];
  }
  static constexpr uint32_t N0 = 0xffffffffu;  // -p^-1 mod 2^32
};

struct FqP {
  static constexpr int N = 12;
  __device__ static inline uint32_t p(int i) {
    constexpr uint32_t P[12] = {0xffffaaabu, 0xb9feffffu, 0xb153ffffu,
                                0x1eabfffeu, 0xf6b0f624u, 0x6730d2a0u,
                                0xf38512bfu, 0x64774b84u, 0x434bacd7u,
                                0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
    return P[i];
  }
  __device__ static inline uint32_t one(int i) {  // R mod p (Montgomery 1)
    constexpr uint32_t O[12] = {0x0002fffdu, 0x76090000u, 0xc40c0002u,
                                0xebf4000bu, 0x53c758bau, 0x5f489857u,
                                0x70525745u, 0x77ce5853u, 0xa256ec6du,
                                0x5c071a97u, 0xfa80e493u, 0x15f65ec3u};
    return O[i];
  }
  static constexpr uint32_t N0 = 0xfffcfffdu;
};

template <class F>
struct Fe {
  uint32_t w[F::N];
};

template <class F>
__device__ __forceinline__ Fe<F> fe_load(const uint32_t* ptr, long stride,
                                         long i) {
  Fe<F> r;
#pragma unroll
  for (int k = 0; k < F::N; ++k) r.w[k] = ptr[k * stride + i];
  return r;
}

template <class F>
__device__ __forceinline__ void fe_store(uint32_t* ptr, long stride, long i,
                                         const Fe<F>& a) {
#pragma unroll
  for (int k = 0; k < F::N; ++k) ptr[k * stride + i] = a.w[k];
}

template <class F>
__device__ __forceinline__ Fe<F> fe_zero() {
  Fe<F> r;
#pragma unroll
  for (int k = 0; k < F::N; ++k) r.w[k] = 0;
  return r;
}

template <class F>
__device__ __forceinline__ bool fe_is_zero(const Fe<F>& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < F::N; ++k) acc |= a.w[k];
  return acc == 0;
}

template <class F>
__device__ __forceinline__ bool fe_eq(const Fe<F>& a, const Fe<F>& b) {
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < F::N; ++k) acc |= a.w[k] ^ b.w[k];
  return acc == 0;
}

// t (N words + carry word hi) -> t mod p, given t < 2p: t - p in one
// borrow chain, kept unless it borrowed past hi.
template <class F>
__device__ __forceinline__ Fe<F> fe_reduce_once(const uint32_t* t,
                                                uint32_t hi) {
  constexpr int N = F::N;
  uint32_t d[N];
  d[0] = sub_cc(t[0], F::p(0));
#pragma unroll
  for (int k = 1; k < N; ++k) d[k] = subc_cc(t[k], F::p(k));
  const uint32_t keep = subc(hi, 0);  // all ones iff t < p
  Fe<F> r;
#pragma unroll
  for (int k = 0; k < N; ++k) r.w[k] = (t[k] & keep) | (d[k] & ~keep);
  return r;
}

template <class F>
__device__ __forceinline__ Fe<F> fe_add(const Fe<F>& a, const Fe<F>& b) {
  constexpr int N = F::N;
  uint32_t t[N];
  t[0] = add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int k = 1; k < N; ++k) t[k] = addc_cc(a.w[k], b.w[k]);
  return fe_reduce_once<F>(t, addc(0, 0));
}

// a - b, plus p where that borrowed (p masked by the borrow, no branch).
template <class F>
__device__ __forceinline__ Fe<F> fe_sub(const Fe<F>& a, const Fe<F>& b) {
  constexpr int N = F::N;
  Fe<F> d;
  d.w[0] = sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int k = 1; k < N; ++k) d.w[k] = subc_cc(a.w[k], b.w[k]);
  const uint32_t mask = subc(0, 0);  // all ones iff a < b
  d.w[0] = add_cc(d.w[0], F::p(0) & mask);
#pragma unroll
  for (int k = 1; k < N - 1; ++k) d.w[k] = addc_cc(d.w[k], F::p(k) & mask);
  d.w[N - 1] = addc(d.w[N - 1], F::p(N - 1) & mask);
  return d;
}

// -- the Montgomery product ---------------------------------------------------
//
// CIOS (one word of b at a time, each followed by one reduction step) with
// the columns split by parity.  The product a[j] * b_i lands in words j
// (low half) and j + 1 (high half); summing only the even j gives words
// 0 .. N-1 with one product word each, the odd j words 1 .. N.  So the
// state is two accumulators, "even" (words 0 .. N-1) and "odd" (words
// 1 .. N), and each adds a row of products in a single chain of N
// mad.lo.cc / madc.hi.cc, one instruction a product word, where one array
// would need a second chain for the high halves.  The chains of the two
// arrays do not feed each other within a step.
//
// After a step the even array's word 0 is zero (that is what the reduction
// digit m is for) and the value is divided by 2^32: the odd array, now at
// words 0 .. N-1, becomes the next step's even one, and the old even one,
// now at words -1 .. N-2, is added into the next odd one as it is formed
// (madc_n_rshift): the two swap roles every step, with no merge pass
// until the end.  Every partial sum is below 2^32 * 2p < 2^(32 (N + 1)),
// so the carries the chains drop out of the top are zero.

// acc[j], acc[j+1] = lo, hi (a[j] * bi) for j = 0, 2, ..., n - 2
template <int n>
__device__ __forceinline__ void mul_n(uint32_t* acc, const uint32_t* a,
                                      uint32_t bi) {
#pragma unroll
  for (int j = 0; j < n; j += 2) {
    acc[j] = a[j] * bi;
    acc[j + 1] = mul_hi(a[j], bi);
  }
}

// acc += lo, hi (a[j] * bi) at j, j + 1 (j even); the carry out is left in
// CC.CF
template <int n>
__device__ __forceinline__ void cmad_n(uint32_t* acc, const uint32_t* a,
                                       uint32_t bi) {
  acc[0] = mad_lo_cc(a[0], bi, acc[0]);
  acc[1] = madc_hi_cc(a[0], bi, acc[1]);
#pragma unroll
  for (int j = 2; j < n; j += 2) {
    acc[j] = madc_lo_cc(a[j], bi, acc[j]);
    acc[j + 1] = madc_hi_cc(a[j], bi, acc[j + 1]);
  }
}

// odd = odd shifted down two words + lo, hi (a[j] * bi) at j, j + 1, with
// the carry in CC.CF taken in at word 0
template <int n>
__device__ __forceinline__ void madc_n_rshift(uint32_t* odd,
                                              const uint32_t* a,
                                              uint32_t bi) {
#pragma unroll
  for (int j = 0; j < n - 2; j += 2) {
    odd[j] = madc_lo_cc(a[j], bi, odd[j + 2]);
    odd[j + 1] = madc_hi_cc(a[j], bi, odd[j + 3]);
  }
  odd[n - 2] = madc_lo_cc(a[n - 2], bi, 0);
  odd[n - 1] = madc_hi(a[n - 2], bi, 0);
}

// One step: (even, odd) += a * bi + m * p, with m the reduction digit that
// clears word 0; after it ``even`` holds words 0 .. N-1 (word 0 zero) and
// ``odd`` words 1 .. N.  The first step starts from nothing; every other
// takes the previous step's arrays with their roles swapped: ``even`` (the
// previous odd) at words 0 .. N-1, ``odd`` (the previous even) at -1 .. N-2.
template <class F>
__device__ __forceinline__ void mad_n_redc(uint32_t* even, uint32_t* odd,
                                           const uint32_t* a, uint32_t bi,
                                           const uint32_t* p, bool first) {
  constexpr int N = F::N;
  if (first) {
    mul_n<N>(odd, a + 1, bi);
    mul_n<N>(even, a, bi);
  } else {
    even[0] = add_cc(even[0], odd[1]);
    madc_n_rshift<N>(odd, a + 1, bi);
    cmad_n<N>(even, a, bi);
    odd[N - 1] = addc(odd[N - 1], 0);
  }
  const uint32_t m = even[0] * F::N0;
  cmad_n<N>(odd, p + 1, m);
  cmad_n<N>(even, p, m);
  odd[N - 1] = addc(odd[N - 1], 0);
}

// Montgomery product a * b * 2^(-32 N) mod p.
template <class F>
__device__ __forceinline__ Fe<F> fe_mul(const Fe<F>& a, const Fe<F>& b) {
  constexpr int N = F::N;
  uint32_t p[N], even[N], odd[N];
#pragma unroll
  for (int k = 0; k < N; ++k) p[k] = F::p(k);
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    mad_n_redc<F>(even, odd, a.w, b.w[i], p, i == 0);
    mad_n_redc<F>(odd, even, a.w, b.w[i + 1], p, false);
  }
  // the last step left even at words 0 .. N-1 and odd at -1 .. N-2
  even[0] = add_cc(even[0], odd[1]);
#pragma unroll
  for (int k = 1; k < N - 1; ++k) even[k] = addc_cc(even[k], odd[k + 1]);
  even[N - 1] = addc(even[N - 1], 0);
  return fe_reduce_once<F>(even, 0);
}

// Montgomery square.
template <class F>
__device__ __forceinline__ Fe<F> fe_sqr(const Fe<F>& a) {
  return fe_mul<F>(a, a);
}
