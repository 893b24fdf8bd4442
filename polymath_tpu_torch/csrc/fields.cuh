// Montgomery arithmetic over the BLS12-381 fields on 32-bit words.
//
// Elements are N little-endian 32-bit words in Montgomery form with the
// radix R = 2^(32 N): Fr N = 8 (R = 2^256), Fq N = 12 (R = 2^384).  That
// is the reference's radix, so every Montgomery value is bit-identical to
// the JAX package's 16-bit-limb arrays (word k = limb 2k | limb 2k+1 << 16).
//
// Every function returns a canonical (fully reduced) value from canonical
// inputs.  Both moduli leave spare top bits (p < R / 2), so a + b never
// overflows N words and the CIOS accumulator needs only N + 2 words.
//
// Data layout in device memory: "limb-major" -- word k of element i of a
// (K, M) tensor sits at ptr[k * stride + i], so neighbouring threads read
// neighbouring addresses for every word.
#pragma once
#include <stdint.h>

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

// t (N words + carry word hi) -> t mod p, given t < 2p.
template <class F>
__device__ __forceinline__ Fe<F> fe_reduce_once(const uint32_t* t,
                                                uint32_t hi) {
  Fe<F> d;
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < F::N; ++k) {
    uint64_t s = (uint64_t)t[k] - F::p(k) - borrow;
    d.w[k] = (uint32_t)s;
    borrow = (s >> 32) & 1;
  }
  const bool keep = (hi == 0) && borrow;  // t < p
  Fe<F> r;
#pragma unroll
  for (int k = 0; k < F::N; ++k) r.w[k] = keep ? t[k] : d.w[k];
  return r;
}

template <class F>
__device__ __forceinline__ Fe<F> fe_add(const Fe<F>& a, const Fe<F>& b) {
  uint32_t t[F::N];
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < F::N; ++k) {
    uint64_t s = (uint64_t)a.w[k] + b.w[k] + c;
    t[k] = (uint32_t)s;
    c = s >> 32;
  }
  return fe_reduce_once<F>(t, (uint32_t)c);
}

template <class F>
__device__ __forceinline__ Fe<F> fe_sub(const Fe<F>& a, const Fe<F>& b) {
  Fe<F> d;
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < F::N; ++k) {
    uint64_t s = (uint64_t)a.w[k] - b.w[k] - borrow;
    d.w[k] = (uint32_t)s;
    borrow = (s >> 32) & 1;
  }
  if (borrow) {  // a < b: add p back
    uint64_t c = 0;
#pragma unroll
    for (int k = 0; k < F::N; ++k) {
      uint64_t s = (uint64_t)d.w[k] + F::p(k) + c;
      d.w[k] = (uint32_t)s;
      c = s >> 32;
    }
  }
  return d;
}

// CIOS Montgomery product a * b * 2^(-32 N) mod p.
template <class F>
__device__ __forceinline__ Fe<F> fe_mul(const Fe<F>& a, const Fe<F>& b) {
  constexpr int N = F::N;
  uint32_t t[N + 2];
#pragma unroll
  for (int k = 0; k < N + 2; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint64_t s = (uint64_t)a.w[i] * b.w[j] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + c;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);
    const uint32_t m = t[0] * F::N0;
    s = (uint64_t)m * F::p(0) + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < N; ++j) {
      s = (uint64_t)m * F::p(j) + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[N] + c;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  return fe_reduce_once<F>(t, t[N]);
}

// Montgomery square: the 2N-word square with each cross product a_i a_j
// (j > i) computed once and doubled, then N reduction steps (SOS).
template <class F>
__device__ __forceinline__ Fe<F> fe_sqr(const Fe<F>& a) {
  constexpr int N = F::N;
  uint32_t t[2 * N + 1];
#pragma unroll
  for (int k = 0; k < 2 * N + 1; ++k) t[k] = 0;
  // cross products
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = i + 1; j < N; ++j) {
      uint64_t s = (uint64_t)a.w[i] * a.w[j] + t[i + j] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
    t[i + N] = (uint32_t)c;
  }
  // double
  uint32_t top = 0;
#pragma unroll
  for (int k = 2 * N - 1; k > 0; --k) {
    uint32_t v = t[k];
    t[k] = (v << 1) | (t[k - 1] >> 31);
    if (k == 2 * N - 1) top = v >> 31;
  }
  t[0] = t[0] << 1;
  t[2 * N] = top;
  // diagonal squares
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t sq = (uint64_t)a.w[i] * a.w[i];
    uint64_t s = (uint64_t)t[2 * i] + (uint32_t)sq + c;
    t[2 * i] = (uint32_t)s;
    s = (uint64_t)t[2 * i + 1] + (uint32_t)(sq >> 32) + (s >> 32);
    t[2 * i + 1] = (uint32_t)s;
    c = s >> 32;
  }
  t[2 * N] += (uint32_t)c;
  // reduction
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint32_t m = t[i] * F::N0;
    uint64_t cc = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint64_t s = (uint64_t)m * F::p(j) + t[i + j] + cc;
      t[i + j] = (uint32_t)s;
      cc = s >> 32;
    }
    // propagate the carry through the upper words
#pragma unroll
    for (int k = i + N; k < 2 * N + 1; ++k) {
      uint64_t s = (uint64_t)t[k] + cc;
      t[k] = (uint32_t)s;
      cc = s >> 32;
    }
  }
  return fe_reduce_once<F>(t + N, t[2 * N]);
}
