// G1 (BLS12-381) Jacobian point kernels on Fq as 12 x 32-bit words.
//
// Replaces, from polymath_tpu/ops:
//   pallas_curve.py:_madd_kernel(fast, packed)  -> g1_madd_kernel   (B3)
//   pallas_gather.py:_gather_kernel            -> g1_gather_kernel (B4)
//   pallas_curve.py:_add_kernel                -> g1_add_kernel    (B5)
// and adds g1_to_affine_kernel, a port-only kernel with no TPU counterpart:
// the reference inverts Z by Fermat in XLA (fixed_base.jac_to_affine_batch);
// in eager PyTorch that is ~570 Fq products per point as separate launches.
//
// One thread per point.  The formulas and every degenerate-case select are
// those of ll.py:ll_jac_madd / ll_jac_add / ll_jac_double / ll_mdbl, so the
// outputs equal curve_jax word for word (all field values are canonical).
// Where a select of the reference overrides a lane, the kernel returns early
// instead of computing the overridden value.
//
// Bound on the H100: integer multiplies.  A madd is 11 Fq products (8M+3S),
// a general add 16, each ~2*144 wide 32x32 products; the 36+24 words of
// traffic per madd are ~240 bytes, far below the multiply time.  The madd
// holds ~130 live words per thread, so expect register spills (nvcc -Xptxas
// -v prints them); tuning them is later work.
#include <cuda_runtime.h>
#include "fields.cuh"

namespace {

typedef Fe<FqP> Fq;

struct Jac {
  Fq x, y, z;
};

__device__ __forceinline__ Fq fq_one() {
  Fq r;
#pragma unroll
  for (int k = 0; k < FqP::N; ++k) r.w[k] = FqP::one(k);
  return r;
}

__device__ __forceinline__ Jac jac_identity() {
  Jac r;
  r.x = fq_one();
  r.y = fq_one();
  r.z = fe_zero<FqP>();
  return r;
}

__device__ __forceinline__ Fq dbl(const Fq& a) { return fe_add<FqP>(a, a); }

// dbl-2009-l (a = 0): 2M + 5S.
__device__ Jac jac_double(const Jac& p) {
  Fq A = fe_sqr<FqP>(p.x);
  Fq B = fe_sqr<FqP>(p.y);
  Fq C = fe_sqr<FqP>(B);
  Fq t = fe_sqr<FqP>(fe_add<FqP>(p.x, B));
  Fq D = dbl(fe_sub<FqP>(fe_sub<FqP>(t, A), C));
  Fq E = fe_add<FqP>(dbl(A), A);
  Jac r;
  r.x = fe_sub<FqP>(fe_sub<FqP>(fe_sqr<FqP>(E), D), D);
  Fq C8 = dbl(dbl(dbl(C)));
  r.y = fe_sub<FqP>(fe_mul<FqP>(E, fe_sub<FqP>(D, r.x)), C8);
  r.z = fe_mul<FqP>(dbl(p.y), p.z);
  return r;
}

// mdbl-2007-bl: double an affine point, 1M + 5S.
__device__ Jac mdbl(const Fq& x1, const Fq& y1) {
  Fq XX = fe_sqr<FqP>(x1);
  Fq YY = fe_sqr<FqP>(y1);
  Fq YYYY = fe_sqr<FqP>(YY);
  Fq t = fe_sqr<FqP>(fe_add<FqP>(x1, YY));
  Fq S = dbl(fe_sub<FqP>(fe_sub<FqP>(t, XX), YYYY));
  Fq M = fe_add<FqP>(dbl(XX), XX);
  Jac r;
  r.x = fe_sub<FqP>(fe_sub<FqP>(fe_sqr<FqP>(M), S), S);
  Fq C8 = dbl(dbl(dbl(YYYY)));
  r.y = fe_sub<FqP>(fe_mul<FqP>(M, fe_sub<FqP>(S, r.x)), C8);
  r.z = dbl(y1);
  return r;
}

// add-2007-bl, 11M + 5S; P == Q doubles, P == -Q gives the identity.
__device__ Jac jac_add(const Jac& p, const Jac& q) {
  if (fe_is_zero<FqP>(p.z)) return q;
  if (fe_is_zero<FqP>(q.z)) return p;
  Fq Z1Z1 = fe_sqr<FqP>(p.z);
  Fq Z2Z2 = fe_sqr<FqP>(q.z);
  Fq U1 = fe_mul<FqP>(p.x, Z2Z2);
  Fq U2 = fe_mul<FqP>(q.x, Z1Z1);
  Fq S1 = fe_mul<FqP>(fe_mul<FqP>(p.y, q.z), Z2Z2);
  Fq S2 = fe_mul<FqP>(fe_mul<FqP>(q.y, p.z), Z1Z1);
  if (fe_eq<FqP>(U1, U2))
    return fe_eq<FqP>(S1, S2) ? jac_double(p) : jac_identity();
  Fq H = fe_sub<FqP>(U2, U1);
  Fq HH = fe_sqr<FqP>(dbl(H));
  Fq J = fe_mul<FqP>(H, HH);
  Fq rr = dbl(fe_sub<FqP>(S2, S1));
  Fq V = fe_mul<FqP>(U1, HH);
  Jac r;
  r.x = fe_sub<FqP>(fe_sub<FqP>(fe_sqr<FqP>(rr), J), dbl(V));
  Fq S1J = fe_mul<FqP>(S1, J);
  r.y = fe_sub<FqP>(fe_mul<FqP>(rr, fe_sub<FqP>(V, r.x)), dbl(S1J));
  Fq ZZ = fe_sub<FqP>(
      fe_sub<FqP>(fe_sqr<FqP>(fe_add<FqP>(p.z, q.z)), Z1Z1), Z2Z2);
  r.z = fe_mul<FqP>(ZZ, H);
  return r;
}

// madd-2007-bl, 8M + 3S: Jacobian += affine (identity = (0, 0)).  fast:
// no doubling fallback; a lane that needs one sets *coll and returns the
// formula's all-zero value (the caller asserts the flag and reruns safe).
__device__ Jac jac_madd(const Jac& p, const Fq& x2, const Fq& y2, bool fast,
                        bool* coll) {
  if (fe_is_zero<FqP>(y2)) return p;
  if (fe_is_zero<FqP>(p.z)) {
    Jac r;
    r.x = x2;
    r.y = y2;
    r.z = fq_one();
    return r;
  }
  Fq Z1Z1 = fe_sqr<FqP>(p.z);
  Fq U2 = fe_mul<FqP>(x2, Z1Z1);
  Fq S2 = fe_mul<FqP>(fe_mul<FqP>(y2, p.z), Z1Z1);
  if (fe_eq<FqP>(U2, p.x)) {
    if (!fe_eq<FqP>(S2, p.y)) return jac_identity();
    if (!fast) return mdbl(x2, y2);
    *coll = true;
    Jac r;
    r.x = fe_zero<FqP>();
    r.y = fe_zero<FqP>();
    r.z = fe_zero<FqP>();
    return r;
  }
  Fq H = fe_sub<FqP>(U2, p.x);
  Fq I = fe_sqr<FqP>(dbl(H));
  Fq J = fe_mul<FqP>(H, I);
  Fq rr = dbl(fe_sub<FqP>(S2, p.y));
  Fq V = fe_mul<FqP>(p.x, I);
  Jac r;
  r.x = fe_sub<FqP>(fe_sub<FqP>(fe_sqr<FqP>(rr), J), dbl(V));
  Fq YJ = fe_mul<FqP>(p.y, J);
  r.y = fe_sub<FqP>(fe_mul<FqP>(rr, fe_sub<FqP>(V, r.x)), dbl(YJ));
  r.z = fe_mul<FqP>(dbl(p.z), H);
  return r;
}

__device__ __forceinline__ Jac load_jac(const uint32_t* ptr, long stride,
                                        long i) {
  Jac r;
  r.x = fe_load<FqP>(ptr, stride, i);
  r.y = fe_load<FqP>(ptr + 12 * stride, stride, i);
  r.z = fe_load<FqP>(ptr + 24 * stride, stride, i);
  return r;
}

__device__ __forceinline__ void store_jac(uint32_t* ptr, long stride, long i,
                                          const Jac& r) {
  fe_store<FqP>(ptr, stride, i, r.x);
  fe_store<FqP>(ptr + 12 * stride, stride, i, r.y);
  fe_store<FqP>(ptr + 24 * stride, stride, i, r.z);
}

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

// out[:, j] = table[idx[j], :] (limb-major); idx == T gives the zero row,
// the affine identity.  Each 96-byte row is read as six 16-byte vectors.
__global__ void g1_gather_kernel(const uint4* table, long T,
                                 const int64_t* idx, uint32_t* out,
                                 long out_stride, long m) {
  const long j = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const long r = idx[j];
  uint32_t w[24];
  if (r >= 0 && r < T) {
#pragma unroll
    for (int v = 0; v < 6; ++v) {
      uint4 q = table[r * 6 + v];
      w[4 * v] = q.x;
      w[4 * v + 1] = q.y;
      w[4 * v + 2] = q.z;
      w[4 * v + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 24; ++k) w[k] = 0;
  }
#pragma unroll
  for (int k = 0; k < 24; ++k) out[k * out_stride + j] = w[k];
}

// Jacobian -> affine by a per-thread Fermat inversion of Z (Z^(q-2));
// Z == 0 gives (0, 0), the affine identity.
__global__ void __launch_bounds__(kThreads)
g1_to_affine_kernel(const uint32_t* p, long p_stride, uint32_t* out,
                    long out_stride, long m) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  Jac a = load_jac(p, p_stride, i);
  Fq zinv = fq_one();
  // q - 2, most significant word first; left-to-right square-and-multiply
  for (int k = FqP::N - 1; k >= 0; --k) {
    const uint32_t e = FqP::p(k) - (k == 0 ? 2u : 0u);
    for (int b = 31; b >= 0; --b) {
      zinv = fe_sqr<FqP>(zinv);
      if ((e >> b) & 1u) zinv = fe_mul<FqP>(zinv, a.z);
    }
  }
  Fq zinv2 = fe_sqr<FqP>(zinv);
  fe_store<FqP>(out, out_stride, i, fe_mul<FqP>(a.x, zinv2));
  fe_store<FqP>(out + 12 * out_stride, out_stride, i,
                fe_mul<FqP>(a.y, fe_mul<FqP>(zinv2, zinv)));
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
    g1_gather_kernel<<<blocks_for(m, 256), 256, 0, (cudaStream_t)stream>>>(
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
