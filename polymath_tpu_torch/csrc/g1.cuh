// G1 (BLS12-381) Jacobian point formulas on Fq as 12 x 32-bit words, shared
// by g1.cu (point kernels) and scan.cu (the fused MSM bucket scan).
//
// The formulas and every degenerate-case select are those of
// ll.py:ll_jac_madd / ll_jac_add / ll_jac_double / ll_mdbl, so the outputs
// equal curve_jax word for word (all field values are canonical).  Where a
// select of the reference overrides a lane, the function returns early
// instead of computing the overridden value.
#pragma once
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

}  // namespace
