// BN254 field and G1 device functions shared by the port's CUDA kernels.
//
// Field elements are 8 little-endian 32-bit limbs in Montgomery form with
// R = 2^256 (the int32 [..., 8] tensors of spartan_tpu_torch). They
// replace the in-kernel blocks of spartan_tpu/ops/pallas_field.py:
//   fe_add / fe_sub  <- _add_block / _sub_block (:68, :73)
//   fe_mul           <- _mont_mul_cios_block (:87-142), CIOS with 32x32->64
//                       products instead of the TPU's 16-bit limbs
//   padd             <- _padd_block_narrow (:332)   RCB 2016 Alg 7, a = 0
//   padd_mixed       <- _padd_mixed_block_narrow (:361)   Alg 8
//   pdbl             <- _pdbl_block_narrow (:389)   Alg 9
// Every function returns canonical limbs (< p), so results are bit-exact
// with the plain PyTorch versions beside each kernel's wrapper.
//
// The header also compiles as plain C++ (no __CUDACC__), so the arithmetic
// can be checked on a host without a GPU.
#pragma once
#include <stdint.h>

#if defined(__CUDACC__)
#define BN_DEV __device__ __forceinline__
#else
#define BN_DEV inline
#endif

namespace bn254 {

// scalar field r
struct Fr {
  static constexpr uint32_t P0 = 0xf0000001u, P1 = 0x43e1f593u, P2 = 0x79b97091u,
                            P3 = 0x2833e848u, P4 = 0x8181585du, P5 = 0xb85045b6u,
                            P6 = 0xe131a029u, P7 = 0x30644e72u;
  static constexpr uint32_t INV = 0xefffffffu;  // -p^-1 mod 2^32
};

// base field q (curve coordinates)
struct Fq {
  static constexpr uint32_t P0 = 0xd87cfd47u, P1 = 0x3c208c16u, P2 = 0x6871ca8du,
                            P3 = 0x97816a91u, P4 = 0x8181585du, P5 = 0xb85045b6u,
                            P6 = 0xe131a029u, P7 = 0x30644e72u;
  static constexpr uint32_t INV = 0xe4866389u;
  // R mod q: the Montgomery form of 1
  static constexpr uint32_t R0 = 0xc58f0d9du, R1 = 0xd35d438du, R2 = 0xf5c70b3du,
                            R3 = 0x0a78eb28u, R4 = 0x7879462cu, R5 = 0x666ea36fu,
                            R6 = 0x9a07df2fu, R7 = 0x0e0a77c1u;
};

struct Fe {
  uint32_t v[8];
};

template <class F>
BN_DEV void load_p(uint32_t p[8]) {
  p[0] = F::P0; p[1] = F::P1; p[2] = F::P2; p[3] = F::P3;
  p[4] = F::P4; p[5] = F::P5; p[6] = F::P6; p[7] = F::P7;
}

// r = s - p if s >= p else s (s < 2p)
template <class F>
BN_DEV void cond_sub_p(uint32_t r[8], const uint32_t s[8]) {
  uint32_t p[8];
  load_p<F>(p);
  uint32_t d[8];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t t = (uint64_t)s[i] - p[i] - borrow;
    d[i] = (uint32_t)t;
    borrow = t >> 63;
  }
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = borrow ? s[i] : d[i];
}

template <class F>
BN_DEV void fe_add(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t s[8];
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)a[i] + b[i];
    s[i] = (uint32_t)c;
    c >>= 32;
  }
  // a + b < 2p < 2^255: no carry out of the top limb
  cond_sub_p<F>(r, s);
}

template <class F>
BN_DEV void fe_sub(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t d[8];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t t = (uint64_t)a[i] - b[i] - borrow;
    d[i] = (uint32_t)t;
    borrow = t >> 63;
  }
  uint32_t p[8];
  load_p<F>(p);
  const uint32_t mask = borrow ? 0xffffffffu : 0u;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    c += (uint64_t)d[i] + (p[i] & mask);
    r[i] = (uint32_t)c;
    c >>= 32;
  }
}

// Montgomery product a*b*R^-1 mod p, CIOS over 8 words. With a, b < p and
// p < 2^254 the running sum stays below 2p < 2^256, so t[8] ends at 0.
template <class F>
BN_DEV void fe_mul(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t p[8];
  load_p<F>(p);
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      c += (uint64_t)a[j] * b[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[8] = (uint32_t)c;
    t[9] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * F::INV;
    c = ((uint64_t)m * p[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; j++) {
      c += (uint64_t)m * p[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[7] = (uint32_t)c;
    t[8] = t[9] + (uint32_t)(c >> 32);
  }
  cond_sub_p<F>(r, t);
}

template <class F>
BN_DEV Fe add(const Fe& a, const Fe& b) {
  Fe r;
  fe_add<F>(r.v, a.v, b.v);
  return r;
}

template <class F>
BN_DEV Fe sub(const Fe& a, const Fe& b) {
  Fe r;
  fe_sub<F>(r.v, a.v, b.v);
  return r;
}

template <class F>
BN_DEV Fe mul(const Fe& a, const Fe& b) {
  Fe r;
  fe_mul<F>(r.v, a.v, b.v);
  return r;
}

// ---------------------------------------------------------------------------
// G1: y^2 = x^3 + 3 over Fq, homogeneous projective (X:Y:Z), identity (0:1:0)
// ---------------------------------------------------------------------------

struct Point {
  Fe X, Y, Z;
};

BN_DEV Fe fq_zero() {
  Fe r;
#pragma unroll
  for (int i = 0; i < 8; i++) r.v[i] = 0;
  return r;
}

BN_DEV Fe fq_one() {
  Fe r;
  r.v[0] = Fq::R0; r.v[1] = Fq::R1; r.v[2] = Fq::R2; r.v[3] = Fq::R3;
  r.v[4] = Fq::R4; r.v[5] = Fq::R5; r.v[6] = Fq::R6; r.v[7] = Fq::R7;
  return r;
}

BN_DEV Point identity() { return Point{fq_zero(), fq_one(), fq_zero()}; }

// 9a = 8a + a (b3 = 3 * 3)
BN_DEV Fe mul9(const Fe& a) {
  Fe a2 = add<Fq>(a, a);
  Fe a4 = add<Fq>(a2, a2);
  Fe a8 = add<Fq>(a4, a4);
  return add<Fq>(a8, a);
}

// complete addition, RCB 2016 Alg 7 with a = 0 (12 multiplications)
BN_DEV Point padd(const Point& P, const Point& Q) {
  Fe t0 = mul<Fq>(P.X, Q.X);
  Fe t1 = mul<Fq>(P.Y, Q.Y);
  Fe t2 = mul<Fq>(P.Z, Q.Z);
  Fe t3 = sub<Fq>(mul<Fq>(add<Fq>(P.X, P.Y), add<Fq>(Q.X, Q.Y)), add<Fq>(t0, t1));
  Fe t4 = sub<Fq>(mul<Fq>(add<Fq>(P.Y, P.Z), add<Fq>(Q.Y, Q.Z)), add<Fq>(t1, t2));
  Fe y3a = sub<Fq>(mul<Fq>(add<Fq>(P.X, P.Z), add<Fq>(Q.X, Q.Z)), add<Fq>(t0, t2));
  Fe t2b3 = mul9(t2);
  Fe y3b = mul9(y3a);
  Fe t0_3 = add<Fq>(add<Fq>(t0, t0), t0);
  Fe z3a = add<Fq>(t1, t2b3);
  Fe t1b = sub<Fq>(t1, t2b3);
  Fe a_ = mul<Fq>(t4, y3b);
  Fe bb = mul<Fq>(t3, t1b);
  Fe c_ = mul<Fq>(y3b, t0_3);
  Fe d_ = mul<Fq>(t1b, z3a);
  Fe e_ = mul<Fq>(t0_3, t3);
  Fe f_ = mul<Fq>(z3a, t4);
  return Point{sub<Fq>(bb, a_), add<Fq>(c_, d_), add<Fq>(f_, e_)};
}

// complete mixed addition P + (x2, y2), RCB 2016 Alg 8 (11 multiplications);
// (x2, y2) must be an affine point, never the identity
BN_DEV Point padd_mixed(const Point& P, const Fe& x2, const Fe& y2) {
  Fe t0 = mul<Fq>(P.X, x2);
  Fe t1 = mul<Fq>(P.Y, y2);
  Fe t3 = sub<Fq>(mul<Fq>(add<Fq>(x2, y2), add<Fq>(P.X, P.Y)), add<Fq>(t0, t1));
  Fe t4 = add<Fq>(mul<Fq>(y2, P.Z), P.Y);
  Fe y3 = add<Fq>(mul<Fq>(x2, P.Z), P.X);
  Fe t0_3 = add<Fq>(add<Fq>(t0, t0), t0);
  Fe t2 = mul9(P.Z);
  Fe z3 = add<Fq>(t1, t2);
  Fe t1b = sub<Fq>(t1, t2);
  Fe y3b = mul9(y3);
  Fe X3 = sub<Fq>(mul<Fq>(t3, t1b), mul<Fq>(t4, y3b));
  Fe Y3 = add<Fq>(mul<Fq>(t1b, z3), mul<Fq>(y3b, t0_3));
  Fe Z3 = add<Fq>(mul<Fq>(z3, t4), mul<Fq>(t0_3, t3));
  return Point{X3, Y3, Z3};
}

// complete doubling, RCB 2016 Alg 9 with a = 0
BN_DEV Point pdbl(const Point& P) {
  Fe t0 = mul<Fq>(P.Y, P.Y);
  Fe t1 = mul<Fq>(P.Y, P.Z);
  Fe t2 = mul<Fq>(P.Z, P.Z);
  Fe xy = mul<Fq>(P.X, P.Y);
  Fe t0_2 = add<Fq>(t0, t0);
  Fe t0_4 = add<Fq>(t0_2, t0_2);
  Fe z3a = add<Fq>(t0_4, t0_4);
  Fe t2b3 = mul9(t2);
  Fe y3a = add<Fq>(t0, t2b3);
  Fe t2b3_3 = add<Fq>(add<Fq>(t2b3, t2b3), t2b3);
  Fe t0c = sub<Fq>(t0, t2b3_3);
  Fe x3a = mul<Fq>(t2b3, z3a);
  Fe Z3 = mul<Fq>(t1, z3a);
  Fe y3b = mul<Fq>(t0c, y3a);
  Fe x3b = mul<Fq>(t0c, xy);
  return Point{add<Fq>(x3b, x3b), add<Fq>(x3a, y3b), Z3};
}

#if defined(__CUDACC__)
// one element = two 16-byte words; callers guarantee 16-byte alignment
__device__ __forceinline__ Fe load_fe(const uint4* __restrict__ p) {
  const uint4 lo = __ldg(p), hi = __ldg(p + 1);
  return Fe{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
}

__device__ __forceinline__ void store_fe(uint4* __restrict__ p, const Fe& a) {
  p[0] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
  p[1] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
}

__device__ __forceinline__ Point load_point(const uint4* x, const uint4* y,
                                            const uint4* z, long long i) {
  return Point{load_fe(x + 2 * i), load_fe(y + 2 * i), load_fe(z + 2 * i)};
}

__device__ __forceinline__ void store_point(uint4* x, uint4* y, uint4* z,
                                            long long i, const Point& P) {
  store_fe(x + 2 * i, P.X);
  store_fe(y + 2 * i, P.Y);
  store_fe(z + 2 * i, P.Z);
}

BN_DEV Fe fr_zero() { return fq_zero(); }

// Fr sum over the warp, exact mod p; lane 0 holds the warp's total
__device__ __forceinline__ Fe warp_sum_fr(Fe x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Fe y;
#pragma unroll
    for (int k = 0; k < 8; k++) y.v[k] = __shfl_down_sync(0xffffffffu, x.v[k], o);
    x = add<Fr>(x, y);
  }
  return x;
}

// Block sum of each of E per-thread Fr accumulators, with modular adds
// (warp shuffles, then one warp over the warps' totals); thread 0 writes
// the E canonical sums to out[0..E) (E elements of two uint4 each). Every
// thread of the block must call it.
template <int E>
__device__ __forceinline__ void block_sum_store(const Fe (&acc)[E], uint4* __restrict__ out) {
  __shared__ Fe part[E][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int e = 0; e < E; e++) {
    const Fe s = warp_sum_fr(acc[e]);
    if (lane == 0) part[e][warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int e = 0; e < E; e++) {
      const Fe s = warp_sum_fr(lane < nwarps ? part[e][lane] : fr_zero());
      if (lane == 0) store_fe(out + 2 * e, s);
    }
  }
}
#endif

}  // namespace bn254
