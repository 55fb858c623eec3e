// BN254 field and G1 device functions shared by the port's CUDA kernels.
//
// Field elements are 8 little-endian 32-bit limbs in Montgomery form with
// R = 2^256 (the int32 [..., 8] tensors of spartan_tpu_torch). They
// replace the in-kernel blocks of spartan_tpu/ops/pallas_field.py:
//   fe_add / fe_sub  <- _add_block / _sub_block (:68, :73)
//   fe_mul           <- _mont_mul_cios_block (:87-142), CIOS on 32-bit words
//                       instead of the TPU's 16-bit limbs
//   padd             <- _padd_block_narrow (:332)   RCB 2016 Alg 7, a = 0
//   padd_mixed       <- _padd_mixed_block_narrow (:361)   Alg 8
//   pdbl             <- _pdbl_block_narrow (:389)   Alg 9
// Every function returns canonical limbs (< p), so results are bit-exact
// with the plain PyTorch versions beside each kernel's wrapper.
//
// Carry chains. The multiword adds, subtracts and the Montgomery product
// are written with the PTX carry-flag instructions (add.cc / addc.cc,
// sub.cc / subc.cc, mad.lo.cc / madc.hi.cc, in namespace cc below): the
// sums ride the carry flag along a row, with no 64-bit temporaries, shifts
// or compares.
// Each cc function is one volatile asm statement, so nvcc keeps their order
// and a chain's flag passes from one to the next (only .cc instructions
// touch it).
//
// The host build. The header also compiles as plain C++ (no __CUDACC__):
// there the cc functions emulate the same instructions with a thread-local
// carry flag, so a host program runs exactly the sequence of word
// operations the device runs (the CPU tests compile it and hold it against
// the plain versions). What the host build cannot check is the PTX itself;
// chip_smoke.py holds every kernel against its plain version on the card.
// This is a split of the build, not a runtime choice: a CUDA build has
// only the PTX form.
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

// One 32-bit PTX instruction each; CF is the carry flag (a borrow for the
// subtracts). *_cc set CF, *c* read it.
namespace cc {
#if defined(__CUDACC__)
#define BN_CC2(fn, ins)                                                  \
  __device__ __forceinline__ uint32_t fn(uint32_t a, uint32_t b) {      \
    uint32_t d;                                                          \
    asm volatile(ins " %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));         \
    return d;                                                            \
  }
#define BN_CC3(fn, ins)                                                        \
  __device__ __forceinline__ uint32_t fn(uint32_t a, uint32_t b, uint32_t c) { \
    uint32_t d;                                                                \
    asm volatile(ins " %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));   \
    return d;                                                                  \
  }
BN_CC2(add_cc, "add.cc.u32")          // a + b
BN_CC2(addc_cc, "addc.cc.u32")        // a + b + CF
BN_CC2(addc, "addc.u32")              // a + b + CF, CF kept
BN_CC2(sub_cc, "sub.cc.u32")          // a - b
BN_CC2(subc_cc, "subc.cc.u32")        // a - b - CF
BN_CC2(subc, "subc.u32")              // a - b - CF, CF kept
BN_CC3(mad_lo_cc, "mad.lo.cc.u32")    // lo(a b) + c
BN_CC3(madc_lo_cc, "madc.lo.cc.u32")  // lo(a b) + c + CF
BN_CC3(mad_hi_cc, "mad.hi.cc.u32")    // hi(a b) + c
BN_CC3(madc_hi_cc, "madc.hi.cc.u32")  // hi(a b) + c + CF
BN_CC3(madc_hi, "madc.hi.u32")        // hi(a b) + c + CF, CF kept
#undef BN_CC2
#undef BN_CC3
#else
inline uint32_t& flag() {
  static thread_local uint32_t cf = 0;
  return cf;
}
inline uint32_t put(uint64_t s) {
  flag() = (uint32_t)(s >> 32);
  return (uint32_t)s;
}
inline uint32_t borrow(uint64_t d) {
  flag() = (uint32_t)(d >> 63);
  return (uint32_t)d;
}
inline uint32_t lo(uint32_t a, uint32_t b) { return a * b; }
inline uint32_t hi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
inline uint32_t add_cc(uint32_t a, uint32_t b) { return put((uint64_t)a + b); }
inline uint32_t addc_cc(uint32_t a, uint32_t b) { return put((uint64_t)a + b + flag()); }
inline uint32_t addc(uint32_t a, uint32_t b) { return a + b + flag(); }
inline uint32_t sub_cc(uint32_t a, uint32_t b) { return borrow((uint64_t)a - b); }
inline uint32_t subc_cc(uint32_t a, uint32_t b) { return borrow((uint64_t)a - b - flag()); }
inline uint32_t subc(uint32_t a, uint32_t b) { return a - b - flag(); }
inline uint32_t mad_lo_cc(uint32_t a, uint32_t b, uint32_t c) { return add_cc(lo(a, b), c); }
inline uint32_t madc_lo_cc(uint32_t a, uint32_t b, uint32_t c) { return addc_cc(lo(a, b), c); }
inline uint32_t mad_hi_cc(uint32_t a, uint32_t b, uint32_t c) { return add_cc(hi(a, b), c); }
inline uint32_t madc_hi_cc(uint32_t a, uint32_t b, uint32_t c) { return addc_cc(hi(a, b), c); }
inline uint32_t madc_hi(uint32_t a, uint32_t b, uint32_t c) { return addc(hi(a, b), c); }
#endif
}  // namespace cc

template <class F>
BN_DEV void load_p(uint32_t p[8]) {
  p[0] = F::P0; p[1] = F::P1; p[2] = F::P2; p[3] = F::P3;
  p[4] = F::P4; p[5] = F::P5; p[6] = F::P6; p[7] = F::P7;
}

// r = s - p if s >= p else s (s < 2p): one borrow chain, then a select by
// mask (no branch)
template <class F>
BN_DEV void cond_sub_p(uint32_t r[8], const uint32_t s[8]) {
  uint32_t p[8];
  load_p<F>(p);
  uint32_t d[8];
  d[0] = cc::sub_cc(s[0], p[0]);
#pragma unroll
  for (int i = 1; i < 8; i++) d[i] = cc::subc_cc(s[i], p[i]);
  const uint32_t keep = cc::subc(0, 0);  // all ones iff s < p
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = (s[i] & keep) | (d[i] & ~keep);
}

template <class F>
BN_DEV void fe_add(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t s[8];
  s[0] = cc::add_cc(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < 7; i++) s[i] = cc::addc_cc(a[i], b[i]);
  s[7] = cc::addc(a[7], b[7]);  // a + b < 2p < 2^255: no carry out
  cond_sub_p<F>(r, s);
}

// a - b, plus p (masked by the borrow) when a < b
template <class F>
BN_DEV void fe_sub(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t d[8];
  d[0] = cc::sub_cc(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < 8; i++) d[i] = cc::subc_cc(a[i], b[i]);
  const uint32_t mask = cc::subc(0, 0);
  uint32_t p[8];
  load_p<F>(p);
  r[0] = cc::add_cc(d[0], p[0] & mask);
#pragma unroll
  for (int i = 1; i < 7; i++) r[i] = cc::addc_cc(d[i], p[i] & mask);
  r[7] = cc::addc(d[7], p[7] & mask);
}

// Montgomery product a*b*R^-1 mod p: CIOS over 8 words (one row per word
// b_i: T += a * b_i, then T = (T + m p) / 2^32 with m = T mod 2^32 *
// (-p^-1)), in the even/odd form of supranational's sppark
// (ff/mont_t.cuh). T is held in two accumulators, X with word k at X[k]
// and Y one word up: the products of the even words a_0, a_2, .. go to X
// and those of the odd words to Y, in chains of lo, hi pairs of one
// product (ptxas makes each pair one IMAD.WIDE.U32.X, a wide multiply-add
// with carry in and out). Dividing by 2^32 leaves Y aligned and X a word
// down, so the two swap roles every row: the next row first adds X's
// lowest live word into Y's first (Y[0] += X[1]) and moves X down two
// words while it adds the odd products (madc_n_rshift), which keeps every
// register pair aligned. On the H100 this takes 200 SASS instructions a
// product against 530 for the same CIOS in portable C with 64-bit
// products, and 345 with both chains on one accumulator, whose pairs
// ptxas had to realign with moves (tools/torch_mont_probe.py, nvcc 12.8).
// With a, b < p and p < 2^254 every row's T stays below 2^288 and the
// result below 2p, so one conditional subtraction makes it canonical.

// acc[j], acc[j + 1] += lo, hi of a[j] * bi for j = 0, 2, 4, 6: one
// chain, its carry out left in CF
BN_DEV void cmad_n(uint32_t acc[8], const uint32_t* a, uint32_t bi) {
  acc[0] = cc::mad_lo_cc(a[0], bi, acc[0]);
  acc[1] = cc::madc_hi_cc(a[0], bi, acc[1]);
#pragma unroll
  for (int j = 2; j < 8; j += 2) {
    acc[j] = cc::madc_lo_cc(a[j], bi, acc[j]);
    acc[j + 1] = cc::madc_hi_cc(a[j], bi, acc[j + 1]);
  }
}

// acc[j], acc[j + 1] = lo, hi of a[j] * bi + acc[j + 2], acc[j + 3] + CF:
// goes on with the chain in CF and moves acc down two words
BN_DEV void madc_n_rshift(uint32_t acc[8], const uint32_t* a, uint32_t bi) {
#pragma unroll
  for (int j = 0; j < 6; j += 2) {
    acc[j] = cc::madc_lo_cc(a[j], bi, acc[j + 2]);
    acc[j + 1] = cc::madc_hi_cc(a[j], bi, acc[j + 3]);
  }
  acc[6] = cc::madc_lo_cc(a[6], bi, 0);
  acc[7] = cc::madc_hi(a[6], bi, 0);
}

// One row. On entry T = X + Y 2^32 after Y[1] joins X[0] (X[k] at word
// k, Y[k] at word k + 1 once moved down); on exit X[0] = 0 and T = X +
// Y 2^32 with Y[k] at word k + 1. X's carry out of word 7 lands in Y[7].
template <class F>
BN_DEV void mad_n_redc(uint32_t X[8], uint32_t Y[8], const uint32_t a[8], uint32_t bi,
                       const uint32_t p[8], bool first) {
  if (first) {
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const uint64_t e = (uint64_t)a[j] * bi, o = (uint64_t)a[j + 1] * bi;
      X[j] = (uint32_t)e;
      X[j + 1] = (uint32_t)(e >> 32);
      Y[j] = (uint32_t)o;
      Y[j + 1] = (uint32_t)(o >> 32);
    }
  } else {
    X[0] = cc::add_cc(X[0], Y[1]);
    madc_n_rshift(Y, a + 1, bi);
    cmad_n(X, a, bi);
    Y[7] = cc::addc(Y[7], 0);
  }
  const uint32_t m = X[0] * F::INV;
  cmad_n(Y, p + 1, m);
  cmad_n(X, p, m);
  Y[7] = cc::addc(Y[7], 0);
}

template <class F>
BN_DEV void fe_mul(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t p[8];
  load_p<F>(p);
  uint32_t even[8], odd[8];
#pragma unroll
  for (int i = 0; i < 8; i += 2) {
    mad_n_redc<F>(even, odd, a, b[i], p, i == 0);
    mad_n_redc<F>(odd, even, a, b[i + 1], p, false);
  }
  // after the last row: word k of T / 2^32 is even[k] + odd[k + 1]
  even[0] = cc::add_cc(even[0], odd[1]);
#pragma unroll
  for (int k = 1; k < 7; k++) even[k] = cc::addc_cc(even[k], odd[k + 1]);
  even[7] = cc::addc(even[7], 0);
  cond_sub_p<F>(r, even);
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

// a = b where mask is all ones, else a unchanged (mask 0): word by word,
// so no Point is addressed and nothing goes to local memory
BN_DEV void select_point(Point& a, const Point& b, uint32_t mask) {
#pragma unroll
  for (int k = 0; k < 8; k++) {
    a.X.v[k] = (b.X.v[k] & mask) | (a.X.v[k] & ~mask);
    a.Y.v[k] = (b.Y.v[k] & mask) | (a.Y.v[k] & ~mask);
    a.Z.v[k] = (b.Z.v[k] & mask) | (a.Z.v[k] & ~mask);
  }
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
#else
// host build: V is any struct of four uint32_t x, y, z, w
template <class V>
inline Fe load_fe(const V* p) {
  return Fe{{p[0].x, p[0].y, p[0].z, p[0].w, p[1].x, p[1].y, p[1].z, p[1].w}};
}

template <class V>
inline void store_fe(V* p, const Fe& a) {
  p[0].x = a.v[0]; p[0].y = a.v[1]; p[0].z = a.v[2]; p[0].w = a.v[3];
  p[1].x = a.v[4]; p[1].y = a.v[5]; p[1].z = a.v[6]; p[1].w = a.v[7];
}
#endif

template <class V>
BN_DEV Point load_point(const V* x, const V* y, const V* z, long long i) {
  return Point{load_fe(x + 2 * i), load_fe(y + 2 * i), load_fe(z + 2 * i)};
}

template <class V>
BN_DEV void store_point(V* x, V* y, V* z, long long i, const Point& P) {
  store_fe(x + 2 * i, P.X);
  store_fe(y + 2 * i, P.Y);
  store_fe(z + 2 * i, P.Z);
}

// Horner ladder of one row of W window sums, most significant first: the
// window sum S_w of this row is element w * stride + i. acc = S_0, then
// for w = 1 .. W-1: c doublings and acc + S_w. One call site per formula.
template <class V>
BN_DEV Point horner_ladder(const V* x, const V* y, const V* z, long long i,
                           long long stride, int W, int c) {
  Point acc = load_point(x, y, z, i);
  for (int w = 1; w < W; w++) {
    for (int k = 0; k < c; k++) acc = pdbl(acc);
    acc = padd(acc, load_point(x, y, z, (long long)w * stride + i));
  }
  return acc;
}

// MSB-first double-and-add of P by the scalar k (8 little-endian words,
// bits nbits-1 .. 0): every bit costs one pdbl and one padd, and the sum
// is taken by mask where the bit is set.
BN_DEV Point scalar_mul_ladder(const Point& P, const uint32_t* k, int nbits) {
  Point acc = identity();
  for (int i = nbits - 1; i >= 0; i--) {
    acc = pdbl(acc);
    const Point s = padd(acc, P);
    select_point(acc, s, 0u - ((k[i >> 5] >> (i & 31)) & 1u));
  }
  return acc;
}

#if defined(__CUDACC__)
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
