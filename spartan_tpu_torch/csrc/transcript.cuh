// The merlin transcript (STROBE-128 on Keccak-f[1600]) and the Fiat-Shamir
// step of one batched product-sumcheck round, as device functions shared
// by T1 (sc_transcript.cu) and T2 (sc_tail.cu).
//
// Counterpart of spartan_tpu/ops/transcript_device.py (keccak_f1600_lanes
// :110, DynStrobe :251, DynTranscript :370, fr_to_bytes_dev :416,
// bytes64_to_fr_mont :431) and of the round body of
// spartan_tpu/core/sumcheck_fused.py (_make_round_body :140: the cubic
// from its evaluations :98, the absorbs and the squeeze, _horner4 :111).
// The bytes are those of spartan_tpu_torch/utils/strobe.py and
// utils/transcript.py: STROBE v1.0.2, 128-bit level, rate 166, merlin
// framing; the plain version is spartan_tpu_torch/ops/transcript_device.py.
//
// The sponge is one struct of 208 bytes, the packed int32 [52] tensor of
// the wrappers: the 200 state bytes (25 little-endian 64-bit lanes), then
// pos and pos_begin. Keccak-f[1600] loads the 25 lanes into registers,
// runs its 24 rounds there and stores them back; the byte-wise absorbs
// and squeezes index the state in memory. All of it is serial by nature:
// one thread runs it.
//
// Like bn254.cuh, this header also compiles as plain C++ (no __CUDACC__),
// so the CPU tests build it with g++ and hold it to the plain versions.
#pragma once
#include <stdint.h>
#include <string.h>

#include "bn254.cuh"

#if defined(__CUDACC__)
#define TR_DEV __device__ __forceinline__
#define TR_CALL __device__ __noinline__
#define TR_CONST __constant__ const
#else
#define TR_DEV inline
#define TR_CALL inline
#define TR_CONST static const
#endif

namespace sctr {

using bn254::Fe;
using bn254::Fr;

constexpr int STROBE_R = 166;
constexpr uint8_t FLAG_I = 1, FLAG_A = 2, FLAG_C = 4, FLAG_M = 16;

struct Sponge {
  union {
    uint64_t lane[25];
    uint8_t b[200];
  } s;
  int32_t pos, pos_begin;
};
static_assert(sizeof(Sponge) == 208, "Sponge must match the packed int32 [52] tensor");

TR_CONST uint64_t KECCAK_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

TR_DEV uint64_t rotl64(uint64_t x, int n) { return (x << n) | (x >> (64 - n)); }

// Keccak-f[1600] on 25 lanes, A[x + 5y]; rho and pi walk the lanes in the
// order of the pi permutation starting from lane 1 (each step moves the
// previous lane, rotated, into the next one).
TR_CALL void keccak_f1600(uint64_t* lane) {
  uint64_t a[25];
#pragma unroll
  for (int i = 0; i < 25; i++) a[i] = lane[i];
  for (int round = 0; round < 24; round++) {
    uint64_t c[5];
#pragma unroll
    for (int x = 0; x < 5; x++) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; x++) {
      const uint64_t d = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
#pragma unroll
      for (int y = 0; y < 25; y += 5) a[y + x] ^= d;
    }
    uint64_t t = a[1], u;
#define SCTR_RP(j, r) u = a[j]; a[j] = rotl64(t, r); t = u;
    SCTR_RP(10, 1) SCTR_RP(7, 3) SCTR_RP(11, 6) SCTR_RP(17, 10) SCTR_RP(18, 15)
    SCTR_RP(3, 21) SCTR_RP(5, 28) SCTR_RP(16, 36) SCTR_RP(8, 45) SCTR_RP(21, 55)
    SCTR_RP(24, 2) SCTR_RP(4, 14) SCTR_RP(15, 27) SCTR_RP(23, 41) SCTR_RP(19, 56)
    SCTR_RP(13, 8) SCTR_RP(12, 25) SCTR_RP(2, 43) SCTR_RP(20, 62) SCTR_RP(14, 18)
    SCTR_RP(22, 39) SCTR_RP(9, 61) SCTR_RP(6, 20) SCTR_RP(1, 44)
#undef SCTR_RP
#pragma unroll
    for (int y = 0; y < 25; y += 5) {
      uint64_t row[5];
#pragma unroll
      for (int x = 0; x < 5; x++) row[x] = a[y + x];
#pragma unroll
      for (int x = 0; x < 5; x++) a[y + x] = row[x] ^ (~row[(x + 1) % 5] & row[(x + 2) % 5]);
    }
    a[0] ^= KECCAK_RC[round];
  }
#pragma unroll
  for (int i = 0; i < 25; i++) lane[i] = a[i];
}

// ---------------------------------------------------------------------------
// STROBE-128 (merlin's subset: meta_ad, ad, prf; no KEY flag)
// ---------------------------------------------------------------------------

TR_CALL void run_f(Sponge& sp) {
  sp.s.b[sp.pos] ^= (uint8_t)sp.pos_begin;
  sp.s.b[sp.pos + 1] ^= 0x04;
  sp.s.b[STROBE_R + 1] ^= 0x80;
  keccak_f1600(sp.s.lane);
  sp.pos = 0;
  sp.pos_begin = 0;
}

TR_CALL void absorb(Sponge& sp, const uint8_t* data, int n) {
  for (int i = 0; i < n; i++) {
    sp.s.b[sp.pos++] ^= data[i];
    if (sp.pos == STROBE_R) run_f(sp);
  }
}

TR_CALL void squeeze(Sponge& sp, uint8_t* out, int n) {
  for (int i = 0; i < n; i++) {
    out[i] = sp.s.b[sp.pos];
    sp.s.b[sp.pos++] = 0;
    if (sp.pos == STROBE_R) run_f(sp);
  }
}

TR_CALL void begin_op(Sponge& sp, uint8_t flags) {
  const uint8_t framing[2] = {(uint8_t)sp.pos_begin, flags};
  sp.pos_begin = sp.pos + 1;
  absorb(sp, framing, 2);
  if ((flags & FLAG_C) && sp.pos != 0) run_f(sp);
}

TR_DEV void le32(uint8_t out[4], uint32_t v) {
  out[0] = (uint8_t)v; out[1] = (uint8_t)(v >> 8);
  out[2] = (uint8_t)(v >> 16); out[3] = (uint8_t)(v >> 24);
}

// merlin append_message: meta_ad(label), meta_ad(len, more), ad(message)
TR_CALL void append_message(Sponge& sp, const char* label, int llen, const uint8_t* msg,
                            int mlen) {
  uint8_t len[4];
  le32(len, (uint32_t)mlen);
  begin_op(sp, FLAG_M | FLAG_A);
  absorb(sp, reinterpret_cast<const uint8_t*>(label), llen);
  absorb(sp, len, 4);
  begin_op(sp, FLAG_A);
  absorb(sp, msg, mlen);
}

// merlin challenge_bytes: meta_ad(label), meta_ad(len, more), prf(n)
TR_CALL void challenge_bytes(Sponge& sp, const char* label, int llen, uint8_t* out, int n) {
  uint8_t len[4];
  le32(len, (uint32_t)n);
  begin_op(sp, FLAG_M | FLAG_A);
  absorb(sp, reinterpret_cast<const uint8_t*>(label), llen);
  absorb(sp, len, 4);
  begin_op(sp, FLAG_I | FLAG_A | FLAG_C);
  squeeze(sp, out, n);
}

// ---------------------------------------------------------------------------
// Fr elements (8 little-endian 32-bit words, Montgomery form)
// ---------------------------------------------------------------------------

TR_DEV Fe fe_words(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3, uint32_t w4,
                   uint32_t w5, uint32_t w6, uint32_t w7) {
  return Fe{{w0, w1, w2, w3, w4, w5, w6, w7}};
}

// R^2 and R^3 mod p (raw), 1 (raw), and 1/2, 1/6 in Montgomery form
TR_DEV Fe k_r2() {
  return fe_words(0xae216da7u, 0x1bb8e645u, 0xe35c59e3u, 0x53fe3ab1u, 0x53bb8085u,
                  0x8c49833du, 0x7f4e44a5u, 0x0216d0b1u);
}
TR_DEV Fe k_r3() {
  return fe_words(0xb4bf0040u, 0x5e94d8e1u, 0x1cfbb6b8u, 0x2a489cbeu, 0xa19fcfedu,
                  0x893cc664u, 0x7fcc657cu, 0x0cf8594bu);
}
TR_DEV Fe k_one_raw() { return fe_words(1u, 0u, 0u, 0u, 0u, 0u, 0u, 0u); }
TR_DEV Fe k_inv2() {
  return fe_words(0x1ffffffeu, 0x783c14d8u, 0x0c8d1eddu, 0xaf982f6fu, 0xfcfd4f45u,
                  0x8f5f7492u, 0x3d9cbfacu, 0x1f37631au);
}
TR_DEV Fe k_inv6() {
  return fe_words(0x0aaaaaaau, 0x7d695c48u, 0xaed9b4f4u, 0x3a880fcfu, 0xa9a9c517u,
                  0xda7526dbu, 0x69deea8eu, 0x0a67cbb3u);
}

TR_DEV Fe fe_zero() { return fe_words(0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u); }

// element i of an [.., 8] int32 tensor (plain loads: T2 rereads what it wrote)
TR_DEV Fe ld(const uint32_t* p, long long i) {
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = p[8 * i + k];
  return r;
}

TR_DEV void st(uint32_t* p, long long i, const Fe& a) {
#pragma unroll
  for (int k = 0; k < 8; k++) p[8 * i + k] = a.v[k];
}

TR_DEV Fe add(const Fe& a, const Fe& b) { return bn254::add<Fr>(a, b); }
TR_DEV Fe sub(const Fe& a, const Fe& b) { return bn254::sub<Fr>(a, b); }
TR_DEV Fe mul(const Fe& a, const Fe& b) { return bn254::mul<Fr>(a, b); }

// canonical 32-byte little-endian serialization of a Montgomery element
TR_DEV void fr_to_bytes(const Fe& x, uint8_t out[32]) {
  const Fe c = mul(x, k_one_raw());
#pragma unroll
  for (int k = 0; k < 8; k++) le32(out + 4 * k, c.v[k]);
}

// 64 little-endian bytes -> the element they encode mod p, Montgomery form
// (from_le_bytes_mod_order): x = lo + hi 2^256, x R = lo R + hi R^2 =
// mont(lo, R^2) + mont(hi, R^3). lo and hi are first reduced below p (a
// 256-bit word is below 6p: five conditional subtractions).
TR_DEV Fe reduce256(Fe x) {
  for (int k = 0; k < 5; k++) bn254::cond_sub_p<Fr>(x.v, x.v);
  return x;
}

TR_CALL Fe bytes64_to_fr(const uint8_t b[64]) {
  Fe lo, hi;
  for (int k = 0; k < 8; k++) {
    lo.v[k] = (uint32_t)b[4 * k] | ((uint32_t)b[4 * k + 1] << 8) |
              ((uint32_t)b[4 * k + 2] << 16) | ((uint32_t)b[4 * k + 3] << 24);
    hi.v[k] = (uint32_t)b[32 + 4 * k] | ((uint32_t)b[33 + 4 * k] << 8) |
              ((uint32_t)b[34 + 4 * k] << 16) | ((uint32_t)b[35 + 4 * k] << 24);
  }
  return add(mul(reduce256(lo), k_r2()), mul(reduce256(hi), k_r3()));
}

// ---------------------------------------------------------------------------
// one round's Fiat-Shamir step
// ---------------------------------------------------------------------------

// The cubic through (0, e0), (1, e1), (2, e2), (3, e3), coefficients low to
// high (unipoly.rs:34-38): a = (e3 - 3e2 + 3e1 - e0) / 6,
// b = (2e0 - 5e1 + 4e2 - e3) / 2, c = e1 - e0 - a - b, d = e0.
TR_DEV void cubic_from_evals(const Fe& e0, const Fe& e1, const Fe& e2, const Fe& e3,
                             Fe cs[4]) {
  const Fe e1x3 = add(add(e1, e1), e1);
  const Fe e2x2 = add(e2, e2);
  const Fe ta = sub(add(e3, e1x3), add(add(e2x2, e2), e0));
  const Fe tb = sub(add(add(e0, e0), add(e2x2, e2x2)), add(add(add(e1x3, e1), e1), e3));
  const Fe a = mul(ta, k_inv6());
  const Fe b = mul(tb, k_inv2());
  cs[0] = e0;
  cs[1] = sub(sub(sub(e1, e0), a), b);
  cs[2] = b;
  cs[3] = a;
}

// Given the round's combined evaluations c0, c2, c3 (sum_i coeff_i e_t,i)
// and the running claim e: the cubic through (c0, e - c0, c2, c3) into
// cs[4], absorbed as UniPoly.append_to_transcript(b"poly") does; squeezes
// "challenge_nextround" and returns it; e becomes the cubic at r.
TR_CALL Fe round_transcript(Sponge& sp, const Fe& c0, const Fe& c2, const Fe& c3, Fe& e,
                            Fe cs[4]) {
  cubic_from_evals(c0, sub(e, c0), c2, c3, cs);
  append_message(sp, "poly", 4, reinterpret_cast<const uint8_t*>("UniPoly_begin"), 13);
  for (int k = 0; k < 4; k++) {
    uint8_t b[32];
    fr_to_bytes(cs[k], b);
    append_message(sp, "coeff", 5, b, 32);
  }
  append_message(sp, "poly", 4, reinterpret_cast<const uint8_t*>("UniPoly_end"), 11);
  uint8_t ch[64];
  challenge_bytes(sp, "challenge_nextround", 19, ch, 64);
  const Fe r = bytes64_to_fr(ch);
  Fe acc = cs[3];
  for (int k = 2; k >= 0; k--) acc = add(mul(acc, r), cs[k]);
  e = acc;
  return r;
}

// T1's whole step on one thread (sc_transcript.cu launches it): evals
// [3 ninst, 8] ((e0, e2, e3) of each instance), coeffs [ninst, 8]; the
// claim [8] and the packed sponge int32 [52] are updated in place, the
// coefficients go to poly_out [4, 8] and r to r_out [8].
TR_CALL void round_step(const uint32_t* evals, const uint32_t* coeffs, int ninst,
                        uint32_t* claim, int32_t* sponge, uint32_t* poly_out,
                        uint32_t* r_out) {
  Sponge sp;
  memcpy(&sp, sponge, sizeof(Sponge));
  Fe c0 = fe_zero(), c2 = fe_zero(), c3 = fe_zero();
  for (int k = 0; k < ninst; k++) {
    const Fe w = ld(coeffs, k);
    c0 = add(c0, mul(ld(evals, 3 * k), w));
    c2 = add(c2, mul(ld(evals, 3 * k + 1), w));
    c3 = add(c3, mul(ld(evals, 3 * k + 2), w));
  }
  Fe e = ld(claim, 0);
  Fe cs[4];
  const Fe r = round_transcript(sp, c0, c2, c3, e, cs);
  for (int k = 0; k < 4; k++) st(poly_out, k, cs[k]);
  st(r_out, 0, r);
  st(claim, 0, e);
  memcpy(sponge, &sp, sizeof(Sponge));
}

}  // namespace sctr
