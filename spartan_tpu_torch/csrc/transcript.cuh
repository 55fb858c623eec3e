// The merlin transcript (STROBE-128 on Keccak-f[1600]) and the Fiat-Shamir
// step of one batched product-sumcheck round, run by one warp, shared by
// T1 (sc_transcript.cu) and T2 (sc_tail.cu).
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
// pos and pos_begin. The step runs on the 32 lanes of one warp:
// - Keccak-f[1600] across lanes: lane i < 25 holds state lane i in a
//   register; theta's column parities and chi's neighbours come by
//   shuffles, rho and pi are one shuffle of each lane's rotated value.
// - Absorbs in parallel: a round absorbs a byte string of fixed layout
//   (the merlin labels, length words, the STROBE framing and the 4 x 32
//   coefficient bytes, 255 bytes in all). Where each byte lands, where F
//   runs and which pos_begin each framing byte and each F carries follow
//   from the starting pos and pos_begin alone, which every lane knows. So
//   the string is laid out in shared memory, each lane XORs the bytes of
//   its own state lane in, block by block, and the warp permutes wherever
//   the position reaches the rate or the C flag forces it.
// - Independent products on separate lanes: the cubic's two and the four
//   conversions to bytes in one (the conversion is linear, so c1's bytes
//   follow from the others'), the two of the challenge's reduction; the
//   claim's update takes two products in a row, (c0 + c1 r) + r^2 (c2 +
//   c3 r), with c1 r, r^2 and c3 r on three lanes (sums mod p are exact,
//   so any order gives Horner's value).
// The step (round_step_warp) is out of line, so its registers do not cap
// the kernel that calls it.
//
// Like bn254.cuh, this header also compiles as plain C++ (no __CUDACC__),
// so the CPU tests build it with g++ and hold it to the plain versions.
// There the warp is 32 emulated lanes on one thread (ucontext): each lane
// runs the same code up to its next shuffle or warp barrier, and a loop
// over the 32 lanes advances them all past it, so the host build runs the
// warp algorithm itself, shuffle for shuffle.
#pragma once
#include <stdint.h>
#include <string.h>

#include "bn254.cuh"

#if defined(__CUDACC__)
#define TR_DEV __device__ __forceinline__
#define TR_CALL __device__ __noinline__
#define TR_CONST __constant__ const
#else
#include <stdlib.h>
#include <ucontext.h>

#include <type_traits>
#define TR_DEV inline
#define TR_CALL inline
#define TR_CONST static const
#endif

namespace sctr {

using bn254::Fe;
using bn254::Fr;

constexpr int STROBE_R = 166;
constexpr uint8_t FLAG_I = 1, FLAG_A = 2, FLAG_C = 4, FLAG_M = 16;
constexpr int SPONGE_WORDS = 52;

struct Sponge {
  union {
    uint64_t lane[25];
    uint8_t b[200];
  } s;
  int32_t pos, pos_begin;
};
static_assert(sizeof(Sponge) == 4 * SPONGE_WORDS, "Sponge must match the packed int32 [52] tensor");

TR_CONST uint64_t KECCAK_RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

// rho's rotation of lane x + 5y
TR_CONST int KECCAK_RHO[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                               25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};

// ---------------------------------------------------------------------------
// the warp: lane index, shuffles, warp barrier
// ---------------------------------------------------------------------------

#if defined(__CUDACC__)
struct Warp {
  __device__ __forceinline__ int lane() const { return threadIdx.x & 31; }
  __device__ __forceinline__ void sync() const { __syncwarp(); }
  __device__ __forceinline__ uint32_t shfl(uint32_t v, int src) const {
    return __shfl_sync(0xffffffffu, v, src);
  }
  __device__ __forceinline__ uint64_t shfl(uint64_t v, int src) const {
    return __shfl_sync(0xffffffffu, (unsigned long long)v, src);
  }
  __device__ __forceinline__ Fe shfl(const Fe& v, int src) const {
    Fe r;
#pragma unroll
    for (int k = 0; k < 8; k++) r.v[k] = __shfl_sync(0xffffffffu, v.v[k], src);
    return r;
  }
};
#else
// 32 lanes as fibers on the calling thread. A shuffle deposits the lane's
// value, yields to the scheduler and reads the source lane's deposit; the
// scheduler's loop resumes each lane in turn, so one pass takes every lane
// to its next shuffle or barrier. Deposits alternate between two slot
// sets: a lane can overwrite a set only after every lane has passed the
// next barrier, by which time each has read from it. The carry flag of
// bn254.cuh's host build is per thread, which is sound here because no
// carry chain spans a yield.
namespace hostwarp {
constexpr int LANES = 32;
constexpr size_t STACK = 256 * 1024;
struct Ctx {
  ucontext_t sched, lane[LANES];
  unsigned char slot[2][LANES][32];
  int phase[LANES];
  bool done[LANES];
  void (*body)(void*, int);
  void* arg;
};
inline Ctx*& current() {
  static thread_local Ctx* c = nullptr;
  return c;
}
inline void yield(int lane) { swapcontext(&current()->lane[lane], &current()->sched); }
inline void entry(int lane) {
  Ctx* c = current();
  c->body(c->arg, lane);
  c->done[lane] = true;
}
}  // namespace hostwarp

struct Warp {
  int id;
  int lane() const { return id; }
  void sync() const { hostwarp::yield(id); }
  template <class T>
  T shfl(const T& v, int src) const {
    static_assert(sizeof(T) <= 32, "one slot holds 32 bytes");
    hostwarp::Ctx* c = hostwarp::current();
    const int p = c->phase[id];
    memcpy(c->slot[p][id], &v, sizeof(T));
    hostwarp::yield(id);
    T r;
    memcpy(&r, c->slot[p][src & 31], sizeof(T));
    c->phase[id] = p ^ 1;
    return r;
  }
};

// Runs fn(Warp{lane}) on the 32 emulated lanes; returns when all are done.
template <class F>
void run_warp(F&& fn) {
  using namespace hostwarp;
  Ctx* c = new Ctx();
  char* stacks = static_cast<char*>(malloc(LANES * STACK));
  Ctx* saved = current();
  current() = c;
  c->arg = &fn;
  c->body = [](void* a, int lane) {
    (*static_cast<typename std::remove_reference<F>::type*>(a))(Warp{lane});
  };
  for (int l = 0; l < LANES; l++) {
    getcontext(&c->lane[l]);
    c->lane[l].uc_stack.ss_sp = stacks + l * STACK;
    c->lane[l].uc_stack.ss_size = STACK;
    c->lane[l].uc_link = &c->sched;
    makecontext(&c->lane[l], reinterpret_cast<void (*)()>(entry), 1, l);
  }
  for (bool any = true; any;) {
    any = false;
    for (int l = 0; l < LANES; l++)
      if (!c->done[l]) {
        any = true;
        swapcontext(&c->sched, &c->lane[l]);
      }
  }
  current() = saved;
  free(stacks);
  delete c;
}
#endif

// ---------------------------------------------------------------------------
// Keccak-f[1600] across lanes: lane i = x + 5y < 25 holds A[x, y]
// ---------------------------------------------------------------------------

TR_DEV uint64_t rotl64(uint64_t v, int n) { return (v << n) | (v >> ((64 - n) & 63)); }

TR_DEV void keccak_lanes(const Warp& w, uint64_t& a) {
  const int i = w.lane();
  // lanes 25..31 take the wiring of lanes 0..6: their values are never read
  const int x = i % 5, y = (i / 5) % 5;
  const int col1 = x + 5 * ((y + 1) % 5), col2 = x + 5 * ((y + 2) % 5);
  const int col3 = x + 5 * ((y + 3) % 5), col4 = x + 5 * ((y + 4) % 5);
  const int left = (x + 4) % 5, right = (x + 1) % 5;  // row 0 of columns x - 1, x + 1
  // pi moves A[x, y] to B[y, 2x + 3y], so B[u, v] comes from lane
  // (u + 3v) % 5 + 5u; chi reads B[x, y], B[x + 1, y] and B[x + 2, y],
  // which this lane takes from those three lanes' rotated values at once
  const int x1 = (x + 1) % 5, x2 = (x + 2) % 5;
  const int src0 = (x + 3 * y) % 5 + 5 * x, src1 = (x1 + 3 * y) % 5 + 5 * x1;
  const int src2 = (x2 + 3 * y) % 5 + 5 * x2;
  const int rho = KECCAK_RHO[i < 25 ? i : 0];
  for (int round = 0; round < 24; round++) {
    const uint64_t c = a ^ w.shfl(a, col1) ^ w.shfl(a, col2) ^ w.shfl(a, col3) ^ w.shfl(a, col4);
    const uint64_t cl = w.shfl(c, left), cr = w.shfl(c, right);
    const uint64_t r = rotl64(a ^ cl ^ rotl64(cr, 1), rho);
    const uint64_t b0 = w.shfl(r, src0), b1 = w.shfl(r, src1), b2 = w.shfl(r, src2);
    a = b0 ^ (~b1 & b2);
    if (i == 0) a ^= KECCAK_RC[round];
  }
}

// ---------------------------------------------------------------------------
// STROBE-128 on a warp (merlin's subset: meta_ad, ad, prf; no KEY flag)
// ---------------------------------------------------------------------------

// the warp's view of a sponge: this lane's state lane (lanes >= 25 carry none),
// and the positions, the same on every lane
struct WSponge {
  uint64_t a;
  int pos, pos_begin;
};

TR_DEV WSponge ws_load(const Warp& w, const Sponge* sp) {
  const int l = w.lane();
  return WSponge{l < 25 ? sp->s.lane[l] : 0, sp->pos, sp->pos_begin};
}

TR_DEV void ws_store(const Warp& w, const WSponge& s, Sponge* sp) {
  const int l = w.lane();
  if (l < 25) sp->s.lane[l] = s.a;
  if (l == 0) {
    sp->pos = s.pos;
    sp->pos_begin = s.pos_begin;
  }
}

// pos_begin after absorbing bytes [0, k) of a string that started at
// position p0, the last operation having begun at byte s <= k: 0 if F ran
// after one of the bytes s .. k - 1 (the position crossed the rate),
// else that operation's starting position + 1.
TR_DEV int strobe_pos_begin(int p0, int s, int k) {
  return (p0 + k) / STROBE_R > (p0 + s) / STROBE_R ? 0 : (p0 + s) % STROBE_R + 1;
}

// the state-lane bits that F's padding XORs in: pos_begin at byte `at`,
// 0x04 at at + 1, 0x80 at the rate + 1
TR_DEV uint64_t strobe_pad(int lane, int at, int pos_begin) {
  uint64_t x = 0;
  if (at >> 3 == lane) x ^= (uint64_t)(uint8_t)pos_begin << (8 * (at & 7));
  if ((at + 1) >> 3 == lane) x ^= (uint64_t)0x04 << (8 * ((at + 1) & 7));
  if ((STROBE_R + 1) >> 3 == lane) x ^= (uint64_t)0x80 << (8 * ((STROBE_R + 1) & 7));
  return x;
}

// Absorb nops STROBE operations laid out in buf (memory the warp shares):
// operation m begins at byte off[m] (off[0] = 0) with its two framing
// bytes (the previous pos_begin, flags[m]), which this writes, and its
// data runs to the next operation (the last to byte len). Only the last
// operation may carry the C flag: F then runs at the end unless the
// position is 0.
TR_DEV void warp_absorb(const Warp& w, WSponge& s, uint8_t* buf, int len, const int* off,
                        const uint8_t* flags, int nops) {
  const int l = w.lane(), p0 = s.pos;
  for (int m = l; m < nops; m += 32) {
    buf[off[m]] = (uint8_t)(m == 0 ? s.pos_begin : strobe_pos_begin(p0, off[m - 1], off[m]));
    buf[off[m] + 1] = flags[m];
  }
  w.sync();
  const int end = p0 + len, nfull = end / STROBE_R, tail = end % STROBE_R;
  const bool forced = (flags[nops - 1] & FLAG_C) && tail != 0;
  for (int blk = 0; blk < nfull + (tail != 0); blk++) {
    uint64_t x = 0;
    for (int u = 0; u < 8; u++) {
      const int q = 8 * l + u, k = blk * STROBE_R + q - p0;
      if (q < STROBE_R && k >= 0 && k < len) x |= (uint64_t)buf[k] << (8 * u);
    }
    if (blk < nfull) {
      // the position reached the rate after byte kc, inside operation m
      const int kc = (blk + 1) * STROBE_R - p0 - 1;
      int m = 0;
      while (m + 1 < nops && off[m + 1] <= kc) m++;
      s.a ^= x ^ strobe_pad(l, STROBE_R, strobe_pos_begin(p0, off[m], kc));
      keccak_lanes(w, s.a);
    } else if (forced) {
      s.a ^= x ^ strobe_pad(l, tail, strobe_pos_begin(p0, off[nops - 1], len));
      keccak_lanes(w, s.a);
    } else {
      s.a ^= x;
    }
  }
  if (forced) {
    s.pos = 0;
    s.pos_begin = 0;
  } else {
    s.pos = tail;
    s.pos_begin = strobe_pos_begin(p0, off[nops - 1], len);
  }
  w.sync();
}

// Squeeze n bytes into out (memory the warp shares): each byte is read and
// zeroed, and F runs where the position reaches the rate.
TR_DEV void warp_squeeze(const Warp& w, WSponge& s, uint8_t* out, int n) {
  const int l = w.lane(), p0 = s.pos;
  const int end = p0 + n, nfull = end / STROBE_R;
  for (int blk = 0; blk * STROBE_R < end; blk++) {
    for (int u = 0; u < 8; u++) {
      const int q = 8 * l + u, j = blk * STROBE_R + q - p0;
      if (q < STROBE_R && j >= 0 && j < n) {
        out[j] = (uint8_t)(s.a >> (8 * u));
        s.a &= ~((uint64_t)0xff << (8 * u));
      }
    }
    if (blk < nfull) {
      s.a ^= strobe_pad(l, STROBE_R, blk == 0 ? s.pos_begin : 0);
      keccak_lanes(w, s.a);
    }
  }
  s.pos = end % STROBE_R;
  if (nfull) s.pos_begin = 0;
  w.sync();
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
// 1/2 and 1/6 mod p, raw: mont(x, 1/6) is x/6 leaving Montgomery form
TR_DEV Fe k_inv2_raw() {
  return fe_words(0xf8000001u, 0xa1f0fac9u, 0x3cdcb848u, 0x9419f424u, 0x40c0ac2eu,
                  0xdc2822dbu, 0x7098d014u, 0x18322739u);
}
TR_DEV Fe k_inv6_raw() {
  return fe_words(0x48000001u, 0xb891a1fbu, 0xbac53323u, 0x4c2b4191u, 0xc1411ef8u,
                  0xc442e4c2u, 0x10feb022u, 0x285396b5u);
}
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

// a if c else b, word by word (no branch, no indexed registers)
TR_DEV Fe fe_pick(bool c, const Fe& a, const Fe& b) {
  const uint32_t m = 0u - (uint32_t)c;
  Fe r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.v[k] = (a.v[k] & m) | (b.v[k] & ~m);
  return r;
}

// the sum over the warp, exact mod p, on every lane
TR_DEV Fe warp_allsum(const Warp& w, Fe x) {
  for (int m = 16; m > 0; m >>= 1) x = add(x, w.shfl(x, w.lane() ^ m));
  return x;
}

TR_DEV void le32(uint8_t* out, uint32_t v) {
  out[0] = (uint8_t)v; out[1] = (uint8_t)(v >> 8);
  out[2] = (uint8_t)(v >> 16); out[3] = (uint8_t)(v >> 24);
}

TR_DEV uint32_t rd_le32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

// a 256-bit word reduced below p (it is below 6p: five conditional
// subtractions)
TR_DEV Fe reduce256(Fe x) {
  for (int k = 0; k < 5; k++) bn254::cond_sub_p<Fr>(x.v, x.v);
  return x;
}

// 64 little-endian bytes (memory the warp shares) -> the element they
// encode mod p in Montgomery form, on every lane (from_le_bytes_mod_order):
// x = lo + hi 2^256, x R = mont(lo, R^2) + mont(hi, R^3), lo's product on
// even lanes and hi's on odd ones, each half first reduced below p
TR_DEV Fe challenge_to_fr(const Warp& w, const uint8_t* b) {
  const bool odd = w.lane() & 1;
  Fe x;
  for (int k = 0; k < 8; k++) x.v[k] = rd_le32(b + 32 * odd + 4 * k);
  x = mul(reduce256(x), fe_pick(odd, k_r3(), k_r2()));
  return add(w.shfl(x, 0), w.shfl(x, 1));
}

// ---------------------------------------------------------------------------
// one round's Fiat-Shamir step
// ---------------------------------------------------------------------------

// The byte string a round absorbs (UniPoly.append_to_transcript(b"poly")
// and the label of challenge_scalar(b"challenge_nextround")): 14 STROBE
// operations, each merlin append a meta_ad of label and length word and
// an ad of the message. The framing bytes (written by warp_absorb) and the
// coefficient bytes are 0 in the template.
constexpr int ROUND_LEN = 255;
constexpr int ROUND_OPS = 14;
constexpr int ROUND_COEFF = 38, ROUND_COEFF_STEP = 45;  // coefficient k at 38 + 45k
constexpr int ROUND_CHALLENGE = 256;                    // the 64 squeezed bytes
constexpr int ROUND_BUF = ROUND_CHALLENGE + 64;         // bytes of a round's buffer
TR_CONST int ROUND_OP_OFF[ROUND_OPS] = {0, 10, 25, 36, 70, 81, 115, 126, 160, 171, 205, 215,
                                        228, 253};
TR_CONST uint8_t ROUND_OP_FLAGS[ROUND_OPS] = {
    FLAG_M | FLAG_A, FLAG_A, FLAG_M | FLAG_A, FLAG_A, FLAG_M | FLAG_A, FLAG_A,
    FLAG_M | FLAG_A, FLAG_A, FLAG_M | FLAG_A, FLAG_A, FLAG_M | FLAG_A, FLAG_A,
    FLAG_M | FLAG_A, FLAG_I | FLAG_A | FLAG_C};
#define SCTR_Z32 "\0\0\0\0\0\0\0\0\0\0\0\0\0\0\0\0\0\0\0\0\0\0\0\0\0\0\0\0\0\0\0\0"
#define SCTR_COEFF "\0\0" "coeff" "\x20\0\0\0" "\0\0" SCTR_Z32
alignas(4) TR_CONST uint8_t ROUND_TEMPLATE[ROUND_LEN + 1] =
    "\0\0" "poly" "\x0d\0\0\0" "\0\0" "UniPoly_begin"
    SCTR_COEFF SCTR_COEFF SCTR_COEFF SCTR_COEFF
    "\0\0" "poly" "\x0b\0\0\0" "\0\0" "UniPoly_end"
    "\0\0" "challenge_nextround" "\x40\0\0\0" "\0\0";
#undef SCTR_COEFF
#undef SCTR_Z32

// the template into buf (ROUND_BUF bytes, 4-byte aligned)
TR_DEV void round_template(const Warp& w, uint8_t* buf) {
  const uint32_t* t = reinterpret_cast<const uint32_t*>(ROUND_TEMPLATE);
  uint32_t* b = reinterpret_cast<uint32_t*>(buf);
  for (int k = w.lane(); k < (ROUND_LEN + 1) / 4; k += 32) b[k] = t[k];
  w.sync();
}

// Every lane of one warp calls it with the same arguments: the round's
// combined evaluations c0, c2, c3 (sum_i coeff_i e_t,i) and the running
// claim e. sp is the sponge and buf a round's buffer (round_template
// filled in), both in memory the warp shares. The cubic through (c0, e -
// c0, c2, c3) is absorbed as UniPoly.append_to_transcript(b"poly") does,
// "challenge_nextround" is squeezed to r, and out[0..6) receives the four
// coefficients (low to high), r, and the cubic at r (the next claim).
TR_CALL void round_step_warp(Warp w, Sponge* sp, uint8_t* buf, Fe c0, Fe c2, Fe c3, Fe e,
                             Fe* out) {
  const int l = w.lane();
  // the cubic (unipoly.rs:34-38): a = (e3 - 3e2 + 3e1 - e0) / 6,
  // b = (2e0 - 5e1 + 4e2 - e3) / 2, c = e1 - e0 - a - b. Its coefficients'
  // canonical values come in the same product as a and b, on lanes 0..5:
  // mont(c0, 1), mont(e1, 1), ta/6 and tb/2 leaving Montgomery form, then
  // a and b in it; c's canonical value is the same combination of the
  // canonical ones (mont(x, 1) is linear)
  const Fe e1 = sub(e, c0);
  const Fe e1x3 = add(add(e1, e1), e1);
  const Fe e2x2 = add(c2, c2);
  const Fe ta = sub(add(c3, e1x3), add(add(e2x2, c2), c0));
  const Fe tb = sub(add(add(c0, c0), add(e2x2, e2x2)), add(add(add(e1x3, e1), e1), c3));
  const int k6 = l % 6;
  const bool odd = l & 1;
  const Fe px = fe_pick(k6 == 0, c0, fe_pick(k6 == 1, e1, fe_pick(odd, tb, ta)));
  const Fe py = fe_pick(k6 < 2, k_one_raw(),
                        k6 < 4 ? fe_pick(odd, k_inv2_raw(), k_inv6_raw())
                               : fe_pick(odd, k_inv2(), k_inv6()));
  const Fe pr = mul(px, py);
  const Fe z0 = w.shfl(pr, 0), z1 = w.shfl(pr, 1), za = w.shfl(pr, 2), zb = w.shfl(pr, 3);
  const Fe ca = w.shfl(pr, 4), cb = w.shfl(pr, 5);
  const Fe cc = sub(sub(sub(e1, c0), ca), cb);
  // coefficient l's canonical bytes on lanes 0..3, into the string
  const int k4 = l & 3;
  const Fe canon = fe_pick(k4 == 0, z0, fe_pick(k4 == 1, sub(sub(sub(z1, z0), za), zb),
                                                fe_pick(k4 == 2, zb, za)));
  if (l < 4) {
    uint8_t* dst = buf + ROUND_COEFF + ROUND_COEFF_STEP * l;
    for (int k = 0; k < 8; k++) le32(dst + 4 * k, canon.v[k]);
  }
  WSponge s = ws_load(w, sp);
  warp_absorb(w, s, buf, ROUND_LEN, ROUND_OP_OFF, ROUND_OP_FLAGS, ROUND_OPS);
  warp_squeeze(w, s, buf + ROUND_CHALLENGE, 64);
  ws_store(w, s, sp);
  const Fe r = challenge_to_fr(w, buf + ROUND_CHALLENGE);
  // the next claim (c0 + c1 r) + r^2 (c2 + c3 r): c1 r, r^2, c3 r on lanes 0, 1, 2
  const int t3 = l % 3;
  const Fe y = mul(fe_pick(t3 == 0, cc, fe_pick(t3 == 1, r, ca)), r);
  const Fe y0 = w.shfl(y, 0), y1 = w.shfl(y, 1), y2 = w.shfl(y, 2);
  const Fe en = add(add(c0, y0), mul(y1, add(cb, y2)));
  if (l < 6)
    out[l] = fe_pick(l == 0, c0, fe_pick(l == 1, cc, fe_pick(l == 2, cb, fe_pick(l == 3, ca,
                                                                                fe_pick(l == 4, r, en)))));
  w.sync();
}

// T1 on one warp: evals [3 ninst, 8] ((e0, e2, e3) of each instance),
// coeffs [ninst, 8]; the claim [8] and the packed sponge int32 [52] are
// updated in place, the coefficients go to poly_out [4, 8] and r to r_out
// [8]. sp, buf and out (6 elements) are scratch the warp shares. Lane k
// takes instances k, k + 32, ...: their 3 products each, then three warp
// sums.
TR_DEV void t1_round(const Warp& w, const uint32_t* evals, const uint32_t* coeffs, int ninst,
                     uint32_t* claim, int32_t* sponge, uint32_t* poly_out, uint32_t* r_out,
                     Sponge* sp, uint8_t* buf, Fe* out) {
  const int l = w.lane();
  int32_t* words = reinterpret_cast<int32_t*>(sp);
  for (int k = l; k < SPONGE_WORDS; k += 32) words[k] = sponge[k];
  round_template(w, buf);
  Fe c0 = fe_zero(), c2 = fe_zero(), c3 = fe_zero();
  for (int k = l; k < ninst; k += 32) {
    const Fe wk = ld(coeffs, k);
    c0 = add(c0, mul(ld(evals, 3 * k), wk));
    c2 = add(c2, mul(ld(evals, 3 * k + 1), wk));
    c3 = add(c3, mul(ld(evals, 3 * k + 2), wk));
  }
  c0 = warp_allsum(w, c0);
  c2 = warp_allsum(w, c2);
  c3 = warp_allsum(w, c3);
  const Fe e = ld(claim, 0);
  w.sync();
  round_step_warp(w, sp, buf, c0, c2, c3, e, out);
  if (l < 4) st(poly_out, l, out[l]);
  if (l == 4) st(r_out, 0, out[4]);
  if (l == 5) st(claim, 0, out[5]);
  for (int k = l; k < SPONGE_WORDS; k += 32) sponge[k] = words[k];
}

}  // namespace sctr
