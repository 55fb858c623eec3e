// S3: one round of the phase-1 ZK sumcheck, sum_x T(x) * (A(x) * B(x) - C(x)).
//
// Replaces: spartan_tpu/ops/pallas_sumcheck.py
//   _k_lm_evals_additive (:555, pallas_call :631), _k_step_additive (:164,
//   :375) and _k_evals_additive (:227, :432), dispatched from
//   spartan_tpu/core/sumcheck.py prove_cubic_with_additive_term (:1066).
// Modes (template STEP), as in sc_round_prod.cu: evals only (thread i < n/2
//   reads (X[i], X[i + n/2])), or fold all four tables by r into their
//   natural folded tables and take the next round's terms from the folded
//   (lo, hi). The terms are T * (A * B - C) at t = 0, 2, 3.
// Bound on the H100: about even. A step reads 4 tables and writes 4 half
//   tables (192 bytes per thread of 4 input elements) against 8 fold and 6
//   eval Montgomery products per thread.
// Design: one thread per (pair of) output positions in a grid-stride loop;
//   canonical per-thread sums, block sums with modular adds, canonical
//   partials [nblocks, 3, 8] that the wrapper sums exactly.
#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace bn254;

struct AdditiveArgs {
  const uint4* in[4];  // T, A, B, C
  uint4* out[4];       // folded T, A, B, C (STEP only)
};

template <bool STEP>
__global__ void __launch_bounds__(256)
sc_round_additive_kernel(const AdditiveArgs args, const uint4* __restrict__ r, long long q,
                         uint4* __restrict__ partials) {
  Fe rr;
  if (STEP) rr = load_fe(r);
  Fe e0 = fr_zero(), e2 = fr_zero(), e3 = fr_zero();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < q; i += stride) {
    Fe lo[4], hi[4];
#pragma unroll
    for (int t = 0; t < 4; t++) {
      const uint4* __restrict__ X = args.in[t];
      if (STEP) {
        Fe u = load_fe(X + 2 * i), v = load_fe(X + 2 * (i + 2 * q));
        lo[t] = add<Fr>(u, mul<Fr>(rr, sub<Fr>(v, u)));
        u = load_fe(X + 2 * (i + q));
        v = load_fe(X + 2 * (i + 3 * q));
        hi[t] = add<Fr>(u, mul<Fr>(rr, sub<Fr>(v, u)));
        store_fe(args.out[t] + 2 * i, lo[t]);
        store_fe(args.out[t] + 2 * (i + q), hi[t]);
      } else {
        lo[t] = load_fe(X + 2 * i);
        hi[t] = load_fe(X + 2 * (i + q));
      }
    }
    Fe d[4], x[4];
#pragma unroll
    for (int t = 0; t < 4; t++) d[t] = sub<Fr>(hi[t], lo[t]);
    e0 = add<Fr>(e0, mul<Fr>(lo[0], sub<Fr>(mul<Fr>(lo[1], lo[2]), lo[3])));
#pragma unroll
    for (int t = 0; t < 4; t++) x[t] = add<Fr>(hi[t], d[t]);  // t = 2
    e2 = add<Fr>(e2, mul<Fr>(x[0], sub<Fr>(mul<Fr>(x[1], x[2]), x[3])));
#pragma unroll
    for (int t = 0; t < 4; t++) x[t] = add<Fr>(x[t], d[t]);  // t = 3
    e3 = add<Fr>(e3, mul<Fr>(x[0], sub<Fr>(mul<Fr>(x[1], x[2]), x[3])));
  }
  const Fe acc[3] = {e0, e2, e3};
  block_sum_store<3>(acc, partials + (long long)blockIdx.x * 3 * 2);
}

// ptrs: host array of the 4 input pointers (T, A, B, C), then in STEP mode
// the 4 output pointers. q: n/2 (evals only) or n/4 (step).
// partials: [nblocks, 3, 8]. Returns cudaGetLastError().
extern "C" int sc_round_additive_launch(int step, const unsigned long long* ptrs,
                                        const void* r, long long q, int nblocks,
                                        void* partials, void* stream) {
  if (nblocks <= 0 || q <= 0) return (int)cudaErrorInvalidValue;
  AdditiveArgs args;
  for (int t = 0; t < 4; t++) {
    args.in[t] = reinterpret_cast<const uint4*>(ptrs[t]);
    args.out[t] = step ? reinterpret_cast<uint4*>(ptrs[4 + t]) : nullptr;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint4* P = static_cast<uint4*>(partials);
  const uint4* R = static_cast<const uint4*>(r);
  if (step) {
    sc_round_additive_kernel<true><<<nblocks, 256, 0, s>>>(args, R, q, P);
  } else {
    sc_round_additive_kernel<false><<<nblocks, 256, 0, s>>>(args, R, q, P);
  }
  return (int)cudaGetLastError();
}
