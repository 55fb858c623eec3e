// S4: one round of the phase-2 ZK sumcheck, sum_x A(x) * B(x).
//
// Replaces: spartan_tpu/ops/pallas_sumcheck.py
//   _k_lm_evals_quad (:589, pallas_call :631), _k_step_quad (:189, :394)
//   and _k_evals_quad (:244, :449), dispatched from
//   spartan_tpu/core/sumcheck.py prove_quad (:1190).
// Modes (template STEP), as in sc_round_prod.cu: evals only (thread i < n/2
//   reads (X[i], X[i + n/2])), or fold both tables by r into their natural
//   folded tables and take the next round's terms from the folded (lo, hi).
//   The terms are A * B at t = 0 and t = 2 (a table's value at t = 2 is
//   2hi - lo).
// Bound on the H100: memory. A step reads 2 tables and writes 2 half tables
//   (96 bytes per thread of 4 input elements) against 4 fold and 2 eval
//   Montgomery products per thread.
// Design: as sc_round_additive.cu, with two accumulators.
#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace bn254;

struct QuadArgs {
  const uint4* in[2];  // A, B
  uint4* out[2];       // folded A, B (STEP only)
};

template <bool STEP>
__global__ void __launch_bounds__(256)
sc_round_quad_kernel(const QuadArgs args, const uint4* __restrict__ r, long long q,
                     uint4* __restrict__ partials) {
  Fe rr;
  if (STEP) rr = load_fe(r);
  Fe e0 = fr_zero(), e2 = fr_zero();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < q; i += stride) {
    Fe lo[2], hi[2];
#pragma unroll
    for (int t = 0; t < 2; t++) {
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
    e0 = add<Fr>(e0, mul<Fr>(lo[0], lo[1]));
    const Fe a2 = add<Fr>(hi[0], sub<Fr>(hi[0], lo[0]));  // t = 2
    const Fe b2 = add<Fr>(hi[1], sub<Fr>(hi[1], lo[1]));
    e2 = add<Fr>(e2, mul<Fr>(a2, b2));
  }
  const Fe acc[2] = {e0, e2};
  block_sum_store<2>(acc, partials + (long long)blockIdx.x * 2 * 2);
}

// ptrs: host array of the 2 input pointers (A, B), then in STEP mode the 2
// output pointers. q: n/2 (evals only) or n/4 (step).
// partials: [nblocks, 2, 8]. Returns cudaGetLastError().
extern "C" int sc_round_quad_launch(int step, const unsigned long long* ptrs, const void* r,
                                    long long q, int nblocks, void* partials, void* stream) {
  if (nblocks <= 0 || q <= 0) return (int)cudaErrorInvalidValue;
  QuadArgs args;
  for (int t = 0; t < 2; t++) {
    args.in[t] = reinterpret_cast<const uint4*>(ptrs[t]);
    args.out[t] = step ? reinterpret_cast<uint4*>(ptrs[2 + t]) : nullptr;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint4* P = static_cast<uint4*>(partials);
  const uint4* R = static_cast<const uint4*>(r);
  if (step) {
    sc_round_quad_kernel<true><<<nblocks, 256, 0, s>>>(args, R, q, P);
  } else {
    sc_round_quad_kernel<false><<<nblocks, 256, 0, s>>>(args, R, q, P);
  }
  return (int)cudaGetLastError();
}
