// T1: the Fiat-Shamir step of one batched product-sumcheck round on the card.
//
// No Pallas counterpart: it stands for the transcript half of the round body
// of spartan_tpu/core/sumcheck_fused.py (_make_round_body :140-196, on the
// DynTranscript of spartan_tpu/ops/transcript_device.py :370), which the JAX
// package traces into its fused sumcheck. Here the rounds above the tail run
// as S2 step -> T1 -> next S2 step on one stream, with no host read between
// them: T1 reads S2's evaluations and writes the challenge r where the next
// S1/S2 launch reads it.
// Work: given the round's evaluations (e0, e2, e3) of I instances ([3I, 8],
//   as S2's wrapper returns them), the layer coefficients [I, 8] and the
//   running claim e, form c_t = sum_i coeff_i e_t,i, the cubic through
//   (c0, e - c0, c2, c3), absorb it (merlin framing), squeeze
//   "challenge_nextround", and set e = cubic(r).
// Bound on the H100: latency. The work is one sponge (two to three
//   Keccak-f[1600] permutations, each depending on the last) and about 65
//   Montgomery products, a few hundred bytes in and out.
// Design: one warp runs transcript.cuh's t1_round: lane k forms the 3
//   products of instances k, k + 32, ..., three warp sums give c0, c2, c3,
//   and the step runs across the warp (Keccak one state lane per lane, the
//   absorbs in parallel from a byte string laid out in shared memory, the
//   independent products on separate lanes). The sponge lives in shared
//   memory and registers, never in a thread's local memory. Every argument
//   is updated in place, so the wrapper allocates nothing.
#include <cuda_runtime.h>

#include "transcript.cuh"

using namespace sctr;

__global__ void __launch_bounds__(32)
sc_transcript_kernel(const uint32_t* __restrict__ evals, const uint32_t* __restrict__ coeffs,
                     int ninst, uint32_t* __restrict__ claim, int32_t* __restrict__ sponge,
                     uint32_t* __restrict__ poly_out, uint32_t* __restrict__ r_out) {
  __shared__ Sponge sp;
  __shared__ alignas(16) uint8_t buf[ROUND_BUF];
  __shared__ Fe out[6];
  t1_round(Warp{}, evals, coeffs, ninst, claim, sponge, poly_out, r_out, &sp, buf, out);
}

// evals [3 ninst, 8], coeffs [ninst, 8]; claim [8], sponge int32 [52],
// poly_out [4, 8] and r_out [8] are written in place. One warp.
// Returns cudaGetLastError().
extern "C" int sc_transcript_launch(const void* evals, const void* coeffs, int ninst,
                                    void* claim, void* sponge, void* poly_out, void* r_out,
                                    void* stream) {
  if (ninst <= 0) return (int)cudaErrorInvalidValue;
  sc_transcript_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(evals), static_cast<const uint32_t*>(coeffs), ninst,
      static_cast<uint32_t*>(claim), static_cast<int32_t*>(sponge),
      static_cast<uint32_t*>(poly_out), static_cast<uint32_t*>(r_out));
  return (int)cudaGetLastError();
}
