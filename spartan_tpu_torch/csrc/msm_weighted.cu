// H4: weighted bucket reduction sum_b b * B_b, split over bucket segments.
//
// Replaces: spartan_tpu/ops/msm_pallas.py _weighted_kernel (:114-161),
//   called by bucket_windows_seq (pallas_call at :301).
// Bound on the H100: integer multiplies. Two complete additions per bucket
//   (24 Montgomery products) against 96 bytes read per bucket.
// Design: the TPU ran one lane per row through all 2^c - 1 buckets, highest
//   first, with a running sum (run += B_b) and a total (tot += run). A
//   single MSM has only ~20-37 rows, which would leave the card idle, so
//   each row's buckets are cut into segments of `seglen` and each
//   (row, segment) is one thread. A segment [s, e] walked from the top gives
//   run = sum B_b and tot = sum (b - s + 1) B_b; its exact share of the row's
//   sum is tot + (s - 1) * run, formed here by a short double-and-add over
//   the bits of s - 1. The wrapper adds the segments' shares with H2.
#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace bn254;

// One out-of-line copy of each formula: inlining the five call sites below
// multiplies the code size and is not needed for a memory-light loop.
__device__ __noinline__ void padd_to(Point* out, const Point* P, const Point* Q) {
  *out = padd(*P, *Q);
}

__device__ __noinline__ void pdbl_to(Point* out, const Point* P) { *out = pdbl(*P); }

// b{x,y,z}: [B, nb] bucket sums of buckets 1..nb; out: [B, nseg] shares.
__global__ void msm_weighted_kernel(const uint4* __restrict__ bx, const uint4* __restrict__ by,
                                    const uint4* __restrict__ bz, int nb, int seglen,
                                    int nseg, long long total, uint4* __restrict__ ox,
                                    uint4* __restrict__ oy, uint4* __restrict__ oz) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long row = t / nseg;
  const int seg = (int)(t % nseg);
  const int first = seg * seglen + 1;
  const int last = min(first + seglen - 1, nb);
  const long long base = row * (long long)nb - 1;  // bucket b at base + b
  Point run = identity();
  Point tot = identity();
  for (int b = last; b >= first; b--) {
    const Point B = load_point(bx, by, bz, base + b);
    padd_to(&run, &run, &B);
    padd_to(&tot, &tot, &run);
  }
  const int k = first - 1;
  Point corr = identity();
  if (k > 0) {
    for (int i = 31 - __clz(k); i >= 0; i--) {
      pdbl_to(&corr, &corr);
      if ((k >> i) & 1) padd_to(&corr, &corr, &run);
    }
  }
  Point out;
  padd_to(&out, &tot, &corr);
  store_point(ox, oy, oz, t, out);
}

extern "C" int msm_weighted_launch(const void* bx, const void* by, const void* bz,
                                   int nb, int seglen, int nseg, long long total,
                                   void* ox, void* oy, void* oz, void* stream) {
  if (total <= 0) return 0;
  if (seglen <= 0 || nseg <= 0 || (long long)seglen * nseg < nb)
    return (int)cudaErrorInvalidValue;
  const int block = 64;
  const unsigned grid = (unsigned)((total + block - 1) / block);
  msm_weighted_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(bx), static_cast<const uint4*>(by),
      static_cast<const uint4*>(bz), nb, seglen, nseg, total, static_cast<uint4*>(ox),
      static_cast<uint4*>(oy), static_cast<uint4*>(oz));
  return (int)cudaGetLastError();
}
