// H4: weighted bucket reduction sum_b b * B_b, one row per 2^ls lanes.
//
// Replaces: spartan_tpu/ops/msm_pallas.py _weighted_kernel (:114-161),
//   called by bucket_windows_seq (pallas_call at :301), and the tree-add of
//   its segment totals (reduce_points, :316-320).
// Bound on the H100: integer multiplies. Two complete additions per bucket
//   (24 Montgomery products) against 96 bytes read per bucket.
// Design: the TPU ran one lane per row through all nb buckets, highest
//   first, with a running sum (run += B_b) and a total (tot += run). A
//   single MSM has only ~20-37 rows, which would leave the card idle, so
//   here S = 2^ls lanes of a warp share a row (32 / S rows per warp) and
//   lane s takes the buckets of segment s, [sL + 1, (s + 1)L] with
//   L = 2^lg (S L >= nb; the wrapper picks L = 64 where nb allows, so a
//   lane makes ~128 additions and the lanes' combine below stays small).
//   Walked from the top, lane s gets run_s = sum B_b and
//   tot_s = sum (b - sL) B_b. The row's sum is
//   sum_s tot_s + L * sum_s s * run_s, and
//   sum_s s * run_s = sum_{s >= 1} U_s with U_s = sum_{s' >= s} run_s'. So:
//   a suffix scan of run over the row's lanes (ls shuffle steps), lg
//   doublings of U_s, Y_s = L U_s + tot_s (Y_0 = tot_0), and a shuffle tree
//   of Y (ls steps), whose first lane writes the sum. No segment needs a
//   correction of its own and no share leaves the kernel. Each formula has
//   one call site, and no Point is ever addressed (a conditional picks
//   values by assignment), so nothing goes to local memory and the inlined
//   code stays small (nvcc 12.8 crashed on a kernel with five inlined
//   padd/pdbl sites).
#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace bn254;

// lane + o of the lane's group of w lanes (its own value past the group)
__device__ __forceinline__ Point shfl_down_point(const Point& P, int o, int w) {
  Point r;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    r.X.v[k] = __shfl_down_sync(0xffffffffu, P.X.v[k], o, w);
    r.Y.v[k] = __shfl_down_sync(0xffffffffu, P.Y.v[k], o, w);
    r.Z.v[k] = __shfl_down_sync(0xffffffffu, P.Z.v[k], o, w);
  }
  return r;
}

// b{x,y,z}: [rows, nb] bucket sums of buckets 1..nb; out: [rows] row sums.
__global__ void msm_weighted_kernel(const uint4* __restrict__ bx, const uint4* __restrict__ by,
                                    const uint4* __restrict__ bz, int nb, int lg, int ls,
                                    long long rows, uint4* __restrict__ ox,
                                    uint4* __restrict__ oy, uint4* __restrict__ oz) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = t >> ls;
  const int S = 1 << ls, s = (int)(t & (S - 1));
  const int L = 1 << lg;
  // lanes past the last row keep an empty segment: every lane of the warp
  // takes part in the shuffles
  const int lo = s * L + 1, hi = row < rows ? min(s * L + L, nb) : 0;
  const long long base = row * nb - 1;  // bucket b at base + b
  // the segment, top down: even steps run += B_b, odd steps tot += run
  // (the first bucket starts both), through one padd call site
  Point run = identity(), tot = identity();
  if (hi >= lo) {
    run = load_point(bx, by, bz, base + hi);
    tot = run;
  }
#pragma unroll 1
  for (int i = 2; i < 2 * (hi - lo + 1); i++) {
    const bool odd = i & 1;
    Point a = run, q = run;
    if (odd) a = tot;
    else q = load_point(bx, by, bz, base + hi - (i >> 1));
    const Point r = padd(a, q);
    if (odd) tot = r;
    else run = r;
  }
  // steps 0..ls-1: suffix scan U_s of run; step ls: Y_s = L U_s + tot_s;
  // then ls steps of a tree sum of Y into lane 0 (one padd call site)
  Point acc = run;
#pragma unroll 1
  for (int step = 0; step <= 2 * ls; step++) {
    Point y = tot;
    bool take;
    if (step < ls) {
      const int o = 1 << step;
      y = shfl_down_point(acc, o, S);
      take = s + o < S;
    } else if (step == ls) {
      for (int i = 0; i < lg; i++) acc = pdbl(acc);
      if (s == 0) acc = tot;
      take = s > 0;
    } else {
      const int o = S >> (step - ls);
      y = shfl_down_point(acc, o, S);
      take = s < o;
    }
    if (take) acc = padd(acc, y);
  }
  if (s == 0 && row < rows) store_point(ox, oy, oz, row, acc);
}

extern "C" int msm_weighted_launch(const void* bx, const void* by, const void* bz, int nb,
                                   int lg, int ls, long long rows, void* ox, void* oy,
                                   void* oz, void* stream) {
  if (rows <= 0) return 0;
  if (nb <= 0 || lg < 0 || lg > 24 || ls < 0 || ls > 5 || ((long long)1 << (lg + ls)) < nb)
    return (int)cudaErrorInvalidValue;
  const int block = 128;
  const unsigned grid = (unsigned)(((rows << ls) + block - 1) / block);
  msm_weighted_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(bx), static_cast<const uint4*>(by),
      static_cast<const uint4*>(bz), nb, lg, ls, rows, static_cast<uint4*>(ox),
      static_cast<uint4*>(oy), static_cast<uint4*>(oz));
  return (int)cudaGetLastError();
}
