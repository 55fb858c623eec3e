// H4: weighted bucket reduction sum_b b * B_b per digit row, in levels of
// lane groups of at most a warp.
//
// Replaces: spartan_tpu/ops/msm_pallas.py _weighted_kernel (:114-161),
//   called by bucket_windows_seq (pallas_call at :301), and the tree-add of
//   its segment totals (reduce_points, :316-320).
// Bound on the H100: integer multiplies. Two complete additions per bucket
//   (24 Montgomery products) against 96 bytes read per bucket.
// Design: the TPU ran one lane per row through all nb buckets, highest
//   first, with a running sum (run += B_b) and a total (tot += run). Here a
//   lane takes a segment of L = 2^lg buckets, and S = 2^ls lanes (at most
//   a warp) form a group. Walked from the top, lane s of a group gets
//   run_s = sum B_b and tot_s = sum (b - sL) B_b over its segment
//   (b counted from the group's first bucket). The group's sum is
//   T = sum_s tot_s + L * sum_s s * run_s, and
//   sum_s s * run_s = sum_{s >= 1} U_s with U_s = sum_{s' >= s} run_s'. So:
//   a suffix scan of run over the group's lanes (ls shuffle steps), lg
//   doublings of U_s, Y_s = L U_s + tot_s (Y_0 = tot_0), and a shuffle tree
//   of Y (ls steps), whose first lane writes T. No segment needs a
//   correction of its own.
// Two layouts (msm.py h4_layout picks one from rows and nb):
//   - one warp a row, where the rows fill the card (the Hyrax commits:
//     thousands of rows of 127-1,023 buckets): one group of S <= 32 lanes
//     covers the row (S L >= nb, L = 64 where nb allows), 32 / S rows share
//     a warp, and T is the row's sum. One launch.
//   - few rows (a KZG MSM's 16 windows of 65,535 buckets): a row takes G
//     groups of 32 lanes (G warps) of small segments (L = 8-64), so that the
//     rows' warps fill the card. Group g's T_g counts its buckets from its
//     own first one, and the row's sum is
//       sum_g T_g + (32 L) * sum_g g * R_g,  R_g = sum of the group's buckets,
//     which is this same combine over the groups as lanes (run = R_g,
//     tot = T_g) with lg + 5 doublings. R_g is the group's U_0, taken by
//     its first lane before the doublings, so it costs no addition. The
//     next level runs as a second launch of the kernel (the LOAD form: a
//     lane reads its (R, T) instead of walking buckets), in groups of up to
//     32, and again while a row has more than one group; the launch
//     function below queues every level on the stream in one call. A
//     second launch, not a last-group-finishes counter: the levels are
//     deterministic, need no coherent loads or zeroed counters, and each
//     is small (a level's lanes are the groups of the one below).
// Each formula has one call site in each form, and no Point is ever
// addressed (a conditional picks values by assignment), so nothing goes to
// local memory and the inlined code stays small (nvcc 12.8 crashed on a
// kernel with five inlined padd/pdbl sites).
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

// One level over [rows, groups] groups of 2^ls lanes; lane i of a row
// (i = g * 2^ls + s) holds:
//   WALK: the buckets [i L + 1, (i + 1) L] of the bucket sums {i}{x,y,z}
//     [rows, n] (bucket b at b - 1; L = 2^lg);
//   LOAD: element i of the previous level's R = {i}{x,y,z} and T =
//     {t}{x,y,z}, both [rows, n] (identity past n).
// Writes each group's T to o{x,y,z} [rows, groups] and, if r{x,y,z} is
// given, its R there; dbl doublings weigh the lanes (lg at level 0).
template <bool WALK>
__global__ void msm_weighted_kernel(const uint4* __restrict__ ix, const uint4* __restrict__ iy,
                                    const uint4* __restrict__ iz, const uint4* __restrict__ tx,
                                    const uint4* __restrict__ ty, const uint4* __restrict__ tz,
                                    int n, int lg, int dbl, int ls, long long groups,
                                    long long rows, uint4* __restrict__ ox,
                                    uint4* __restrict__ oy, uint4* __restrict__ oz,
                                    uint4* __restrict__ rx, uint4* __restrict__ ry,
                                    uint4* __restrict__ rz) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long q = t >> ls;  // the lane's group, row-major over [rows, groups]
  const long long row = q / groups;
  const int S = 1 << ls, s = (int)(t & (S - 1));
  const long long i = (q - row * groups) * S + s;
  // lanes past the last row keep an empty segment: every lane of the warp
  // takes part in the shuffles
  Point run = identity(), tot = identity();
  if (WALK) {
    const int L = 1 << lg;
    const int lo = (int)i * L + 1, hi = row < rows ? min(lo + L - 1, n) : 0;
    const long long base = row * n - 1;  // bucket b at base + b
    if (hi >= lo) {
      run = load_point(ix, iy, iz, base + hi);
      tot = run;
    }
    // the segment, top down: even steps run += B_b, odd steps tot += run
    // (the first bucket starts both), through one padd call site
#pragma unroll 1
    for (int k = 2; k < 2 * (hi - lo + 1); k++) {
      const bool odd = k & 1;
      Point a = run, p = run;
      if (odd) a = tot;
      else p = load_point(ix, iy, iz, base + hi - (k >> 1));
      const Point r = padd(a, p);
      if (odd) tot = r;
      else run = r;
    }
  } else if (row < rows && i < n) {
    run = load_point(ix, iy, iz, row * n + i);
    tot = load_point(tx, ty, tz, row * n + i);
  }
  // steps 0..ls-1: suffix scan U_s of run; step ls: R = U_0 (lane 0),
  // Y_s = 2^dbl U_s + tot_s; then ls steps of a tree sum of Y into lane 0
  // (one padd call site)
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
      if (s == 0) {
        if (rx != nullptr && row < rows) store_point(rx, ry, rz, q, acc);
        acc = tot;
      } else {
        for (int k = 0; k < dbl; k++) acc = pdbl(acc);
      }
      take = s > 0;
    } else {
      const int o = S >> (step - ls);
      y = shfl_down_point(acc, o, S);
      take = s < o;
    }
    if (take) acc = padd(acc, y);
  }
  if (s == 0 && row < rows) store_point(ox, oy, oz, q, acc);
}

// lanes of a group at a level over n inputs a row: log2 of min(32, 2^ceil(log2 n))
static int group_log2(long long n) {
  int ls = 0;
  while (ls < 5 && (1LL << ls) < n) ls++;
  return ls;
}

// The levels of one layout: the bucket sums b{x,y,z} [rows, nb] in segments
// of 2^lg and groups of 2^ls lanes (0 <= ls <= 5), then groups of at most 32
// over the groups below until a row has one; out [rows] row sums. Every
// level but the last writes its T and R ([rows, groups] each, T first) one
// after another into the scratch s{x,y,z} of `scratch` points (msm.py
// h4_levels sizes it); too little scratch is refused before any launch.
extern "C" int msm_weighted_launch(const void* bx, const void* by, const void* bz, int nb,
                                   int lg, int ls, long long rows, void* sx, void* sy, void* sz,
                                   long long scratch, void* ox, void* oy, void* oz,
                                   void* stream) {
  if (rows <= 0) return 0;
  if (nb <= 0 || lg < 0 || lg > 24 || ls < 0 || ls > 5) return (int)cudaErrorInvalidValue;
  const long long g0 = (nb + (1LL << (lg + ls)) - 1) >> (lg + ls);
  long long need = 0;
  for (long long g = g0; g > 1;) {
    need += 2 * rows * g;
    const int l = group_log2(g);
    g = (g + (1LL << l) - 1) >> l;
  }
  if (need > scratch || (need > 0 && (sx == nullptr || sy == nullptr || sz == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int block = 128;
  uint4 *const px = static_cast<uint4*>(sx), *const py = static_cast<uint4*>(sy),
               *const pz = static_cast<uint4*>(sz);
  // level 0: walk the buckets
  long long groups = g0, off = 0;
  const uint4 *ix = static_cast<const uint4*>(bx), *iy = static_cast<const uint4*>(by),
              *iz = static_cast<const uint4*>(bz), *tx = nullptr, *ty = nullptr, *tz = nullptr;
  int n = nb, l = ls, dbl = lg;
  bool walk = true;
  for (;;) {
    const bool last = groups == 1;
    uint4 *o[3], *r[3] = {nullptr, nullptr, nullptr};
    if (last) {
      o[0] = static_cast<uint4*>(ox); o[1] = static_cast<uint4*>(oy); o[2] = static_cast<uint4*>(oz);
    } else {
      o[0] = px + 2 * off; o[1] = py + 2 * off; o[2] = pz + 2 * off;
      r[0] = px + 2 * (off + rows * groups); r[1] = py + 2 * (off + rows * groups);
      r[2] = pz + 2 * (off + rows * groups);
    }
    const long long threads = (rows * groups) << l;
    const unsigned grid = (unsigned)((threads + block - 1) / block);
    if (walk)
      msm_weighted_kernel<true><<<grid, block, 0, st>>>(ix, iy, iz, tx, ty, tz, n, lg, dbl, l,
                                                        groups, rows, o[0], o[1], o[2], r[0],
                                                        r[1], r[2]);
    else
      msm_weighted_kernel<false><<<grid, block, 0, st>>>(ix, iy, iz, tx, ty, tz, n, lg, dbl, l,
                                                         groups, rows, o[0], o[1], o[2], r[0],
                                                         r[1], r[2]);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || last) return (int)err;
    // the next level: this level's groups are its lanes, each a segment of
    // 2^(dbl + l) buckets
    ix = r[0]; iy = r[1]; iz = r[2];
    tx = o[0]; ty = o[1]; tz = o[2];
    off += 2 * rows * groups;
    n = (int)groups;
    dbl += l;
    l = group_log2(groups);
    groups = (groups + (1LL << l) - 1) >> l;
    walk = false;
  }
}
