// H3: Pippenger bucket sums by run-balanced tiles of the sorted digit rows.
//
// Replaces: spartan_tpu/ops/msm_pallas.py _prefix_kernel (:65-111), called
//   by bucket_windows_seq (:165, pallas_call at :239), together with the
//   run-end gather that reads each bucket's sum out of the streamed prefixes
//   (:260-278).
// Bound on the H100: integer multiplies. Every point of every digit row is
//   one mixed addition (11 Montgomery products, ~2,900 32-bit multiplies)
//   against 64 bytes of affine coordinates read, and the bucket sums written
//   once. The point table is small (N x 64 bytes) and stays in L2, so the
//   gathers through `order` are L2 hits.
// Design: the TPU gave each lane a whole digit-sorted row (or an equal slice
//   of it), so its work never depended on the digits. Here the wrapper sorts
//   each row (torch.sort) and passes the sorted digits `sd`, the permutation
//   `order` and each row's first nonzero position `start`. The nonzero range
//   of a row is cut into tiles of T sorted positions (T = msm.TILE = 32,
//   passed by the wrapper), one thread each: a thread walks its tile once
//   with mixed adds, whatever the runs of equal digits are, so no thread
//   makes more than T - 1 of them (its loop ends at p1 = min(p0 + T, N);
//   the optional `walk` output reads the count of each). A run that starts and ends inside the tile
//   is a finished bucket sum, written straight to the output. A run cut by a
//   tile edge leaves a piece: the tile's first and last runs go to two piece
//   slots of the tile. Zero rows and the digit-0 prefix get no work.
//   The pieces lie in sorted order, so the same segmented reduction runs
//   again one level up (msm_bucket_combine_kernel): tiles of T slots, one
//   thread each, complete adds; a run holding both its bucket's first and
//   last piece is finished, the others leave pieces for the next level. Each
//   level has at most 2/T as many slots as the one below, and the level with
//   one tile finishes every bucket. Buckets with no points keep the identity
//   written first. Edge rules are the JAX package's: infinity points carry
//   digit 0 and digit 0 has no bucket.
#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace bn254;

// A piece slot's key: -1 when empty, else (bucket << 2) | first | last << 1,
// where bucket = row * nb + digit - 1 indexes the [B, nb] output, `first`
// says the piece holds the bucket's first point and `last` its last.
__device__ __forceinline__ int piece_key(long long bucket, bool first, bool last) {
  return (int)(bucket << 2) | (first ? 1 : 0) | (last ? 2 : 0);
}

// A finished run goes to the output; an unfinished one to the tile's first
// slot if it is the tile's first run, else to its second.
__device__ __forceinline__ void flush_run(const Point& acc, long long bucket, bool first,
                                          bool last, int nrun, long long tile, uint4* ox,
                                          uint4* oy, uint4* oz, uint4* sx, uint4* sy,
                                          uint4* sz, int& key0, int& key1) {
  if (first && last) {
    store_point(ox, oy, oz, bucket, acc);
  } else if (nrun == 0) {
    store_point(sx, sy, sz, 2 * tile, acc);
    key0 = piece_key(bucket, first, last);
  } else {
    store_point(sx, sy, sz, 2 * tile + 1, acc);
    key1 = piece_key(bucket, first, last);
  }
}

__global__ void msm_bucket_fill_kernel(uint4* ox, uint4* oy, uint4* oz, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) store_point(ox, oy, oz, i, identity());
}

// px, py: [N] affine points; order, sd: [B, N] point index and digit of each
// sorted position; start: [B] first nonzero position of each row; tile t is
// row t / tpr, positions start + (t % tpr) * T onwards. walk, unless null:
// [B * tpr] the mixed adds each tile's thread made.
__global__ void msm_bucket_tiles_kernel(const uint4* __restrict__ px,
                                        const uint4* __restrict__ py,
                                        const int* __restrict__ order,
                                        const int* __restrict__ sd,
                                        const int* __restrict__ start, int N, int nb,
                                        int T, int tpr, long long ntiles, uint4* ox,
                                        uint4* oy, uint4* oz, uint4* sx, uint4* sy,
                                        uint4* sz, int* __restrict__ skey,
                                        int* __restrict__ walk) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= ntiles) return;
  const long long row = t / tpr;
  const int* ord = order + row * N;
  const int* dig = sd + row * N;
  const int s0 = start[row];
  const long long p0 = s0 + (t % tpr) * (long long)T;
  int key0 = -1, key1 = -1, nadd = 0;
  if (p0 < N) {
    const int p1 = (int)min(p0 + T, (long long)N);
    int d = dig[p0];
    bool first = p0 == s0 || dig[p0 - 1] != d;
    long long idx = ord[p0];
    Point acc{load_fe(px + 2 * idx), load_fe(py + 2 * idx), fq_one()};
    int nrun = 0;
    for (int p = (int)p0 + 1; p < p1; p++) {
      const int e = dig[p];
      idx = ord[p];
      const Fe x = load_fe(px + 2 * idx), y = load_fe(py + 2 * idx);
      if (e != d) {
        flush_run(acc, row * nb + d - 1, first, true, nrun++, t, ox, oy, oz, sx, sy, sz, key0,
                  key1);
        d = e;
        first = true;
        acc = Point{x, y, fq_one()};
      } else {
        acc = padd_mixed(acc, x, y);
        nadd++;
      }
    }
    const bool last = p1 == N || dig[p1] != d;
    flush_run(acc, row * nb + d - 1, first, last, nrun, t, ox, oy, oz, sx, sy, sz, key0,
              key1);
  }
  skey[2 * t] = key0;
  skey[2 * t + 1] = key1;
  if (walk) walk[t] = nadd;
}

// One level up: n piece slots (ix, iy, iz, ikey) in sorted order; tile t
// takes slots [t * T, t * T + T) and writes its pieces to slots 2t, 2t + 1.
__global__ void msm_bucket_combine_kernel(const uint4* __restrict__ ix,
                                          const uint4* __restrict__ iy,
                                          const uint4* __restrict__ iz,
                                          const int* __restrict__ ikey, long long n, int T,
                                          long long ntiles, uint4* ox, uint4* oy, uint4* oz,
                                          uint4* sx, uint4* sy, uint4* sz,
                                          int* __restrict__ skey) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= ntiles) return;
  const long long q0 = t * T, q1 = min(q0 + T, n);
  int key0 = -1, key1 = -1;
  int nrun = 0, cur = -1;
  bool first = false, last = false;
  Point acc = identity();
  for (long long q = q0; q < q1; q++) {
    const int k = ikey[q];
    if (k < 0) continue;
    const int g = k >> 2;
    const Point v = load_point(ix, iy, iz, q);
    if (g != cur) {
      if (cur >= 0)
        flush_run(acc, cur, first, last, nrun++, t, ox, oy, oz, sx, sy, sz, key0, key1);
      cur = g;
      first = k & 1;
      acc = v;
    } else {
      acc = padd(acc, v);
    }
    last = (k >> 1) & 1;
  }
  if (cur >= 0)
    flush_run(acc, cur, first, last, nrun, t, ox, oy, oz, sx, sy, sz, key0, key1);
  skey[2 * t] = key0;
  skey[2 * t + 1] = key1;
}

static unsigned blocks(long long n, int block) { return (unsigned)((n + block - 1) / block); }

// out: [B, nb] bucket sums; two piece buffers of na and nbuf slots (points +
// keys), ping-ponged by the levels: the tiles write 2 * B * ceil(N / T)
// slots into the first, level k reads the buffer level k - 1 wrote; walk:
// null, or [B * ceil(N / T)] for the mixed adds of each tile's thread.
extern "C" int msm_bucket_launch(const void* px, const void* py, const void* order,
                                 const void* sd, const void* start, int N, int nb, int B,
                                 int T, void* ox, void* oy, void* oz, void* ax, void* ay,
                                 void* az, void* akey, long long na, void* bx, void* by,
                                 void* bz, void* bkey, long long nbuf, void* walk,
                                 void* stream) {
  if (B <= 0 || nb <= 0) return 0;
  if (N <= 0 || T < 4) return (int)cudaErrorInvalidValue;  // levels shrink for T >= 4
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int block = 128;
  uint4 *o[3] = {static_cast<uint4*>(ox), static_cast<uint4*>(oy), static_cast<uint4*>(oz)};
  const long long nout = (long long)B * nb;
  msm_bucket_fill_kernel<<<blocks(nout, block), block, 0, st>>>(o[0], o[1], o[2], nout);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int tpr = (N + T - 1) / T;
  const long long ntiles = (long long)B * tpr;
  if (2 * ntiles > na || 2 * ((2 * ntiles + T - 1) / T) > nbuf)
    return (int)cudaErrorInvalidValue;
  uint4* buf[2][3] = {
      {static_cast<uint4*>(ax), static_cast<uint4*>(ay), static_cast<uint4*>(az)},
      {static_cast<uint4*>(bx), static_cast<uint4*>(by), static_cast<uint4*>(bz)}};
  int* key[2] = {static_cast<int*>(akey), static_cast<int*>(bkey)};
  msm_bucket_tiles_kernel<<<blocks(ntiles, block), block, 0, st>>>(
      static_cast<const uint4*>(px), static_cast<const uint4*>(py),
      static_cast<const int*>(order), static_cast<const int*>(sd),
      static_cast<const int*>(start), N, nb, T, tpr, ntiles, o[0], o[1], o[2], buf[0][0],
      buf[0][1], buf[0][2], key[0], static_cast<int*>(walk));
  rc = (int)cudaGetLastError();
  long long n = 2 * ntiles;
  for (int src = 0; rc == 0; src ^= 1) {
    const long long nt = (n + T - 1) / T;
    const int dst = src ^ 1;
    msm_bucket_combine_kernel<<<blocks(nt, block), block, 0, st>>>(
        buf[src][0], buf[src][1], buf[src][2], key[src], n, T, nt, o[0], o[1], o[2],
        buf[dst][0], buf[dst][1], buf[dst][2], key[dst]);
    rc = (int)cudaGetLastError();
    if (nt == 1) break;
    n = 2 * nt;
  }
  return rc;
}
