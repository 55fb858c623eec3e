// H3: Pippenger bucket sums, one thread per (digit row, bucket).
//
// Replaces: spartan_tpu/ops/msm_pallas.py _prefix_kernel (:65-111), called
//   by bucket_windows_seq (:165, pallas_call at :239), together with the
//   run-end gather that reads each bucket's sum out of the streamed prefixes
//   (:260-278).
// Bound on the H100: integer multiplies. Every point of every digit row is
//   one mixed addition (11 Montgomery products, ~2,900 32-bit multiplies)
//   against 64 bytes of affine coordinates read, and the bucket sums written
//   once.
// Design: the TPU walked each row's digit-sorted points in order, one row
//   per lane, resetting a prefix at every digit change and streaming all N
//   prefixes to memory. Here the rows are sorted by the wrapper
//   (torch.sort) and the run [lo, hi) of each bucket found by
//   torch.searchsorted; each thread then walks only its own run with mixed
//   adds, from the identity, and writes its bucket sum directly: no prefix
//   array, no gather, and as many independent threads as (row, bucket)
//   pairs. Edge rules are the JAX package's: infinity points carry digit 0
//   and digit 0 has no bucket, so neither ever reaches a mixed add; an empty
//   run leaves the identity.
#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace bn254;

// px, py: [N] affine points (8 limbs each); order: [B, N] point index of each
// sorted position; lo, hi: [B, nb] run bounds of buckets 1..nb;
// out: [B, nb] projective bucket sums.
__global__ void msm_bucket_kernel(const uint4* __restrict__ px, const uint4* __restrict__ py,
                                  const int* __restrict__ order, const int* __restrict__ lo,
                                  const int* __restrict__ hi, int N, int nb,
                                  long long total, uint4* __restrict__ ox,
                                  uint4* __restrict__ oy, uint4* __restrict__ oz) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long row = t / nb;
  const int* ord = order + row * (long long)N;
  const int s = lo[t], e = hi[t];
  Point acc = identity();
  for (int k = s; k < e; k++) {
    const long long idx = __ldg(ord + k);
    acc = padd_mixed(acc, load_fe(px + 2 * idx), load_fe(py + 2 * idx));
  }
  store_point(ox, oy, oz, t, acc);
}

extern "C" int msm_bucket_launch(const void* px, const void* py, const void* order,
                                 const void* lo, const void* hi, int N, int nb,
                                 long long total, void* ox, void* oy, void* oz,
                                 void* stream) {
  if (total <= 0) return 0;
  const int block = 128;
  const unsigned grid = (unsigned)((total + block - 1) / block);
  msm_bucket_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(px), static_cast<const uint4*>(py),
      static_cast<const int*>(order), static_cast<const int*>(lo),
      static_cast<const int*>(hi), N, nb, total, static_cast<uint4*>(ox),
      static_cast<uint4*>(oy), static_cast<uint4*>(oz));
  return (int)cudaGetLastError();
}
