// S1: fold k sumcheck tables by one challenge, out[i] = T[i] + r * (T[i + h] - T[i]).
//
// Replaces: spartan_tpu/ops/pallas_sumcheck.py _k_lm_fold (:545), called by
//   lm_fold_pairs (pallas_call at :614): DensePolynomial.bound_poly_var_top
//   over k tables at once.
// Bound on the H100: memory. Per output element it reads 64 bytes and
//   writes 32 against one Montgomery product (264 32-bit multiplies); at
//   3.35 TB/s the bytes take about as long as the multiplies.
// Design: natural order, no pair layout. Table k is blockIdx.y; the k input
//   and output pointers travel by value in the kernel's parameters, so one
//   launch folds every table of a round with no pointer array to copy.
//   A grid-stride loop covers the h outputs of each table.
#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace bn254;

#define SC_FOLD_MAX 64

struct FoldArgs {
  const uint4* in[SC_FOLD_MAX];
  uint4* out[SC_FOLD_MAX];
};

__global__ void __launch_bounds__(256)
sc_fold_kernel(const FoldArgs args, const uint4* __restrict__ r, long long h) {
  const uint4* __restrict__ in = args.in[blockIdx.y];
  uint4* __restrict__ out = args.out[blockIdx.y];
  const Fe rr = load_fe(r);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < h; i += stride) {
    const Fe lo = load_fe(in + 2 * i);
    const Fe hi = load_fe(in + 2 * (i + h));
    store_fe(out + 2 * i, add<Fr>(lo, mul<Fr>(rr, sub<Fr>(hi, lo))));
  }
}

// ptrs: host array of 2k device pointers, the k inputs ([2h, 8] each) then
// the k outputs ([h, 8] each); r: device pointer to one element.
// Returns cudaGetLastError().
extern "C" int sc_fold_launch(const unsigned long long* ptrs, int k, const void* r,
                              long long h, int nblocks, void* stream) {
  if (k <= 0 || h <= 0) return 0;
  if (k > SC_FOLD_MAX || nblocks <= 0) return (int)cudaErrorInvalidValue;
  FoldArgs args;
  for (int j = 0; j < k; j++) {
    args.in[j] = reinterpret_cast<const uint4*>(ptrs[j]);
    args.out[j] = reinterpret_cast<uint4*>(ptrs[k + j]);
  }
  sc_fold_kernel<<<dim3((unsigned)nblocks, (unsigned)k), 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      args, static_cast<const uint4*>(r), h);
  return (int)cudaGetLastError();
}
