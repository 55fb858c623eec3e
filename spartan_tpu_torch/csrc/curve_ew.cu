// H2: complete projective add and doubling on BN254 G1: elementwise, and
// the two ladders that chain them (Horner over window sums, double-and-add).
//
// Replaces: spartan_tpu/ops/pallas_field.py make_curve_kernels ->
//   padd_kernel (:507) via padd (:520) and pdbl_kernel (:514) via pdbl
//   (:534), bodies _padd_block_narrow (:332) and _pdbl_block_narrow (:389),
//   which curve_jax.enable_pallas installs as padd/pdbl; the JAX package's
//   callers loop over them (msm.py _horner_windows, curve_jax.scalar_mul).
// Bound on the H100: integer multiplies. padd moves 288 bytes per point
//   against 12 Montgomery products (~3,200 32-bit multiplies), so the
//   multiply rate, not the 3.35 TB/s of memory, sets the floor; pdbl
//   likewise with 192 bytes and 8 products. A ladder reads each input once
//   and makes hundreds of dependent point operations per row.
// Design: one thread per point (or ladder row), all three coordinates in
//   registers. The formulas are complete (RCB 2016 Alg 7/9, a = 0, b3 = 9),
//   so identity and doubling inputs need no branch and a warp never
//   diverges. A ladder runs whole in one launch (bn254.cuh horner_ladder,
//   scalar_mul_ladder): the accumulator never leaves the registers, where
//   a loop of elementwise launches wrote and read three coordinate tensors
//   per step and paid a launch each time. The prove's Horner ladders have
//   only ~10^3 rows, too few to fill the card, so they run in blocks of 32
//   threads: every row gets an SM of its own before any SM takes two warps.
#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace bn254;

__global__ void padd_kernel(const uint4* __restrict__ x1, const uint4* __restrict__ y1,
                            const uint4* __restrict__ z1, const uint4* __restrict__ x2,
                            const uint4* __restrict__ y2, const uint4* __restrict__ z2,
                            uint4* __restrict__ ox, uint4* __restrict__ oy,
                            uint4* __restrict__ oz, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Point P = load_point(x1, y1, z1, i);
  const Point Q = load_point(x2, y2, z2, i);
  store_point(ox, oy, oz, i, padd(P, Q));
}

__global__ void pdbl_kernel(const uint4* __restrict__ x, const uint4* __restrict__ y,
                            const uint4* __restrict__ z, uint4* __restrict__ ox,
                            uint4* __restrict__ oy, uint4* __restrict__ oz, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_point(ox, oy, oz, i, pdbl(load_point(x, y, z, i)));
}

// window sums x, y, z: [W, B] (most significant window first) -> [B]
__global__ void __launch_bounds__(32) horner_kernel(const uint4* __restrict__ x,
                                                    const uint4* __restrict__ y,
                                                    const uint4* __restrict__ z, int W, int c,
                                                    long long B, uint4* __restrict__ ox,
                                                    uint4* __restrict__ oy,
                                                    uint4* __restrict__ oz) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  store_point(ox, oy, oz, i, horner_ladder(x, y, z, i, B, W, c));
}

// k: [n, 8] canonical scalars; points x, y, z: [n] -> k_i * P_i
__global__ void scalar_mul_kernel(const uint32_t* __restrict__ k, int nbits,
                                  const uint4* __restrict__ x, const uint4* __restrict__ y,
                                  const uint4* __restrict__ z, long long n,
                                  uint4* __restrict__ ox, uint4* __restrict__ oy,
                                  uint4* __restrict__ oz) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store_point(ox, oy, oz, i, scalar_mul_ladder(load_point(x, y, z, i), k + 8 * i, nbits));
}

static inline unsigned grid_for(long long n, int block) {
  return (unsigned)((n + block - 1) / block);
}

extern "C" int curve_padd_launch(const void* x1, const void* y1, const void* z1,
                                 const void* x2, const void* y2, const void* z2,
                                 void* ox, void* oy, void* oz, long long n,
                                 void* stream) {
  if (n <= 0) return 0;
  const int block = 128;
  padd_kernel<<<grid_for(n, block), block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x1), static_cast<const uint4*>(y1),
      static_cast<const uint4*>(z1), static_cast<const uint4*>(x2),
      static_cast<const uint4*>(y2), static_cast<const uint4*>(z2),
      static_cast<uint4*>(ox), static_cast<uint4*>(oy), static_cast<uint4*>(oz), n);
  return (int)cudaGetLastError();
}

extern "C" int curve_pdbl_launch(const void* x, const void* y, const void* z,
                                 void* ox, void* oy, void* oz, long long n,
                                 void* stream) {
  if (n <= 0) return 0;
  const int block = 128;
  pdbl_kernel<<<grid_for(n, block), block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(y),
      static_cast<const uint4*>(z), static_cast<uint4*>(ox), static_cast<uint4*>(oy),
      static_cast<uint4*>(oz), n);
  return (int)cudaGetLastError();
}

extern "C" int curve_horner_launch(const void* x, const void* y, const void* z, int W, int c,
                                   long long B, void* ox, void* oy, void* oz, void* stream) {
  if (B <= 0) return 0;
  if (W <= 0 || c < 0) return (int)cudaErrorInvalidValue;
  const int block = 32;
  horner_kernel<<<grid_for(B, block), block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(y),
      static_cast<const uint4*>(z), W, c, B, static_cast<uint4*>(ox),
      static_cast<uint4*>(oy), static_cast<uint4*>(oz));
  return (int)cudaGetLastError();
}

extern "C" int curve_scalar_mul_launch(const void* k, int nbits, const void* x, const void* y,
                                       const void* z, long long n, void* ox, void* oy,
                                       void* oz, void* stream) {
  if (n <= 0) return 0;
  if (nbits < 0 || nbits > 256) return (int)cudaErrorInvalidValue;
  const int block = 128;
  scalar_mul_kernel<<<grid_for(n, block), block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(k), nbits, static_cast<const uint4*>(x),
      static_cast<const uint4*>(y), static_cast<const uint4*>(z), n,
      static_cast<uint4*>(ox), static_cast<uint4*>(oy), static_cast<uint4*>(oz));
  return (int)cudaGetLastError();
}
