// H1: elementwise BN254 field mul / add / sub, Fr and Fq.
//
// Replaces: spartan_tpu/ops/pallas_field.py make_field_kernels ->
//   mul_kernel (:469), add_kernel (:472), sub_kernel (:475), called by
//   binary.op (:478-495), which field_jax.enable_pallas installs as
//   fr/fq.mul/add/sub.
// Bound on the H100: memory. A mul reads 64 bytes and writes 32 per element
//   against 264 32-bit multiplies; at 3.35 TB/s and the card's 32-bit
//   integer multiply rate the bytes take longer. add/sub are memory-bound
//   by far.
// Design: one thread per element, the 8 limbs of each operand in registers
//   (two 16-byte loads), CIOS with 32x32->64 products for mul. An operand
//   with step 0 is a single element read by every thread: the scalar-times-
//   table broadcasts of the sumcheck folds (sumcheck.py k_fold_top) and the
//   r1csproof k_rlc3 need no copy.
#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace bn254;

template <int OP, class F>
__global__ void field_ew_kernel(const uint4* __restrict__ a, long long a_step,
                                const uint4* __restrict__ b, long long b_step,
                                uint4* __restrict__ out, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fe x = load_fe(a + 2 * i * a_step);
  const Fe y = load_fe(b + 2 * i * b_step);
  Fe r;
  if (OP == 0) {
    r = mul<F>(x, y);
  } else if (OP == 1) {
    r = add<F>(x, y);
  } else {
    r = sub<F>(x, y);
  }
  store_fe(out + 2 * i, r);
}

template <int OP>
static void launch_op(int field, const uint4* a, long long sa, const uint4* b,
                      long long sb, uint4* out, long long n, cudaStream_t s) {
  const int block = 256;
  const long long grid = (n + block - 1) / block;
  if (field == 0) {
    field_ew_kernel<OP, Fr><<<(unsigned)grid, block, 0, s>>>(a, sa, b, sb, out, n);
  } else {
    field_ew_kernel<OP, Fq><<<(unsigned)grid, block, 0, s>>>(a, sa, b, sb, out, n);
  }
}

// op: 0 mul, 1 add, 2 sub; field: 0 Fr, 1 Fq. Returns cudaGetLastError().
extern "C" int field_ew_launch(int op, int field, const void* a, long long a_step,
                               const void* b, long long b_step, void* out,
                               long long n, void* stream) {
  if (n <= 0) return 0;
  if (op < 0 || op > 2 || field < 0 || field > 1) return (int)cudaErrorInvalidValue;
  const uint4* A = static_cast<const uint4*>(a);
  const uint4* B = static_cast<const uint4*>(b);
  uint4* O = static_cast<uint4*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (op == 0) {
    launch_op<0>(field, A, a_step, B, b_step, O, n, s);
  } else if (op == 1) {
    launch_op<1>(field, A, a_step, B, b_step, O, n, s);
  } else {
    launch_op<2>(field, A, a_step, B, b_step, O, n, s);
  }
  return (int)cudaGetLastError();
}
