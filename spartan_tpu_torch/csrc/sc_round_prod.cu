// S2: one round of the batched product sumcheck, sum_x A(x) * B(x) * C(x),
// for every instance of the round in one launch.
//
// Replaces: spartan_tpu/ops/pallas_sumcheck.py
//   _k_lm_evals_prod (:573, pallas_call :631), _k_step_prod (:116, :338),
//   _k_step_prod_sharedC (:140, :357) and _k_evals_prod (:211, :416),
//   dispatched from spartan_tpu/core/sumcheck.py prove_cubic /
//   prove_cubic_batched (:542-845).
// Modes (template STEP):
//   evals only: thread i < q = n/2 reads (X[i], X[i + q]) of A, B, C;
//   fold, then evals: thread i < q = n/4 reads X[i], X[i + q], X[i + 2q],
//     X[i + 3q], folds lo = f(X[i], X[i + 2q]) and hi = f(X[i + q], X[i + 3q])
//     with f(u, v) = u + r * (v - u), writes out[i] = lo and out[i + q] = hi
//     (the natural folded table) and takes the next round's terms from
//     (lo, hi). An instance whose C output pointer is null reads an already
//     folded C ([n/2, 8]: the eq table shared by the "par" instances, folded
//     once per round by S1) instead of folding its own.
//   The terms are A*B*C at t = 0, 2, 3, where a table's value at t = 2 is
//   2hi - lo and at t = 3 is 3hi - 2lo.
// Bound on the H100: about even. A fold-and-evals step reads 3 tables and
//   writes 3 half tables (144 bytes per thread of 4 input elements) against
//   12 Montgomery products per thread (3168 32-bit multiplies).
// Design: instance k is blockIdx.y, its pointers travel by value in the
//   kernel's parameters. A grid-stride loop accumulates each thread's terms
//   with modular adds, so partial sums stay canonical; the block reduces
//   them (warp shuffles, modular adds) and writes canonical partials
//   [I, nblocks, 3, 8]; the wrapper sums those exactly. A sum mod p is
//   unique, so the result does not depend on the order of the adds.
#include <cuda_runtime.h>

#include "bn254.cuh"

using namespace bn254;

#define SC_PROD_MAX 32

struct ProdArgs {
  const uint4* a[SC_PROD_MAX];
  const uint4* b[SC_PROD_MAX];
  const uint4* c[SC_PROD_MAX];
  uint4* oa[SC_PROD_MAX];
  uint4* ob[SC_PROD_MAX];
  uint4* oc[SC_PROD_MAX];
};

__device__ __forceinline__ Fe fold_at(const uint4* __restrict__ X, long long i, long long off,
                                      const Fe& r) {
  const Fe lo = load_fe(X + 2 * i);
  const Fe hi = load_fe(X + 2 * (i + off));
  return add<Fr>(lo, mul<Fr>(r, sub<Fr>(hi, lo)));
}

template <bool STEP>
__global__ void __launch_bounds__(256)
sc_round_prod_kernel(const ProdArgs args, const uint4* __restrict__ r, long long q,
                     uint4* __restrict__ partials) {
  const int k = blockIdx.y;
  const uint4* __restrict__ A = args.a[k];
  const uint4* __restrict__ B = args.b[k];
  const uint4* __restrict__ C = args.c[k];
  uint4* __restrict__ OC = args.oc[k];
  Fe rr;
  if (STEP) rr = load_fe(r);
  Fe e0 = fr_zero(), e2 = fr_zero(), e3 = fr_zero();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < q; i += stride) {
    Fe al, ah, bl, bh, cl, ch;
    if (STEP) {
      uint4* __restrict__ OA = args.oa[k];
      uint4* __restrict__ OB = args.ob[k];
      al = fold_at(A, i, 2 * q, rr);
      ah = fold_at(A, i + q, 2 * q, rr);
      bl = fold_at(B, i, 2 * q, rr);
      bh = fold_at(B, i + q, 2 * q, rr);
      store_fe(OA + 2 * i, al);
      store_fe(OA + 2 * (i + q), ah);
      store_fe(OB + 2 * i, bl);
      store_fe(OB + 2 * (i + q), bh);
      if (OC != nullptr) {
        cl = fold_at(C, i, 2 * q, rr);
        ch = fold_at(C, i + q, 2 * q, rr);
        store_fe(OC + 2 * i, cl);
        store_fe(OC + 2 * (i + q), ch);
      } else {
        cl = load_fe(C + 2 * i);
        ch = load_fe(C + 2 * (i + q));
      }
    } else {
      al = load_fe(A + 2 * i);
      ah = load_fe(A + 2 * (i + q));
      bl = load_fe(B + 2 * i);
      bh = load_fe(B + 2 * (i + q));
      cl = load_fe(C + 2 * i);
      ch = load_fe(C + 2 * (i + q));
    }
    const Fe da = sub<Fr>(ah, al), db = sub<Fr>(bh, bl), dc = sub<Fr>(ch, cl);
    e0 = add<Fr>(e0, mul<Fr>(mul<Fr>(al, bl), cl));
    Fe a = add<Fr>(ah, da), b = add<Fr>(bh, db), c = add<Fr>(ch, dc);  // t = 2
    e2 = add<Fr>(e2, mul<Fr>(mul<Fr>(a, b), c));
    a = add<Fr>(a, da);  // t = 3
    b = add<Fr>(b, db);
    c = add<Fr>(c, dc);
    e3 = add<Fr>(e3, mul<Fr>(mul<Fr>(a, b), c));
  }
  const Fe acc[3] = {e0, e2, e3};
  block_sum_store<3>(acc, partials + ((long long)k * gridDim.x + blockIdx.x) * 3 * 2);
}

// ptrs: host array of 6 * ninst device pointers in the order a[], b[], c[],
// oa[], ob[], oc[] (the outputs only in STEP mode; oc[k] = 0 for an instance
// whose c[k] is already folded). q: n/2 (evals only) or n/4 (step).
// partials: [ninst, nblocks, 3, 8]. Returns cudaGetLastError().
extern "C" int sc_round_prod_launch(int step, const unsigned long long* ptrs, int ninst,
                                    const void* r, long long q, int nblocks, void* partials,
                                    void* stream) {
  if (ninst <= 0) return 0;
  if (ninst > SC_PROD_MAX || nblocks <= 0 || q <= 0) return (int)cudaErrorInvalidValue;
  ProdArgs args;
  for (int j = 0; j < ninst; j++) {
    args.a[j] = reinterpret_cast<const uint4*>(ptrs[j]);
    args.b[j] = reinterpret_cast<const uint4*>(ptrs[ninst + j]);
    args.c[j] = reinterpret_cast<const uint4*>(ptrs[2 * ninst + j]);
    args.oa[j] = step ? reinterpret_cast<uint4*>(ptrs[3 * ninst + j]) : nullptr;
    args.ob[j] = step ? reinterpret_cast<uint4*>(ptrs[4 * ninst + j]) : nullptr;
    args.oc[j] = step ? reinterpret_cast<uint4*>(ptrs[5 * ninst + j]) : nullptr;
  }
  const dim3 grid((unsigned)nblocks, (unsigned)ninst);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint4* P = static_cast<uint4*>(partials);
  const uint4* R = static_cast<const uint4*>(r);
  if (step) {
    sc_round_prod_kernel<true><<<grid, 256, 0, s>>>(args, R, q, P);
  } else {
    sc_round_prod_kernel<false><<<grid, 256, 0, s>>>(args, R, q, P);
  }
  return (int)cudaGetLastError();
}
