#!/usr/bin/env python3
"""Forms of the BN254 Montgomery product on the card: SASS, registers and rate.

    python3 tools/torch_mont_probe.py

Builds one probe library from ``spartan_tpu_torch/csrc/bn254.cuh`` with
nvcc (sm_90a, the kernels' flags) holding four forms of the 8-word Fq
Montgomery product:

  c64       CIOS in portable C, 32x32 -> 64-bit products and 64-bit
            carries (the header's form before its carry chains);
  lohi      CIOS in PTX carry chains, each row's low product words in one
            chain and its high words in a second;
  evenodd   the same chains regrouped so that the low and high words of
            one product are neighbours in a chain (the even words a_0,
            a_2, .. in the first, the odd ones in the second), on one
            accumulator;
  dual      the header's ``fe_mul``: the even and odd chains on two
            accumulators (the odd one a word up) whose roles swap every
            row, as in supranational's sppark ``ff/mont_t.cuh``, so that
            every chain's word pairs stay aligned.

For each form it reports ptxas's registers, the SASS instructions of a
kernel that makes one product (``cuobjdump``; the product plus the
thread's loads and store) and the product rate of a kernel in which every
thread makes two chains of dependent products on a full card, against the
32-bit multiply bound (264 multiplies per product at 132 SMs x 64 per
clock x 1.98 GHz). The four forms must give the same canonical limbs.
Prints one JSON line per form. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

SOURCE = r"""
#include <cuda_runtime.h>
#include "bn254.cuh"
using namespace bn254;

namespace c64 {
template <class F>
__device__ __forceinline__ void cond_sub_p(uint32_t r[8], const uint32_t s[8]) {
  uint32_t p[8];
  load_p<F>(p);
  uint32_t d[8];
  uint64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t t = (uint64_t)s[i] - p[i] - borrow;
    d[i] = (uint32_t)t;
    borrow = t >> 63;
  }
#pragma unroll
  for (int i = 0; i < 8; i++) r[i] = borrow ? s[i] : d[i];
}

template <class F>
__device__ __forceinline__ void fe_mul(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t p[8];
  load_p<F>(p);
  uint32_t t[10];
#pragma unroll
  for (int i = 0; i < 10; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      c += (uint64_t)a[j] * b[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[8] = (uint32_t)c;
    t[9] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * F::INV;
    c = ((uint64_t)m * p[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < 8; j++) {
      c += (uint64_t)m * p[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[8];
    t[7] = (uint32_t)c;
    t[8] = t[9] + (uint32_t)(c >> 32);
  }
  cond_sub_p<F>(r, t);
}
}  // namespace c64

namespace lohi {
template <class F>
__device__ __forceinline__ void fe_mul(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t p[8];
  load_p<F>(p);
  uint32_t t[9];
#pragma unroll
  for (int j = 0; j < 9; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const uint32_t bi = b[i];
    // lo(a_j b_i) at word j, then hi(a_j b_i) at word j + 1
    t[0] = cc::mad_lo_cc(a[0], bi, t[0]);
#pragma unroll
    for (int j = 1; j < 8; j++) t[j] = cc::madc_lo_cc(a[j], bi, t[j]);
    t[8] = cc::addc(t[8], 0);
    t[1] = cc::mad_hi_cc(a[0], bi, t[1]);
#pragma unroll
    for (int j = 1; j < 7; j++) t[j + 1] = cc::madc_hi_cc(a[j], bi, t[j + 1]);
    t[8] = cc::madc_hi(a[7], bi, t[8]);
    const uint32_t m = t[0] * F::INV;
    (void)cc::mad_lo_cc(m, p[0], t[0]);
#pragma unroll
    for (int j = 1; j < 8; j++) t[j - 1] = cc::madc_lo_cc(m, p[j], t[j]);
    t[7] = cc::addc(t[8], 0);
    t[0] = cc::mad_hi_cc(m, p[0], t[0]);
#pragma unroll
    for (int j = 1; j < 7; j++) t[j] = cc::madc_hi_cc(m, p[j], t[j]);
    t[7] = cc::madc_hi(m, p[7], t[7]);
    t[8] = 0;
  }
  cond_sub_p<F>(r, t);
}
}  // namespace lohi

namespace evenodd {
template <class F>
__device__ __forceinline__ void fe_mul(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t p[8];
  load_p<F>(p);
  uint32_t t[9];
#pragma unroll
  for (int j = 0; j < 9; j++) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    const uint32_t bi = b[i];
    // a_0, a_2, a_4, a_6: lo at word 2k, hi at 2k + 1
    t[0] = cc::mad_lo_cc(a[0], bi, t[0]);
    t[1] = cc::madc_hi_cc(a[0], bi, t[1]);
#pragma unroll
    for (int j = 2; j < 8; j += 2) {
      t[j] = cc::madc_lo_cc(a[j], bi, t[j]);
      t[j + 1] = cc::madc_hi_cc(a[j], bi, t[j + 1]);
    }
    t[8] = cc::addc(t[8], 0);
    // a_1, a_3, a_5, a_7: lo at word 2k + 1, hi at 2k + 2
    t[1] = cc::mad_lo_cc(a[1], bi, t[1]);
    t[2] = cc::madc_hi_cc(a[1], bi, t[2]);
#pragma unroll
    for (int j = 3; j < 7; j += 2) {
      t[j] = cc::madc_lo_cc(a[j], bi, t[j]);
      t[j + 1] = cc::madc_hi_cc(a[j], bi, t[j + 1]);
    }
    t[7] = cc::madc_lo_cc(a[7], bi, t[7]);
    t[8] = cc::madc_hi(a[7], bi, t[8]);
    const uint32_t m = t[0] * F::INV;
    // m p, even words, shifting down one word as it goes
    (void)cc::mad_lo_cc(m, p[0], t[0]);
    t[0] = cc::madc_hi_cc(m, p[0], t[1]);
#pragma unroll
    for (int j = 2; j < 8; j += 2) {
      t[j - 1] = cc::madc_lo_cc(m, p[j], t[j]);
      t[j] = cc::madc_hi_cc(m, p[j], t[j + 1]);
    }
    t[7] = cc::addc(t[8], 0);
    // m p, odd words
    t[0] = cc::mad_lo_cc(m, p[1], t[0]);
    t[1] = cc::madc_hi_cc(m, p[1], t[1]);
#pragma unroll
    for (int j = 3; j < 7; j += 2) {
      t[j - 1] = cc::madc_lo_cc(m, p[j], t[j - 1]);
      t[j] = cc::madc_hi_cc(m, p[j], t[j]);
    }
    t[6] = cc::madc_lo_cc(m, p[7], t[6]);
    t[7] = cc::madc_hi(m, p[7], t[7]);
    t[8] = 0;
  }
  cond_sub_p<F>(r, t);
}
}  // namespace evenodd

template <int V>
__device__ __forceinline__ Fe mulv(const Fe& a, const Fe& b) {
  Fe r;
  if (V == 0) c64::fe_mul<Fq>(r.v, a.v, b.v);
  else if (V == 1) lohi::fe_mul<Fq>(r.v, a.v, b.v);
  else if (V == 2) evenodd::fe_mul<Fq>(r.v, a.v, b.v);
  else fe_mul<Fq>(r.v, a.v, b.v);
  return r;
}

template <int V>
__global__ void __launch_bounds__(256) mul_chains(const uint4* __restrict__ in,
                                                  uint4* __restrict__ out, int iters,
                                                  long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Fe x = load_fe(in + 2 * i), y = load_fe(in + 2 * ((i + 1) % n));
  Fe u = y, v = x;
  for (int k = 0; k < iters; k++) {
    x = mulv<V>(x, y);
    u = mulv<V>(u, v);
  }
  store_fe(out + 2 * i, x);
  store_fe(out + 2 * (n + i), u);
}

template <int V>
__global__ void mul_once(const uint4* __restrict__ a, const uint4* __restrict__ b,
                         uint4* __restrict__ out) {
  store_fe(out, mulv<V>(load_fe(a), load_fe(b)));
}

extern "C" int probe_launch(int v, const void* in, void* out, int iters, long long n,
                            void* stream) {
  const unsigned grid = (unsigned)((n + 255) / 256);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* I = static_cast<const uint4*>(in);
  uint4* O = static_cast<uint4*>(out);
  if (v == 0) mul_chains<0><<<grid, 256, 0, s>>>(I, O, iters, n);
  if (v == 1) mul_chains<1><<<grid, 256, 0, s>>>(I, O, iters, n);
  if (v == 2) mul_chains<2><<<grid, 256, 0, s>>>(I, O, iters, n);
  if (v == 3) mul_chains<3><<<grid, 256, 0, s>>>(I, O, iters, n);
  if (v == 4) mul_once<0><<<1, 1, 0, s>>>(I, I + 2, O);
  if (v == 5) mul_once<1><<<1, 1, 0, s>>>(I, I + 2, O);
  if (v == 6) mul_once<2><<<1, 1, 0, s>>>(I, I + 2, O);
  if (v == 7) mul_once<3><<<1, 1, 0, s>>>(I, I + 2, O);
  return (int)cudaGetLastError();
}
"""

FORMS = ("c64", "lohi", "evenodd", "dual")
THREADS, ITERS = 132 * 2048, 256


def main() -> int:
    import torch

    from spartan_tpu_torch.ops import kernels as K
    from spartan_tpu_torch.ops.limbs import to_tensor
    from spartan_tpu_torch.ops.fields_host import FQ_MOD

    if not torch.cuda.is_available():
        print("torch_mont_probe: needs a CUDA card", file=sys.stderr)
        return 2
    out_dir = os.path.join(HERE, "build", "probe")
    os.makedirs(out_dir, exist_ok=True)
    src, so = os.path.join(out_dir, "mont_probe.cu"), os.path.join(out_dir, "mont_probe.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    ptx = subprocess.run([K.nvcc_path(), *K.NVCC_FLAGS, "-I", K.CSRC, "-o", so, src],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         check=True).stdout
    regs = K.parse_ptxas(ptx)
    sass = K.sass(so)
    lib = ctypes.CDLL(so)
    lib.probe_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_void_p]
    dev = torch.device("cuda")
    import numpy as np

    rng = np.random.default_rng(5)
    vals = [int.from_bytes(rng.bytes(32), "little") % FQ_MOD for _ in range(THREADS)]
    words = np.array([[(v >> (32 * k)) & 0xFFFFFFFF for k in range(8)] for v in vals],
                     dtype=np.uint32)
    x = to_tensor(words, dev)
    outs, stream = {}, torch.cuda.current_stream(dev).cuda_stream
    bound_s = 2 * THREADS * ITERS * 264 / (132 * 64 * 1.98e9)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    for v, form in enumerate(FORMS):
        out = torch.empty((2 * THREADS, 8), dtype=torch.int32, device=dev)
        K.check(lib.probe_launch(v, x.data_ptr(), out.data_ptr(), ITERS, THREADS, stream), form)
        torch.cuda.synchronize()
        times = []
        for _ in range(5):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            K.check(lib.probe_launch(v, x.data_ptr(), out.data_ptr(), ITERS, THREADS, stream),
                    form)
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        times.sort()
        outs[form] = out
        once = [f for f in sass if f.startswith(f"_Z8mul_onceILi{v}E")]
        chains = [f for f in regs if f.startswith(f"_Z10mul_chainsILi{v}E")]
        ms = times[2]
        print(json.dumps({"form": form, "nvidia_smi": smi,
                          "one_product_sass": sass[once[0]] if once else None,
                          "chains_kernel_ptxas": regs[chains[0]] if chains else None,
                          "ms": ms, "ms_spread": [times[0], times[-1]],
                          "products_per_s": 2 * THREADS * ITERS / (ms / 1e3),
                          "bound_ms": bound_s * 1e3, "share_of_bound": bound_s * 1e3 / ms}),
              flush=True)
    same = all(torch.equal(outs[f], outs["c64"]) for f in FORMS)
    print(json.dumps({"forms_agree": same}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
