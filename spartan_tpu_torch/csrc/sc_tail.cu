// T2: every remaining round of a batched product sumcheck whose tables have
// at most SMALL_BUCKET_N entries, in one launch: evaluations, Fiat-Shamir
// step and fold, round after round, with the challenges on the card.
//
// No Pallas counterpart: it stands for spartan_tpu/core/sumcheck_fused.py
// _k_fused_cubic_batched (:199-226), the JAX package's lax.while_loop over
// the small-table tail. Each round does what S2 does (the products A*B*C at
// t = 0, 2, 3 and their exact sums), then T1's step (transcript.cuh
// round_step_warp), then what S1 does (fold every table by r).
// Bound on the H100: the chain of rounds. Each round needs the last one's
//   challenge, so the rounds run one after another. At SMALL_BUCKET_N =
//   2^14 entries the first rounds are multiply-bound (2.47 million
//   Montgomery products at the leaf layout, most of them in the first
//   four rounds) on the 16 SMs of one cluster, the most a cluster has;
//   from about 2^10 entries down every round costs the step's latency on
//   one warp (2-3 dependent Keccak-f[1600] permutations and a few
//   dependent products) plus the block reduction and the barriers.
//   PERF.md gives the times (NVIDIA H100 80GB HBM3, 700 W).
// Design: a thread-block cluster of nb blocks (16 from 128 entries up, else
//   1: the wrapper's tail_cluster), launched with cudaLaunchKernelEx.
//   - The wrapper stacks the tables into one [M, n, 8] buffer (A of every
//     instance, B of every instance, the shared C, the own Cs; 22.5 MB at
//     the leaf layout's 2^14 entries, so it stays in the 50 MB L2), folded
//     in place.
//   - Block b owns the pairs i = b (mod nb). While the half size h is a
//     multiple of nb, a block's inputs in round j + 1 (positions i and
//     i + h/2) are its own writes from round j's fold, so blocks share only
//     each round's three weighted sums. Each block pushes its sums into
//     every block's shared memory (distributed shared memory, two slots by
//     round parity), one cluster barrier follows, and every block's warp 0
//     adds the nb sums and runs the step itself: each keeps its own copy of
//     the sponge, and the same inputs give the same challenge. One cluster
//     barrier a round, and r never crosses SMs. Block 0 writes the outputs.
//   - When h falls below nb, a last cluster barrier makes every fold
//     visible, the other blocks exit, and block 0 runs the remaining rounds
//     (fewer pairs than blocks: the step's latency, whatever runs them).
//   - A thread takes a contiguous run of the block's (instance, pair)
//     items, so the layer coefficient it weights its terms by changes
//     rarely; a round ends in one block reduction of three elements.
//   - 384 threads a block, one block an SM (162 registers, no spill): the
//     evaluation and fold loops keep their accumulators in registers. 512
//     threads cap a thread at 128 registers and spill; 256 leave the
//     first rounds' multiplies waiting on latency.
//   Chosen over a cooperative launch across all 132 SMs, which would take
//   the first rounds' products further: that needs a grid-wide barrier a
//   round, through device memory, where a cluster barrier stays among 16
//   neighbouring SMs, and most rounds are the step's latency, which more
//   SMs do not shorten. Plain loads throughout (never __ldg): the tables
//   are rewritten inside the launch.
// A refused launch, or a cluster size the card cannot schedule
// (cudaOccupancyMaxActiveClusters), returns its error; nothing falls back.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "transcript.cuh"

namespace cg = cooperative_groups;
using namespace sctr;

#define SC_TAIL_THREADS 384
#define SC_TAIL_MAX_CLUSTER 16

// one element of the stacked tables: two 16-byte words, coherent loads
__device__ __forceinline__ Fe tload(const uint32_t* T, long long i) {
  const uint4* p = reinterpret_cast<const uint4*>(T) + 2 * i;
  const uint4 lo = p[0], hi = p[1];
  return Fe{{lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w}};
}

__device__ __forceinline__ void tstore(uint32_t* T, long long i, const Fe& a) {
  uint4* p = reinterpret_cast<uint4*>(T) + 2 * i;
  p[0] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
  p[1] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
}

// the three sums over the block, exact mod p; warp 0 ends with the totals
// on every lane
__device__ __forceinline__ void block_sums3(const Warp& w, Fe& a, Fe& b, Fe& c) {
  constexpr int NW = SC_TAIL_THREADS / 32;
  __shared__ Fe part[3][NW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a = warp_allsum(w, a);
  b = warp_allsum(w, b);
  c = warp_allsum(w, c);
  if (lane == 0) {
    part[0][warp] = a;
    part[1][warp] = b;
    part[2][warp] = c;
  }
  __syncthreads();
  if (warp == 0) {
    a = warp_allsum(w, lane < NW ? part[0][lane] : fe_zero());
    b = warp_allsum(w, lane < NW ? part[1][lane] : fe_zero());
    c = warp_allsum(w, lane < NW ? part[2][lane] : fe_zero());
  }
}

__global__ void __launch_bounds__(SC_TAIL_THREADS, 1)
sc_tail_kernel(uint32_t* T, int ntab, int n, int ninst, int npar,
               const uint32_t* __restrict__ coeffs, uint32_t* __restrict__ claim,
               int32_t* __restrict__ sponge, uint32_t* __restrict__ polys,
               uint32_t* __restrict__ rs, uint32_t* __restrict__ finals, int rounds) {
  cg::cluster_group cluster = cg::this_cluster();
  int nb = (int)cluster.num_blocks();
  const int b = (int)cluster.block_rank();
  __shared__ Sponge sp;
  __shared__ alignas(16) uint8_t buf[ROUND_BUF];
  __shared__ Fe out[6];                             // coefficients, r, the claim
  __shared__ Fe part[2][SC_TAIL_MAX_CLUSTER][3];    // every block's sums, by round parity
  const int tid = threadIdx.x;
  const Warp w{};
  int32_t* words = reinterpret_cast<int32_t*>(&sp);
  for (int k = tid; k < SPONGE_WORDS; k += SC_TAIL_THREADS) words[k] = sponge[k];
  if (tid < 32) round_template(w, buf);
  if (tid == 0) out[5] = ld(claim, 0);
  // every block of the cluster runs before any writes into its shared memory
  if (nb > 1)
    cluster.sync();
  else
    __syncthreads();
  const long long tsz = 8LL * n;  // words per table
  const uint32_t* A = T;
  const uint32_t* B = T + tsz * ninst;
  const uint32_t* Cp = T + tsz * 2 * ninst;
  int lg_nb = __ffs(nb) - 1;
  for (int j = 0; j < rounds; j++) {
    const int lg_h = rounds - j - 1, h = 1 << lg_h;
    if (nb > 1 && h < nb) {
      // the rest runs in block 0, which reads the other blocks' folds
      __threadfence();
      cluster.sync();
      if (b != 0) return;
      nb = 1;
      lg_nb = 0;
    }
    const int lg_hb = lg_h - lg_nb, hb = 1 << lg_hb;  // this block's pairs b + nb q, q < hb
    // the evaluations: a contiguous run of the items (instance k, pair q)
    const int total = ninst << lg_hb, per = (total + SC_TAIL_THREADS - 1) / SC_TAIL_THREADS;
    int x = tid * per;
    const int x1 = min(x + per, total);
    Fe s0 = fe_zero(), s2 = fe_zero(), s3 = fe_zero();
    while (x < x1) {
      const int k = x >> lg_hb, xe = min(x1, (k + 1) << lg_hb);
      const uint32_t* a = A + tsz * k;
      const uint32_t* bb = B + tsz * k;
      const uint32_t* c = k < npar ? Cp : Cp + tsz * (1 + k - npar);
      Fe t0 = fe_zero(), t2 = fe_zero(), t3 = fe_zero();
      for (; x < xe; x++) {
        const int i = b + ((x & (hb - 1)) << lg_nb);
        const Fe al = tload(a, i), ah = tload(a, i + h);
        const Fe bl = tload(bb, i), bh = tload(bb, i + h);
        const Fe cl = tload(c, i), ch = tload(c, i + h);
        const Fe da = sub(ah, al), db = sub(bh, bl), dc = sub(ch, cl);
        t0 = add(t0, mul(mul(al, bl), cl));
        Fe u = add(ah, da), v = add(bh, db), z = add(ch, dc);  // t = 2
        t2 = add(t2, mul(mul(u, v), z));
        u = add(u, da);  // t = 3
        v = add(v, db);
        z = add(z, dc);
        t3 = add(t3, mul(mul(u, v), z));
      }
      const Fe wk = ld(coeffs, k);
      s0 = add(s0, mul(t0, wk));
      s2 = add(s2, mul(t2, wk));
      s3 = add(s3, mul(t3, wk));
    }
    block_sums3(w, s0, s2, s3);
    if (nb > 1) {
      if (tid < nb) {
        Fe* dst = cluster.map_shared_rank(&part[j & 1][b][0], tid);
        dst[0] = s0;
        dst[1] = s2;
        dst[2] = s3;
      }
      cluster.sync();
      if (tid < 32) {
        const bool in = tid < nb;
        s0 = warp_allsum(w, in ? part[j & 1][tid][0] : fe_zero());
        s2 = warp_allsum(w, in ? part[j & 1][tid][1] : fe_zero());
        s3 = warp_allsum(w, in ? part[j & 1][tid][2] : fe_zero());
      }
    }
    if (tid < 32) {
      round_step_warp(w, &sp, buf, s0, s2, s3, out[5], out);
      if (b == 0 && tid < 4) st(polys, 4 * j + tid, out[tid]);
      if (b == 0 && tid == 4) st(rs, j, out[4]);
    }
    __syncthreads();
    const Fe r = out[4];
    for (int y = tid; y < ntab << lg_hb; y += SC_TAIL_THREADS) {
      const int t = y >> lg_hb, i = b + ((y & (hb - 1)) << lg_nb);
      uint32_t* p = T + tsz * t;
      const Fe lo = tload(p, i), hi = tload(p, i + h);
      tstore(p, i, add(lo, mul(r, sub(hi, lo))));
    }
    __syncthreads();
  }
  if (b != 0) return;  // only with no round (n = 1 runs one block)
  for (int t = tid; t < ntab; t += SC_TAIL_THREADS) st(finals, t, tload(T + tsz * t, 0));
  if (tid == 0) st(claim, 0, out[5]);
  for (int k = tid; k < SPONGE_WORDS; k += SC_TAIL_THREADS) sponge[k] = words[k];
}

// T: [ntab, n, 8] stacked tables (ntab = 2 ninst + 1 + nseq: A of every
// instance, B of every instance, the shared C, then the own C of the last
// ninst - npar instances), folded in place; coeffs [ninst, 8]; claim [8] and
// sponge int32 [52] updated in place; polys [rounds, 4, 8], rs [rounds, 8]
// and finals [ntab, 8] written. n = 2^rounds <= 2^20. cluster: the blocks
// of the one cluster, a power of two up to SC_TAIL_MAX_CLUSTER, and at
// most n / 2 unless 1. Returns the launch's error (cudaGetLastError()).
extern "C" int sc_tail_launch(void* T, int ntab, long long n, int ninst, int npar,
                              const void* coeffs, void* claim, void* sponge, void* polys,
                              void* rs, void* finals, int rounds, int cluster, void* stream) {
  if (ninst <= 0 || npar < 0 || npar > ninst || ntab != 3 * ninst + 1 - npar || n <= 0 ||
      rounds < 0 || rounds > 20 || (1LL << rounds) != n || cluster < 1 ||
      cluster > SC_TAIL_MAX_CLUSTER || (cluster & (cluster - 1)) ||
      (cluster > 1 && 2LL * cluster > n) || (long long)ntab * n > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  static bool nonportable = false;
  static bool schedulable[SC_TAIL_MAX_CLUSTER + 1] = {};
  cudaError_t e;
  if (cluster > 8 && !nonportable) {
    e = cudaFuncSetAttribute(sc_tail_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    nonportable = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(SC_TAIL_THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (!schedulable[cluster]) {
    int active = 0;
    e = cudaOccupancyMaxActiveClusters(&active, sc_tail_kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (active < 1) return (int)cudaErrorInvalidConfiguration;
    schedulable[cluster] = true;
  }
  e = cudaLaunchKernelEx(&cfg, sc_tail_kernel, static_cast<uint32_t*>(T), ntab, (int)n, ninst,
                         npar, static_cast<const uint32_t*>(coeffs),
                         static_cast<uint32_t*>(claim), static_cast<int32_t*>(sponge),
                         static_cast<uint32_t*>(polys), static_cast<uint32_t*>(rs),
                         static_cast<uint32_t*>(finals), rounds);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
