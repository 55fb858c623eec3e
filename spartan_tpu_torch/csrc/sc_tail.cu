// T2: every remaining round of a batched product sumcheck whose tables have
// at most SMALL_BUCKET_N entries, in one launch: evaluations, Fiat-Shamir
// step and fold, round after round, with the challenges on the card.
//
// No Pallas counterpart: it stands for spartan_tpu/core/sumcheck_fused.py
// _k_fused_cubic_batched (:199-226), the JAX package's lax.while_loop over
// the small-table tail. Each round does what S2 does (the products A*B*C at
// t = 0, 2, 3 and their exact sums), then T1's step (transcript.cuh
// round_transcript), then what S1 does (fold every table by r).
// Bound on the H100: latency and one SM. At the tail's largest round the
//   work is a few hundred thousand Montgomery products, well under 0.1 ms
//   of the card's multiply rate, but each round depends on the previous
//   round's challenge, and the Fiat-Shamir step is one thread's serial
//   sponge.
// Design: one block. The wrapper stacks the tables into one [M, n, 8]
//   buffer (A of every instance, B of every instance, the shared C, the own
//   Cs; ~5.6 MB at 2^12 entries for the ops trees' leaf layout, so it lives
//   in L2) and the kernel folds that copy in place: thread i of a fold reads
//   T[i] and T[i + h] and writes T[i], so no two threads touch one entry.
//   The threads' evaluation terms are weighted by the layer coefficients as
//   they are summed (sum_i coeff_i e_t,i is all the transcript needs), so a
//   round ends in one block reduction of three elements; thread 0 runs the
//   transcript step with the sponge in shared memory and publishes r, and a
//   block barrier separates the phases. Plain loads throughout: the tables
//   are rewritten inside the launch.
#include <cuda_runtime.h>

#include "transcript.cuh"

using namespace sctr;

#define SC_TAIL_THREADS 512

// the three sums over the block, exact mod p; thread 0 holds the totals
__device__ __forceinline__ void block_sum3(Fe& a, Fe& b, Fe& c) {
  __shared__ Fe part[3][SC_TAIL_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  a = bn254::warp_sum_fr(a);
  b = bn254::warp_sum_fr(b);
  c = bn254::warp_sum_fr(c);
  if (lane == 0) {
    part[0][warp] = a;
    part[1][warp] = b;
    part[2][warp] = c;
  }
  __syncthreads();
  if (warp == 0) {
    a = bn254::warp_sum_fr(lane < nwarps ? part[0][lane] : fe_zero());
    b = bn254::warp_sum_fr(lane < nwarps ? part[1][lane] : fe_zero());
    c = bn254::warp_sum_fr(lane < nwarps ? part[2][lane] : fe_zero());
  }
}

__global__ void __launch_bounds__(SC_TAIL_THREADS)
sc_tail_kernel(uint32_t* __restrict__ T, int ntab, long long n, int ninst, int npar,
               const uint32_t* __restrict__ coeffs, uint32_t* __restrict__ claim,
               int32_t* __restrict__ sponge, uint32_t* __restrict__ polys,
               uint32_t* __restrict__ rs, uint32_t* __restrict__ finals, int rounds) {
  __shared__ Sponge sp;
  __shared__ Fe r_sh;
  const int tid = threadIdx.x, nt = blockDim.x;
  Fe e = fe_zero();
  if (tid == 0) {
    memcpy(&sp, sponge, sizeof(Sponge));
    e = ld(claim, 0);
  }
  const long long tsz = 8 * n;  // words per table
  const uint32_t* A = T;
  const uint32_t* B = T + tsz * ninst;
  const uint32_t* Cp = T + tsz * 2 * ninst;
  long long m = n;
  for (int j = 0; j < rounds; j++, m >>= 1) {
    const long long h = m >> 1;
    Fe s0 = fe_zero(), s2 = fe_zero(), s3 = fe_zero();
    if (tid < h) {
      for (int k = 0; k < ninst; k++) {
        const uint32_t* a = A + tsz * k;
        const uint32_t* b = B + tsz * k;
        const uint32_t* c = k < npar ? Cp : Cp + tsz * (1 + k - npar);
        Fe t0 = fe_zero(), t2 = fe_zero(), t3 = fe_zero();
        for (long long i = tid; i < h; i += nt) {
          const Fe al = ld(a, i), ah = ld(a, i + h);
          const Fe bl = ld(b, i), bh = ld(b, i + h);
          const Fe cl = ld(c, i), ch = ld(c, i + h);
          const Fe da = sub(ah, al), db = sub(bh, bl), dc = sub(ch, cl);
          t0 = add(t0, mul(mul(al, bl), cl));
          Fe x = add(ah, da), y = add(bh, db), z = add(ch, dc);  // t = 2
          t2 = add(t2, mul(mul(x, y), z));
          x = add(x, da);  // t = 3
          y = add(y, db);
          z = add(z, dc);
          t3 = add(t3, mul(mul(x, y), z));
        }
        const Fe w = ld(coeffs, k);
        s0 = add(s0, mul(t0, w));
        s2 = add(s2, mul(t2, w));
        s3 = add(s3, mul(t3, w));
      }
    }
    block_sum3(s0, s2, s3);
    if (tid == 0) {
      Fe cs[4];
      const Fe r = round_transcript(sp, s0, s2, s3, e, cs);
      for (int k = 0; k < 4; k++) st(polys, 4 * j + k, cs[k]);
      st(rs, j, r);
      r_sh = r;
    }
    __syncthreads();
    const Fe r = r_sh;
    const long long total = (long long)ntab * h;
    for (long long x = tid; x < total; x += nt) {
      const long long t = x / h, i = x - t * h;
      uint32_t* p = T + tsz * t;
      const Fe lo = ld(p, i), hi = ld(p, i + h);
      st(p, i, add(lo, mul(r, sub(hi, lo))));
    }
    __syncthreads();
  }
  for (int t = tid; t < ntab; t += nt) st(finals, t, ld(T + tsz * t, 0));
  if (tid == 0) {
    st(claim, 0, e);
    memcpy(sponge, &sp, sizeof(Sponge));
  }
}

// T: [ntab, n, 8] stacked tables (ntab = 2 ninst + 1 + nseq: A of every
// instance, B of every instance, the shared C, then the own C of the last
// ninst - npar instances), folded in place; coeffs [ninst, 8]; claim [8] and
// sponge int32 [52] updated in place; polys [rounds, 4, 8], rs [rounds, 8]
// and finals [ntab, 8] written. n = 2^rounds. Returns cudaGetLastError().
extern "C" int sc_tail_launch(void* T, int ntab, long long n, int ninst, int npar,
                              const void* coeffs, void* claim, void* sponge, void* polys,
                              void* rs, void* finals, int rounds, int threads, void* stream) {
  if (ninst <= 0 || npar < 0 || npar > ninst || ntab != 3 * ninst + 1 - npar || n <= 0 ||
      rounds < 0 || (1LL << rounds) != n || threads <= 0 || threads > SC_TAIL_THREADS ||
      threads % 32)
    return (int)cudaErrorInvalidValue;
  sc_tail_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(T), ntab, n, ninst, npar, static_cast<const uint32_t*>(coeffs),
      static_cast<uint32_t*>(claim), static_cast<int32_t*>(sponge),
      static_cast<uint32_t*>(polys), static_cast<uint32_t*>(rs),
      static_cast<uint32_t*>(finals), rounds);
  return (int)cudaGetLastError();
}
