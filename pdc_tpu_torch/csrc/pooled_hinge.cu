// Pooled non-match hinge, forward (K1) and backward (K2), for Hopper (sm_90a).
//
// Replaces the TPU kernels pdc_tpu/ops/pallas_loss.py `_fwd_kernel` (:42-74,
// launched by `_pooled_hinge_fwd_call` :129-166) and `_bwd_kernel` (:77-117,
// launched by `_pooled_hinge_bwd_call` :171-208). For every pair b of a batch,
// match rows da [Nm, D] against pool rows db [P, D]:
//
//   forward:  loss_b = sum_ij w_ij * max(M - dist_ij, 0)^2 [* pixw_ij]
//             hard_b = #{ij : w_ij != 0 and M - dist_ij > 0}      (integer)
//   backward: gda_i = g_b *  sum_j c_ij (da_i - db_j)
//             gdb_j = g_b * -sum_i c_ij (da_i - db_j)
//             c_ij  = -2 w_ij pixw_ij hinge_ij / dist_ij  where hinge > 0 and
//                     d2 > 1e-24, else 0
//
// with d2 = sum_d (da_id - db_jd)^2, dist = sqrt(max(d2, 1e-24)),
// w_ij = mvalid_i * pvalid_j * [|mu_i - pu_j| >= 1 and |mv_i - pv_j| >= 1]
// (the collision rule) and, with use_pix, pixw = min(|uv_i - uv_j|, M_pixel) /
// M_pixel. Nothing of size [Nm, P] reaches device memory.
//
// Arithmetic: the difference form, with every product and sum rounded on its
// own (__fmul_rn / __fadd_rn / __fdiv_rn keep nvcc from contracting them into
// FMAs). Each term is then bit-identical to the plain PyTorch version in
// pdc_tpu_torch/ops/pooled_hinge.py, which computes the same table one
// elementwise op at a time, so the hard count matches exactly and only the
// order of the final sums differs. The TPU kernel expanded
// ||a||^2 - 2<a,b> + ||b||^2 for its matrix unit; that form loses about
// eps * ||a||^2 in d2, exactly where the hinge is live (d2 < M^2 = 0.25).
//
// NaN and infinity, as the plain version gives them. Its loss_b is NaN
// wherever da[b] or db[b] holds a NaN, valid or not (0 * NaN is NaN), or
// one channel holds the same infinity in a row and in a pool entry
// (inf - inf). Its gda[i,d] is NaN where da[i,d] or any db[b,:,d] is not
// finite, and gdb[j,d] where db[j,d] or any da[b,:,d] is not (0 * NaN and
// 0 * inf in c * t). Such a pair never counts: NaN fails every comparison.
// Every block of K1 and K2 holds its own rows and stages the whole pool of
// its pair, so each takes these flags from the raw values as it loads them
// (before an invalid entry's channel 0 becomes +inf, below) and writes NaN
// where the plain version has it: no extra pass, no atomics. The flags wait
// in shared memory while the block walks its pairs: held in registers they
// cost K2's walk registers and time.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 without tensor cores):
// per launch at the training shapes (B=4, Nm=10000, P=1024, D=3) the inputs
// are ~0.7 MB (~0.2 us) against B*Nm*P = 41M pairs. Each pair of a valid row
// and entry needs only its distance decided (3D - 1 operations and the test
// d2 < T below); the ~5% of pairs that pass need the collision test, a
// square root, the hinge and the loss (K1) or c and c * t into ga and gb
// (K2). On a real step's masked pool that is ~0.39 GFLOP for K1 and
// ~0.45 GFLOP for K2: ~0.0058 and ~0.0067 ms, bound by operations
// (chip_smoke.py's hinge_bound counts it from the run's data). The counted
// pairs' square roots on the special-function units (16 per SM per clock)
// take ~0.0005 ms.
//
// Both kernels walk the pairs the same way (the first K1 gave each match row
// 4 threads, took all 41M square roots, padded D=3 to 4 and branched per
// pair; the first K2 walked every pair twice):
//   1. One walk over each pair. A warp holds kWalkRows match rows in
//      registers (every lane the same rows) and its lanes walk the staged
//      pool chunk's entries, one entry per lane at a time, so each pool
//      entry's loads serve all of a warp's rows and each (row, entry) pair is
//      evaluated once.
//   2. The square root only where a pair can count. d2 is tested first
//      against T, the least float with sqrtf(T) >= M (host bisection,
//      hinge_threshold). That is exact: d2 >= T means dist >= M and
//      hinge = 0. Invalid rows and pool entries carry +inf in channel 0 and
//      fail the test, as do NaN distances. K1's test is d2 < T: it counts a
//      pair with d2 <= 1e-24 (dist = 1e-12, hinge = M - 1e-12). K2's is
//      1e-24 < d2 < T: such a pair has no gradient. The counted path takes
//      dist = sqrtf(max(d2, 1e-24)) once.
//   3. The test only sets a bit in the lane's 32-bit mask (32 / kWalkRows
//      entries x kWalkRows rows); the counted path then runs over each
//      lane's own bits, so a warp pays for it as often as its busiest lane
//      has bits. Taking the branch per pair made the warp run the counted
//      path whenever any of its 32 lanes counted: with ~4.5% of pairs
//      counting, ~77% of the time.
//   4. Templates on the exact D for D <= 4 (no padded channel on the main
//      path's D=3), then 8 and 16; rows per warp and chunk shrink with D so
//      that the registers and the shared slots fit (7 rows up to D=4, 4 up
//      to 8, 2 up to 16). __launch_bounds__ asks for 3 blocks of 256 threads
//      per SM up to D=8 (2 above), which caps ptxas at 80 registers: without
//      that cap it gave hinge_bwd<3> 86, 2 blocks per SM, and K2 took 20%
//      longer.
//   5. A grid sized to the card. Every block walks the whole pool for its
//      kWarps * kWalkRows rows, so a launch takes ceil(blocks / slots)
//      rounds, slots being the resident blocks (3 per SM on 132 SMs: 396).
//      Up to D=4 a warp takes 7 rows, not 8: at the main path's B=4,
//      Nm=10000 that is 4 * ceil(10000 / 56) = 716 blocks, 2 rounds with 90%
//      of the slots busy, where 8 rows would give 628 blocks, 2 rounds with
//      79% busy and a longer walk per block (8 rows against 7).
// K1: the counted path adds the term to the lane's loss and one to its
//   count. A fixed xor-shuffle tree sums each warp's lanes, and the block
//   sums its warps in order into one partial per block (NaN where the
//   block's flags say so). hinge_fwd_final gives each pair one block, whose
//   threads take the partials in order and a fixed tree sums them: on an
//   H100 0.0014 ms, where one thread per pair walking its partials in a
//   chain took 0.0068 ms.
// K2: c * t goes into a ga slot per (row, lane) and a gb slot per entry of
//   the lane, both in shared memory and private to the lane; at the end the
//   32 lanes' ga of a row are summed by a fixed xor-shuffle tree, and at the
//   end of each chunk the block sums the kWarps gb slots of each entry in
//   warp order into one partial per (block, entry). hinge_bwd_final gives
//   each lane one pool entry and each of the 8 warps every 8th block's
//   partial, then adds the warps' sums in warp order, over a grid of
//   ceil(P/32) x B blocks (128 at the main path's shapes).
// No atomics anywhere: two runs give bit-equal results.

#include <cuda_runtime.h>

#include <cmath>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 16;
constexpr unsigned kExpBits = 0x7f800000u;

struct Hinge {
  float M, M_pixel;
  int use_pix;
};

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fc00000); }
__device__ __forceinline__ bool nonfinite(float x) {
  return (__float_as_uint(x) & kExpBits) == kExpBits;
}

// Non-finite raw values seen, by channel: inf bit d for +inf in channel d,
// bit 16 + d for -inf (D <= 16); nan bit d for a NaN in channel d.
struct NonFinite {
  unsigned inf = 0u, nan = 0u;
  __device__ __forceinline__ void note(float x, int d) {
    const unsigned u = __float_as_uint(x);
    if ((u & kExpBits) != kExpBits) return;
    if (u & 0x7fffffu)
      nan |= 1u << d;
    else
      inf |= 1u << ((u >> 31) * 16 + d);
  }
  // bit d: any non-finite value in channel d
  __device__ __forceinline__ unsigned channels() const {
    return nan | (inf & 0xffffu) | (inf >> 16);
  }
};

// The walk's shapes: kWalkRows(MAXD) match rows per warp (header, point 5),
// pool chunks of kFwdChunk / kBwdChunk entries, and groups of
// 32 / kWalkRows entries per lane, whose (entry, row) pairs fit one 32-bit
// mask.
__host__ __device__ constexpr int kWalkRows(int maxd) { return maxd <= 4 ? 7 : (maxd <= 8 ? 4 : 2); }
__host__ __device__ constexpr int kFwdChunk(int maxd) { return maxd <= 4 ? 1024 : 512; }
__host__ __device__ constexpr int kBwdChunk(int maxd) { return maxd <= 4 ? 256 : 128; }
// Resident blocks per SM that the registers must allow (at most 80 per
// thread for 3 blocks of 256); the shared memory allows as many (D <= 16: 2).
__host__ __device__ constexpr int kWalkBlocksPerSm(int maxd) { return maxd <= 8 ? 3 : 2; }

// Dynamic shared memory of one K2 block, in floats: the pool chunk (MAXD
// channels, pu, pv, pvalid), one gb partial per (warp, channel, entry), one
// ga partial per (warp, row, channel, lane), and the block's rows (MAXD
// channels, u, v, validity).
template <int MAXD>
constexpr int bwd_smem_floats() {
  return kBwdChunk(MAXD) * (MAXD + 3 + kWarps * MAXD) + kWarps * kWalkRows(MAXD) * MAXD * 32 +
         kWarps * kWalkRows(MAXD) * (MAXD + 3);
}

// Stage one pool chunk of C entries into s [MAXD + 3][C]: the channels, then
// pu, pv, pvalid. A pool entry with pvalid == 0 gets +inf in channel 0, so
// that every pair with it has d2 = inf (or NaN) and fails the distance test:
// its weight is 0 in the plain version as well. nf notes the raw channels.
template <int MAXD, int C>
__device__ __forceinline__ void stage_pool(float* s, const float* __restrict__ db,
                                           const float* __restrict__ pu,
                                           const float* __restrict__ pv,
                                           const float* __restrict__ pvalid, int b, int P, int D,
                                           int p0, int n, NonFinite& nf) {
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const size_t o = (size_t)b * P + p0 + k;
    const float valid = pvalid[o];
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
      const bool real = MAXD <= 4 || d < D;
      const float x = real ? db[o * D + d] : 0.f;
      if (real) nf.note(x, d);
      s[d * C + k] = (d == 0 && valid == 0.f) ? pos_inf() : x;
    }
    s[MAXD * C + k] = pu[o];
    s[(MAXD + 1) * C + k] = pv[o];
    s[(MAXD + 2) * C + k] = valid;
  }
}

// The warp's R rows starting at row0 of pair b, into registers a (every
// lane) and, from lane 0, into the warp's shared row slots myrow [R][MAXD + 3]
// (channels, u, v, validity). A row that is invalid (mvalid == 0) or past Nm
// gets +inf in channel 0, so it fails the distance test like an invalid
// entry. nf notes the raw channels of every row before Nm, valid or not; bit
// r * MAXD + d of rnf marks a non-finite da of row r in channel d.
template <int MAXD, int R>
__device__ __forceinline__ void load_rows(const float* __restrict__ da,
                                          const float* __restrict__ mu,
                                          const float* __restrict__ mv,
                                          const float* __restrict__ mvalid, int b, int row0,
                                          int Nm, int D, float (&a)[R][MAXD], float* myrow,
                                          NonFinite& nf, unsigned& rnf) {
  constexpr int RS = MAXD + 3;
  const int lane = threadIdx.x & 31;
  rnf = 0u;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    const bool in = row < Nm;
    const size_t o = (size_t)b * Nm + row;
    const float mval = in ? mvalid[o] : 0.f;
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
      const bool real = in && (MAXD <= 4 || d < D);
      const float x = real ? da[o * D + d] : 0.f;
      if (real) {
        nf.note(x, d);
        if (nonfinite(x)) rnf |= 1u << (r * MAXD + d);
      }
      a[r][d] = mval != 0.f ? x : (d == 0 ? pos_inf() : 0.f);
    }
    if (lane == 0) {
#pragma unroll
      for (int d = 0; d < MAXD; ++d) myrow[r * RS + d] = a[r][d];
      myrow[r * RS + MAXD] = in ? mu[o] : 0.f;
      myrow[r * RS + MAXD + 1] = in ? mv[o] : 0.f;
      myrow[r * RS + MAXD + 2] = mval;
    }
  }
}

// K1's counted path of one pair that passed the distance test, from shared
// memory: row slot ar, entry k of the staged chunk spool [MAXD + 3][C].
// Returns false where the pair does not count (weight 0, collision, or
// hinge <= 0); else sets the hinge, the weight w and the pixel weight pixw
// (1 without use_pix), each rounded as the plain version rounds it.
template <int MAXD, int C>
__device__ __forceinline__ bool counted_pair(const float* ar, const float* spool, int k,
                                             const Hinge& h, float& hinge, float& w,
                                             float& pixw) {
  float t = ar[0] - spool[k];
  float d2 = __fmul_rn(t, t);
#pragma unroll
  for (int d = 1; d < MAXD; ++d) {
    t = ar[d] - spool[d * C + k];
    d2 = __fadd_rn(d2, __fmul_rn(t, t));
  }
  const float du = fabsf(ar[MAXD] - spool[MAXD * C + k]);
  const float dv = fabsf(ar[MAXD + 1] - spool[(MAXD + 1) * C + k]);
  w = __fmul_rn(ar[MAXD + 2], spool[(MAXD + 2) * C + k]);
  if (w == 0.f || !(du >= 1.f && dv >= 1.f)) return false;
  hinge = h.M - sqrtf(fmaxf(d2, 1e-24f));
  if (!(hinge > 0.f)) return false;
  pixw = 1.f;
  if (h.use_pix) {
    const float pix = sqrtf(__fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv)));
    pixw = __fdiv_rn(fminf(pix, h.M_pixel), h.M_pixel);
  }
  return true;
}

// K1's test pass over one group of G = 32 / R entries of a lane (entries
// k0 + 32 m + lane): bit m * R + r is set where row r and the entry have
// d2 < T.
template <int MAXD, int R, int C>
__device__ __forceinline__ unsigned test_pass(const float (&a)[R][MAXD], const float* spool,
                                              int k0, int n, float T) {
  constexpr int G = 32 / R;
  const int lane = threadIdx.x & 31;
  unsigned bits = 0u;
#pragma unroll
  for (int m = 0; m < G; ++m) {
    const int k = k0 + 32 * m + lane;
    if (k >= n) break;
    float bk[MAXD];
#pragma unroll
    for (int d = 0; d < MAXD; ++d) bk[d] = spool[d * C + k];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float t = a[r][0] - bk[0];
      float d2 = __fmul_rn(t, t);
#pragma unroll
      for (int d = 1; d < MAXD; ++d) {
        t = a[r][d] - bk[d];
        d2 = __fadd_rn(d2, __fmul_rn(t, t));
      }
      if (d2 < T) bits |= 1u << (m * R + r);
    }
  }
  return bits;
}

// ---- K1 -------------------------------------------------------------------

// Grid (nblk, B), kThreads threads. Warp w of block x owns the R match rows
// starting at (x * kWarps + w) * R of pair b and walks every pool chunk
// (header, points 1-3). Writes one partial loss and count per block:
// part_loss / part_hard [B, nblk].
template <int MAXD>
__global__ void __launch_bounds__(kThreads, kWalkBlocksPerSm(MAXD))
hinge_fwd(const float* __restrict__ da, const float* __restrict__ db,
          const float* __restrict__ mu, const float* __restrict__ mv,
          const float* __restrict__ mvalid, const float* __restrict__ pu,
          const float* __restrict__ pv, const float* __restrict__ pvalid,
          float* __restrict__ part_loss, int* __restrict__ part_hard, int Nm, int P, int D,
          float T, Hinge h) {
  constexpr int R = kWalkRows(MAXD);
  constexpr int C = kFwdChunk(MAXD);
  constexpr int G = 32 / R;
  constexpr int RS = MAXD + 3;
  __shared__ float spool[(MAXD + 3) * C];
  __shared__ float srow[kWarps * R * RS];
  __shared__ float wloss[kWarps];
  __shared__ int whard[kWarps];
  // non-finite flags, per warp, of its rows [0] and of the pool entries its
  // lanes staged [1]; kept here, not in registers, during the walk
  __shared__ unsigned winf[2][kWarps], wnan[2][kWarps];

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* const myrow = srow + warp * R * RS;
  NonFinite rows_nf;
  unsigned rnf;
  float a[R][MAXD];
  load_rows<MAXD, R>(da, mu, mv, mvalid, b, (blockIdx.x * kWarps + warp) * R, Nm, D, a, myrow,
                     rows_nf, rnf);
  if (lane == 0) {  // the same in every lane of the warp
    winf[0][warp] = rows_nf.inf;
    wnan[0][warp] = rows_nf.nan;
    winf[1][warp] = wnan[1][warp] = 0u;
  }

  float loss = 0.f;
  int hard = 0;
  for (int p0 = 0; p0 < P; p0 += C) {
    const int n = min(C, P - p0);
    __syncthreads();  // the previous chunk is consumed
    NonFinite pool_nf;
    stage_pool<MAXD, C>(spool, db, pu, pv, pvalid, b, P, D, p0, n, pool_nf);
    const unsigned pinf = __reduce_or_sync(0xffffffffu, pool_nf.inf);
    const unsigned pnan = __reduce_or_sync(0xffffffffu, pool_nf.nan);
    if (lane == 0) {
      winf[1][warp] |= pinf;
      wnan[1][warp] |= pnan;
    }
    __syncthreads();
    for (int k0 = 0; k0 < n; k0 += 32 * G) {
      unsigned bits = test_pass<MAXD, R, C>(a, spool, k0, n, T);
      while (bits) {
        const int i = __ffs((int)bits) - 1;
        bits &= bits - 1u;
        const int m = i / R, r = i - m * R;
        float hinge, w, pixw;
        if (!counted_pair<MAXD, C>(myrow + r * RS, spool, k0 + 32 * m + lane, h, hinge, w, pixw))
          continue;
        float term = __fmul_rn(__fmul_rn(w, hinge), hinge);
        if (h.use_pix) term = __fmul_rn(term, pixw);
        loss = __fadd_rn(loss, term);
        ++hard;
      }
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    loss = __fadd_rn(loss, __shfl_xor_sync(0xffffffffu, loss, off));
    hard += __shfl_xor_sync(0xffffffffu, hard, off);
  }
  if (lane == 0) {
    wloss[warp] = loss;
    whard[warp] = hard;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float l = 0.f;
    int c = 0;
    unsigned rinf = 0u, pinf = 0u, nan = 0u;
    for (int w = 0; w < kWarps; ++w) {
      l = __fadd_rn(l, wloss[w]);
      c += whard[w];
      rinf |= winf[0][w];
      pinf |= winf[1][w];
      nan |= wnan[0][w] | wnan[1][w];
    }
    // a NaN in the block's rows or the pool, or inf - inf in one channel
    if (nan || (rinf & pinf)) l = quiet_nan();
    part_loss[(size_t)b * gridDim.x + blockIdx.x] = l;
    part_hard[(size_t)b * gridDim.x + blockIdx.x] = c;
  }
}

// Grid B, kThreads threads: thread t of block b takes the partials t,
// t + kThreads, ... of pair b in order, a fixed xor-shuffle tree sums each
// warp, and thread 0 the warps in order. No atomics.
__global__ void __launch_bounds__(kThreads)
hinge_fwd_final(const float* __restrict__ part_loss, const int* __restrict__ part_hard,
                float* __restrict__ loss, long long* __restrict__ hard, int nblk) {
  __shared__ float wl[kWarps];
  __shared__ long long wh[kWarps];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float l = 0.f;
  long long c = 0;
  for (int k = threadIdx.x; k < nblk; k += kThreads) {
    l = __fadd_rn(l, part_loss[(size_t)b * nblk + k]);
    c += part_hard[(size_t)b * nblk + k];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, off));
    c += __shfl_xor_sync(0xffffffffu, c, off);
  }
  if (lane == 0) {
    wl[warp] = l;
    wh[warp] = c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    long long n = 0;
    for (int w = 0; w < kWarps; ++w) {
      s = __fadd_rn(s, wl[w]);
      n += wh[w];
    }
    loss[b] = s;
    hard[b] = n;
  }
}

// ---- K2 -------------------------------------------------------------------

// Grid (nblk, B), kThreads threads. Warp w of block x owns the R match
// rows starting at (x * kWarps + w) * R of pair b; every lane holds those
// rows in registers and walks its own pool entries (k = lane, lane + 32, ...)
// of each chunk, so each (row, entry) pair is evaluated once, in two passes
// over each group of G = 32 / R entries of a lane:
//   test pass, every pair: t = a - b, d2, and the test 1e-24 < d2 < T. T is
//     the least float with sqrtf(T) >= M, so d2 >= T means dist >= M and
//     hinge = 0: nothing to add, and no square root taken. A pair that
//     passes sets its bit in the lane's 32-bit mask.
//   counted pass, each lane over its own set bits: collision and weight,
//     dist = sqrtf(d2) (once: d2 > 1e-24, so it is the plain version's
//     sqrt(max(d2, 1e-24))), hinge, pixel weight, c, and c * t added into
//     the lane's ga slot of the row and gb slot of the entry (shared memory,
//     both private to the lane). A warp runs this pass as often as its
//     busiest lane has bits, not once per pair that any lane counts.
// At the end of a chunk the block sums the kWarps gb partials of each entry
// in warp order and writes one partial per (block, entry) to part_gdb
// [B, nblk, D, P]: NaN in channel d where the block's rows hold a non-finite
// value in channel d. At the end, each row's ga is summed over the 32 lanes
// by a fixed xor-shuffle tree: NaN where the row's value or any pool entry's
// in that channel is not finite.
template <int MAXD>
__global__ void __launch_bounds__(kThreads, kWalkBlocksPerSm(MAXD))
hinge_bwd(const float* __restrict__ da, const float* __restrict__ db,
          const float* __restrict__ mu, const float* __restrict__ mv,
          const float* __restrict__ mvalid, const float* __restrict__ pu,
          const float* __restrict__ pv, const float* __restrict__ pvalid,
          const float* __restrict__ g_loss, float* __restrict__ gda,
          float* __restrict__ part_gdb, int Nm, int P, int D, float T, Hinge h) {
  constexpr int R = kWalkRows(MAXD);
  constexpr int C = kBwdChunk(MAXD);
  constexpr int G = 32 / R;        // entries per lane in one mask
  constexpr int RS = MAXD + 3;     // floats per staged row
  extern __shared__ float smem[];
  float* const spool = smem;                       // [MAXD + 3][C]
  float* const sgb = spool + (MAXD + 3) * C;       // [kWarps][MAXD][C]
  float* const sga = sgb + kWarps * MAXD * C;      // [kWarps][R][MAXD][32]
  float* const srow = sga + kWarps * R * MAXD * 32;  // [kWarps][R][MAXD + 3]
  // per warp: the channels with a non-finite value in its rows [0] and in
  // the pool entries its lanes staged [1], and its rows' (row, channel)
  // bits [2]; kept here, not in registers, during the walk
  __shared__ unsigned wnf[3][kWarps];

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * kWarps + warp) * R;
  float* const myrow = srow + warp * R * RS;
  float* const myga = sga + warp * R * MAXD * 32 + lane;
  float* const mygb = sgb + warp * MAXD * C;

  NonFinite rows_nf;
  unsigned rnf;
  float a[R][MAXD];
  load_rows<MAXD, R>(da, mu, mv, mvalid, b, row0, Nm, D, a, myrow, rows_nf, rnf);
#pragma unroll
  for (int i = 0; i < R * MAXD; ++i) myga[i * 32] = 0.f;
  if (lane == 0) {  // the same in every lane of the warp
    wnf[0][warp] = rows_nf.channels();
    wnf[1][warp] = 0u;
    wnf[2][warp] = rnf;
  }

  for (int p0 = 0; p0 < P; p0 += C) {
    const int n = min(C, P - p0);
    __syncthreads();  // the previous chunk and its gb partials are consumed
    NonFinite pool_nf;
    stage_pool<MAXD, C>(spool, db, pu, pv, pvalid, b, P, D, p0, n, pool_nf);
    const unsigned pch = __reduce_or_sync(0xffffffffu, pool_nf.channels());
    if (lane == 0) wnf[1][warp] |= pch;
    __syncthreads();
    for (int k0 = 0; k0 < n; k0 += 32 * G) {
      // test pass: bit m * R + r for entry k0 + 32 m + lane against row r
      unsigned bits = 0u;
#pragma unroll
      for (int m = 0; m < G; ++m) {
        const int k = k0 + 32 * m + lane;
        if (k >= n) break;
        float bk[MAXD];
#pragma unroll
        for (int d = 0; d < MAXD; ++d) {
          bk[d] = spool[d * C + k];
          mygb[d * C + k] = 0.f;
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          float t = a[r][0] - bk[0];
          float d2 = __fmul_rn(t, t);
#pragma unroll
          for (int d = 1; d < MAXD; ++d) {
            t = a[r][d] - bk[d];
            d2 = __fadd_rn(d2, __fmul_rn(t, t));
          }
          if (d2 > 1e-24f && d2 < T) bits |= 1u << (m * R + r);
        }
      }
      // counted pass: the arithmetic of K1's counted_pair (d2 > 1e-24 here, so
      // sqrtf(d2) is the plain version's dist), then c and c * t
      while (bits) {
        const int i = __ffs((int)bits) - 1;
        bits &= bits - 1u;
        const int m = i / R, r = i - m * R;
        const int k = k0 + 32 * m + lane;
        const float* ar = myrow + r * RS;
        float t[MAXD];
        t[0] = ar[0] - spool[k];
        float d2 = __fmul_rn(t[0], t[0]);
#pragma unroll
        for (int d = 1; d < MAXD; ++d) {
          t[d] = ar[d] - spool[d * C + k];
          d2 = __fadd_rn(d2, __fmul_rn(t[d], t[d]));
        }
        const float du = fabsf(ar[MAXD] - spool[MAXD * C + k]);
        const float dv = fabsf(ar[MAXD + 1] - spool[(MAXD + 1) * C + k]);
        const float w = __fmul_rn(ar[MAXD + 2], spool[(MAXD + 2) * C + k]);
        if (w == 0.f || !(du >= 1.f && dv >= 1.f)) continue;
        const float dist = sqrtf(d2);
        const float hinge = fmaxf(h.M - dist, 0.f);
        if (!(hinge > 0.f)) continue;
        float pixw = 1.f;
        if (h.use_pix) {
          const float pix = sqrtf(__fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv)));
          pixw = __fdiv_rn(fminf(pix, h.M_pixel), h.M_pixel);
        }
        const float c = __fdiv_rn(__fmul_rn(__fmul_rn(-2.f, __fmul_rn(w, pixw)), hinge), dist);
#pragma unroll
        for (int d = 0; d < MAXD; ++d) {
          const float ct = __fmul_rn(c, t[d]);
          myga[(r * MAXD + d) * 32] = __fadd_rn(myga[(r * MAXD + d) * 32], ct);
          mygb[d * C + k] = __fadd_rn(mygb[d * C + k], ct);
        }
      }
    }
    __syncthreads();
    unsigned rows_ch = 0u;  // channels with a non-finite value in the block's rows
#pragma unroll
    for (int w = 0; w < kWarps; ++w) rows_ch |= wnf[0][w];
    // one partial per (block, entry): the warps' partials in warp order
    float* const out = part_gdb + ((size_t)b * gridDim.x + blockIdx.x) * D * P + p0;
    for (int i = threadIdx.x; i < D * n; i += kThreads) {
      const int d = i / n, k = i - d * n;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, sgb[(w * MAXD + d) * C + k]);
      out[(size_t)d * P + k] = (rows_ch >> d) & 1u ? quiet_nan() : s;
    }
  }

  unsigned pool_ch = 0u;  // every warp's slot was written before the last chunk's walk
#pragma unroll
  for (int w = 0; w < kWarps; ++w) pool_ch |= wnf[1][w];
  rnf = wnf[2][warp];
  const float g = g_loss[b];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
      float s = myga[(r * MAXD + d) * 32];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
      if (lane == 0 && row < Nm && (MAXD <= 4 || d < D)) {
        const bool nan = ((pool_ch >> d) | (rnf >> (r * MAXD + d))) & 1u;
        gda[((size_t)b * Nm + row) * D + d] = nan ? quiet_nan() : __fmul_rn(g, s);
      }
    }
  }
}

// Grid (ceil(P / 32), B), kThreads threads: lane l owns pool entry
// 32 * x + l; warp w sums the partials of blocks w, w + kWarps, ... in
// order, and the warps' sums are added in warp order. No atomics. NaN where
// the entry's own db value is not finite.
__global__ void __launch_bounds__(kThreads)
hinge_bwd_final(const float* __restrict__ part_gdb, const float* __restrict__ db,
                const float* __restrict__ g_loss, float* __restrict__ gdb, int P, int D,
                int nblk) {
  __shared__ float red[kWarps][kMaxD][32];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = blockIdx.x * 32 + lane;
  for (int d = 0; d < D; ++d) {
    float s = 0.f;
    if (j < P)
      for (int k = warp; k < nblk; k += kWarps)
        s = __fadd_rn(s, part_gdb[(((size_t)b * nblk + k) * D + d) * P + j]);
    red[warp][d][lane] = s;
  }
  __syncthreads();
  const float g = g_loss[b];
  for (int i = threadIdx.x; i < D * 32; i += kThreads) {
    const int d = i >> 5, l = i & 31, jj = blockIdx.x * 32 + l;
    if (jj >= P) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, red[w][d][l]);
    const size_t o = ((size_t)b * P + jj) * D + d;
    gdb[o] = nonfinite(db[o]) ? quiet_nan() : __fmul_rn(g, -s);
  }
}

int prologue(int device, int B, int Nm, int P, int D) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || B > 65535 || Nm < 1 || P < 1 || D < 1 || D > kMaxD)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// Calls f(std::integral_constant<int, MAXD>) for the template of D: the
// exact D up to 4, else 8 or 16 (padded channels add 0 - 0).
template <typename F>
void by_d(int D, F f) {
  switch (D) {
    case 1: f(std::integral_constant<int, 1>{}); break;
    case 2: f(std::integral_constant<int, 2>{}); break;
    case 3: f(std::integral_constant<int, 3>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    default:
      if (D <= 8)
        f(std::integral_constant<int, 8>{});
      else
        f(std::integral_constant<int, 16>{});
  }
}

// The least float T >= 0 with sqrtf(T) >= M, by bisection over the bit
// patterns of non-negative floats (ordered as their values). The host's
// sqrtf is IEEE and correctly rounded, as the device's is without
// --use_fast_math, so for every d2: d2 < T exactly when sqrtf(d2) < M,
// which is when fl(M - sqrtf(d2)) > 0. M <= 0 gives T = 0 (nothing
// counts); NaN, or an M above the largest float's root, gives T = +inf
// (every pair takes the counted path, whose own hinge test decides).
float hinge_threshold(float M) {
  unsigned lo = 0u, hi = 0x7f800000u;
  while (lo < hi) {
    const unsigned mid = lo + (hi - lo) / 2;
    float x;
    std::memcpy(&x, &mid, sizeof x);
    if (sqrtf(x) >= M)
      hi = mid;
    else
      lo = mid + 1;
  }
  float t;
  std::memcpy(&t, &lo, sizeof t);
  return t;
}

// Blocks per pair b of K1's and K2's grids.
template <int MAXD>
int walk_blocks(int Nm) {
  return (Nm + kWarps * kWalkRows(MAXD) - 1) / (kWarps * kWalkRows(MAXD));
}

}  // namespace

extern "C" {

// K1. Device pointers of contiguous tensors: da [B, Nm, D], db [B, P, D],
// mu/mv/mvalid [B, Nm], pu/pv/pvalid [B, P], part_loss/part_hard of
// pdc_pooled_hinge_fwd_partials(B, Nm, D) entries, loss [B] float, hard [B]
// int64. Returns cudaGetLastError() of the launches.
int pdc_pooled_hinge_fwd(const float* da, const float* db, const float* mu, const float* mv,
                         const float* mvalid, const float* pu, const float* pv,
                         const float* pvalid, float* part_loss, int* part_hard, float* loss,
                         long long* hard, int B, int Nm, int P, int D, float M, int use_pix,
                         float M_pixel, int device, void* stream) {
  int err = prologue(device, B, Nm, P, D);
  if (err) return err;
  const Hinge h{M, M_pixel, use_pix};
  const float T = hinge_threshold(M);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int nblk = 0;
  by_d(D, [&](auto maxd) {
    constexpr int MAXD = decltype(maxd)::value;
    nblk = walk_blocks<MAXD>(Nm);
    hinge_fwd<MAXD><<<dim3(nblk, B), kThreads, 0, s>>>(da, db, mu, mv, mvalid, pu, pv, pvalid,
                                                        part_loss, part_hard, Nm, P, D, T, h);
  });
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  hinge_fwd_final<<<B, kThreads, 0, s>>>(part_loss, part_hard, loss, hard, nblk);
  return (int)cudaGetLastError();
}

// K1's scratch: the entries part_loss and part_hard each need for these
// shapes, B * nblk (nblk: blocks per pair of K1's grid), or -1 for shapes
// K1 does not take.
long long pdc_pooled_hinge_fwd_partials(int B, int Nm, int D) {
  if (B < 1 || Nm < 1 || D < 1 || D > kMaxD) return -1;
  int nblk = 0;
  by_d(D, [&](auto maxd) { nblk = walk_blocks<decltype(maxd)::value>(Nm); });
  return (long long)B * nblk;
}

// K2. Same inputs plus g_loss [B] (the loss cotangent); part_gdb of
// pdc_pooled_hinge_bwd_partials(B, Nm, P, D) floats, gda [B, Nm, D],
// gdb [B, P, D]. Returns cudaGetLastError() of the launches.
int pdc_pooled_hinge_bwd(const float* da, const float* db, const float* mu, const float* mv,
                         const float* mvalid, const float* pu, const float* pv,
                         const float* pvalid, const float* g_loss, float* part_gdb, float* gda,
                         float* gdb, int B, int Nm, int P, int D, float M, int use_pix,
                         float M_pixel, int device, void* stream) {
  int err = prologue(device, B, Nm, P, D);
  if (err) return err;
  const Hinge h{M, M_pixel, use_pix};
  const float T = hinge_threshold(M);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int nblk = 0;
  by_d(D, [&](auto maxd) {
    constexpr int MAXD = decltype(maxd)::value;
    nblk = walk_blocks<MAXD>(Nm);
    // above the 48 KB default: pdc_pooled_hinge_prepare allowed it on this device
    const int smem = bwd_smem_floats<MAXD>() * (int)sizeof(float);
    hinge_bwd<MAXD><<<dim3(nblk, B), kThreads, smem, s>>>(
        da, db, mu, mv, mvalid, pu, pv, pvalid, g_loss, gda, part_gdb, Nm, P, D, T, h);
  });
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  hinge_bwd_final<<<dim3((P + 31) / 32, B), kThreads, 0, s>>>(part_gdb, db, g_loss, gdb, P, D,
                                                              nblk);
  return (int)cudaGetLastError();
}

// Lets every template of hinge_bwd use the dynamic shared memory it launches
// with (above the 48 KB default) on `device`. Called once per device before
// the first launch there, so that no launch sets a function attribute: a
// launch may be captured into a CUDA graph. Returns the first error, or 0.
int pdc_pooled_hinge_prepare(int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int templates[] = {1, 2, 3, 4, 8, 16};  // by_d's MAXD values
  int err = 0;
  for (int D : templates) {
    by_d(D, [&](auto maxd) {
      constexpr int MAXD = decltype(maxd)::value;
      if (!err)
        err = (int)cudaFuncSetAttribute(hinge_bwd<MAXD>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        bwd_smem_floats<MAXD>() * (int)sizeof(float));
    });
  }
  return err;
}

// K2's scratch: the floats part_gdb needs for these shapes, B * nblk * D * P
// (nblk: blocks per pair of K2's grid), or -1 for shapes K2 does not take.
long long pdc_pooled_hinge_bwd_partials(int B, int Nm, int P, int D) {
  if (B < 1 || Nm < 1 || P < 1 || D < 1 || D > kMaxD) return -1;
  int nblk = 0;
  by_d(D, [&](auto maxd) { nblk = walk_blocks<decltype(maxd)::value>(Nm); });
  return (long long)B * nblk * D * P;
}

// The threshold K1 and K2 use for margin M (see hinge_threshold).
float pdc_pooled_hinge_threshold(float M) { return hinge_threshold(M); }

const char* pdc_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
