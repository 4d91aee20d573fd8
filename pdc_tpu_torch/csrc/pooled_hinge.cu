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
// K1 (simple first; later work: the K2 walk below, one launch for both pools):
//   grid (row tiles of kRows match rows, B). The pool is staged through shared
//   memory in chunks of kPoolChunk entries, so any P fits. kLanes threads per
//   match row walk the chunk's pool entries; each keeps a float loss and an
//   int count; the block reduces them in a fixed order (warp shuffles, then
//   warps in order) into one partial per block, and a second kernel sums the
//   partials of each pair in block order.
//
// K2 (redesigned; the first design walked every pair twice):
//   1. One walk over each pair. A warp holds kBwdRows match rows in
//      registers (every lane the same rows) and its lanes walk the pool
//      chunk's entries, one entry per lane at a time, so each (row, entry)
//      pair is evaluated once. c * t goes into a ga slot per (row, lane)
//      and a gb slot per entry of the lane, both in shared memory and
//      private to the lane; at the end the 32 lanes' ga of a row are summed
//      by a fixed xor-shuffle tree, and at the end of each chunk the block
//      sums the kWarps gb slots of each entry in warp order into one
//      partial per (block, entry).
//   2. The square root only where a pair can count. d2 is tested first:
//      1e-24 < d2 < T, where T is the least float with sqrtf(T) >= M
//      (host bisection, hinge_threshold). That is exact: d2 >= T means
//      dist >= M and hinge = 0. Invalid rows and pool entries carry +inf in
//      channel 0 and fail the test too. The counted path takes dist =
//      sqrtf(d2) once and reuses it for c (the first design took it twice).
//      The test only sets a bit in the lane's 32-bit mask (32 / kBwdRows
//      entries x kBwdRows rows); the counted path then runs over each
//      lane's own bits, so a warp pays for it as often as its busiest lane
//      has bits. Taking the branch per pair instead made the warp run the
//      counted path whenever any of its 32 lanes counted: with ~4.5% of
//      pairs counting, ~77% of the time.
//   3. Templates on the exact D for D <= 4 (no padded channel on the main
//      path's D=3), then 8 and 16; rows per warp and chunk shrink with D so
//      that the registers and the shared slots fit (7 rows and 256 entries
//      up to D=4, 4 and 128 up to 8, 2 and 128 up to 16). hinge_bwd<3>
//      takes 53.6 KB of shared memory and, under __launch_bounds__ asking
//      for 3 blocks per SM, 72 registers without spills (ptxas), so 3
//      blocks of 256 threads are resident per SM. Without that cap ptxas
//      gave it 86 registers: 2 blocks per SM, and K2 took 20% longer.
//   4. A grid sized to the card. Every block walks the whole pool for its
//      kWarps * kBwdRows rows, so a launch takes ceil(blocks / slots) rounds,
//      slots being the resident blocks (3 per SM on 132 SMs: 396). Up to
//      D=4 a warp takes 7 rows, not 8: at the main path's B=4, Nm=10000
//      that is 4 * ceil(10000 / 56) = 716 blocks, 2 rounds with 90% of the
//      slots busy, where 8 rows would give 628 blocks, 2 rounds with 79%
//      busy and a longer walk per block (8 rows against 7).
//   5. An ordered, parallel final reduction: hinge_bwd_final gives each
//      lane one pool entry and each of the 8 warps every 8th block's
//      partial, then adds the warps' sums in warp order, over a grid of
//      ceil(P/32) x B blocks (128 at the main path's shapes).
// No atomics anywhere: two runs give bit-equal results.

#include <cuda_runtime.h>

#include <cmath>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;                 // K1: match rows per block
constexpr int kLanes = kThreads / kRows;  // K1: threads per row in the row walk
constexpr int kPoolChunk = 512;           // K1: pool entries staged at a time
constexpr int kMaxD = 16;

struct Hinge {
  float M, M_pixel;
  int use_pix;
};

// Shared-memory staging of one pool chunk (structure of arrays).
template <int MAXD>
struct PoolChunk {
  float db[MAXD][kPoolChunk];
  float pu[kPoolChunk], pv[kPoolChunk], pvalid[kPoolChunk];
};

template <int MAXD>
__device__ __forceinline__ void stage_pool(PoolChunk<MAXD>& s, const float* __restrict__ db,
                                           const float* __restrict__ pu,
                                           const float* __restrict__ pv,
                                           const float* __restrict__ pvalid, int b, int P, int D,
                                           int p0, int n) {
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const size_t o = (size_t)b * P + p0 + k;
#pragma unroll
    for (int d = 0; d < MAXD; ++d) s.db[d][k] = d < D ? db[o * D + d] : 0.f;
    s.pu[k] = pu[o];
    s.pv[k] = pv[o];
    s.pvalid[k] = pvalid[o];
  }
}

// One (match row, pool entry) pair. Returns true when the pair is a counted
// term (valid, no collision, hinge > 0); then sets the weight w (without the
// pixel weight), the pixel weight pixw (1 without use_pix), hinge, d2 and the
// differences t. Padded channels are 0 - 0 and add 0 exactly.
template <int MAXD>
__device__ __forceinline__ bool pair(const float (&a)[MAXD], float u, float v, float mval,
                                     const float* sdb, int stride, float su, float sv,
                                     float spvalid, const Hinge& h, float (&t)[MAXD], float& d2,
                                     float& hinge, float& w, float& pixw) {
  d2 = 0.f;
#pragma unroll
  for (int d = 0; d < MAXD; ++d) {
    t[d] = a[d] - sdb[d * stride];
    d2 = __fadd_rn(d2, __fmul_rn(t[d], t[d]));
  }
  const float dist = sqrtf(fmaxf(d2, 1e-24f));
  hinge = fmaxf(h.M - dist, 0.f);
  const float du = fabsf(u - su), dv = fabsf(v - sv);
  w = __fmul_rn(mval, spvalid);
  if (w == 0.f || du < 1.f || dv < 1.f || !(hinge > 0.f)) return false;
  pixw = 1.f;
  if (h.use_pix) {
    const float pix = sqrtf(__fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv)));
    pixw = __fdiv_rn(fminf(pix, h.M_pixel), h.M_pixel);
  }
  return true;
}

template <int MAXD>
__device__ __forceinline__ void load_row(const float* __restrict__ da,
                                         const float* __restrict__ mu,
                                         const float* __restrict__ mv,
                                         const float* __restrict__ mvalid, int b, int row, int Nm,
                                         int D, float (&a)[MAXD], float& u, float& v,
                                         float& mval) {
  const bool in = row < Nm;
  const size_t o = (size_t)b * Nm + row;
#pragma unroll
  for (int d = 0; d < MAXD; ++d) a[d] = (in && d < D) ? da[o * D + d] : 0.f;
  u = in ? mu[o] : 0.f;
  v = in ? mv[o] : 0.f;
  mval = in ? mvalid[o] : 0.f;
}

template <int MAXD>
__global__ void __launch_bounds__(kThreads)
hinge_fwd(const float* __restrict__ da, const float* __restrict__ db,
          const float* __restrict__ mu, const float* __restrict__ mv,
          const float* __restrict__ mvalid, const float* __restrict__ pu,
          const float* __restrict__ pv, const float* __restrict__ pvalid,
          float* __restrict__ part_loss, int* __restrict__ part_hard, int Nm, int P, int D,
          Hinge h) {
  __shared__ PoolChunk<MAXD> s;
  __shared__ float wloss[kWarps];
  __shared__ int whard[kWarps];

  const int b = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  float a[MAXD], u, v, mval;
  load_row<MAXD>(da, mu, mv, mvalid, b, row, Nm, D, a, u, v, mval);

  float loss = 0.f;
  int hard = 0;
  for (int p0 = 0; p0 < P; p0 += kPoolChunk) {
    const int n = min(kPoolChunk, P - p0);
    __syncthreads();  // the previous chunk is consumed
    stage_pool<MAXD>(s, db, pu, pv, pvalid, b, P, D, p0, n);
    __syncthreads();
    if (mval != 0.f) {
      for (int k = lane; k < n; k += kLanes) {
        float t[MAXD], d2, hinge, w, pixw;
        if (pair<MAXD>(a, u, v, mval, &s.db[0][k], kPoolChunk, s.pu[k], s.pv[k], s.pvalid[k],
                       h, t, d2, hinge, w, pixw)) {
          float term = __fmul_rn(__fmul_rn(w, hinge), hinge);
          if (h.use_pix) term = __fmul_rn(term, pixw);
          loss = __fadd_rn(loss, term);
          ++hard;
        }
      }
    }
  }

  const int wl = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    loss += __shfl_down_sync(0xffffffffu, loss, off);
    hard += __shfl_down_sync(0xffffffffu, hard, off);
  }
  if (wl == 0) {
    wloss[warp] = loss;
    whard[warp] = hard;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float l = 0.f;
    int c = 0;
    for (int w = 0; w < kWarps; ++w) {
      l += wloss[w];
      c += whard[w];
    }
    part_loss[(size_t)b * gridDim.x + blockIdx.x] = l;
    part_hard[(size_t)b * gridDim.x + blockIdx.x] = c;
  }
}

// one thread per pair b: partials in block order
__global__ void hinge_fwd_final(const float* __restrict__ part_loss,
                                const int* __restrict__ part_hard, float* __restrict__ loss,
                                long long* __restrict__ hard, int B, int nblk) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float l = 0.f;
  long long c = 0;
  for (int k = 0; k < nblk; ++k) {
    l += part_loss[(size_t)b * nblk + k];
    c += part_hard[(size_t)b * nblk + k];
  }
  loss[b] = l;
  hard[b] = c;
}

// ---- K2 -------------------------------------------------------------------

// K2's shapes: kBwdRows(MAXD) match rows per warp (header, point 4), pool
// chunks of kBwdChunk(MAXD) entries, and groups of 32 / kBwdRows entries per
// lane, whose (entry, row) pairs fit one 32-bit mask.
__host__ __device__ constexpr int kBwdRows(int maxd) { return maxd <= 4 ? 7 : (maxd <= 8 ? 4 : 2); }
__host__ __device__ constexpr int kBwdChunk(int maxd) { return maxd <= 4 ? 256 : 128; }
// Resident K2 blocks per SM that the registers must allow (at most 80 per
// thread for 3 blocks of 256); the shared memory allows as many (D <= 16: 2).
__host__ __device__ constexpr int kBwdBlocksPerSm(int maxd) { return maxd <= 8 ? 3 : 2; }

// Dynamic shared memory of one K2 block, in floats: the pool chunk (MAXD
// channels, pu, pv, pvalid), one gb partial per (warp, channel, entry), one
// ga partial per (warp, row, channel, lane), and the block's rows (MAXD
// channels, u, v, validity).
template <int MAXD>
constexpr int bwd_smem_floats() {
  return kBwdChunk(MAXD) * (MAXD + 3 + kWarps * MAXD) + kWarps * kBwdRows(MAXD) * MAXD * 32 +
         kWarps * kBwdRows(MAXD) * (MAXD + 3);
}

// Stage one pool chunk for K2. A pool entry with pvalid == 0 gets +inf in
// channel 0, so that every pair with it has d2 = inf (or NaN) and fails the
// distance test: its weight is 0 in the plain version as well.
template <int MAXD>
__device__ __forceinline__ void stage_pool_bwd(float* s, const float* __restrict__ db,
                                               const float* __restrict__ pu,
                                               const float* __restrict__ pv,
                                               const float* __restrict__ pvalid, int b, int P,
                                               int D, int p0, int n) {
  constexpr int C = kBwdChunk(MAXD);
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const size_t o = (size_t)b * P + p0 + k;
    const float valid = pvalid[o];
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
      const float x = (MAXD <= 4 || d < D) ? db[o * D + d] : 0.f;
      s[d * C + k] = (d == 0 && valid == 0.f) ? __int_as_float(0x7f800000) : x;
    }
    s[MAXD * C + k] = pu[o];
    s[(MAXD + 1) * C + k] = pv[o];
    s[(MAXD + 2) * C + k] = valid;
  }
}

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
// [B, nblk, D, P]. At the end, each row's ga is summed over the 32 lanes by
// a fixed xor-shuffle tree.
template <int MAXD>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSm(MAXD))
hinge_bwd(const float* __restrict__ da, const float* __restrict__ db,
          const float* __restrict__ mu, const float* __restrict__ mv,
          const float* __restrict__ mvalid, const float* __restrict__ pu,
          const float* __restrict__ pv, const float* __restrict__ pvalid,
          const float* __restrict__ g_loss, float* __restrict__ gda,
          float* __restrict__ part_gdb, int Nm, int P, int D, float T, Hinge h) {
  constexpr int R = kBwdRows(MAXD);
  constexpr int C = kBwdChunk(MAXD);
  constexpr int G = 32 / R;        // entries per lane in one mask
  constexpr int RS = MAXD + 3;     // floats per staged row
  extern __shared__ float smem[];
  float* const spool = smem;                       // [MAXD + 3][C]
  float* const sgb = spool + (MAXD + 3) * C;       // [kWarps][MAXD][C]
  float* const sga = sgb + kWarps * MAXD * C;      // [kWarps][R][MAXD][32]
  float* const srow = sga + kWarps * R * MAXD * 32;  // [kWarps][R][MAXD + 3]
  const float inf = __int_as_float(0x7f800000);

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * kWarps + warp) * R;
  float* const myrow = srow + warp * R * RS;
  float* const myga = sga + warp * R * MAXD * 32 + lane;
  float* const mygb = sgb + warp * MAXD * C;

  // The warp's rows. A row that is invalid (mvalid == 0) or past Nm gets
  // +inf in channel 0, so it fails the distance test like an invalid entry.
  float a[R][MAXD];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
    const bool in = row < Nm;
    const size_t o = (size_t)b * Nm + row;
    const float mval = in ? mvalid[o] : 0.f;
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
      a[r][d] = (in && mval != 0.f && (MAXD <= 4 || d < D)) ? da[o * D + d]
                                                             : (d == 0 && mval == 0.f ? inf : 0.f);
      myga[(r * MAXD + d) * 32] = 0.f;
    }
    if (lane == 0) {
#pragma unroll
      for (int d = 0; d < MAXD; ++d) myrow[r * RS + d] = a[r][d];
      myrow[r * RS + MAXD] = in ? mu[o] : 0.f;
      myrow[r * RS + MAXD + 1] = in ? mv[o] : 0.f;
      myrow[r * RS + MAXD + 2] = mval;
    }
  }

  for (int p0 = 0; p0 < P; p0 += C) {
    const int n = min(C, P - p0);
    __syncthreads();  // the previous chunk and its gb partials are consumed
    stage_pool_bwd<MAXD>(spool, db, pu, pv, pvalid, b, P, D, p0, n);
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
      // counted pass: the same arithmetic as pair(), from shared memory
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
    // one partial per (block, entry): the warps' partials in warp order
    float* const out = part_gdb + ((size_t)b * gridDim.x + blockIdx.x) * D * P + p0;
    for (int i = threadIdx.x; i < D * n; i += kThreads) {
      const int d = i / n, k = i - d * n;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s = __fadd_rn(s, sgb[(w * MAXD + d) * C + k]);
      out[(size_t)d * P + k] = s;
    }
  }

  const float g = g_loss[b];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = row0 + r;
#pragma unroll
    for (int d = 0; d < MAXD; ++d) {
      float s = myga[(r * MAXD + d) * 32];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
      if (lane == 0 && row < Nm && (MAXD <= 4 || d < D))
        gda[((size_t)b * Nm + row) * D + d] = __fmul_rn(g, s);
    }
  }
}

// Grid (ceil(P / 32), B), kThreads threads: lane l owns pool entry
// 32 * x + l; warp w sums the partials of blocks w, w + kWarps, ... in
// order, and the warps' sums are added in warp order. No atomics.
__global__ void __launch_bounds__(kThreads)
hinge_bwd_final(const float* __restrict__ part_gdb, const float* __restrict__ g_loss,
                float* __restrict__ gdb, int P, int D, int nblk) {
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
    gdb[((size_t)b * P + jj) * D + d] = __fmul_rn(g, -s);
  }
}

template <typename F4, typename F8, typename F16>
void by_d(int D, F4 f4, F8 f8, F16 f16) {
  if (D <= 4)
    f4();
  else if (D <= 8)
    f8();
  else
    f16();
}

int prologue(int device, int B, int Nm, int P, int D) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 1 || B > 65535 || Nm < 1 || P < 1 || D < 1 || D > kMaxD)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// Calls f(std::integral_constant<int, MAXD>) for K2's template of D: the
// exact D up to 4, else 8 or 16 (padded channels add 0 - 0).
template <typename F>
void by_d_bwd(int D, F f) {
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

// Blocks per pair b of K2's grid.
template <int MAXD>
int bwd_blocks(int Nm) {
  return (Nm + kWarps * kBwdRows(MAXD) - 1) / (kWarps * kBwdRows(MAXD));
}

}  // namespace

extern "C" {

// K1's match rows per block: the caller sizes K1's partials from it
// (nblk = ceil(Nm / rows)).
int pdc_pooled_hinge_rows_per_block() { return kRows; }

// K1. Device pointers of contiguous tensors: da [B, Nm, D], db [B, P, D],
// mu/mv/mvalid [B, Nm], pu/pv/pvalid [B, P], part_loss/part_hard [B, nblk],
// loss [B] float, hard [B] int64. Returns cudaGetLastError() of the launches.
int pdc_pooled_hinge_fwd(const float* da, const float* db, const float* mu, const float* mv,
                         const float* mvalid, const float* pu, const float* pv,
                         const float* pvalid, float* part_loss, int* part_hard, float* loss,
                         long long* hard, int B, int Nm, int P, int D, float M, int use_pix,
                         float M_pixel, int device, void* stream) {
  int err = prologue(device, B, Nm, P, D);
  if (err) return err;
  const int nblk = (Nm + kRows - 1) / kRows;
  const dim3 grid(nblk, B);
  const Hinge h{M, M_pixel, use_pix};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  by_d(
      D,
      [&] { hinge_fwd<4><<<grid, kThreads, 0, s>>>(da, db, mu, mv, mvalid, pu, pv, pvalid,
                                                   part_loss, part_hard, Nm, P, D, h); },
      [&] { hinge_fwd<8><<<grid, kThreads, 0, s>>>(da, db, mu, mv, mvalid, pu, pv, pvalid,
                                                   part_loss, part_hard, Nm, P, D, h); },
      [&] { hinge_fwd<16><<<grid, kThreads, 0, s>>>(da, db, mu, mv, mvalid, pu, pv, pvalid,
                                                    part_loss, part_hard, Nm, P, D, h); });
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  hinge_fwd_final<<<(B + 127) / 128, 128, 0, s>>>(part_loss, part_hard, loss, hard, B, nblk);
  return (int)cudaGetLastError();
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
  by_d_bwd(D, [&](auto maxd) {
    constexpr int MAXD = decltype(maxd)::value;
    nblk = bwd_blocks<MAXD>(Nm);
    const int smem = bwd_smem_floats<MAXD>() * (int)sizeof(float);
    // above the 48 KB default: allowed per launch, on the current device
    err = (int)cudaFuncSetAttribute(hinge_bwd<MAXD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    smem);
    if (err) return;
    hinge_bwd<MAXD><<<dim3(nblk, B), kThreads, smem, s>>>(
        da, db, mu, mv, mvalid, pu, pv, pvalid, g_loss, gda, part_gdb, Nm, P, D, T, h);
  });
  if (err) return err;
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  hinge_bwd_final<<<dim3((P + 31) / 32, B), kThreads, 0, s>>>(part_gdb, g_loss, gdb, P, D, nblk);
  return (int)cudaGetLastError();
}

// K2's scratch: the floats part_gdb needs for these shapes, B * nblk * D * P
// (nblk: blocks per pair of K2's grid), or -1 for shapes K2 does not take.
long long pdc_pooled_hinge_bwd_partials(int B, int Nm, int P, int D) {
  if (B < 1 || Nm < 1 || P < 1 || D < 1 || D > kMaxD) return -1;
  int nblk = 0;
  by_d_bwd(D, [&](auto maxd) { nblk = bwd_blocks<decltype(maxd)::value>(Nm); });
  return (long long)B * nblk * D * P;
}

// The threshold K2 uses for margin M (see hinge_threshold).
float pdc_pooled_hinge_threshold(float M) { return hinge_threshold(M); }

const char* pdc_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
