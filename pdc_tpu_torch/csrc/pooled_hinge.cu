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
// are ~0.7 MB (~0.2 us) against B*Nm*P = 41M pairs of ~20 fp32 operations
// and one sqrt each: ~0.8 GFLOP (~12 us) and 41M sqrt on the SFUs. Both
// kernels are bound by operations; the backward evaluates every pair twice
// (once per phase below).
//
// Design (simple first; later work: wgmma for the D-contractions, fusing the
// two pools into one launch, a persistent grid):
//   grid (row tiles of kRows match rows, B). The pool is staged through shared
//   memory in chunks of kPoolChunk entries, so any P fits.
//   K1: kLanes threads per match row walk the chunk's pool entries; each keeps
//     a float loss and an int count; the block reduces them in a fixed order
//     (warp shuffles, then warps in order) into one partial per block, and a
//     second kernel sums the partials of each pair in block order.
//   K2, phase A (rows): the same walk accumulates gda_i in registers; the
//     kLanes threads of a row combine by xor-shuffle and lane 0 writes gda_i.
//     No other block touches row i.
//   K2, phase B (columns): with the block's rows also in shared memory, each
//     thread owns pool entries of the chunk and loops over the block's rows,
//     writing one gdb partial per (block, j). A second kernel sums the partials
//     in block order.
// No atomics anywhere: two runs give bit-equal results.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;                 // match rows per block
constexpr int kLanes = kThreads / kRows;  // threads per row in the row walk
constexpr int kPoolChunk = 512;           // pool entries staged at a time
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

template <int MAXD>
__global__ void __launch_bounds__(kThreads)
hinge_bwd(const float* __restrict__ da, const float* __restrict__ db,
          const float* __restrict__ mu, const float* __restrict__ mv,
          const float* __restrict__ mvalid, const float* __restrict__ pu,
          const float* __restrict__ pv, const float* __restrict__ pvalid,
          const float* __restrict__ g_loss, float* __restrict__ gda,
          float* __restrict__ part_gdb, int Nm, int P, int D, Hinge h) {
  __shared__ PoolChunk<MAXD> s;
  __shared__ float ra[MAXD][kRows];
  __shared__ float ru[kRows], rv[kRows], rvalid[kRows];

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int row = row0 + threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int nrows = min(kRows, Nm - row0);
  float a[MAXD], u, v, mval;
  load_row<MAXD>(da, mu, mv, mvalid, b, row, Nm, D, a, u, v, mval);
  if (lane == 0) {
    const int r = threadIdx.x / kLanes;
#pragma unroll
    for (int d = 0; d < MAXD; ++d) ra[d][r] = a[d];
    ru[r] = u;
    rv[r] = v;
    rvalid[r] = mval;
  }

  float ga[MAXD];
#pragma unroll
  for (int d = 0; d < MAXD; ++d) ga[d] = 0.f;

  for (int p0 = 0; p0 < P; p0 += kPoolChunk) {
    const int n = min(kPoolChunk, P - p0);
    __syncthreads();
    stage_pool<MAXD>(s, db, pu, pv, pvalid, b, P, D, p0, n);
    __syncthreads();
    // phase A: this thread's row against its share of the chunk
    if (mval != 0.f) {
      for (int k = lane; k < n; k += kLanes) {
        float t[MAXD], d2, hinge, w, pixw;
        if (pair<MAXD>(a, u, v, mval, &s.db[0][k], kPoolChunk, s.pu[k], s.pv[k], s.pvalid[k],
                       h, t, d2, hinge, w, pixw) &&
            d2 > 1e-24f) {
          const float c = __fdiv_rn(__fmul_rn(__fmul_rn(-2.f, __fmul_rn(w, pixw)), hinge),
                                    sqrtf(d2));
#pragma unroll
          for (int d = 0; d < MAXD; ++d) ga[d] = __fadd_rn(ga[d], __fmul_rn(c, t[d]));
        }
      }
    }
    // phase B: this thread's pool entries against all rows of the block
    for (int k = threadIdx.x; k < n; k += kThreads) {
      float gb[MAXD];
#pragma unroll
      for (int d = 0; d < MAXD; ++d) gb[d] = 0.f;
      for (int r = 0; r < nrows; ++r) {
        if (rvalid[r] == 0.f) continue;
        float ar[MAXD];
#pragma unroll
        for (int d = 0; d < MAXD; ++d) ar[d] = ra[d][r];
        float t[MAXD], d2, hinge, w, pixw;
        if (pair<MAXD>(ar, ru[r], rv[r], rvalid[r], &s.db[0][k], kPoolChunk, s.pu[k], s.pv[k],
                       s.pvalid[k], h, t, d2, hinge, w, pixw) &&
            d2 > 1e-24f) {
          const float c = __fdiv_rn(__fmul_rn(__fmul_rn(-2.f, __fmul_rn(w, pixw)), hinge),
                                    sqrtf(d2));
#pragma unroll
          for (int d = 0; d < MAXD; ++d) gb[d] = __fadd_rn(gb[d], __fmul_rn(c, t[d]));
        }
      }
      float* out = part_gdb + (((size_t)b * gridDim.x + blockIdx.x) * P + p0 + k) * D;
      for (int d = 0; d < D; ++d) out[d] = gb[d];
    }
  }

  // the kLanes threads of a row are consecutive lanes of one warp
#pragma unroll
  for (int d = 0; d < MAXD; ++d) {
#pragma unroll
    for (int off = 1; off < kLanes; off <<= 1) ga[d] += __shfl_xor_sync(0xffffffffu, ga[d], off);
  }
  if (lane == 0 && row < Nm) {
    const float g = g_loss[b];
    float* out = gda + ((size_t)b * Nm + row) * D;
    for (int d = 0; d < D; ++d) out[d] = __fmul_rn(g, ga[d]);
  }
}

// one thread per (b, j, d): partials in block order
__global__ void hinge_bwd_final(const float* __restrict__ part_gdb,
                                const float* __restrict__ g_loss, float* __restrict__ gdb, int B,
                                int P, int D, int nblk) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per_pair = (long long)P * D;
  if (t >= B * per_pair) return;
  const int b = (int)(t / per_pair);
  const long long jd = t % per_pair;
  float s = 0.f;
  for (int k = 0; k < nblk; ++k) s += part_gdb[((long long)b * nblk + k) * per_pair + jd];
  gdb[t] = __fmul_rn(g_loss[b], -s);
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

}  // namespace

extern "C" {

// Match rows per block: the caller sizes the partials from it
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

// K2. Same inputs plus g_loss [B] (the loss cotangent); part_gdb
// [B, nblk, P, D], gda [B, Nm, D], gdb [B, P, D].
int pdc_pooled_hinge_bwd(const float* da, const float* db, const float* mu, const float* mv,
                         const float* mvalid, const float* pu, const float* pv,
                         const float* pvalid, const float* g_loss, float* part_gdb, float* gda,
                         float* gdb, int B, int Nm, int P, int D, float M, int use_pix,
                         float M_pixel, int device, void* stream) {
  int err = prologue(device, B, Nm, P, D);
  if (err) return err;
  const int nblk = (Nm + kRows - 1) / kRows;
  const dim3 grid(nblk, B);
  const Hinge h{M, M_pixel, use_pix};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  by_d(
      D,
      [&] { hinge_bwd<4><<<grid, kThreads, 0, s>>>(da, db, mu, mv, mvalid, pu, pv, pvalid,
                                                   g_loss, gda, part_gdb, Nm, P, D, h); },
      [&] { hinge_bwd<8><<<grid, kThreads, 0, s>>>(da, db, mu, mv, mvalid, pu, pv, pvalid,
                                                   g_loss, gda, part_gdb, Nm, P, D, h); },
      [&] { hinge_bwd<16><<<grid, kThreads, 0, s>>>(da, db, mu, mv, mvalid, pu, pv, pvalid,
                                                    g_loss, gda, part_gdb, Nm, P, D, h); });
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long n = (long long)B * P * D;
  hinge_bwd_final<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(part_gdb, g_loss, gdb, B, P, D,
                                                              nblk);
  return (int)cudaGetLastError();
}

const char* pdc_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
