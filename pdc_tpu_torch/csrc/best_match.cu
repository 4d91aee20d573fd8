// Streaming best-match argmin over descriptor images, for Hopper (sm_90a).
//
// Replaces the TPU kernel pdc_tpu/ops/pallas_kernels.py `_best_match_kernel`
// (:30-61, launched by `pallas_best_match` :64-109). For every query q of
// image b it finds the pixel p of minimal squared distance ||r_p - q||^2,
// ties going to the lowest pixel index as torch.argmin / jnp.argmin do, and
// returns (p, ||r_p - q||). Nothing of size [HW, Q] ever reaches device memory.
//
// Layout: descriptor images channel-planar [B, D, HW] fp32 (the backbone's NCHW
// output as it is, and the TPU kernel's transposed `resT [D, HW]`), queries
// [B, Q, D] fp32, D <= 16. Outputs idx [B, Q] int32, dist [B, Q] fp32.
//
// Arithmetic: fp32 FMAs on the difference, d2 = sum_d (r_d - q_d)^2. The TPU
// kernel expanded ||r||^2 - 2<r,q> + ||q||^2 to ride the matrix unit; that form
// loses about eps * ||r||^2 to cancellation (~3e-5 in d2 for the random-init
// ResNet-34-8s, whose ||r||^2 is ~270), enough to pick the wrong pixel among
// near-ties and to turn an exact match's distance 0 into ~5e-3. On this card
// there is no matrix unit to feed at D <= 16, and the difference form costs
// D subtractions more per (pixel, query) pair. A pixel whose distance is NaN
// never wins; a query with no finite distance gets pixel 0 (as argmin of an
// all-inf row) and distance inf.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 without tensor cores):
// one read of B*HW*D*4 bytes (3.69 MB for one 640x480 D=3 image, ~1.1 us)
// against about 2*Q*HW*D + 2*Q*HW fp32 operations (~39 MFLOP at Q=16, ~0.6 us;
// ~2.5 GFLOP at Q=1024, ~38 us). Memory- and launch-bound at serving Q (<= 16),
// bound by instruction issue from Q of a few hundred on: each (pixel, query)
// pair costs D subtractions and D FMAs at the least, 2D of the card's 128
// fp32 lanes per SM per clock.
//
// Design. The first design took two launches (per-chunk partials, then one
// thread per query walking ~300 partials in a chain of dependent loads: on
// an H100 that second launch alone took 0.062 ms of device time at B=1,
// Q=16), 12 scalar loads per thread, and read each query's D values from
// shared memory for every (pixel, query) pair. This one:
//   1. One launch. Grid (slices, query groups, B). A block walks one slice of
//      the image (steps of kThreads * 4 pixels) for one group of QG queries,
//      reduces its threads' minima (ties to the lower index) and writes one
//      partial per query. Then it takes a ticket from the counter of its
//      (image, query group); the block that draws the last ticket reduces
//      that group's partials, each query's by TPQ = kThreads / QG threads
//      that load 8 partials at a time and a fixed shuffle tree under the
//      same (value, index) order, so the result does not depend on which
//      block finishes last, writes idx and dist, and sets the counter back
//      to 0 for the next launch. The counters live in the caller's buffer,
//      zeroed once per (device, stream) by ops/best_match.py.
//   2. Loads in flight. Each thread takes 4 consecutive pixels per step:
//      one 16-byte load per channel plane, neighbouring threads on
//      neighbouring addresses, and up to D=4 the next step's loads are
//      issued before this step's distances. Where HW % 4 != 0 or the image
//      is not 16-byte aligned, 4 scalar loads take their place. The grid is
//      one wave: slices per (image, query group) so that the launch has at
//      most kBlocksPerSm blocks per SM (resident under __launch_bounds__),
//      in whole steps. At B=1, Q=1024, 288 blocks in two waves took 0.164 ms
//      on an H100, 256 in one 0.117 ms.
//   3. A register tile of 4 pixels x QG queries. A query's D values are read
//      from shared memory once per 4 pixels (one 16-byte load up to D=4),
//      and the 4 distances are folded by fminf before the one comparison
//      against the running minimum; only an improvement (rare after the
//      first steps) finds which of the 4 pixels it was, the lowest first.
//      QG is 32 from Q = 17 on up to D=4 (Q=1024 reads the image 32 times,
//      from L2), else 16.
//   4. Templates on the exact D up to 4 (no padded channel at D=3), then 8
//      and 16.
// Within a thread the pixels increase and only a strictly smaller distance
// replaces the minimum; every later step orders by (value, index). No
// atomics touch a sum, so results are bit-reproducible.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <math_constants.h>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPix = 4;                     // consecutive pixels per thread and step
constexpr int kStep = kThreads * kPix;      // pixels per block and step
constexpr int kBlocksPerSm = 2;
constexpr int kMaxD = 16;
constexpr int kMaxDevices = 64;

// (v, i) is better than (bv, bi): smaller value, or equal value and lower index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

// Pixels p .. p + 3 of every channel of one image into r; a pixel past HW
// gets NaN, which never wins. vec: one 16-byte load per plane.
template <int MAXD>
__device__ __forceinline__ void load_pixels(const float* __restrict__ img, int D, int HW, int p,
                                            int vec, float (&r)[MAXD][kPix]) {
#pragma unroll
  for (int d = 0; d < MAXD; ++d) {
    if (d < D) {
      const float* plane = img + (size_t)d * HW;
      if (vec) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(plane + p));
        r[d][0] = v.x, r[d][1] = v.y, r[d][2] = v.z, r[d][3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < kPix; ++j) r[d][j] = p + j < HW ? __ldg(plane + p + j) : CUDART_NAN_F;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPix; ++j) r[d][j] = 0.f;
    }
  }
}

template <int MAXD, int QG>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
best_match(const float* __restrict__ res, const float* __restrict__ queries,
           float* __restrict__ part_val, int* __restrict__ part_idx,
           unsigned* __restrict__ counters, int* __restrict__ out_idx,
           float* __restrict__ out_dist, int D, int HW, int Q, int steps, int vec) {
  constexpr int NQ4 = (MAXD + 3) / 4;  // float4 per staged query
  constexpr int TPQ = kThreads / QG;   // last block: threads per query
  __shared__ float4 sq[QG][NQ4];
  __shared__ float wval[kWarps][QG];
  __shared__ int widx[kWarps][QG];
  __shared__ bool last;

  const int slice = blockIdx.x, nslices = gridDim.x;
  const int group = blockIdx.y, ngroups = gridDim.y;
  const int b = blockIdx.z;
  const int q0 = group * QG;
  const int nq = min(QG, Q - q0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const float* const img = res + (size_t)b * D * HW;
  const int p_end = (int)min((long long)HW, (long long)(slice + 1) * steps * kStep);
  // up to D=4 the next step's loads are issued before this step's distances
  // (the first step's before the queries are staged)
  constexpr bool kPrefetch = MAXD <= 4;
  float r[MAXD][kPix], next[MAXD][kPix];
  int p = slice * steps * kStep + kPix * threadIdx.x;
  if (kPrefetch && p < p_end) load_pixels<MAXD>(img, D, HW, p, vec, next);

  // the group's queries; missing queries and channels are 0 (padded channels
  // add (0 - 0)^2 = 0 exactly; padded queries are dropped)
  float* const sqf = reinterpret_cast<float*>(sq);
  for (int i = threadIdx.x; i < QG * NQ4 * 4; i += kThreads) {
    const int q = i / (NQ4 * 4), d = i % (NQ4 * 4);
    sqf[i] = (q < nq && d < D) ? queries[((size_t)b * Q + q0 + q) * D + d] : 0.f;
  }
  __syncthreads();

  float best[QG];
  int bidx[QG];
#pragma unroll
  for (int q = 0; q < QG; ++q) {
    best[q] = CUDART_INF_F;
    bidx[q] = INT_MAX;
  }

  for (; p < p_end; p += kStep) {
    if (kPrefetch) {
#pragma unroll
      for (int d = 0; d < MAXD; ++d)
#pragma unroll
        for (int j = 0; j < kPix; ++j) r[d][j] = next[d][j];
      if (p + kStep < p_end) load_pixels<MAXD>(img, D, HW, p + kStep, vec, next);
    } else {
      load_pixels<MAXD>(img, D, HW, p, vec, r);
    }
#pragma unroll
    for (int q = 0; q < QG; ++q) {
      float qd[NQ4 * 4];
#pragma unroll
      for (int k = 0; k < NQ4; ++k) {
        const float4 v = sq[q][k];
        qd[4 * k] = v.x, qd[4 * k + 1] = v.y, qd[4 * k + 2] = v.z, qd[4 * k + 3] = v.w;
      }
      float d2[kPix];
#pragma unroll
      for (int j = 0; j < kPix; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < MAXD; ++d) {
          const float t = r[d][j] - qd[d];
          acc = fmaf(t, t, acc);
        }
        d2[j] = acc;
      }
      const float m = fminf(fminf(d2[0], d2[1]), fminf(d2[2], d2[3]));
      if (m < best[q]) {  // strict: an equal distance at a later pixel loses
        best[q] = m;
        bidx[q] = p + (d2[0] == m ? 0 : d2[1] == m ? 1 : d2[2] == m ? 2 : 3);
      }
    }
  }

  // the block's minimum per query: warps by a shuffle tree, then warps in order
#pragma unroll
  for (int q = 0; q < QG; ++q) {
    float v = best[q];
    int i = bidx[q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, off);
      const int oi = __shfl_xor_sync(0xffffffffu, i, off);
      if (better(ov, oi, v, i)) {
        v = ov;
        i = oi;
      }
    }
    if (lane == 0) {
      wval[warp][q] = v;
      widx[warp][q] = i;
    }
  }
  __syncthreads();
  // partials [B, ngroups, QG, nslices]
  const size_t pbase = ((size_t)b * ngroups + group) * QG * nslices;
  if (threadIdx.x < QG) {
    const int q = threadIdx.x;
    float v = wval[0][q];
    int i = widx[0][q];
    for (int w = 1; w < kWarps; ++w) {
      if (better(wval[w][q], widx[w][q], v, i)) {
        v = wval[w][q];
        i = widx[w][q];
      }
    }
    part_val[pbase + (size_t)q * nslices + slice] = v;
    part_idx[pbase + (size_t)q * nslices + slice] = i;
  }

  // the last block of this (image, query group) reduces its partials
  __threadfence();  // the partials are visible before the ticket is taken
  __syncthreads();
  unsigned* const counter = counters + (size_t)b * ngroups + group;
  if (threadIdx.x == 0) last = atomicAdd(counter, 1u) == (unsigned)nslices - 1u;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int q = threadIdx.x / TPQ, j = threadIdx.x % TPQ;
  float v = CUDART_INF_F;
  int i = INT_MAX;
  constexpr int kBatch = 8;  // partials in flight per thread
  for (int s0 = j; s0 < nslices; s0 += kBatch * TPQ) {
    float pv[kBatch];
    int pi[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int s = s0 + u * TPQ;
      pv[u] = s < nslices ? __ldcg(part_val + pbase + (size_t)q * nslices + s) : CUDART_INF_F;
      pi[u] = s < nslices ? __ldcg(part_idx + pbase + (size_t)q * nslices + s) : INT_MAX;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (better(pv[u], pi[u], v, i)) {
        v = pv[u];
        i = pi[u];
      }
    }
  }
#pragma unroll
  for (int off = TPQ / 2; off > 0; off >>= 1) {  // within each group of TPQ lanes
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  if (j == 0 && q < nq) {
    const size_t o = (size_t)b * Q + q0 + q;
    out_idx[o] = i == INT_MAX ? 0 : i;  // no finite distance: pixel 0, as argmin gives
    out_dist[o] = sqrtf(fmaxf(v, 0.f));
  }
  if (threadIdx.x == 0) *counter = 0u;  // ready for the next launch on this stream
}

// The shape of one launch: QG queries per block, ngroups query groups,
// nslices slices of steps * kStep pixels per (image, query group).
struct Plan {
  int qg, ngroups, nslices, steps;
};

int sm_count(int device) {
  static int cached[kMaxDevices];  // 0: not asked yet
  if (device < 0 || device >= kMaxDevices) return 0;
  if (cached[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
      return 0;
    cached[device] = n;
  }
  return cached[device];
}

int plan(int B, int D, int HW, int Q, int device, Plan* out) {
  if (D < 1 || D > kMaxD || HW < 1 || Q < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const int nsm = sm_count(device);
  if (nsm == 0) return (int)cudaErrorInvalidDevice;
  Plan p;
  p.qg = (Q > 16 && D <= 4) ? 32 : 16;
  p.ngroups = (Q + p.qg - 1) / p.qg;
  const long long total = ((long long)HW + kStep - 1) / kStep;  // steps of the image
  const long long per = (long long)B * p.ngroups;
  long long slices = (long long)nsm * kBlocksPerSm / per;  // one wave of resident blocks
  slices = slices < 1 ? 1 : (slices > total ? total : slices);
  p.steps = (int)((total + slices - 1) / slices);
  p.nslices = (int)((total + p.steps - 1) / p.steps);
  *out = p;
  return 0;
}

// Calls f(std::integral_constant<int, MAXD>) for the template of D: the
// exact D up to 4, else 8 or 16 (padded channels add (0 - 0)^2).
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

}  // namespace

extern "C" {

// The launch's shape for these arguments on `device`: out[0] slices per
// (image, query group), out[1] query groups, out[2] queries per group,
// out[3] steps of 1024 pixels per slice. The caller sizes the partials
// (B * out[1] * out[2] * out[0] floats and as many int32) and the counters
// (B * out[1] uint32, zero) from it. Returns 0 or a cudaError.
int pdc_best_match_plan(int B, int D, int HW, int Q, int device, int* out) {
  Plan p;
  const int err = plan(B, D, HW, Q, device, &p);
  if (err) return err;
  out[0] = p.nslices, out[1] = p.ngroups, out[2] = p.qg, out[3] = p.steps;
  return 0;
}

// Launches the kernel on `stream` and returns cudaGetLastError() of the
// launch (0 on success). Pointers are device pointers of contiguous tensors:
// res [B, D, HW], queries [B, Q, D], part_val/part_idx and counters as
// pdc_best_match_plan sizes them (the counters zero, and used by no other
// stream while this launch runs: the kernel leaves them zero), idx/dist
// [B, Q]. The caller has checked 1 <= D <= 16, HW >= 1, Q >= 1,
// B <= 65535 and ceil(Q / 16) <= 65535.
int pdc_best_match(const float* res, const float* queries, float* part_val, int* part_idx,
                   unsigned* counters, int* idx, float* dist, int B, int D, int HW, int Q,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Plan p;
  const int e = plan(B, D, HW, Q, device, &p);
  if (e) return e;
  const dim3 grid(p.nslices, p.ngroups, B);
  const int vec = HW % 4 == 0 && reinterpret_cast<std::uintptr_t>(res) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  by_d(D, [&](auto maxd) {
    constexpr int MAXD = decltype(maxd)::value;
    if (p.qg == 16)
      best_match<MAXD, 16><<<grid, kThreads, 0, s>>>(res, queries, part_val, part_idx, counters,
                                                     idx, dist, D, HW, Q, p.steps, vec);
    else if constexpr (MAXD <= 4)
      best_match<MAXD, 32><<<grid, kThreads, 0, s>>>(res, queries, part_val, part_idx, counters,
                                                     idx, dist, D, HW, Q, p.steps, vec);
  });
  return (int)cudaGetLastError();
}

const char* pdc_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
