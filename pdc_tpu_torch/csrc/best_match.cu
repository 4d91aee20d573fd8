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
// D subtractions more per (pixel, query) pair.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 without tensor cores):
// one read of B*HW*D*4 bytes (3.69 MB for one 640x480 D=3 image, ~1.1 us)
// against about 2*Q*HW*D + 2*Q*HW fp32 operations (~39 MFLOP at Q=16, ~0.6 us;
// ~2.5 GFLOP at Q=1024, ~38 us). Memory- and launch-bound at serving Q (<= 16),
// FMA-bound from Q of a few hundred on. Check the variant with nvidia-smi:
// the PCIe card has 2.0 TB/s and 51 TFLOP/s.
//
// Design (simple first; later work: wider query tiles, cp.async/TMA staging):
//   pass 1, grid (pixel chunks, query groups of kQG, B): the block keeps its
//     query group in shared memory; each thread walks kPixPerThread pixels in
//     increasing order (coalesced loads along each plane) and keeps a running
//     (min, idx) per query in registers, replacing only on strict <. A warp
//     shuffle and a shared-memory pass reduce the block, ties to the lower
//     index, and the block writes one partial per (chunk, query).
//   pass 2, one thread per (b, q): reduce the partials in chunk order with
//     strict <, then dist = sqrt(min).
// No atomics, so results are deterministic and reproducible. The image stays
// in the 50 MB L2 across query groups.

#include <cuda_runtime.h>

#include <climits>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPixPerThread = 4;
constexpr int kChunk = kThreads * kPixPerThread;  // pixels per pass-1 block
constexpr int kQG = 16;                           // queries per pass-1 block
constexpr int kMaxD = 16;

// (v, i) is better than (bv, bi): smaller value, or equal value and lower index
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

template <int MAXD>
__global__ void __launch_bounds__(kThreads)
best_match_partial(const float* __restrict__ res, const float* __restrict__ queries,
                   float* __restrict__ part_val, int* __restrict__ part_idx,
                   int D, int HW, int Q, int nchunks) {
  __shared__ float sq[kQG][MAXD];
  __shared__ float wval[kWarps][kQG];
  __shared__ int widx[kWarps][kQG];

  const int chunk = blockIdx.x;
  const int q0 = blockIdx.y * kQG;
  const int b = blockIdx.z;
  const int nq = min(kQG, Q - q0);

  // queries of this group; missing queries and channels are 0 (the padded
  // channels then add (0 - 0)^2 = 0 exactly, and padded queries are dropped)
  for (int i = threadIdx.x; i < kQG * MAXD; i += kThreads) {
    const int q = i / MAXD, d = i % MAXD;
    sq[q][d] = (q < nq && d < D) ? queries[((size_t)b * Q + q0 + q) * D + d] : 0.f;
  }
  __syncthreads();

  float best[kQG];
  int bidx[kQG];
#pragma unroll
  for (int q = 0; q < kQG; ++q) {
    best[q] = CUDART_INF_F;
    bidx[q] = INT_MAX;
  }

  const float* img = res + (size_t)b * D * HW;
  const int base = chunk * kChunk + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kPixPerThread; ++k) {
    const int p = base + k * kThreads;  // increasing in k: strict < keeps the first
    if (p < HW) {
      float r[MAXD];
#pragma unroll
      for (int d = 0; d < MAXD; ++d) r[d] = d < D ? __ldg(img + (size_t)d * HW + p) : 0.f;
#pragma unroll
      for (int q = 0; q < kQG; ++q) {
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < MAXD; ++d) {
          const float t = r[d] - sq[q][d];
          acc = fmaf(t, t, acc);
        }
        if (acc < best[q]) {
          best[q] = acc;
          bidx[q] = p;
        }
      }
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < kQG; ++q) {
    float v = best[q];
    int i = bidx[q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
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

  if (threadIdx.x < nq) {
    const int q = threadIdx.x;
    float v = wval[0][q];
    int i = widx[0][q];
    for (int w = 1; w < kWarps; ++w) {
      if (better(wval[w][q], widx[w][q], v, i)) {
        v = wval[w][q];
        i = widx[w][q];
      }
    }
    const size_t o = ((size_t)b * nchunks + chunk) * Q + q0 + q;  // [B, nchunks, Q]
    part_val[o] = v;
    part_idx[o] = i;
  }
}

__global__ void best_match_final(const float* __restrict__ part_val,
                                 const int* __restrict__ part_idx, int* __restrict__ out_idx,
                                 float* __restrict__ out_dist, int B, int Q, int nchunks) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * Q) return;
  const int b = (int)(t / Q), q = (int)(t % Q);
  float v = CUDART_INF_F;
  int i = INT_MAX;
  // chunks hold increasing pixel ranges and each partial already holds its
  // chunk's lowest tied index, so strict < in chunk order keeps the lowest
  for (int c = 0; c < nchunks; ++c) {
    const size_t o = ((size_t)b * nchunks + c) * Q + q;
    const float pv = part_val[o];
    if (pv < v) {
      v = pv;
      i = part_idx[o];
    }
  }
  // no finite distance at all (inf/NaN descriptors): pixel 0, as argmin gives
  out_idx[t] = i == INT_MAX ? 0 : i;
  out_dist[t] = sqrtf(fmaxf(v, 0.f));
}

}  // namespace

extern "C" {

// Pixels each pass-1 block covers; the caller sizes the partials
// [B, ceil(HW / chunk), Q] from it.
int pdc_best_match_chunk_pixels() { return kChunk; }

// Launches both passes on `stream` and returns cudaGetLastError() of the
// launches (0 on success). Pointers are device pointers of contiguous tensors:
// res [B, D, HW], queries [B, Q, D], part_val/part_idx [B, nchunks, Q],
// idx/dist [B, Q]. The caller has checked 1 <= D <= 16, HW >= 1, Q >= 1,
// B <= 65535 and ceil(Q / 16) <= 65535.
int pdc_best_match(const float* res, const float* queries, float* part_val, int* part_idx,
                   int* idx, float* dist, int B, int D, int HW, int Q, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (D < 1 || D > kMaxD || HW < 1 || Q < 1 || B < 1) return (int)cudaErrorInvalidValue;
  const int nchunks = (HW + kChunk - 1) / kChunk;
  const dim3 grid(nchunks, (Q + kQG - 1) / kQG, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 4) {
    best_match_partial<4><<<grid, kThreads, 0, s>>>(res, queries, part_val, part_idx, D, HW, Q,
                                                    nchunks);
  } else if (D <= 8) {
    best_match_partial<8><<<grid, kThreads, 0, s>>>(res, queries, part_val, part_idx, D, HW, Q,
                                                    nchunks);
  } else {
    best_match_partial<16><<<grid, kThreads, 0, s>>>(res, queries, part_val, part_idx, D, HW,
                                                     Q, nchunks);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)B * Q;
  const int threads = 256;
  best_match_final<<<(unsigned)((n + threads - 1) / threads), threads, 0, s>>>(
      part_val, part_idx, idx, dist, B, Q, nchunks);
  return (int)cudaGetLastError();
}

const char* pdc_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
