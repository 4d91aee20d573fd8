// Flash attention of the ViT backbone (K4), forward and backward, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no ViT. Added because the ViT
// step's attention ran in PyTorch's scaled_dot_product_attention (its
// memory-efficient CUTLASS kernels), which is not a kernel of this repository
// and took 29% of the step's device time. For each frame b and head h, with q,
// k, v the [N, d] slices of the qkv projection's output [B, N, 3, heads, d]:
//
//   forward:  o = softmax(scale * q k^T) v,  lse_i = log2 sum_j 2^(s_ij)
//             (s = scale * log2(e) * q k^T, the row's log-sum-exp in base 2)
//   backward: p = 2^(s - lse), delta_i = sum_c do_ic o_ic,
//             ds = p * (do v^T - delta),
//             dq = scale * ds k,  dk = scale * ds^T q,  dv = p^T do
//
// No N x N tensor reaches device memory: the backward recomputes p from lse.
//
// Bound on an H100 SXM: the products. At the ViT cell's shapes (B=8 frames,
// 16 heads, N=1615, d=64) a block's forward and backward read and write
// 0.42 GB (0.13 ms at 3.35 TB/s) against 0.256 TFLOP of N x N x d products
// (q k^T and p v forward; dp, dv, dk, dq backward): 3.83 ms at the 67 TFLOP/s
// of fp32 outside the tensor cores, 1.55 ms at the 165 TFLOP/s that split-fp32
// allows (495 TFLOP/s of TF32 over three products). The backward recomputes
// q k^T in both of its passes and do v^T in the second too: 0.128 TFLOP more.
//
// Arithmetic. float32 inputs: every product runs as split-fp32 (3xTF32, as
// PyTorch's memory-efficient kernel does with CUTLASS's OpMultiplyAddFastF32):
// each operand x becomes hi = x with the low 13 bits of its mantissa cleared
// (its TF32 part, truncated: one logical operation) and lo = x - hi (exact in
// fp32; the tensor core reads its top 19 bits), and a b ~ a_lo b_hi + a_hi b_lo
// + a_hi b_hi, the small products first. The split is made where each
// fragment is loaded, by every warp; cvt.rna.tf32.f32 in its place runs on the
// conversion units and held the kernels a quarter longer, and splitting each
// walked tile once into shared memory saved less than it cost (H100). Each
// tile's product starts from a zeroed accumulator and is added to the running
// sum in fp32 by the FMA units: summed over a whole walk in the tensor cores'
// accumulator, the split's low bits were lost (7 times the error). The
// plain-TF32 mode (one product of the TF32 parts) exists for the test that shows
// split-fp32 is needed. bfloat16 inputs: widened to fp32
// in shared memory (exact in TF32), one product each, p and ds rounded to
// bfloat16 before their products (as SDPA's flash kernel does), fp32
// accumulation. The softmax, its running max and sum, lse, delta and every
// accumulator are fp32.
//
// Design (FlashAttention-2, Dao 2023), on mma.sync m16n8k8 TF32 tiles:
//  * a block is 4 warps; each warp owns 16 rows of the block's 64 (queries in
//    the forward and dq, keys in dk/dv) and walks tiles of 64 rows of the
//    other side, double-buffered in shared memory by cp.async, so the next
//    tile's load overlaps this tile's products;
//  * q, k and v are read where the qkv projection put them (a row stride of
//    3*C, heads side by side), o and the gradient are written where the next
//    layer reads them: no permute, transpose or stack copies around the call;
//  * shared-memory rows are d + 4 floats: ldmatrix reads the row-major
//    fragments (a warp's 8 row addresses fall in distinct banks) and the
//    scalar column-order reads (rows 2t and 2t+1, column g) are conflict-free;
//  * the C fragment of a product (row g, columns 2t and 2t+1) is reused as the
//    A fragment of the next (columns t and t+4) by numbering the next
//    product's k dimension in that order, its B rows read in the same order:
//    p, ds and their transposes never pass through shared memory;
//  * forward: one launch, a block per (64 queries, frame and head) holds its
//    q tile split in registers, walks the key tiles with an online softmax in
//    base 2 and writes o and lse;
//  * backward: two launches, no atomics, so a run repeats bit for bit.
//    flash_bwd_dq (a block per 64 queries) computes delta for its rows (the
//    rowsum pass, folded into the block that owns the rows), stores it, and
//    walks the key tiles for dq; flash_bwd_dkdv (a block per 64 keys) walks
//    the query tiles for dk and dv. Both write into one [B, N, 3*C] gradient
//    of the qkv projection, in q's, k's and v's places;
//  * head dims d that are multiples of 16 up to 128 run in tiles of the next
//    power of two (16, 32, 64, 128), the columns past d loaded as zeros and
//    never stored; the ragged last tile of rows is masked (zeros loaded, -inf
//    scores, nothing stored).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

// One library a build: FLASH_MODE, the products (2: float32 at split-fp32, 1:
// float32 in plain TF32, 0: bfloat16), and FLASH_DIM, the head dims' tile (16,
// 32, 64 or 128), so that a caller compiles only the kernels it runs.
#ifndef FLASH_MODE
#define FLASH_MODE 2
#endif
#ifndef FLASH_DIM
#define FLASH_DIM 64
#endif

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kOwn = 16 * kWarps;  // rows a block owns, 16 a warp
constexpr int kWalk = 64;          // rows of a walked tile

// products: split-fp32, one TF32 product (test fault), exact (bf16 values)
enum Mode { kExact = 0, kTf32 = 1, kSplit = 2 };

// x with the low 13 bits of its mantissa cleared: its TF32 part, truncated
// (|x - hi| < 2^-10 |x|).
__device__ __forceinline__ uint32_t to_tf32(float x) { return __float_as_uint(x) & 0xffffe000u; }

template <int MODE>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (MODE == kExact) {
    hi = __float_as_uint(x);
  } else {
    hi = to_tf32(x);
    if (MODE == kSplit) lo = __float_as_uint(x - __uint_as_float(hi));
  }
}

// an operand fragment: A (4 registers) or B (2), its TF32 high part and the
// remainder (split-fp32 only)
template <int N>
struct Frag {
  uint32_t hi[N], lo[N];
};

template <int MODE>
__device__ __forceinline__ Frag<4> frag_a(float a0, float a1, float a2, float a3) {
  Frag<4> f;
  split<MODE>(a0, f.hi[0], f.lo[0]);
  split<MODE>(a1, f.hi[1], f.lo[1]);
  split<MODE>(a2, f.hi[2], f.lo[2]);
  split<MODE>(a3, f.hi[3], f.lo[3]);
  return f;
}

template <int MODE>
__device__ __forceinline__ Frag<2> frag_b(float b0, float b1) {
  Frag<2> f;
  split<MODE>(b0, f.hi[0], f.lo[0]);
  split<MODE>(b1, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b: the small products first, then the large one
template <int MODE>
__device__ __forceinline__ void product(float (&c)[4], const Frag<4>& a, const Frag<2>& b) {
  if (MODE == kSplit) {
    mma(c, a.lo, b.hi);
    mma(c, a.hi, b.lo);
  }
  mma(c, a.hi, b.hi);
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// The A fragment (rows r0..r0+15, k columns k0..k0+7) of a row-major tile of
// row stride S: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4).
template <int MODE, int S>
__device__ __forceinline__ Frag<4> load_a(const float* tile, int r0, int k0, int lane) {
  const int mat = lane >> 3;
  uint32_t r[4];
  ldsm4(r, tile + (r0 + (mat & 1) * 8 + (lane & 7)) * S + k0 + (mat >> 1) * 4);
  return frag_a<MODE>(__uint_as_float(r[0]), __uint_as_float(r[1]), __uint_as_float(r[2]),
                      __uint_as_float(r[3]));
}

// The B fragments of two n-tiles (rows n0..n0+7 and n0+8..n0+15 of a
// row-major tile, k columns k0..k0+7): b0 (k=t, n=g), b1 (k=t+4, n=g).
template <int MODE, int S>
__device__ __forceinline__ void load_b_rows(Frag<2>& f0, Frag<2>& f1, const float* tile, int n0,
                                            int k0, int lane) {
  const int mat = lane >> 3;
  uint32_t r[4];
  ldsm4(r, tile + (n0 + (mat >> 1) * 8 + (lane & 7)) * S + k0 + (mat & 1) * 4);
  f0 = frag_b<MODE>(__uint_as_float(r[0]), __uint_as_float(r[1]));
  f1 = frag_b<MODE>(__uint_as_float(r[2]), __uint_as_float(r[3]));
}

// The B fragment of k rows k0..k0+7 and columns n0..n0+7 of a row-major tile,
// k numbered as a C fragment's columns reused as an A fragment: slot t is row
// k0 + 2t, slot t+4 is row k0 + 2t + 1.
template <int MODE, int S>
__device__ __forceinline__ Frag<2> load_b_cols(const float* tile, int k0, int n0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const float* p = tile + (k0 + 2 * t) * S + n0 + g;
  return frag_b<MODE>(p[0], p[S]);
}

// A C fragment (row g: c0, c1 at columns 2t, 2t+1; row g+8: c2, c3) as the A
// fragment of the next product, in load_b_cols's k order.
template <int MODE>
__device__ __forceinline__ Frag<4> c_as_a(const float (&c)[4]) {
  return frag_a<MODE>(c[0], c[2], c[1], c[3]);
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src, bool valid) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ float round_to(float x) {
  if (std::is_same<T, __nv_bfloat16>::value) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

// Rows row0..row0+ROWS-1 of an array of n rows (row stride `stride` elements,
// columns 0..dv-1 real) into a [ROWS][D+4] float tile; zeros past n and dv.
// float32 goes by cp.async (16 bytes a copy); bfloat16 is widened to float
// on the way, by plain loads and stores.
template <typename T, int ROWS, int D>
__device__ __forceinline__ void load_tile(float* tile, const T* base, int row0, int n,
                                          long long stride, int dv) {
  constexpr int S = D + 4;
  if constexpr (std::is_same<T, float>::value) {
    constexpr int C = D / 4;
    for (int i = threadIdx.x; i < ROWS * C; i += kThreads) {
      const int r = i / C, c = (i % C) * 4;
      const bool ok = row0 + r < n && c < dv;
      const float* src = ok ? base + (row0 + r) * stride + c : base;
      cp_async16(tile + r * S + c, src, ok);
    }
  } else {
    constexpr int C = D / 8;
    for (int i = threadIdx.x; i < ROWS * C; i += kThreads) {
      const int r = i / C, c = (i % C) * 8;
      float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
      if (row0 + r < n && c < dv) {
        const uint4 u = *reinterpret_cast<const uint4*>(base + (row0 + r) * stride + c);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
        const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
        const float2 e = __bfloat1622float2(h[2]), f = __bfloat1622float2(h[3]);
        lo = make_float4(a.x, a.y, b.x, b.y);
        hi = make_float4(e.x, e.y, f.x, f.y);
      }
      *reinterpret_cast<float4*>(tile + r * S + c) = lo;
      *reinterpret_cast<float4*>(tile + r * S + c + 4) = hi;
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// A warp's [16, D] accumulator (rows r and r+8 of its lanes, columns 8j+2t
// and 8j+2t+1) into rows of an array (row stride `stride`), times `mul`,
// within n rows and dv columns.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base, const float (&acc)[D / 8][4], int r, int n,
                                           long long stride, int dv, float mul0, float mul1,
                                           int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (c >= dv) continue;
    if (r < n) store2(base + r * stride + c, acc[j][0] * mul0, acc[j][1] * mul0);
    if (r + 8 < n) store2(base + (r + 8) * stride + c, acc[j][2] * mul1, acc[j][3] * mul1);
  }
}

template <int D>
constexpr int fwd_smem_floats() {
  return (kOwn + 4 * kWalk) * (D + 4);  // q; k and v, two stages
}
template <int D>
constexpr int bwd_smem_floats() {
  // two kept tiles, two walked in two stages; lse, delta
  return (2 * kOwn + 4 * kWalk) * (D + 4) + 4 * kWalk;
}

// ---------------------------------------------------------------------------
// forward: grid (query tiles, B * heads)

template <typename T, int D, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd(const T* __restrict__ qkv, T* __restrict__ o, float* __restrict__ lse, int n,
              int heads, int dv, long long sqb, long long sqn, long long sob, long long son,
              float scale_log2) {
  constexpr int S = D + 4, KD = D / 8, NT = kWalk / 8;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [kOwn][S]
  float* ks = qs + kOwn * S;         // [2][kWalk][S]
  float* vs = ks + 2 * kWalk * S;    // [2][kWalk][S]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int m0 = blockIdx.x * kOwn;
  const T* qb = qkv + b * sqb + (long long)h * dv;
  const T* kb = qb + (long long)heads * dv;
  const T* vb = kb + (long long)heads * dv;

  // the q tile, then the first k and v tiles
  load_tile<T, kOwn, D>(qs, qb, m0, n, sqn, dv);
  cp_commit();
  load_tile<T, kWalk, D>(ks, kb, 0, n, sqn, dv);
  load_tile<T, kWalk, D>(vs, vb, 0, n, sqn, dv);
  cp_commit();
  cp_wait<1>();
  __syncthreads();
  Frag<4> qf[KD];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    qf[kk] = load_a<MODE, S>(qs, warp * 16, kk * 8, lane);

  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float acc[KD][4];
#pragma unroll
  for (int j = 0; j < KD; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int tiles = (n + kWalk - 1) / kWalk;
  for (int it = 0; it < tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < tiles) {
      load_tile<T, kWalk, D>(ks + (st ^ 1) * kWalk * S, kb, (it + 1) * kWalk, n, sqn, dv);
      load_tile<T, kWalk, D>(vs + (st ^ 1) * kWalk * S, vb, (it + 1) * kWalk, n, sqn, dv);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* kt = ks + st * kWalk * S;
    const float* vt = vs + st * kWalk * S;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        Frag<2> b0, b1;
        load_b_rows<MODE, S>(b0, b1, kt, np * 16, kk * 8, lane);
        product<MODE>(s[2 * np], qf[kk], b0);
        product<MODE>(s[2 * np + 1], qf[kk], b1);
      }
    }

    // the online softmax, base 2
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = it * kWalk + j * 8 + 2 * t + e < n;
        s[j][e] = ok ? s[j][e] * scale_log2 : -INFINITY;
        s[j][2 + e] = ok ? s[j][2 + e] * scale_log2 : -INFINITY;
        mx[0] = fmaxf(mx[0], s[j][e]);
        mx[1] = fmaxf(mx[1], s[j][2 + e]);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m_run[r] - mx[r]);
      m_run[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - mx[e >> 1]);
        sum[e >> 1] += p;
        s[j][e] = round_to<T>(p);
      }
    }
    l_run[0] = l_run[0] * alpha[0] + sum[0];
    l_run[1] = l_run[1] * alpha[1] + sum[1];

    // this tile's p v, added to the rescaled o
    float pv[KD][4];
#pragma unroll
    for (int j = 0; j < KD; ++j) pv[j][0] = pv[j][1] = pv[j][2] = pv[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const Frag<4> a = c_as_a<MODE>(s[kk]);
#pragma unroll
      for (int j = 0; j < KD; ++j)
        product<MODE>(pv[j], a, load_b_cols<MODE, S>(vt, kk * 8, j * 8, lane));
    }
#pragma unroll
    for (int j = 0; j < KD; ++j) {
      acc[j][0] = fmaf(acc[j][0], alpha[0], pv[j][0]);
      acc[j][1] = fmaf(acc[j][1], alpha[0], pv[j][1]);
      acc[j][2] = fmaf(acc[j][2], alpha[1], pv[j][2]);
      acc[j][3] = fmaf(acc[j][3], alpha[1], pv[j][3]);
    }
    __syncthreads();  // the next iteration's loads overwrite this stage
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const int row = m0 + warp * 16 + g;
  store_rows<T, D>(o + b * sob + (long long)h * dv, acc, row, n, son, dv, 1.f / l_run[0],
                   1.f / l_run[1], lane);
  if (t == 0) {
    float* l = lse + (long long)bh * n;
    if (row < n) l[row] = m_run[0] + log2f(l_run[0]);
    if (row + 8 < n) l[row + 8] = m_run[1] + log2f(l_run[1]);
  }
}

// ---------------------------------------------------------------------------
// backward, dq (and delta): grid (query tiles, B * heads)

template <typename T, int D, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq(const T* __restrict__ qkv, const T* __restrict__ o, const T* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ delta, T* __restrict__ dqkv,
                 int n, int heads, int dv, long long sqb, long long sqn, long long sob,
                 long long son, long long sgb, long long sgn, float scale, float scale_log2) {
  constexpr int S = D + 4, KD = D / 8, NT = kWalk / 8;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [kOwn][S], kept
  float* ds = qs + kOwn * S;         // [kOwn][S] (do), kept
  float* ks = ds + kOwn * S;         // [2][kWalk][S]
  float* vs = ks + 2 * kWalk * S;    // [2][kWalk][S]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int m0 = blockIdx.x * kOwn;
  const T* qb = qkv + b * sqb + (long long)h * dv;
  const T* kb = qb + (long long)heads * dv;
  const T* vb = kb + (long long)heads * dv;
  const T* ob = o + b * sob + (long long)h * dv;
  const T* dob = dout + b * sob + (long long)h * dv;

  load_tile<T, kOwn, D>(qs, qb, m0, n, sqn, dv);
  load_tile<T, kOwn, D>(ds, dob, m0, n, son, dv);
  load_tile<T, kWalk, D>(ks, kb, 0, n, sqn, dv);
  load_tile<T, kWalk, D>(vs, vb, 0, n, sqn, dv);
  cp_commit();

  // delta = rowsum(do * o) of the warp's 16 rows: two lanes a row
  const int rl = warp * 16 + (lane >> 1), half = lane & 1;
  float dsum = 0.f;
  if (m0 + rl < n) {
    const T* pd = dob + (m0 + rl) * son;
    const T* po = ob + (m0 + rl) * son;
    for (int c = half; c < dv; c += 2) dsum += to_float(pd[c]) * to_float(po[c]);
  }
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
  if (half == 0 && m0 + rl < n) delta[(long long)bh * n + m0 + rl] = dsum;
  const int row = m0 + warp * 16 + g;
  const float delta0 = __shfl_sync(0xffffffffu, dsum, 2 * g);
  const float delta1 = __shfl_sync(0xffffffffu, dsum, 2 * (g + 8));
  const float lse0 = row < n ? lse[(long long)bh * n + row] : 0.f;
  const float lse1 = row + 8 < n ? lse[(long long)bh * n + row + 8] : 0.f;

  float dq[KD][4];
#pragma unroll
  for (int j = 0; j < KD; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  const int tiles = (n + kWalk - 1) / kWalk;
  for (int it = 0; it < tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < tiles) {
      load_tile<T, kWalk, D>(ks + (st ^ 1) * kWalk * S, kb, (it + 1) * kWalk, n, sqn, dv);
      load_tile<T, kWalk, D>(vs + (st ^ 1) * kWalk * S, vb, (it + 1) * kWalk, n, sqn, dv);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* kt = ks + st * kWalk * S;
    const float* vt = vs + st * kWalk * S;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const Frag<4> a = load_a<MODE, S>(qs, warp * 16, kk * 8, lane);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        Frag<2> b0, b1;
        load_b_rows<MODE, S>(b0, b1, kt, np * 16, kk * 8, lane);
        product<MODE>(s[2 * np], a, b0);
        product<MODE>(s[2 * np + 1], a, b1);
      }
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const Frag<4> a = load_a<MODE, S>(ds, warp * 16, kk * 8, lane);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        Frag<2> b0, b1;
        load_b_rows<MODE, S>(b0, b1, vt, np * 16, kk * 8, lane);
        product<MODE>(dp[2 * np], a, b0);
        product<MODE>(dp[2 * np + 1], a, b1);
      }
    }
    // ds = p (dp - delta), into s
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = it * kWalk + j * 8 + 2 * t + (e & 1) < n;
        const float p = ok ? exp2f(s[j][e] * scale_log2 - (e < 2 ? lse0 : lse1)) : 0.f;
        s[j][e] = round_to<T>(p * (dp[j][e] - (e < 2 ? delta0 : delta1)));
      }
    }
    // dq += ds k
    float part[KD][4];
#pragma unroll
    for (int j = 0; j < KD; ++j) part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const Frag<4> a = c_as_a<MODE>(s[kk]);
#pragma unroll
      for (int j = 0; j < KD; ++j)
        product<MODE>(part[j], a, load_b_cols<MODE, S>(kt, kk * 8, j * 8, lane));
    }
#pragma unroll
    for (int j = 0; j < KD; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[j][e] += part[j][e];
    __syncthreads();
  }
  store_rows<T, D>(dqkv + b * sgb + (long long)h * dv, dq, row, n, sgn, dv, scale, scale, lane);
}

// ---------------------------------------------------------------------------
// backward, dk and dv: grid (key tiles, B * heads); delta from flash_bwd_dq

template <typename T, int D, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dkdv(const T* __restrict__ qkv, const T* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   T* __restrict__ dqkv, int n, int heads, int dv, long long sqb, long long sqn,
                   long long sob, long long son, long long sgb, long long sgn, float scale,
                   float scale_log2) {
  constexpr int S = D + 4, KD = D / 8, NT = kWalk / 8;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                  // [kOwn][S], kept
  float* vt = kt + kOwn * S;         // [kOwn][S], kept
  float* qs = vt + kOwn * S;         // [2][kWalk][S]
  float* ds = qs + 2 * kWalk * S;    // [2][kWalk][S] (do)
  float* ls = ds + 2 * kWalk * S;    // [2][kWalk] lse
  float* es = ls + 2 * kWalk;        // [2][kWalk] delta
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t = lane & 3, g = lane >> 2;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int n0 = blockIdx.x * kOwn;
  const T* qb = qkv + b * sqb + (long long)h * dv;
  const T* kb = qb + (long long)heads * dv;
  const T* vb = kb + (long long)heads * dv;
  const T* dob = dout + b * sob + (long long)h * dv;
  const float* lb = lse + (long long)bh * n;
  const float* eb = delta + (long long)bh * n;

  auto load_rows = [&](int stage, int row0) {
    load_tile<T, kWalk, D>(qs + stage * kWalk * S, qb, row0, n, sqn, dv);
    load_tile<T, kWalk, D>(ds + stage * kWalk * S, dob, row0, n, son, dv);
    if (threadIdx.x < kWalk) {
      const int r = row0 + threadIdx.x;
      ls[stage * kWalk + threadIdx.x] = r < n ? lb[r] : 0.f;
      es[stage * kWalk + threadIdx.x] = r < n ? eb[r] : 0.f;
    }
  };
  load_tile<T, kOwn, D>(kt, kb, n0, n, sqn, dv);
  load_tile<T, kOwn, D>(vt, vb, n0, n, sqn, dv);
  load_rows(0, 0);
  cp_commit();

  float dk[KD][4], dvv[KD][4];
#pragma unroll
  for (int j = 0; j < KD; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dvv[j][e] = 0.f;

  const int tiles = (n + kWalk - 1) / kWalk;
  for (int it = 0; it < tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < tiles) load_rows(st ^ 1, (it + 1) * kWalk);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const float* qt = qs + st * kWalk * S;
    const float* dt = ds + st * kWalk * S;
    const float* lt = ls + st * kWalk;
    const float* et = es + st * kWalk;

    // s^T = k q^T: the warp's 16 keys against the tile's 64 queries
    float p[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const Frag<4> a = load_a<MODE, S>(kt, warp * 16, kk * 8, lane);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        Frag<2> b0, b1;
        load_b_rows<MODE, S>(b0, b1, qt, np * 16, kk * 8, lane);
        product<MODE>(p[2 * np], a, b0);
        product<MODE>(p[2 * np + 1], a, b1);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = j * 8 + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(lt + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = it * kWalk + c + (e & 1) < n;
        p[j][e] = ok ? round_to<T>(exp2f(p[j][e] * scale_log2 - ((e & 1) ? l2.y : l2.x)))
                     : 0.f;
      }
    }
    // dv += p^T do
    {
      float part[KD][4];
#pragma unroll
      for (int j = 0; j < KD; ++j) part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        const Frag<4> a = c_as_a<MODE>(p[kk]);
#pragma unroll
        for (int j = 0; j < KD; ++j)
          product<MODE>(part[j], a, load_b_cols<MODE, S>(dt, kk * 8, j * 8, lane));
      }
#pragma unroll
      for (int j = 0; j < KD; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dvv[j][e] += part[j][e];
    }
    // dp^T = v do^T, then ds^T = p^T (dp^T - delta), into p
    {
      float dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const Frag<4> a = load_a<MODE, S>(vt, warp * 16, kk * 8, lane);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          Frag<2> b0, b1;
          load_b_rows<MODE, S>(b0, b1, dt, np * 16, kk * 8, lane);
          product<MODE>(dp[2 * np], a, b0);
          product<MODE>(dp[2 * np + 1], a, b1);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 e2 = *reinterpret_cast<const float2*>(et + j * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[j][e] = round_to<T>(p[j][e] * (dp[j][e] - ((e & 1) ? e2.y : e2.x)));
      }
    }
    // dk += ds^T q
    {
      float part[KD][4];
#pragma unroll
      for (int j = 0; j < KD; ++j) part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        const Frag<4> a = c_as_a<MODE>(p[kk]);
#pragma unroll
        for (int j = 0; j < KD; ++j)
          product<MODE>(part[j], a, load_b_cols<MODE, S>(qt, kk * 8, j * 8, lane));
      }
#pragma unroll
      for (int j = 0; j < KD; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[j][e] += part[j][e];
    }
    __syncthreads();
  }
  T* gb = dqkv + b * sgb + (long long)h * dv;
  const int row = n0 + warp * 16 + g;
  store_rows<T, D>(gb + (long long)heads * dv, dk, row, n, sgn, dv, scale, scale, lane);
  store_rows<T, D>(gb + 2LL * heads * dv, dvv, row, n, sgn, dv, 1.f, 1.f, lane);
}

// ---------------------------------------------------------------------------
// dispatch on the dtype, the mode and the head dim's tile width

struct Args {
  const void* qkv;
  const void* o;
  const void* dout;
  void* out;  // o (forward) or dqkv (backward)
  float* lse;
  float* delta;
  int batch, n, heads, dv;
  long long sqb, sqn, sob, son, sgb, sgn;
  float scale, scale_log2;
  cudaStream_t stream;
};

template <typename T, int D, int MODE>
int run(const Args& a, bool forward) {
  const dim3 grid((a.n + kOwn - 1) / kOwn, a.batch * a.heads);
  const T* qkv = static_cast<const T*>(a.qkv);
  if (forward) {
    flash_fwd<T, D, MODE><<<grid, kThreads, fwd_smem_floats<D>() * sizeof(float), a.stream>>>(
        qkv, static_cast<T*>(a.out), a.lse, a.n, a.heads, a.dv, a.sqb, a.sqn, a.sob, a.son,
        a.scale_log2);
    return (int)cudaGetLastError();
  }
  const size_t smem = bwd_smem_floats<D>() * sizeof(float);
  flash_bwd_dq<T, D, MODE><<<grid, kThreads, smem, a.stream>>>(
      qkv, static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.lse, a.delta,
      static_cast<T*>(a.out), a.n, a.heads, a.dv, a.sqb, a.sqn, a.sob, a.son, a.sgb, a.sgn,
      a.scale, a.scale_log2);
  int err = (int)cudaGetLastError();
  if (err) return err;
  flash_bwd_dkdv<T, D, MODE><<<grid, kThreads, smem, a.stream>>>(
      qkv, static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.out), a.n, a.heads,
      a.dv, a.sqb, a.sqn, a.sob, a.son, a.sgb, a.sgn, a.scale, a.scale_log2);
  return (int)cudaGetLastError();
}

template <typename T, int D, int MODE>
int allow_smem() {
  int err = (int)cudaFuncSetAttribute(flash_fwd<T, D, MODE>,
                                      cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      fwd_smem_floats<D>() * (int)sizeof(float));
  if (!err)
    err = (int)cudaFuncSetAttribute(flash_bwd_dq<T, D, MODE>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    bwd_smem_floats<D>() * (int)sizeof(float));
  if (!err)
    err = (int)cudaFuncSetAttribute(flash_bwd_dkdv<T, D, MODE>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    bwd_smem_floats<D>() * (int)sizeof(float));
  return err;
}

// f.call<T, D, MODE>() for this library's products and tile
template <typename F>
int by_kind(const F& f) {
  using T = std::conditional_t<FLASH_MODE == kExact, __nv_bfloat16, float>;
  return f.template call<T, FLASH_DIM, FLASH_MODE>();
}

struct Prepare {
  template <typename T, int D, int M>
  int call() const {
    return allow_smem<T, D, M>();
  }
};

struct Launch {
  const Args& a;
  bool forward;
  template <typename T, int D, int M>
  int call() const {
    return run<T, D, M>(a, forward);
  }
};

int check(int device, int dtype, int split, int batch, int n, int heads, int dv) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int tile = dv <= 16 ? 16 : dv <= 32 ? 32 : dv <= 64 ? 64 : 128;
  const int mode = dtype == 1 ? kExact : split ? kSplit : kTf32;
  if (mode != FLASH_MODE || tile != FLASH_DIM || n < 1 || heads < 1 || batch < 1 ||
      dv > 128 || dv % 16 || (long long)batch * heads > 65535)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

// Allows this library's kernels their dynamic shared memory on `device`;
// once a device, before the first launch.
int pdc_flash_prepare(int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return by_kind(Prepare{});
}

// Forward. qkv [B, N, 3*heads*dv] (strides sqb, sqn; last dimension
// contiguous), o [B, N, heads*dv] (strides sob, son), lse [B*heads, N] float.
// dtype 0 float32, 1 bfloat16; split 1 for split-fp32 products (float32).
// Products or a head dim of another library's build are refused
// (cudaErrorInvalidValue). Returns cudaGetLastError() of the launch.
int pdc_flash_fwd(int dtype, int split, const void* qkv, void* o, float* lse, int batch, int n,
                  int heads, int dv, long long sqb, long long sqn, long long sob, long long son,
                  float scale_log2, int device, void* stream) {
  int err = check(device, dtype, split, batch, n, heads, dv);
  if (err) return err;
  Args a{qkv, nullptr, nullptr, o, lse, nullptr, batch, n, heads, dv, sqb, sqn, sob, son, 0, 0,
         0.f, scale_log2, static_cast<cudaStream_t>(stream)};
  return by_kind(Launch{a, true});
}

// Backward: dq with delta, then dk and dv. o and dout share strides (sob,
// son); dqkv [B, N, 3*heads*dv] (strides sgb, sgn); delta [B*heads, N] float
// scratch.
int pdc_flash_bwd(int dtype, int split, const void* qkv, const void* o, const void* dout,
                  const float* lse, float* delta, void* dqkv, int batch, int n, int heads, int dv,
                  long long sqb, long long sqn, long long sob, long long son, long long sgb,
                  long long sgn, float scale, float scale_log2, int device, void* stream) {
  int err = check(device, dtype, split, batch, n, heads, dv);
  if (err) return err;
  Args a{qkv, o, dout, dqkv, const_cast<float*>(lse), delta, batch, n, heads, dv, sqb, sqn, sob,
         son, sgb, sgn, scale, scale_log2, static_cast<cudaStream_t>(stream)};
  return by_kind(Launch{a, false});
}

const char* pdc_flash_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
