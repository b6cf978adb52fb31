// Flash attention forward and backward for Hopper (sm_90a): three kernels,
// each in a float32 (CUDA-core) and a bfloat16 (tensor-core) body.
//
// Replaces the TPU kernels of mpi_tensorflow_tpu/ops/flash_attention.py:
//   flash_fwd_kernel  <- _flash_fwd_kernel  (pl.pallas_call in _flash_forward)
//   flash_dq_kernel   <- _flash_dq_kernel   (first pl.pallas_call in
//                                             _flash_backward)
//   flash_dkdv_kernel <- _flash_dkdv_kernel (second pl.pallas_call in
//                                             _flash_backward)
// and computes what they compute, for q, k, v of shape (B*H, S, D):
//
//   forward   s = scale * q k^T  (masked: col >= S, or col > row if causal)
//             out = softmax(s) v,  lse = m + log(l)      (per query row)
//   dq        p = exp(s - lse),  ds = p * (dO v^T - delta) * scale,
//             dq = ds k
//   dk, dv    dv = p^T dO,  dk = ds^T q
//
// where delta = rowsum(dO * out) is computed in float32 outside the
// kernels, as the TPU version leaves it to XLA.  Rounding points follow
// the TPU kernels: scores, p, dp, ds, m, l and lse are float32; p is
// rounded to v's type before p.v and to dO's type before dV; ds stays
// float32 in dq += ds k and dk += ds^T q (k and q upcast to float32); the
// output is acc / (l or 1) in q's type.  lse is stored as (B*H, S) float32
// (the TPU kernel's lane-broadcast copies of it are a layout artifact).
//
// Design.  The TPU kernels walk a sequential (b*h, q-block, k-block) grid
// on one core and carry the online softmax's max, sum and accumulator in
// VMEM scratch from one grid step to the next.  Hopper blocks run in
// parallel and in no order, so nothing carries between them.  Here one CTA
// owns one (b*h, 64-query tile) for the forward and dq, or one (b*h, 64-key
// tile) for dk/dv, and loops over the other axis itself: under `causal`
// the forward and dq stop at the diagonal tile (the TPU kernel's last_k),
// and dk/dv start at it (first_q).  Rows past S are zero-filled and every
// score of such a row or column is masked to p = 0 before the exp (exp(0 -
// lse) is not 0), so S needs no padding.  dq and dk/dv stay two kernels:
// no atomics, so dq is deterministic.
//
// In float32 all three run on the CUDA cores (flash_fwd_kernel,
// flash_dq_kernel, flash_dkdv_kernel): tiles staged in shared memory as
// float32 with an odd row stride; 256 threads form a 16 x 16 grid, each
// computing a 4 x 4 micro-tile of the 64 x 64 score block (rows ty*4..,
// columns tx + 16 j) and owning 4 rows x D/16 columns of the float32
// accumulators; row statistics are reduced across a half-warp with
// shuffles.  Float32 stays there because tensor cores would mean TF32 (10
// mantissa bits).
//
// In bfloat16 all three run on the tensor cores (flash_fwd_kernel_tc,
// flash_dq_kernel_tc, flash_dkdv_kernel_tc; helpers in hopper_mma.cuh).
// One warpgroup of 128 threads per 64-row tile (the forward: two of them
// in a CTA of a 128-row tile, sharing the streamed K and V tiles); Q, K,
// V, dO tiles are bf16 in shared memory, 128B-swizzled, the head dim
// zero-padded to kD = 64 or 128 (zeros add nothing); the streamed tiles
// are cp.async copies (16 bytes a thread, zero-filled past S and D; rows
// that are not 16-byte aligned, D % 8 != 0, are gathered element-wise),
// double-buffered in the backward and triple-buffered in the forward, that
// run under the current tile's products.  Products are wgmma m64nNk16
// bf16 -> float32:
//
//   product                      A (64 rows)            B
//   s = q k^T, dp = dO v^T       q, dO: smem K-major    k, v: K-major
//   s^T = k q^T, dp^T = v dO^T   k, v: smem K-major     q, dO: K-major
//   out += p v                   p: registers           v: MN-major
//   dq += ds k                   ds hi, lo: registers   k: MN-major
//   dv += p^T dO, dk += ds^T q   p^T; ds^T hi, lo: reg. dO, q: MN-major
//
// The forward keeps the TPU kernel's online softmax in the fragment
// layout: each thread holds two rows (16 warp + lane / 4, and + 8); their
// max and sum are reduced over the 4 lanes of a quad.  Per key tile:
// s = scale q k^T, masked scores set so that p = 0, m_new = max(m,
// rowmax s), p = exp(s - m_new), l = l corr + sum p over the unrounded
// float32 p, then -- once the previous tile's p v has completed -- acc *=
// corr and acc += bf16(p) v.  The key tiles are walked in order in one
// CTA, so the running max, and with it every bf16 rounding of p, is the
// TPU kernel's.  With D = 64 the exps and their float32 arithmetic, not
// the products, are the longer part of a tile, so each score costs one
// FMUL (scale), one FMAX, one FFMA and one ex2: p = 2^(s log2(e) - m
// log2(e)), masked scores being -inf (2^-inf = 0; m is finite from the
// first tile on, whose column 0 every row sees).
//
// The register operands are the score accumulators' own fragments
// converted in place (no shared-memory round trip); lse and delta are
// indexed through the same fragment layout.  Every exp runs on ex2.approx
// (within 2 ulp of float32, far below the bf16 rounding of what follows;
// the accurate expf costs dq a visible share of its time): __expf in the
// backward's p = exp(s - lse), the FFMA form above in the forward.  ds stays
// float32 in its two products: it is split into hi = bf16(ds) and lo =
// bf16(ds - hi), and both are issued into one float32 accumulator, so the
// sum is ds k to ~2^-16 relative -- one extra product per kernel (dq: s,
// dp, 2 x ds k; dk/dv: s^T, dp^T, dv, 2 x ds^T q).  Occupancy at kD = 64:
// the forward fits 2 CTAs of 256 threads an SM (65 KB of shared memory,
// 121 registers), dq 4 of 128 (50 KB); dk/dv is held to 3 by
// __launch_bounds__ (left alone ptxas gives it registers for 2 only, which
// is slower).  Each warpgroup waits on its own products: a forward whose
// p v stayed in flight under the next tile's q k^T made ptxas serialize
// the wgmmas (C7515) and measured no faster.
//
// What bounds it.  Operations: at S = 4096, D = 64 each product is 2 S^2 D
// flops per (b, h), far past the H100's ~295 flop/byte ridge.  The float32
// kernels are held to the CUDA cores' 67 TFLOP/s.  The bf16 kernels reach
// a fifth to a quarter of the tensor cores' 989: each warpgroup waits on
// its own products (no warp specialisation, no overlap of the softmax
// with the next tile's wgmma), so latency is hidden only by the 4
// warpgroups of an SM.  Next: TMA loads with a producer warp, and the
// next tile's q k^T issued under this tile's softmax with two score
// buffers (FlashAttention-3's ping-pong) -- in a form ptxas does not
// serialize; 128-row tiles for the backward.
//
// Plain C interface (no PyTorch headers), built by ops/_build.py with nvcc
// and loaded with ctypes; ops/flash_attention.py wraps it.

#include <cfloat>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"

namespace {

constexpr int kThreads = 256;          // 16 x 16
constexpr int kTile = 64;              // queries per q tile, keys per k tile
constexpr int kTM = 4;                 // micro-tile rows (ty * 4 + a)
constexpr int kTN = 4;                 // micro-tile cols (tx + 16 * b)
constexpr int kPStride = kTile + 1;    // odd stride of the p / ds tiles
constexpr int kMaxD = 128;
constexpr float kNegBig = -1e30f;      // the TPU kernel's NEG_BIG

// the CUDA-core bodies run in float32 only (bf16 takes the tensor cores),
// so T's conversions and p.astype(v.dtype) are the identity
__device__ __forceinline__ float to_float(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_float(float x) {
  static_assert(std::is_same_v<T, float>, "CUDA-core bodies are float32");
  return x;
}
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return from_float<T>(x);
}

// reductions over the 16 threads of a half-warp (the threads sharing ty)
__device__ __forceinline__ float half_warp_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// smem row stride of a kTile x D tile: odd, so the 16 rows a half-warp
// reads at one column fall in 16 different banks
__host__ __device__ __forceinline__ int tile_stride(int D) { return D | 1; }

// rows [row0, row0 + kTile) of a row-major (S, D) matrix into smem as
// float; rows at or past S are zero (0 * garbage could be NaN)
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int S, int D, int stride) {
  const int n = min(kTile, S - row0) * D;
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    dst[r * stride + d] =
        i < n ? to_float(src[(size_t)row0 * D + i]) : 0.f;
  }
}

// per-row statistics of rows [row0, row0 + kTile); 0 past S
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int S) {
  for (int i = threadIdx.x; i < kTile; i += kThreads)
    dst[i] = row0 + i < S ? src[row0 + i] : 0.f;
}

// c[a][b] = sum_d A[ty*4 + a][d] * B[tx + 16 b][d]  (both tiles in smem)
__device__ __forceinline__ void tile_dot(float (&c)[kTM][kTN],
                                         const float* A, const float* B,
                                         int D, int stride, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < kTM; ++a)
#pragma unroll
    for (int b = 0; b < kTN; ++b) c[a][b] = 0.f;
  const float* ar = A + ty * kTM * stride;
  const float* br = B + tx * stride;
  for (int d = 0; d < D; ++d) {
    float av[kTM], bv[kTN];
#pragma unroll
    for (int a = 0; a < kTM; ++a) av[a] = ar[a * stride + d];
#pragma unroll
    for (int b = 0; b < kTN; ++b) bv[b] = br[16 * b * stride + d];
#pragma unroll
    for (int a = 0; a < kTM; ++a)
#pragma unroll
      for (int b = 0; b < kTN; ++b) c[a][b] = fmaf(av[a], bv[b], c[a][b]);
  }
}

// acc[a][e] += sum_c P[ty*4 + a][c] * V[c][tx + 16 e]   (d = tx + 16 e < D)
template <int kE>
__device__ __forceinline__ void tile_acc(float (&acc)[kTM][kE],
                                         const float* P, const float* V,
                                         int D, int stride, int ty, int tx) {
  const float* pr = P + ty * kTM * kPStride;
  for (int c = 0; c < kTile; ++c) {
    float pv[kTM];
#pragma unroll
    for (int a = 0; a < kTM; ++a) pv[a] = pr[a * kPStride + c];
    const float* vr = V + c * stride + tx;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      if (tx + 16 * e < D) {
        const float vv = vr[16 * e];
#pragma unroll
        for (int a = 0; a < kTM; ++a) acc[a][e] = fmaf(pv[a], vv, acc[a][e]);
      }
    }
  }
}

// a kTile x D float32 accumulator owned as 4 rows x D/16 columns, to T
template <typename T, int kE>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[kTM][kE],
                                           int row0, int S, int D, int ty,
                                           int tx) {
#pragma unroll
  for (int a = 0; a < kTM; ++a) {
    const int row = row0 + ty * kTM + a;
    if (row >= S) continue;
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int d = tx + 16 * e;
      if (d < D) dst[(size_t)row * D + d] = from_float<T>(acc[a][e]);
    }
  }
}

__device__ __forceinline__ bool visible(int row, int col, int S,
                                        int causal) {
  return row < S && col < S && (!causal || col <= row);
}

// ------------------------------------------------------------- forward

template <typename T, int kE>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int S, int D, float scale,
                 int causal) {
  extern __shared__ float smem[];
  const int stride = tile_stride(D);
  float* qs = smem;                        // kTile x stride
  float* ks = qs + kTile * stride;         // kTile x stride
  float* vs = ks + kTile * stride;         // kTile x stride
  float* ps = vs + kTile * stride;         // kTile x kPStride

  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t base = (size_t)bh * S * D;
  load_tile(qs, q + base, q0, S, D, stride);

  float m[kTM], l[kTM], acc[kTM][kE];
#pragma unroll
  for (int a = 0; a < kTM; ++a) {
    m[a] = kNegBig;
    l[a] = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[a][e] = 0.f;
  }

  const int nk = (S + kTile - 1) / kTile;
  const int last_k = causal ? min((q0 + kTile - 1) / kTile, nk - 1) : nk - 1;
  for (int kt = 0; kt <= last_k; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                       // the last tile's smem is free
    load_tile(ks, k + base, k0, S, D, stride);
    load_tile(vs, v + base, k0, S, D, stride);
    __syncthreads();

    float s[kTM][kTN];
    tile_dot(s, qs, ks, D, stride, ty, tx);
#pragma unroll
    for (int a = 0; a < kTM; ++a) {
      const int r = ty * kTM + a, row = q0 + r;
      float mx = kNegBig;
#pragma unroll
      for (int b = 0; b < kTN; ++b) {
        const bool ok = visible(row, k0 + tx + 16 * b, S, causal);
        s[a][b] = ok ? s[a][b] * scale : kNegBig;
        mx = fmaxf(mx, s[a][b]);
      }
      const float m_new = fmaxf(m[a], half_warp_max(mx));
      const float corr = expf(m[a] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int b = 0; b < kTN; ++b) {
        const bool ok = visible(row, k0 + tx + 16 * b, S, causal);
        const float p = ok ? expf(s[a][b] - m_new) : 0.f;
        psum += p;
        ps[r * kPStride + tx + 16 * b] = round_to<T>(p);
      }
      l[a] = l[a] * corr + half_warp_sum(psum);
      m[a] = m_new;
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[a][e] *= corr;
    }
    __syncthreads();
    tile_acc(acc, ps, vs, D, stride, ty, tx);
  }

#pragma unroll
  for (int a = 0; a < kTM; ++a) {
    const float l_safe = l[a] == 0.f ? 1.f : l[a];
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[a][e] = acc[a][e] / l_safe;
    const int row = q0 + ty * kTM + a;
    if (tx == 0 && row < S) lse[(size_t)bh * S + row] = m[a] + logf(l_safe);
  }
  store_rows<T, kE>(out + base, acc, q0, S, D, ty, tx);
}

// ------------------------------------------------------------------ dq

template <typename T, int kE>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int S,
                int D, float scale, int causal) {
  extern __shared__ float smem[];
  const int stride = tile_stride(D);
  float* qs = smem;                        // kTile x stride
  float* dos = qs + kTile * stride;        // kTile x stride
  float* ks = dos + kTile * stride;        // kTile x stride
  float* vs = ks + kTile * stride;         // kTile x stride
  float* dss = vs + kTile * stride;        // kTile x kPStride
  float* lse_s = dss + kTile * kPStride;   // kTile
  float* dsum_s = lse_s + kTile;           // kTile

  const int bh = blockIdx.y, q0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t base = (size_t)bh * S * D;
  load_tile(qs, q + base, q0, S, D, stride);
  load_tile(dos, dout + base, q0, S, D, stride);
  load_rows(lse_s, lse + (size_t)bh * S, q0, S);
  load_rows(dsum_s, delta + (size_t)bh * S, q0, S);

  float acc[kTM][kE];
#pragma unroll
  for (int a = 0; a < kTM; ++a)
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[a][e] = 0.f;

  const int nk = (S + kTile - 1) / kTile;
  const int last_k = causal ? min((q0 + kTile - 1) / kTile, nk - 1) : nk - 1;
  for (int kt = 0; kt <= last_k; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile(ks, k + base, k0, S, D, stride);
    load_tile(vs, v + base, k0, S, D, stride);
    __syncthreads();

    float s[kTM][kTN], dp[kTM][kTN];
    tile_dot(s, qs, ks, D, stride, ty, tx);
    tile_dot(dp, dos, vs, D, stride, ty, tx);
#pragma unroll
    for (int a = 0; a < kTM; ++a) {
      const int r = ty * kTM + a;
#pragma unroll
      for (int b = 0; b < kTN; ++b) {
        const int c = tx + 16 * b;
        const float p = visible(q0 + r, k0 + c, S, causal)
                            ? expf(s[a][b] * scale - lse_s[r])
                            : 0.f;
        dss[r * kPStride + c] = p * (dp[a][b] - dsum_s[r]) * scale;
      }
    }
    __syncthreads();
    tile_acc(acc, dss, ks, D, stride, ty, tx);     // dq += ds k
  }
  store_rows<T, kE>(dq + base, acc, q0, S, D, ty, tx);
}

// --------------------------------------------------------------- dk, dv

template <typename T, int kE>
__global__ void __launch_bounds__(kThreads)
flash_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dk,
                  T* __restrict__ dv, int S, int D, float scale,
                  int causal) {
  extern __shared__ float smem[];
  const int stride = tile_stride(D);
  float* ks = smem;                        // kTile x stride
  float* vs = ks + kTile * stride;         // kTile x stride
  float* qs = vs + kTile * stride;         // kTile x stride
  float* dos = qs + kTile * stride;        // kTile x stride
  float* pts = dos + kTile * stride;       // kTile x kPStride: p^T
  float* dsts = pts + kTile * kPStride;    // kTile x kPStride: ds^T
  float* lse_s = dsts + kTile * kPStride;  // kTile
  float* dsum_s = lse_s + kTile;           // kTile

  const int bh = blockIdx.y, k0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t base = (size_t)bh * S * D;
  load_tile(ks, k + base, k0, S, D, stride);
  load_tile(vs, v + base, k0, S, D, stride);

  float acc_dk[kTM][kE], acc_dv[kTM][kE];
#pragma unroll
  for (int a = 0; a < kTM; ++a)
#pragma unroll
    for (int e = 0; e < kE; ++e) acc_dk[a][e] = acc_dv[a][e] = 0.f;

  const int nq = (S + kTile - 1) / kTile;
  const int first_q = causal ? k0 / kTile : 0;   // earlier rows are masked
  for (int qt = first_q; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile(qs, q + base, q0, S, D, stride);
    load_tile(dos, dout + base, q0, S, D, stride);
    load_rows(lse_s, lse + (size_t)bh * S, q0, S);
    load_rows(dsum_s, delta + (size_t)bh * S, q0, S);
    __syncthreads();

    // transposed orientation: rows are keys (ty*4 + a), cols are queries
    float s[kTM][kTN], dp[kTM][kTN];
    tile_dot(s, ks, qs, D, stride, ty, tx);
    tile_dot(dp, vs, dos, D, stride, ty, tx);
#pragma unroll
    for (int a = 0; a < kTM; ++a) {
      const int c = ty * kTM + a;
#pragma unroll
      for (int b = 0; b < kTN; ++b) {
        const int r = tx + 16 * b;
        const float p = visible(q0 + r, k0 + c, S, causal)
                            ? expf(s[a][b] * scale - lse_s[r])
                            : 0.f;
        pts[c * kPStride + r] = round_to<T>(p);   // p_t.astype(do.dtype)
        dsts[c * kPStride + r] = p * (dp[a][b] - dsum_s[r]) * scale;
      }
    }
    __syncthreads();
    tile_acc(acc_dv, pts, dos, D, stride, ty, tx);   // dv += p^T dO
    tile_acc(acc_dk, dsts, qs, D, stride, ty, tx);   // dk += ds^T q
  }
  store_rows<T, kE>(dk + base, acc_dk, k0, S, D, ty, tx);
  store_rows<T, kE>(dv + base, acc_dv, k0, S, D, ty, tx);
}

// ------------------------------------- dq, dk, dv in bf16: tensor cores
//
// One warpgroup (128 threads) per CTA owns a 64-row tile; products are
// wgmma m64nNk16 bf16 -> f32 on swizzled tiles (hopper_mma.cuh), kD the
// head dim padded to 64 or 128 in shared memory only.  Streamed tiles are
// double-buffered: the next tile's cp.async copies run under this tile's
// products.

using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 128;

template <int kD>
__host__ __device__ constexpr size_t tc_tile_bytes() {
  return (size_t)(kD / 64) * hopper::kBlockBytes;
}

// scores and dp of one 64 x 64 tile: d = A B^T with A, B tiles read
// K-major.  Every k step runs, the zero-padded ones too: skipping them
// under a runtime test makes ptxas serialize the wgmmas (C7515).
template <int kD>
__device__ __forceinline__ void tc_scores(float (&d)[32], uint32_t a,
                                          uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    hopper::wgmma_ss_n64(d, hopper::desc_k_major(a, kk),
                         hopper::desc_k_major(b, kk), kk > 0);
}

// acc += X B for a 64 x 64 float32 X given as its bf16 split hi + lo
// (two products on one accumulator) and B (64 rows x kD) read MN-major
template <int kD>
__device__ __forceinline__ void tc_acc_split(float (&acc)[kD / 2],
                                             const float (&x)[32],
                                             uint32_t b) {
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    hopper::a_fragment_split(hi[kk], lo[kk], x, kk);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    hopper::wgmma_rs<kD>(acc, hi[kk], hopper::desc_mn_major(b, kk));
    hopper::wgmma_rs<kD>(acc, lo[kk], hopper::desc_mn_major(b, kk));
  }
  hopper::wgmma_commit();
}

// a 64 x kD float32 accumulator to rows [row0, row0 + 64) of (S, D) bf16
template <int kD>
__device__ __forceinline__ void tc_store(bf16* dst, const float (&acc)[kD / 2],
                                         int row0, int S, int D) {
  const int w = threadIdx.x % kTcThreads / 32, l = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < kD / 2; ++j) {
    const int row = row0 + hopper::frag_row(w, l, j);
    const int col = hopper::frag_col(l, j);
    if (row < S && col < D)
      dst[(size_t)row * D + col] = __float2bfloat16(acc[j]);
  }
}

// the two rows' values reduced over the 4 lanes of a quad (the lanes
// that share a fragment row)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
constexpr float kLog2e = 1.4426950408889634f;
// 2^x on the SFU (ex2.approx, within 2 ulp: what __expf computes after
// its own multiply by log2(e))
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The forward's CTA: two warpgroups, each owning 64 query rows of a
// 128-row tile, share the streamed K and V tiles (three buffers).
constexpr int kFwdRows = 2 * kTile;
constexpr int kFwdThreads = 2 * kTcThreads;
constexpr int kFwdBuffers = 3;

template <int kD>
__global__ void __launch_bounds__(kFwdThreads, kD == 64 ? 2 : 1)
flash_fwd_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    float* __restrict__ lse, int S, int D, float scale,
                    int causal) {
  extern __shared__ uint8_t smem_raw[];
  constexpr size_t kTileB = tc_tile_bytes<kD>();
  uint8_t* qs = hopper::align_1024(smem_raw);   // a tile a warpgroup
  uint8_t* ks = qs + 2 * kTileB;                 // kFwdBuffers buffers
  uint8_t* vs = ks + kFwdBuffers * kTileB;       // kFwdBuffers buffers

  const int bh = blockIdx.y, tid = threadIdx.x;
  const int wg = tid / kTcThreads, w = (tid % kTcThreads) / 32, l = tid % 32;
  const int qc = blockIdx.x * kFwdRows, q0 = qc + wg * kTile;
  const size_t base = (size_t)bh * S * D;
  const int nk = (S + kTile - 1) / kTile;
  const int last_k =
      causal ? min((qc + kFwdRows - 1) / kTile, nk - 1) : nk - 1;
  using hopper::load_tile;
  // key tile t into its buffer, one copy group
  auto load_kv = [&](int t) {
    if (t <= last_k) {
      const size_t nb = (t % kFwdBuffers) * kTileB;
      load_tile<kD, kFwdThreads>(ks + nb, k + base, t * kTile, S, D, tid);
      load_tile<kD, kFwdThreads>(vs + nb, v + base, t * kTile, S, D, tid);
    }
    hopper::cp_async_commit();
  };
  load_tile<kD, kFwdThreads>(qs, q + base, qc, S, D, tid);
  load_tile<kD, kFwdThreads>(qs + kTileB, q + base, qc + kTile, S, D, tid);
  load_kv(0);
  load_kv(1);
  const uint32_t qw = hopper::smem_u32(qs + wg * kTileB);

  // this thread's two rows of the tile and their running max and sum
  const int r0 = q0 + hopper::frag_row(w, l, 0), r1 = r0 + 8;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[kD / 2], s[32];
#pragma unroll
  for (int j = 0; j < kD / 2; ++j) acc[j] = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) s[j] = 0.f;

  for (int kt = 0; kt <= last_k; ++kt) {
    const int k0 = kt * kTile;
    const uint32_t kb = hopper::smem_u32(ks + (kt % kFwdBuffers) * kTileB);
    const uint32_t vb = hopper::smem_u32(vs + (kt % kFwdBuffers) * kTileB);
    hopper::cp_async_wait<1>();            // tile kt; kt + 1 may fly on
    hopper::fence_async_shared();
    __syncthreads();                       // ... and tile kt - 1's are free

    hopper::wgmma_fence();
    tc_scores<kD>(s, qw, kb);
    hopper::wgmma_commit();
    load_kv(kt + 2);                       // issued under q k^T
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);

    // scale and mask: rows past S stay unmasked (never stored); columns
    // past S, and under `causal` past the row, score -inf: p = 2^-inf = 0
    const bool full = k0 + kTile <= S && (!causal || k0 + kTile <= q0 + 1);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const bool second = (j >> 1) & 1;
      const int col = k0 + hopper::frag_col(l, j);
      const bool vis =
          full || (col < S && (!causal || col <= (second ? r1 : r0)));
      s[j] = vis ? s[j] * scale : -INFINITY;
      if (second) mx1 = fmaxf(mx1, s[j]);
      else mx0 = fmaxf(mx0, s[j]);
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    // exp(s - m) as 2^(s log2(e) - m log2(e)): one FFMA and one ex2 a
    // score; a max that did not move keeps corr = exp(0) = 1 exactly
    const float b0 = mn0 * kLog2e, b1 = mn1 * kLog2e;
    const float corr0 = m0 == mn0 ? 1.f : ex2(fmaf(m0, kLog2e, -b0));
    const float corr1 = m1 == mn1 ? 1.f : ex2(fmaf(m1, kLog2e, -b1));
    // p in place of s
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const bool second = (j >> 1) & 1;
      const float p = ex2(fmaf(s[j], kLog2e, second ? -b1 : -b0));
      s[j] = p;
      if (second) ps1 += p;
      else ps0 += p;
    }
    l0 = l0 * corr0 + quad_sum(ps0);       // the unrounded float32 p
    l1 = l1 * corr1 + quad_sum(ps1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < kD / 2; ++j) acc[j] *= (j >> 1) & 1 ? corr1 : corr0;

    // acc += bf16(p) v: p as the register A operand, v read MN-major.
    // Waiting here keeps ptxas from serializing the wgmmas (C7515): a
    // p v left in flight under the next tile's q k^T measured no faster.
    uint32_t pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::a_fragment(pf[kk], s, kk);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_rs<kD>(acc, pf[kk], hopper::desc_mn_major(vb, kk));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
  }

  const float ls0 = l0 == 0.f ? 1.f : l0, ls1 = l1 == 0.f ? 1.f : l1;
#pragma unroll
  for (int j = 0; j < kD / 2; ++j)
    acc[j] = acc[j] / ((j >> 1) & 1 ? ls1 : ls0);
  if ((l & 3) == 0) {                      // one lane of each quad
    if (r0 < S) lse[(size_t)bh * S + r0] = m0 + logf(ls0);
    if (r1 < S) lse[(size_t)bh * S + r1] = m1 + logf(ls1);
  }
  tc_store<kD>(out + base, acc, q0, S, D);
}

template <int kD>
__global__ void __launch_bounds__(kTcThreads, kD == 64 ? 4 : 2)
flash_dq_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int S, int D, float scale, int causal) {
  extern __shared__ uint8_t smem_raw[];
  constexpr size_t kTileB = tc_tile_bytes<kD>();
  uint8_t* qs = hopper::align_1024(smem_raw);
  uint8_t* dos = qs + kTileB;
  uint8_t* ks = dos + kTileB;              // 2 buffers
  uint8_t* vs = ks + 2 * kTileB;           // 2 buffers

  const int bh = blockIdx.y, q0 = blockIdx.x * kTile, tid = threadIdx.x;
  const int w = tid / 32, l = tid % 32;
  const size_t base = (size_t)bh * S * D;
  using hopper::load_tile;
  load_tile<kD, kTcThreads>(qs, q + base, q0, S, D, tid);
  load_tile<kD, kTcThreads>(dos, dout + base, q0, S, D, tid);
  load_tile<kD, kTcThreads>(ks, k + base, 0, S, D, tid);
  load_tile<kD, kTcThreads>(vs, v + base, 0, S, D, tid);
  hopper::cp_async_commit();

  // this thread's two rows of the tile, and their lse and delta
  const int r0 = q0 + hopper::frag_row(w, l, 0), r1 = r0 + 8;
  const float lse0 = r0 < S ? lse[(size_t)bh * S + r0] : 0.f;
  const float lse1 = r1 < S ? lse[(size_t)bh * S + r1] : 0.f;
  const float dl0 = r0 < S ? delta[(size_t)bh * S + r0] : 0.f;
  const float dl1 = r1 < S ? delta[(size_t)bh * S + r1] : 0.f;

  float acc[kD / 2], s[32], dp[32];
#pragma unroll
  for (int j = 0; j < kD / 2; ++j) acc[j] = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;

  const int nk = (S + kTile - 1) / kTile;
  const int last_k = causal ? min((q0 + kTile - 1) / kTile, nk - 1) : nk - 1;
  for (int kt = 0; kt <= last_k; ++kt) {
    const int k0 = kt * kTile;
    uint8_t* kb = ks + (kt & 1) * kTileB;
    uint8_t* vb = vs + (kt & 1) * kTileB;
    if (kt < last_k) {                     // the next tile, under this one
      const size_t nb = ((kt + 1) & 1) * kTileB;
      load_tile<kD, kTcThreads>(ks + nb, k + base, k0 + kTile, S, D, tid);
      load_tile<kD, kTcThreads>(vs + nb, v + base, k0 + kTile, S, D, tid);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    hopper::fence_async_shared();
    __syncthreads();

    hopper::wgmma_fence();
    tc_scores<kD>(s, hopper::smem_u32(qs), hopper::smem_u32(kb));
    tc_scores<kD>(dp, hopper::smem_u32(dos), hopper::smem_u32(vb));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);

    // ds = p (dp - delta) scale, in place of s; p = 0 where masked
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const bool second = (j >> 1) & 1;
      const int row = second ? r1 : r0;
      const int col = k0 + hopper::frag_col(l, j);
      const float p = visible(row, col, S, causal)
                          ? __expf(s[j] * scale - (second ? lse1 : lse0))
                          : 0.f;
      s[j] = p * (dp[j] - (second ? dl1 : dl0)) * scale;
    }
    tc_acc_split<kD>(acc, s, hopper::smem_u32(kb));   // dq += ds k
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    __syncthreads();                       // kb, vb free for kt + 2
  }
  tc_store<kD>(dq + base, acc, q0, S, D);
}

template <int kD>
__global__ void __launch_bounds__(kTcThreads, kD == 64 ? 3 : 2)
flash_dkdv_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int S, int D, float scale,
                     int causal) {
  extern __shared__ uint8_t smem_raw[];
  constexpr size_t kTileB = tc_tile_bytes<kD>();
  uint8_t* ks = hopper::align_1024(smem_raw);
  uint8_t* vs = ks + kTileB;
  uint8_t* qs = vs + kTileB;               // 2 buffers
  uint8_t* dos = qs + 2 * kTileB;          // 2 buffers
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kTileB);   // 2 x kTile
  float* dl_s = lse_s + 2 * kTile;                              // 2 x kTile

  const int bh = blockIdx.y, k0 = blockIdx.x * kTile, tid = threadIdx.x;
  const int w = tid / 32, l = tid % 32;
  const size_t base = (size_t)bh * S * D;
  const float* lse_bh = lse + (size_t)bh * S;
  const float* dl_bh = delta + (size_t)bh * S;
  using hopper::load_tile;

  // Q, dO, lse and delta of query tile q0 into buffer b; lse and delta
  // past S are 0
  auto load_q = [&](int q0, int b) {
    load_tile<kD, kTcThreads>(qs + b * kTileB, q + base, q0, S, D, tid);
    load_tile<kD, kTcThreads>(dos + b * kTileB, dout + base, q0, S, D, tid);
    const int i = tid % kTile, row = q0 + i;
    const float* src = tid < kTile ? lse_bh : dl_bh;
    float* dst = (tid < kTile ? lse_s : dl_s) + b * kTile + i;
    hopper::cp_async_4(hopper::smem_u32(dst), row < S ? src + row : src,
                       row < S ? 4 : 0);
  };

  const int nq = (S + kTile - 1) / kTile;
  const int first_q = causal ? k0 / kTile : 0;   // earlier rows are masked
  load_tile<kD, kTcThreads>(ks, k + base, k0, S, D, tid);
  load_tile<kD, kTcThreads>(vs, v + base, k0, S, D, tid);
  load_q(first_q * kTile, 0);
  hopper::cp_async_commit();

  // this thread's two key rows of the tile
  const int kr0 = k0 + hopper::frag_row(w, l, 0), kr1 = kr0 + 8;
  float acc_dk[kD / 2], acc_dv[kD / 2], s[32], dp[32];
#pragma unroll
  for (int j = 0; j < kD / 2; ++j) acc_dk[j] = acc_dv[j] = 0.f;
#pragma unroll
  for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;

  for (int qt = first_q; qt < nq; ++qt) {
    const int q0 = qt * kTile, b = (qt - first_q) & 1;
    const uint32_t qb = hopper::smem_u32(qs + b * kTileB);
    const uint32_t dob = hopper::smem_u32(dos + b * kTileB);
    const float* lse_t = lse_s + b * kTile;
    const float* dl_t = dl_s + b * kTile;
    if (qt + 1 < nq) {                     // the next tile, under this one
      load_q(q0 + kTile, b ^ 1);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    hopper::fence_async_shared();
    __syncthreads();

    // transposed orientation: rows are keys, columns are queries
    hopper::wgmma_fence();
    tc_scores<kD>(s, hopper::smem_u32(ks), qb);     // s^T = k q^T
    tc_scores<kD>(dp, hopper::smem_u32(vs), dob);   // dp^T = v dO^T
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::fence_regs(dp);

    // p^T in place of s^T; p = 0 where masked
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int key = (j >> 1) & 1 ? kr1 : kr0;
      const int c = hopper::frag_col(l, j);
      s[j] = visible(q0 + c, key, S, causal)
                 ? __expf(s[j] * scale - lse_t[c])
                 : 0.f;
    }
    // dv += p^T dO, p rounded to dO's type (p_t.astype(do.dtype))
    uint32_t pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::a_fragment(pf[kk], s, kk);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_rs<kD>(acc_dv, pf[kk], hopper::desc_mn_major(dob, kk));
    hopper::wgmma_commit();

    // ds^T = p^T (dp^T - delta) scale, in place of p^T
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = hopper::frag_col(l, j);
      s[j] = s[j] * (dp[j] - dl_t[c]) * scale;
    }
    tc_acc_split<kD>(acc_dk, s, qb);                   // dk += ds^T q
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc_dk);
    hopper::fence_regs(acc_dv);
    __syncthreads();                       // buffer b free for qt + 2
  }
  tc_store<kD>(dk + base, acc_dk, k0, S, D);
  tc_store<kD>(dv + base, acc_dv, k0, S, D);
}

// ------------------------------------------------------------- launches

size_t fwd_smem(int D) {
  return sizeof(float) * (3 * (size_t)kTile * tile_stride(D) +
                          (size_t)kTile * kPStride);
}
size_t dq_smem(int D) {
  return sizeof(float) * (4 * (size_t)kTile * tile_stride(D) +
                          (size_t)kTile * kPStride + 2 * kTile);
}
size_t dkdv_smem(int D) {
  return sizeof(float) * (4 * (size_t)kTile * tile_stride(D) +
                          2 * (size_t)kTile * kPStride + 2 * kTile);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

bool bad_shape(int BH, int S, int D) {
  return BH < 1 || BH > 65535 || S < 1 || D < 1 || D > kMaxD;
}

// one CTA per (tile of `rows` rows, b*h)
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int threads, int rows, size_t smem, int BH,
                   int S, cudaStream_t st, Args... args) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((S + rows - 1) / rows, BH), threads, smem, st>>>(args...);
  return cudaGetLastError();
}

// the tensor-core kernels' shared memory: for the forward two Q tiles
// and three buffers each of K and V, for the backward six tiles (Q, dO
// and two buffers each of K and V; or K, V and two each of Q and dO),
// dk/dv's two buffers of lse and delta, and the slack of the 1024-byte
// alignment
template <int kD> size_t fwd_tc_smem() {
  return (2 + 2 * kFwdBuffers) * tc_tile_bytes<kD>() + 1024;
}
template <int kD> size_t dq_tc_smem() {
  return 6 * tc_tile_bytes<kD>() + 1024;
}
template <int kD> size_t dkdv_tc_smem() {
  return 6 * tc_tile_bytes<kD>() + 4 * kTile * sizeof(float) + 1024;
}

// float32 runs the CUDA-core bodies (tensor cores would mean TF32),
// bfloat16 the tensor-core kernels with the head dim padded to 16 kE
template <typename T, int kE>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                void* lse, int BH, int S, int D, float scale, int causal,
                cudaStream_t st) {
  auto run = [&](auto kernel, int threads, int rows, size_t smem) {
    return launch(kernel, threads, rows, smem, BH, S, st,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<T*>(out),
                  static_cast<float*>(lse), S, D, scale, causal);
  };
  if constexpr (std::is_same_v<T, bf16>)
    return run(flash_fwd_kernel_tc<16 * kE>, kFwdThreads, kFwdRows,
               fwd_tc_smem<16 * kE>());
  else
    return run(flash_fwd_kernel<T, kE>, kThreads, kTile, fwd_smem(D));
}

template <typename T, int kE>
cudaError_t dq(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq_out, int BH,
               int S, int D, float scale, int causal, cudaStream_t st) {
  auto run = [&](auto kernel, int threads, size_t smem) {
    return launch(kernel, threads, kTile, smem, BH, S, st,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const T*>(dout),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta), static_cast<T*>(dq_out),
                  S, D, scale, causal);
  };
  if constexpr (std::is_same_v<T, bf16>)
    return run(flash_dq_kernel_tc<16 * kE>, kTcThreads,
               dq_tc_smem<16 * kE>());
  else
    return run(flash_dq_kernel<T, kE>, kThreads, dq_smem(D));
}

template <typename T, int kE>
cudaError_t dkdv(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, int BH, int S, int D, float scale,
                 int causal, cudaStream_t st) {
  auto run = [&](auto kernel, int threads, size_t smem) {
    return launch(kernel, threads, kTile, smem, BH, S, st,
                  static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const T*>(dout),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta), static_cast<T*>(dk),
                  static_cast<T*>(dv), S, D, scale, causal);
  };
  if constexpr (std::is_same_v<T, bf16>)
    return run(flash_dkdv_kernel_tc<16 * kE>, kTcThreads,
               dkdv_tc_smem<16 * kE>());
  else
    return run(flash_dkdv_kernel<T, kE>, kThreads, dkdv_smem(D));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D <= 64 takes the 4-column
// accumulators (bf16: head dim padded to 64), 64 < D <= 128
// the 8-column ones (padded to 128).
#define FLASH_DISPATCH(fn, ...)                                          \
  do {                                                                   \
    if (dtype == 0)                                                      \
      return (int)(D <= 64 ? fn<float, 4>(__VA_ARGS__)                   \
                           : fn<float, 8>(__VA_ARGS__));                 \
    if (dtype == 1)                                                      \
      return (int)(D <= 64 ? fn<__nv_bfloat16, 4>(__VA_ARGS__)           \
                           : fn<__nv_bfloat16, 8>(__VA_ARGS__));         \
    return (int)cudaErrorInvalidValue;                                   \
  } while (0)

extern "C" {

// Each returns a cudaError_t (0 = launched).  Tensors are contiguous
// (B*H, S, D) in the dtype; lse and delta are (B*H, S) float32.
int flash_fwd(int dtype, const void* q, const void* k, const void* v,
              void* out, void* lse, int BH, int S, int D, float scale,
              int causal, void* stream) {
  if (bad_shape(BH, S, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(fwd, q, k, v, out, lse, BH, S, D, scale, causal, st);
}

int flash_dq(int dtype, const void* q, const void* k, const void* v,
             const void* dout, const void* lse, const void* delta,
             void* dq_out, int BH, int S, int D, float scale, int causal,
             void* stream) {
  if (bad_shape(BH, S, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(dq, q, k, v, dout, lse, delta, dq_out, BH, S, D, scale,
                 causal, st);
}

int flash_dkdv(int dtype, const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               void* dk, void* dv, int BH, int S, int D, float scale,
               int causal, void* stream) {
  if (bad_shape(BH, S, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(dkdv, q, k, v, dout, lse, delta, dk, dv, BH, S, D, scale,
                 causal, st);
}

}  // extern "C"
