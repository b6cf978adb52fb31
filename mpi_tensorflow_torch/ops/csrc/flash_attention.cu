// Flash attention forward and backward for Hopper (sm_90a): three kernels.
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
// and dk/dv start at it (first_q).  Tiles of Q/K/V/dO are staged in shared
// memory as float32 with an odd row stride (conflict-free column walks);
// rows past S are filled with zeros and every score of such a row or
// column is masked to p = 0, so S needs no padding.  256 threads form a
// 16 x 16 grid; each thread computes a 4 x 4 micro-tile of the 64 x 64
// score block (rows ty*4.., columns tx + 16 j) and owns 4 rows x D/16
// columns of the float32 accumulators.  Row statistics are reduced across
// the 16 threads of a half-warp with shuffles and stay in registers.
//
// What bounds it.  Operations: at S = 4096, D = 64 the forward does 4 S D
// = 1 M multiply-adds per 2 D bytes of q it reads in bf16 -- far past the
// H100's ~295 flop/byte ridge.  The products run on the CUDA cores in
// float32 (67 TFLOP/s peak, not the tensor cores' 989 in bf16), fed from
// shared memory (two 4-byte loads per four multiply-adds).  mma.sync or
// wgmma tiles, TMA loads and a bf16 staging of the tiles are later work.
//
// Plain C interface (no PyTorch headers), built by ops/_build.py with nvcc
// and loaded with ctypes; ops/flash_attention.py wraps it.

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;          // 16 x 16
constexpr int kTile = 64;              // queries per q tile, keys per k tile
constexpr int kTM = 4;                 // micro-tile rows (ty * 4 + a)
constexpr int kTN = 4;                 // micro-tile cols (tx + 16 * b)
constexpr int kPStride = kTile + 1;    // odd stride of the p / ds tiles
constexpr int kMaxD = 128;
constexpr float kNegBig = -1e30f;      // the TPU kernel's NEG_BIG

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T and back: p.astype(v.dtype) of the TPU kernels
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
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

dim3 grid_of(int BH, int S) { return dim3((S + kTile - 1) / kTile, BH); }

template <typename T, int kE>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                void* lse, int BH, int S, int D, float scale, int causal,
                cudaStream_t st) {
  auto kernel = flash_fwd_kernel<T, kE>;
  const size_t smem = fwd_smem(D);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid_of(BH, S), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), S, D, scale, causal);
  return cudaGetLastError();
}

template <typename T, int kE>
cudaError_t dq(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq_out, int BH,
               int S, int D, float scale, int causal, cudaStream_t st) {
  auto kernel = flash_dq_kernel<T, kE>;
  const size_t smem = dq_smem(D);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid_of(BH, S), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq_out), S, D, scale, causal);
  return cudaGetLastError();
}

template <typename T, int kE>
cudaError_t dkdv(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, int BH, int S, int D, float scale,
                 int causal, cudaStream_t st) {
  auto kernel = flash_dkdv_kernel<T, kE>;
  const size_t smem = dkdv_smem(D);
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid_of(BH, S), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), S, D, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D <= 64 takes the 4-column
// accumulators, 64 < D <= 128 the 8-column ones.
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
