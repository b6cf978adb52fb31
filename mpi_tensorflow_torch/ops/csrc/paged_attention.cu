// Paged attention over a block-table KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel mpi_tensorflow_tpu/ops/paged_attention_kernel.py
// :_paged_kernel (reached through _paged_call's pl.pallas_call), in its
// "fp32" mode: the pool held in the model's compute dtype.  It computes
// exactly what that kernel computes:
//
//   out[b, h, s] = sum_c softmax_c(score) * V[c],
//   score[c]     = scale * q[b, h, s] . K[c]   if c <= lengths[b] + s
//                = -FLT_MAX                    otherwise,
//
// where key position c lives in pool block block_table[b, c / bs] at row
// c % bs.  Only the first nlive = clamp(ceil((len + S) / bs), 1, NB)
// blocks of a row are read: the rest of its table is null-block padding.
//
// Design.  The TPU kernel walks a sequential grid (row, kv-block) on one
// core and carries the running max, sum and accumulator in VMEM scratch
// from one grid step to the next.  Hopper blocks run in parallel and in
// no order, so nothing can be carried between them.  Here one CUDA block
// owns one (row b, head h, tile of up to TQ queries) and loops over the
// row's live KV blocks itself, reading bt[b, j] and lengths[b] on its
// own:
//   - each K/V block (bs x D) is staged in shared memory as float
//     (K with a padded row stride, so the score loop is free of bank
//     conflicts);
//   - scores are dot products accumulated in float32, masked to
//     -FLT_MAX past each query's position;
//   - each warp owns query rows and keeps their running max m, sum l and
//     D-wide accumulator in float32 registers (the online softmax);
//   - probabilities are rounded to the pool's type before the P.V
//     product, as the TPU kernel's p.astype(v.dtype), and summed in
//     float32;
//   - the output is acc / (l == 0 ? 1 : l), rounded to the query's type.
// Bucket-slack rows (all-null table, length 0) read block 0 and write
// garbage the engine discards, exactly as on the TPU.
//
// What bounds it.  Memory: at S <= 64 queries per row the kernel does
// about S multiply-adds per K/V element it reads, i.e. about S flops per
// byte in bf16 — far under the H100's ~295 flop/byte ridge.  The simple
// design reads each live K/V block once per (row, head, query tile) and
// computes on CUDA cores; a wgmma/TMA pipeline and a split-KV decode that
// spreads one row over several SMs are later work.
//
// Plain C interface (no PyTorch headers), built by ops/_build.py with
// nvcc and loaded with ctypes; ops/paged_attention_kernel.py wraps it.

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;          // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileQ = 16;             // queries per block
constexpr int kRowsPerWarp = kTileQ / kWarps;
constexpr int kMaxD = 128;             // head_dim bound (registers)
constexpr int kDPerLane = kMaxD / 32;

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

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q,        // (B, H, S, D)
                       const T* __restrict__ k_pool,   // (N, H, bs, D)
                       const T* __restrict__ v_pool,   // (N, H, bs, D)
                       const int* __restrict__ table,  // (B, NB)
                       const int* __restrict__ lengths,  // (B,)
                       T* __restrict__ out,            // (B, H, S, D)
                       int H, int S, int D, int bs, int NB, float scale) {
  extern __shared__ float smem[];
  const int ks_stride = D + 1;
  float* qs = smem;                      // kTileQ x D
  float* ks = qs + kTileQ * D;           // bs x (D + 1)
  float* vs = ks + bs * ks_stride;       // bs x D
  float* ps = vs + bs * D;               // kTileQ x bs

  const int b = blockIdx.z, h = blockIdx.y, s0 = blockIdx.x * kTileQ;
  const int nq = min(kTileQ, S - s0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = lengths[b];
  const int nlive = min(max((len + S + bs - 1) / bs, 1), NB);

  const T* qrow = q + ((size_t)(b * H + h) * S + s0) * D;
  for (int i = tid; i < nq * D; i += kThreads) qs[i] = to_float(qrow[i]);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -FLT_MAX;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDPerLane; ++i) acc[r][i] = 0.f;
  }

  for (int j = 0; j < nlive; ++j) {
    const size_t base =
        ((size_t)table[b * NB + j] * H + h) * (size_t)bs * D;
    __syncthreads();                     // previous block's smem is free
    for (int i = tid; i < bs * D; i += kThreads) {
      const int c = i / D, d = i % D;
      ks[c * ks_stride + d] = to_float(k_pool[base + i]);
      vs[i] = to_float(v_pool[base + i]);
    }
    __syncthreads();

    // scores of the tile's queries against this block's keys
    for (int i = tid; i < nq * bs; i += kThreads) {
      const int r = i / bs, c = i % bs;
      const int col = j * bs + c, qpos = len + s0 + r;
      float sc = -FLT_MAX;
      if (col <= qpos) {
        const float* qr = qs + r * D;
        const float* kc = ks + c * ks_stride;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kc[d], dot);
        sc = dot * scale;
      }
      ps[i] = sc;
    }
    __syncthreads();

    // online softmax: each warp updates the rows it owns
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp + rr * kWarps;
      if (r >= nq) break;
      float* pr = ps + r * bs;
      float mx = -FLT_MAX;
      for (int c = lane; c < bs; c += 32) mx = fmaxf(mx, pr[c]);
      const float m_new = fmaxf(m[rr], warp_max(mx));
      const float corr = expf(m[rr] - m_new);
      float psum = 0.f;
      for (int c = lane; c < bs; c += 32) {
        const float p = expf(pr[c] - m_new);
        psum += p;
        pr[c] = to_float(from_float<T>(p));   // p.astype(v.dtype)
      }
      l[rr] = l[rr] * corr + warp_sum(psum);
      m[rr] = m_new;
      __syncwarp();
#pragma unroll
      for (int i = 0; i < kDPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < D) {
          float a = acc[rr][i] * corr;
          for (int c = 0; c < bs; ++c) a = fmaf(pr[c], vs[c * D + d], a);
          acc[rr][i] = a;
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp + rr * kWarps;
    if (r >= nq) break;
    const float inv = 1.f / (l[rr] == 0.f ? 1.f : l[rr]);
    T* orow = out + ((size_t)(b * H + h) * S + s0 + r) * D;
#pragma unroll
    for (int i = 0; i < kDPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < D) orow[d] = from_float<T>(acc[rr][i] * inv);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* table, const int* lengths, void* out, int B,
                   int H, int S, int D, int bs, int NB, float scale,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kTileQ * D + (size_t)bs * (D + 1) +
                       (size_t)bs * D + (size_t)kTileQ * bs);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((S + kTileQ - 1) / kTileQ, H, B);
  paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), table, lengths, static_cast<T*>(out), H,
      S, D, bs, NB, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = launched).
int paged_attention_fwd(int dtype, const void* q, const void* k_pool,
                        const void* v_pool, const void* table,
                        const void* lengths, void* out, int B, int H, int S,
                        int D, int bs, int NB, float scale, void* stream) {
  if (D < 1 || D > kMaxD || bs < 1 || S < 1 || B < 1 || H < 1 || NB < 1)
    return (int)cudaErrorInvalidValue;
  const int* t = static_cast<const int*>(table);
  const int* n = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(q, k_pool, v_pool, t, n, out, B, H, S, D, bs,
                              NB, scale, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k_pool, v_pool, t, n, out, B, H, S,
                                      D, bs, NB, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
