// Paged attention over a block-table KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel mpi_tensorflow_tpu/ops/paged_attention_kernel.py
// :_paged_kernel (reached through _paged_call's pl.pallas_call) in its
// three pool modes, which the wrapper picks from the scales' rank as the
// reference does:
//   - fp   ("fp32"): the pool in the query's type T;
//   - int8: int8 codes, one float32 scale per (block, head, slot) row;
//   - int4: two codes per byte, split-half (byte i holds code i in its
//     low nibble and code i + D/2 in its high one), one float32 scale
//     per group of D/G channels; optionally with the KIVI residual lane.
// It computes exactly what that kernel computes:
//
//   out[b, h, s] = sum_c softmax_c(score) * V[c],
//   score[c]     = scale * q[b, h, s] . K[c]   if c <= lengths[b] + s
//                = -FLT_MAX                    otherwise,
//
// where key position c lives in pool block block_table[b, c / bs] at row
// c % bs.  Only the first nlive = clamp(ceil((len + S) / bs), 1, NB)
// blocks of a row are read: the rest of its table is null-block padding.
// Quantized K and V are code * scale in float32, rounded to T (the TPU
// kernel's .astype(q.dtype)).  With the residual lane, the column of each
// query's own position (c == lengths[b] + s) scores q . k_new[b, h, s] in
// float32 instead — replacing the score before scale and mask — and its
// weight, kept in the softmax sum, multiplies v_new[b, h, s] in float32,
// unrounded, instead of the pool row.
//
// Design.  The TPU kernel walks a sequential grid (row, kv-block) on one
// core and carries the running max, sum and accumulator in VMEM scratch
// from one grid step to the next.  Hopper blocks run in parallel and in
// no order, so nothing can be carried between them.  Here one CUDA block
// owns one (row b, head h, tile of up to TQ queries) and loops over the
// row's live KV blocks itself, reading bt[b, j] and lengths[b] on its
// own:
//   - each K/V block (bs x D) is staged in shared memory as float (K with
//     a padded row stride, so the score loop is free of bank conflicts);
//     quantized blocks are dequantized during that load, so the rest of
//     the kernel is the same in every mode (templated on the mode, no
//     per-element branch);
//   - scores are dot products accumulated in float32, masked to -FLT_MAX
//     past each query's position before any use, so a poisoned null
//     block or dead lane (scale 1e30) gets weight exactly 0;
//   - each warp owns query rows and keeps their running max m, sum l and
//     D-wide accumulator in float32 registers (the online softmax);
//   - probabilities are rounded to T before the P.V product, as the TPU
//     kernel's p.astype(v.dtype), and summed in float32;
//   - the output is acc / (l == 0 ? 1 : l), rounded to the query's type.
// Bucket-slack rows (all-null table, length 0) read block 0 and write
// garbage the engine discards, exactly as on the TPU.
//
// What bounds it.  Memory: at S <= 64 queries per row the kernel does
// about S multiply-adds per K/V element it reads — far under the H100's
// ~295 flop/byte ridge; int8 and int4 pools cut the bytes per element to
// 1 + 4/D and 1/2 + 4/g.  The simple design reads each live K/V block once
// per (row, head, query tile) with scalar loads and computes on CUDA
// cores; vector loads, a wgmma/TMA pipeline and a split-KV decode that
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

enum Mode { kFp = 0, kInt8 = 1, kInt4 = 2 };

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

// Element d of pool row `row` (= (block * H + h) * bs + slot) as the float
// value of T the TPU kernel feeds its dot products.  int8 rows are D bytes
// with one scale per row; int4 rows are D/2 bytes with G scales per row.
template <typename T, int M>
__device__ __forceinline__ float load_kv(const void* __restrict__ pool,
                                        const float* __restrict__ pscale,
                                        size_t row, int d, int D, int G) {
  if constexpr (M == kFp) {
    return to_float(static_cast<const T*>(pool)[row * D + d]);
  } else if constexpr (M == kInt8) {
    const float code = static_cast<const int8_t*>(pool)[row * D + d];
    return to_float(from_float<T>(code * pscale[row]));
  } else {
    const int half = D / 2;
    const bool lo = d < half;
    const int byte =
        static_cast<const uint8_t*>(pool)[row * half + (lo ? d : d - half)];
    int code = lo ? (byte & 0xF) : (byte >> 4);
    code -= code > 7 ? 16 : 0;               // sign-extend the nibble
    return to_float(
        from_float<T>((float)code * pscale[row * G + d / (D / G)]));
  }
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;    // int8: (N, H, bs); int4: (N, H, bs, G)
  const float* v_scale;
  const void* k_new;       // residual lane: (B, H, S, D) in T
  const void* v_new;
  const int* table;        // (B, NB)
  const int* lengths;      // (B,)
  void* out;               // (B, H, S, D) in T
  int B, H, S, D, bs, NB, G;
  float scale;
};

template <typename T, int M, bool R>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(Args a) {
  extern __shared__ float smem[];
  const int H = a.H, S = a.S, D = a.D, bs = a.bs, NB = a.NB, G = a.G;
  const int ks_stride = D + 1;
  float* qs = smem;                      // kTileQ x D
  float* ks = qs + kTileQ * D;           // bs x (D + 1)
  float* vs = ks + bs * ks_stride;       // bs x D
  float* ps = vs + bs * D;               // kTileQ x bs
  float* kns = ps + kTileQ * bs;         // kTileQ x D (residual lane only)

  const int b = blockIdx.z, h = blockIdx.y, s0 = blockIdx.x * kTileQ;
  const int nq = min(kTileQ, S - s0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = a.lengths[b];
  const int nlive = min(max((len + S + bs - 1) / bs, 1), NB);

  const size_t qoff = ((size_t)(b * H + h) * S + s0) * D;
  const T* qrow = static_cast<const T*>(a.q) + qoff;
  for (int i = tid; i < nq * D; i += kThreads) qs[i] = to_float(qrow[i]);
  if constexpr (R) {
    const T* knrow = static_cast<const T*>(a.k_new) + qoff;
    for (int i = tid; i < nq * D; i += kThreads) kns[i] = to_float(knrow[i]);
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -FLT_MAX;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDPerLane; ++i) acc[r][i] = 0.f;
  }

  for (int j = 0; j < nlive; ++j) {
    const size_t row0 = ((size_t)a.table[b * NB + j] * H + h) * (size_t)bs;
    __syncthreads();                     // previous block's smem is free
    for (int i = tid; i < bs * D; i += kThreads) {
      const int c = i / D, d = i % D;
      ks[c * ks_stride + d] = load_kv<T, M>(a.k_pool, a.k_scale, row0 + c,
                                            d, D, G);
      vs[i] = load_kv<T, M>(a.v_pool, a.v_scale, row0 + c, d, D, G);
    }
    __syncthreads();

    // scores of the tile's queries against this block's keys; the
    // residual lane's own column reads k_new's row instead of the pool's
    for (int i = tid; i < nq * bs; i += kThreads) {
      const int r = i / bs, c = i % bs;
      const int col = j * bs + c, qpos = len + s0 + r;
      float sc = -FLT_MAX;
      if (col <= qpos) {
        const float* qr = qs + r * D;
        const float* kc = (R && col == qpos) ? kns + r * D
                                             : ks + c * ks_stride;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kc[d], dot);
        sc = dot * a.scale;
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
      // the residual lane's column in this block (out of range: none)
      const int c_self = R ? len + s0 + r - j * bs : -1;
      float psum = 0.f, pself = 0.f;
      for (int c = lane; c < bs; c += 32) {
        const float p = expf(pr[c] - m_new);
        psum += p;
        if (R && c == c_self) {
          pself = p;                          // weighs v_new, unrounded
          pr[c] = 0.f;
        } else {
          pr[c] = to_float(from_float<T>(p));   // p.astype(v.dtype)
        }
      }
      l[rr] = l[rr] * corr + warp_sum(psum);
      m[rr] = m_new;
      const bool has_self = R && c_self >= 0 && c_self < bs;
      if (has_self) pself = warp_sum(pself);
      __syncwarp();
      const T* vnrow = R ? static_cast<const T*>(a.v_new) + qoff + r * D
                         : nullptr;
#pragma unroll
      for (int i = 0; i < kDPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < D) {
          float v = acc[rr][i] * corr;
          for (int c = 0; c < bs; ++c) v = fmaf(pr[c], vs[c * D + d], v);
          if (has_self) v = fmaf(pself, to_float(vnrow[d]), v);
          acc[rr][i] = v;
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp + rr * kWarps;
    if (r >= nq) break;
    const float inv = 1.f / (l[rr] == 0.f ? 1.f : l[rr]);
    T* orow = static_cast<T*>(a.out) + qoff + (size_t)r * D;
#pragma unroll
    for (int i = 0; i < kDPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < D) orow[d] = from_float<T>(acc[rr][i] * inv);
    }
  }
}

template <typename T, int M, bool R>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)kTileQ * a.D + (size_t)a.bs * (a.D + 1) +
                       (size_t)a.bs * a.D + (size_t)kTileQ * a.bs +
                       (R ? (size_t)kTileQ * a.D : 0));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T, M, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.S + kTileQ - 1) / kTileQ, a.H, a.B);
  paged_attention_kernel<T, M, R><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mode(int mode, bool residual, const Args& a,
                        cudaStream_t st) {
  if (mode == kFp && !residual) return launch<T, kFp, false>(a, st);
  if (mode == kInt8 && !residual) return launch<T, kInt8, false>(a, st);
  if (mode == kInt4)
    return residual ? launch<T, kInt4, true>(a, st)
                    : launch<T, kInt4, false>(a, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (of q, out, k_new, v_new and an fp
// pool).  mode: 0 = fp, 1 = int8, 2 = int4.  k_scale/v_scale are null in
// mode fp; k_new/v_new are null unless the int4 residual lane is on.  G is
// the int4 scale groups per row (1 otherwise).  Returns a cudaError_t
// (0 = launched).
int paged_attention_fwd(int dtype, int mode, const void* q,
                        const void* k_pool, const void* v_pool,
                        const void* k_scale, const void* v_scale,
                        const void* k_new, const void* v_new,
                        const void* table, const void* lengths, void* out,
                        int B, int H, int S, int D, int bs, int NB, int G,
                        float scale, void* stream) {
  if (D < 1 || D > kMaxD || bs < 1 || S < 1 || B < 1 || H < 1 || NB < 1)
    return (int)cudaErrorInvalidValue;
  const bool residual = k_new != nullptr;
  if (residual != (v_new != nullptr) ||
      (mode != kFp && (k_scale == nullptr || v_scale == nullptr)) ||
      (mode == kInt4 && (D % 2 || G < 1 || D % G)))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale), k_new, v_new,
               static_cast<const int*>(table),
               static_cast<const int*>(lengths), out, B, H, S, D, bs, NB,
               G, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_mode<float>(mode, residual, a, st);
  if (dtype == 1)
    return (int)launch_mode<__nv_bfloat16>(mode, residual, a, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
