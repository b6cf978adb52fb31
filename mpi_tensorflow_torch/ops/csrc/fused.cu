// Row LayerNorm and row logsumexp, for Hopper (sm_90a).
//
// Replace the TPU kernels of mpi_tensorflow_tpu/ops/fused.py:
//   - _ln_kernel (reached through _ln_forward's pl.pallas_call): over a
//     row x of F values, in float32,
//       mu = mean(x),  xc = x - mu,  var = mean(xc * xc),
//       y  = xc * rsqrt(var + eps) * scale + bias,
//     written in x's type;
//   - _lse_kernel (reached through online_logsumexp's pl.pallas_call):
//     over a row of V logits, m + log(sum exp(x - m)) in float32, with the
//     running max m and sum carried as the logits stream past, so each
//     logit is read once.
//
// Design.  The TPU kernels take blocks of rows and vocabulary slices on a
// sequential grid, padding N to the row block and V to the vocabulary
// block (with -1e30 logits), and carry the logsumexp's max and sum in
// VMEM scratch across the vocabulary axis.  Here one CUDA block of 256
// threads owns one row and walks it with a stride loop: each thread keeps
// its own running statistics in registers, then the block combines them
// with warp shuffles and one shared-memory pass.  Any N and any F or V
// work by bounds checks alone — nothing is padded.  The LayerNorm reads
// its row three times (mean, variance, output); the second and third
// reads of a row of a few KB hit L1/L2, so device memory sees each
// element about once.
//
// What bounds them.  Memory: a few operations per element against the
// H100's ~295 flop/byte ridge.  The simple design uses scalar loads; wider
// loads and several rows per block for small F are later work.  No model
// path of the repository calls either kernel (the JAX package's model
// keeps XLA's fused LayerNorm and logsumexp); ops/fused.py wraps them.
//
// Plain C interface (no PyTorch headers), built by ops/_build.py with
// nvcc and loaded with ctypes.

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// Sum of x over the block; every thread gets it.  `red` holds kWarps
// floats of shared memory and is free again on return.
__device__ float block_sum(float x, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < kWarps; ++w) t += red[w];
  __syncthreads();
  return t;
}

// exp(a - m) where m >= a, exact at a == m (also for two infinities, where
// a - m would be NaN).
__device__ __forceinline__ float rescale(float a, float m) {
  return a == m ? 1.f : expf(a - m);
}

// Merge the running (max, sum) pair (m2, s2) into (m, s).
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2,
                                          float s2) {
  const float mn = fmaxf(m, m2);
  s = s * rescale(m, mn) + s2 * rescale(m2, mn);
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ out, int F,
                  float eps) {
  __shared__ float red[kWarps];
  const size_t off = (size_t)blockIdx.x * F;
  const T* row = x + off;
  float s = 0.f;
  for (int i = threadIdx.x; i < F; i += kThreads) s += to_float(row[i]);
  const float mu = block_sum(s, red) / F;
  float v = 0.f;
  for (int i = threadIdx.x; i < F; i += kThreads) {
    const float c = to_float(row[i]) - mu;
    v = fmaf(c, c, v);
  }
  const float inv = rsqrtf(block_sum(v, red) / F + eps);
  T* orow = out + off;
  for (int i = threadIdx.x; i < F; i += kThreads)
    orow[i] = from_float<T>((to_float(row[i]) - mu) * inv * scale[i] +
                            bias[i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
logsumexp_kernel(const T* __restrict__ x, float* __restrict__ out, int V) {
  __shared__ float red_m[kWarps], red_s[kWarps];
  const T* row = x + (size_t)blockIdx.x * V;
  float m = -FLT_MAX, s = 0.f;
  for (int i = threadIdx.x; i < V; i += kThreads) {
    const float v = to_float(row[i]);
    if (v > m) {
      s = s * rescale(m, v) + 1.f;
      m = v;
    } else {
      s += rescale(v, m);
    }
  }
  for (int o = 16; o > 0; o >>= 1)
    lse_merge(m, s, __shfl_xor_sync(0xffffffffu, m, o),
              __shfl_xor_sync(0xffffffffu, s, o));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red_m[warp] = m;
    red_s[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = red_m[0];
    s = red_s[0];
    for (int w = 1; w < kWarps; ++w) lse_merge(m, s, red_m[w], red_s[w]);
    out[blockIdx.x] = m + logf(s);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (of x and out).  x and out (N, F);
// scale and bias (F,) float32.  Returns a cudaError_t (0 = launched).
int layer_norm_fwd(int dtype, const void* x, const void* scale,
                   const void* bias, void* out, int N, int F, float eps,
                   void* stream) {
  if (N < 1 || F < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == 0)
    layer_norm_kernel<float><<<N, kThreads, 0, st>>>(
        static_cast<const float*>(x), sc, bi, static_cast<float*>(out), F,
        eps);
  else if (dtype == 1)
    layer_norm_kernel<__nv_bfloat16><<<N, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), sc, bi,
        static_cast<__nv_bfloat16*>(out), F, eps);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dtype as above, of x (N, V); out (N,) float32.
int logsumexp_fwd(int dtype, const void* x, void* out, int N, int V,
                  void* stream) {
  if (N < 1 || V < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    logsumexp_kernel<float><<<N, kThreads, 0, st>>>(
        static_cast<const float*>(x), o, V);
  else if (dtype == 1)
    logsumexp_kernel<__nv_bfloat16><<<N, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), o, V);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
