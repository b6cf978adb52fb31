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
// The TPU kernels take blocks of rows and vocabulary slices on a
// sequential grid, padding N to the row block and V to the vocabulary
// block (with -1e30 logits), and carry the logsumexp's max and sum in
// VMEM scratch across the vocabulary axis.  Nothing is padded here: any
// N and any F or V work by bounds checks and masks alone.
//
// What bounds them.  Memory: a few operations per element against the
// H100's ~295 flop/byte ridge.  The LayerNorm's bound is its bytes, x
// read once and y written once (2 N F sizeof(T)) plus scale and bias
// (8 F): at (4096, 768) bf16 12.6 MB, 3.76 us at 3.35 TB/s.
//
// LayerNorm, general path (layer_norm_kernel): one CTA of 256 threads per
// row walks it with a stride loop, reduces each sum over the block with
// warp shuffles and a shared-memory pass, and reads the row three times
// (mean, centred squares, output).  It reached a quarter of its bound at
// (4096, 768) bf16: 4096 CTAs of which ~1056 are resident make four
// waves, and each row is a chain of dependent latencies (scalar 2-byte
// loads with at most 6 bytes in flight a thread, a block barrier and a
// shared-memory round trip per sum, two L1 re-reads), so the card waits
// on latency, not on bandwidth.
//
// LayerNorm, fast path (layer_norm_rows_kernel<T, kVecs>), for rows whose
// F is a multiple of a 16-byte vector (8 bf16, 4 float32) and at most
// kMaxVecs vectors a lane (2048 bf16, 1024 float32), with x, out, scale
// and bias 16-byte aligned (layer_norm_rows_vecs decides, by shape and
// address alone):
//   - one warp per row, 8 rows per 256-thread CTA, a grid-stride loop over
//     rows with the grid sized to the CTAs the card holds at once
//     (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), so at (4096,
//     768) every row is in flight in one wave and no CTA waits for a slot;
//   - the row is read from device memory once, into registers: lane l
//     owns 16-byte vectors j * 32 + l (neighbouring lanes on neighbouring
//     addresses), all kVecs loads issued before the first use (at F = 768
//     bf16, 3 a lane, 48 bytes in flight a thread); lanes past the row's
//     last vector are masked.  A warp with more rows than one loads its
//     next row before it reduces the current one, so the loads of the
//     grid's later rows overlap the sums and stores of the earlier ones
//     (kVecs more registers a lane);
//   - both statistics by an xor butterfly of warp shuffles: no shared
//     memory, no barrier.  Each lane sums its vectors in order, the
//     butterfly gives every lane the same float32 sum, then the mean;
//     then the centred squares from the same registers and a second
//     butterfly: the two-pass statistics of _ln_kernel, in another order
//     of the same sums (tests/test_torch_fused.py emulates the order);
//   - scale and bias are read as float32 vectors once per row from L1
//     (6 KB at F = 768, resident after the first row).  Holding them in
//     registers across a warp's rows would add 2 F / 32 registers a lane
//     (48 at F = 768) to the 64 ptxas gives the kernel there, and halve
//     the CTAs an SM holds from 4 (32 warps; 528 CTAs on the card, one
//     wave for (4096, 768)'s 512) to 2;
//   - y is stored as 16-byte vectors in x's type.
// Every other call (F = 1001, wider rows, a misaligned view) takes the
// general path.  Both are held against the plain version on the card.
//
// logsumexp (logsumexp_kernel): one CTA of 256 threads per row, each
// thread with its own running (max, sum) in registers, merged by warp
// shuffles and one shared-memory pass.  No model path of the repository
// calls either kernel (the JAX package's model keeps XLA's fused
// LayerNorm and logsumexp); ops/fused.py wraps them.
//
// Plain C interface (no PyTorch headers), built by ops/_build.py with
// nvcc and loaded with ctypes.

#include <cfloat>
#include <cstdint>
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

// Sum of x over the warp by an xor butterfly; every lane gets the same
// float32 value (each step adds the same two values on both lanes).
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Sum of x over the block; every thread gets it.  `red` holds kWarps
// floats of shared memory and is free again on return.
__device__ float block_sum(float x, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  x = warp_sum(x);
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

constexpr int kVecBytes = 16;
// 16-byte vectors a lane holds in the fast path: rows up to 32 x 8 x 8 =
// 2048 bf16 or 32 x 8 x 4 = 1024 float32 values (BERT-large's 1024 too)
constexpr int kMaxVecs = 8;
template <typename T> constexpr int kElems = kVecBytes / sizeof(T);

// One 16-byte vector as float32 values, and back (bf16 rounded to nearest
// even, as __float2bfloat16).
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 p = __bfloat1622float2(h[k]);
    f[2 * k] = p.x;
    f[2 * k + 1] = p.y;
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
  return u;
}

// This lane's vectors of row `row` into v: zero where masked or row >= N.
template <typename T, int kVecs>
__device__ __forceinline__ void load_row(uint4 (&v)[kVecs], const T* x,
                                         long long row, int N, int F,
                                         int nvec, int lane) {
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * F);
#pragma unroll
  for (int j = 0; j < kVecs; ++j)
    v[j] = row < N && j * 32 + lane < nvec ? xr[j * 32 + lane]
                                           : make_uint4(0, 0, 0, 0);
}

// The fast path (see the head of the file): warp w of CTA b takes rows
// b * kWarps + w, then every gridDim.x * kWarps-th row after it.
template <typename T, int kVecs>
__global__ void __launch_bounds__(kThreads)
layer_norm_rows_kernel(const T* __restrict__ x,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias, T* __restrict__ out,
                       int N, int F, float eps) {
  constexpr int kE = kElems<T>;
  const int lane = threadIdx.x % 32;
  const int nvec = F / kE;
  const long long stride = (long long)gridDim.x * kWarps;
  long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  uint4 v[kVecs];
  load_row(v, x, row, N, F, nvec, lane);
  for (; row < N; row += stride) {
    // the warp's next row is in flight while this one is reduced
    uint4 next[kVecs];
    load_row(next, x, row + stride, N, F, nvec, lane);
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kVecs; ++j)
      if (j * 32 + lane < nvec) {
        float f[kE];
        unpack(v[j], f);
#pragma unroll
        for (int e = 0; e < kE; ++e) s += f[e];
      }
    const float mu = warp_sum(s) / F;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < kVecs; ++j)
      if (j * 32 + lane < nvec) {
        float f[kE];
        unpack(v[j], f);
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const float c = f[e] - mu;
          q = fmaf(c, c, q);
        }
      }
    const float inv = rsqrtf(warp_sum(q) / F + eps);
    uint4* orow = reinterpret_cast<uint4*>(out + row * F);
#pragma unroll
    for (int j = 0; j < kVecs; ++j)
      if (j * 32 + lane < nvec) {
        const int i0 = (j * 32 + lane) * kE;
        float f[kE];
        unpack(v[j], f);
#pragma unroll
        for (int e = 0; e < kE; e += 4) {
          const float4 sc =
              __ldg(reinterpret_cast<const float4*>(scale + i0 + e));
          const float4 bi =
              __ldg(reinterpret_cast<const float4*>(bias + i0 + e));
          f[e] = (f[e] - mu) * inv * sc.x + bi.x;
          f[e + 1] = (f[e + 1] - mu) * inv * sc.y + bi.y;
          f[e + 2] = (f[e + 2] - mu) * inv * sc.z + bi.z;
          f[e + 3] = (f[e + 3] - mu) * inv * sc.w + bi.w;
        }
        orow[j * 32 + lane] = pack(f);
      }
#pragma unroll
    for (int j = 0; j < kVecs; ++j) v[j] = next[j];
  }
}

// Launch the fast path with kVecs = vecs (1..kMaxVecs) on as many CTAs as
// the card holds at once, or fewer where N needs fewer.
template <typename T, int kVecs = 1>
int launch_rows(int vecs, const T* x, const float* scale, const float* bias,
                T* out, int N, int F, float eps, cudaStream_t st) {
  if constexpr (kVecs < kMaxVecs) {
    if (vecs != kVecs)
      return launch_rows<T, kVecs + 1>(vecs, x, scale, bias, out, N, F, eps,
                                       st);
  }
  // CTAs of this instantiation one SM holds, asked once per process
  static const struct Occupancy {
    int per_sm = 0;
    cudaError_t err;
    Occupancy()
        : err(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &per_sm, layer_norm_rows_kernel<T, kVecs>, kThreads, 0)) {}
  } occ;
  if (occ.err != cudaSuccess) return (int)occ.err;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long need = ((long long)N + kWarps - 1) / kWarps;
  const long long resident = (long long)occ.per_sm * sms;
  const int grid = (int)(need < resident || resident < 1 ? need : resident);
  layer_norm_rows_kernel<T, kVecs><<<grid, kThreads, 0, st>>>(
      x, scale, bias, out, N, F, eps);
  return (int)cudaGetLastError();
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

// The fast path's kVecs (1..kMaxVecs) for these operands, or 0 where the
// call takes the general path: F a multiple of the 16-byte vector, at
// most kMaxVecs vectors a lane, all four pointers 16-byte aligned.  dtype
// as in layer_norm_fwd.
int layer_norm_rows_vecs(int dtype, const void* x, const void* scale,
                         const void* bias, const void* out, int F) {
  const int elems = dtype == 0 ? kElems<float> : kElems<__nv_bfloat16>;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(scale) |
                         reinterpret_cast<uintptr_t>(bias) |
                         reinterpret_cast<uintptr_t>(out);
  if (F < 1 || F % elems != 0 || addr % kVecBytes != 0) return 0;
  const int vecs = (F / elems + 31) / 32;
  return vecs <= kMaxVecs ? vecs : 0;
}

// dtype: 0 = float32, 1 = bfloat16 (of x and out).  x and out (N, F);
// scale and bias (F,) float32.  Returns a cudaError_t (0 = launched).
int layer_norm_fwd(int dtype, const void* x, const void* scale,
                   const void* bias, void* out, int N, int F, float eps,
                   void* stream) {
  if (N < 1 || F < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const int vecs = layer_norm_rows_vecs(dtype, x, scale, bias, out, F);
  if (dtype == 0 && vecs)
    return launch_rows<float>(vecs, static_cast<const float*>(x), sc, bi,
                              static_cast<float*>(out), N, F, eps, st);
  if (dtype == 1 && vecs)
    return launch_rows<__nv_bfloat16>(
        vecs, static_cast<const __nv_bfloat16*>(x), sc, bi,
        static_cast<__nv_bfloat16*>(out), N, F, eps, st);
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
