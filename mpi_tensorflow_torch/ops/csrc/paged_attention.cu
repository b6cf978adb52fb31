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
// no order, and at decode a row's blocks are few and small, so walking
// them one after another leaves the SM waiting on one DRAM round trip per
// block.  Here one CUDA block of 256 threads owns one (row b, head h, tile
// of up to 8 queries) and takes the row's live blocks all at once (in
// rounds of up to 32 blocks, as many as 96 KB of staged K and V allow):
//   1. the block table, lengths[b] and the query tile are read together;
//      then every live block's K and V (codes and scales when quantized)
//      are copied into shared memory by 16-byte cp.async copies, all in
//      flight at once (4-byte or byte copies where a block's bytes are not
//      16-byte aligned) -- K in one copy group, V in a second that lands
//      under steps 2-4 -- so one DRAM round trip sets the time, not one
//      per block;
//   2. scores of all (query, column) pairs, 8 lanes a score over
//      interleaved dims (the query's slice in registers) and a shuffle
//      reduction; quantized K is dequantized from shared memory (code x
//      scale, rounded to T, as the TPU kernel's .astype(q.dtype)); masked
//      columns (c > lengths[b] + s) score -FLT_MAX and read nothing; the
//      residual lane's own column scores q . k_new;
//   3. one warp a query takes each block's maximum and an inclusive
//      prefix max over the blocks (seeded by the previous rounds'), which
//      is m_j, the running max after block j -- exactly the sequential
//      value -- and f_j = exp(m_j - m_last);
//   4. 8 / (queries) warps a query: p = exp(s - m_j) for block j, rounded
//      to T there -- the TPU kernel's rounding point -- times f_j in
//      float32 is the column's weight; each warp sums the unrounded p f_j
//      into its own slot (l is the slots summed in order); the residual
//      lane's own column keeps its unrounded weight for v_new;
//   5. acc[q, d] = sum_c w_c V[c, d] over the round's columns, split over
//      up to 256 / (queries x D) thread groups by column (four
//      independent sums a thread), the earlier rounds' partials rescaled
//      by exp(m_prev - m_last); the groups' partials are merged through
//      shared memory in a fixed order (the result is deterministic), and
//      the output is acc / (l or 1).
// In exact arithmetic this is the sequential acc * corr recursion (the
// corrections telescope to f_j); only the order of the float32 sums
// differs.  Bucket-slack rows (all-null table, length 0) read block 0 and
// write garbage the engine discards, exactly as on the TPU.
//
// What bounds it.  Memory: at S <= 64 queries per row the kernel does
// about S multiply-adds per K/V element it reads -- far under the H100's
// ~295 flop/byte ridge; int8 and int4 pools cut the bytes per element to
// 1 + 4/D and 1/2 + 4/g.  At the decode shape (8 rows x 12 heads) the
// grid is 96 blocks on 132 SMs, each moving ~40 KB, so latency bounds it,
// not bandwidth: by clock64 stamps in one block (scripts/
// torch_paged_phases.py; NVIDIA H100 80GB HBM3, 700 W, bf16, 10 live
// blocks) ~1.4k cycles go to the table and query
// reads, ~2.4-2.9k to K's round trip, ~2.8k (int4: ~6.5k, the nibble
// dequantization) to the scores, ~2k to the weights, ~1.6-3k to p v and
// ~0.7k to the merge.  Next: splitting a row's blocks over a thread-block
// cluster (merged through distributed shared memory) to fill the idle
// SMs and shorten each block's chain, and 16-byte shared-memory reads in
// steps 2 and 5.
//
// Plain C interface (no PyTorch headers), built by ops/_build.py with
// nvcc and loaded with ctypes; ops/paged_attention_kernel.py wraps it.

#include <algorithm>
#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"

namespace {

constexpr int kThreads = 256;           // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTQ = 8;               // queries per CUDA block
constexpr int kMaxD = 128;              // head_dim bound
constexpr int kPairs = kMaxTQ * kMaxD / kThreads;   // (query, dim) a thread
constexpr int kGroup = 8;               // lanes per score
constexpr int kMaxRound = 32;           // blocks per round: a lane each
constexpr int kStageBudget = 96 * 1024; // staged K and V bytes per round

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
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
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
  int TQ;                  // queries per CUDA block
  int nbr;                 // blocks per round
};

__host__ __device__ __forceinline__ size_t up16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// Shared memory, in bytes from its start: the round's K and V blocks as
// stored (span bytes each, back to back: row c of the round at c x the
// row's bytes), their scales (row c's at c x scales a row), the query tile
// (and k_new's) as float, the round's scores (then weights), and the
// per-query statistics.
struct Layout {
  int span, scale_n, ncap;
  size_t stage_k, stage_v, scale_k, scale_v, qs, kns, sc, mj, fj, red,
      stat, tbl, total;
};

template <typename T, int M>
__host__ __device__ __forceinline__ int row_bytes(int D) {
  return M == kFp ? D * (int)sizeof(T) : M == kInt8 ? D : D / 2;
}
template <int M>
__host__ __device__ __forceinline__ int scales_per_block(int bs, int G) {
  return M == kFp ? 0 : M == kInt8 ? bs : bs * G;
}

template <typename T, int M, bool R>
__host__ __device__ Layout layout_of(const Args& a) {
  Layout L;
  L.span = a.bs * row_bytes<T, M>(a.D);
  L.scale_n = scales_per_block<M>(a.bs, a.G);
  L.ncap = a.nbr * a.bs;
  size_t o = 0;
  L.stage_k = o;  o += up16((size_t)a.nbr * L.span);
  L.stage_v = o;  o += up16((size_t)a.nbr * L.span);
  L.scale_k = o;  o += up16((size_t)a.nbr * L.scale_n * sizeof(float));
  L.scale_v = o;  o += up16((size_t)a.nbr * L.scale_n * sizeof(float));
  L.qs = o;       o += up16((size_t)a.TQ * a.D * sizeof(float));
  L.kns = o;      o += R ? up16((size_t)a.TQ * a.D * sizeof(float)) : 0;
  L.sc = o;       o += up16((size_t)a.TQ * L.ncap * sizeof(float));
  L.mj = o;       o += (size_t)kMaxTQ * kMaxRound * sizeof(float);
  L.fj = o;       o += (size_t)kMaxTQ * kMaxRound * sizeof(float);
  L.red = o;      o += (size_t)kThreads * sizeof(float);
  L.stat = o;     o += (size_t)(3 + 2 * kWarps) * kMaxTQ * sizeof(float);
  L.tbl = o;      o += (size_t)kMaxRound * sizeof(int);
  L.total = o;
  return L;
}

// Element d of row c of a staged round, as the float value of T the TPU
// kernel feeds its dot products: int8 rows are D bytes with one scale a
// row; int4 rows are D/2 bytes (byte i: code i low, code i + D/2 high)
// with G scales a row.
// ginv = G / D: the group of channel d is floor((d + 0.5) ginv), exact for
// d, D <= 128 (the product stays over 1/256 from an integer)
template <typename T, int M>
__device__ __forceinline__ float kv_at(const uint8_t* blk, const float* scl,
                                       int c, int d, int D, int G,
                                       float ginv) {
  if constexpr (M == kFp) {
    return to_float(reinterpret_cast<const T*>(blk)[c * D + d]);
  } else if constexpr (M == kInt8) {
    const float code = reinterpret_cast<const int8_t*>(blk)[c * D + d];
    return round_to<T>(code * scl[c]);
  } else {
    const int half = D / 2;
    const bool lo = d < half;
    const int byte = blk[c * half + (lo ? d : d - half)];
    int code = lo ? (byte & 0xF) : (byte >> 4);
    code -= code > 7 ? 16 : 0;               // sign-extend the nibble
    const int grp = __float2int_rz(((float)d + 0.5f) * ginv);
    return round_to<T>((float)code * scl[c * G + grp]);
  }
}

// Step 2 of the kernel: the masked, scaled score of every (query, column)
// of the round into sc.  8 lanes a score, over dims g, g + 8, ... (kN of
// them at most: kN = D / 8 rounded up, unrolled), 4 columns a warp at a
// time; the query's lane slice is held in registers.
template <typename T, int M, bool R, int kN>
__device__ __forceinline__ void scores(const Args& a, const uint8_t* stage_k,
                                       const float* scale_k, const float* qs,
                                       const float* kns, float* sc, int nq,
                                       int ncols, int ncap, int j0, int len,
                                       int s0, float ginv) {
  const int D = a.D, G = a.G;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / kGroup, g = lane % kGroup;
  for (int r = 0; r < nq; ++r) {
    const int qpos = len + s0 + r;
    float qv[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int d = g + kGroup * i;
      qv[i] = d < D ? qs[r * D + d] : 0.f;
    }
    for (int cb = warp * 4; cb < ncols; cb += kWarps * 4) {
      const int c = cb + sub, col = j0 * a.bs + c;
      const bool vis = c < ncols && col <= qpos;
      float dot = 0.f;
      if (vis && R && col == qpos) {       // the residual lane's own column
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          const int d = g + kGroup * i;
          if (d < D) dot = fmaf(qv[i], kns[r * D + d], dot);
        }
      } else if (vis) {
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          const int d = g + kGroup * i;
          if (d < D)
            dot = fmaf(qv[i], kv_at<T, M>(stage_k, scale_k, c, d, D, G, ginv),
                       dot);
        }
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      dot += __shfl_xor_sync(0xffffffffu, dot, 4);
      if (c < ncols && g == 0)
        sc[r * ncap + c] = vis ? dot * a.scale : -FLT_MAX;
    }
  }
}

template <typename T, int M, bool R>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Layout L = layout_of<T, M, R>(a);
  const int H = a.H, S = a.S, D = a.D, bs = a.bs, NB = a.NB, G = a.G;
  const int TQ = a.TQ, ncap = L.ncap;
  const float ginv = (float)G / (float)D;
  const int bs_shift = (bs & (bs - 1)) == 0 ? __ffs(bs) - 1 : -1;
  uint8_t* stage_k = smem + L.stage_k;
  uint8_t* stage_v = smem + L.stage_v;
  float* scale_k = reinterpret_cast<float*>(smem + L.scale_k);
  float* scale_v = reinterpret_cast<float*>(smem + L.scale_v);
  float* qs = reinterpret_cast<float*>(smem + L.qs);
  float* kns = reinterpret_cast<float*>(smem + L.kns);
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  float* mj = reinterpret_cast<float*>(smem + L.mj);
  float* fj = reinterpret_cast<float*>(smem + L.fj);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* m_run = reinterpret_cast<float*>(smem + L.stat);
  float* l_run = m_run + kMaxTQ;
  float* g_run = l_run + kMaxTQ;       // this round's rescale of acc
  float* part_l = g_run + kMaxTQ;      // per query and warp: sum p f_j
  float* part_s = part_l + kMaxTQ * kWarps;   // the residual lane's p f_j
  int* tbl = reinterpret_cast<int*>(smem + L.tbl);

  const int b = blockIdx.z, h = blockIdx.y, s0 = blockIdx.x * TQ;
  const int nq = min(TQ, S - s0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // the first round's table entries, lengths[b] and the query tile are
  // read together (none depends on another)
  const int first = tid < min(a.nbr, NB) ? a.table[b * NB + tid] : 0;
  const int len = a.lengths[b];
  const size_t qoff = ((size_t)(b * H + h) * S + s0) * D;
  for (int i = tid; i < TQ * D; i += kThreads) {
    const bool in = i / D < nq;
    qs[i] = in ? to_float(static_cast<const T*>(a.q)[qoff + i]) : 0.f;
    if constexpr (R)
      kns[i] = in ? to_float(static_cast<const T*>(a.k_new)[qoff + i]) : 0.f;
  }
  if (tid < min(a.nbr, NB)) tbl[tid] = first;
  if (tid < kMaxTQ) {
    m_run[tid] = -FLT_MAX;
    l_run[tid] = 0.f;
  }
  const int nlive = min(max((len + S + bs - 1) / bs, 1), NB);

  // this thread's (query, dim) pairs and its column group in step 5
  const int P = TQ * D;
  const int splits = max(1, kThreads / P);
  const int my_split = splits > 1 ? tid / P : 0;
  const int npairs = splits > 1 ? (my_split < splits ? 1 : 0)
                                : (P - tid + kThreads - 1) / kThreads;
  const int pair0 = splits > 1 ? tid % P : tid;
  float acc[kPairs];
#pragma unroll
  for (int k = 0; k < kPairs; ++k) acc[k] = 0.f;

  // the pools' copy width: 16-byte copies need 16-byte aligned blocks
  const uintptr_t pools = reinterpret_cast<uintptr_t>(a.k_pool) |
                          reinterpret_cast<uintptr_t>(a.v_pool);
  const int cw = L.span % 16 == 0 && (pools & 15) == 0  ? 16
                 : L.span % 4 == 0 && (pools & 3) == 0 ? 4
                                                       : 1;
  const uint8_t* kp = static_cast<const uint8_t*>(a.k_pool);
  const uint8_t* vp = static_cast<const uint8_t*>(a.v_pool);

  for (int j0 = 0; j0 < nlive; j0 += a.nbr) {
    const int nb = min(a.nbr, nlive - j0);
    const int ncols = nb * bs;
    if (j0 > 0) {
      __syncthreads();                   // the last round's smem is free
      if (tid < nb) tbl[tid] = a.table[b * NB + j0 + tid];
    }
    __syncthreads();

    // 1. every live block of the round into shared memory, all in flight:
    // K (and its scales) in one copy group, V in a second that lands
    // under steps 2-4
    const int chunks = L.span / cw;
    auto stage = [&](uint8_t* dst_pool, const uint8_t* pool, float* dst_scale,
                     const float* scale) {
      for (int i = tid; i < nb * chunks; i += kThreads) {
        const int jb = i / chunks, off = (i - jb * chunks) * cw;
        const size_t src = ((size_t)tbl[jb] * H + h) * L.span + off;
        uint8_t* dst = dst_pool + (size_t)jb * L.span + off;
        if (cw == 16) hopper::cp_async_16(hopper::smem_u32(dst), pool + src, 16);
        else if (cw == 4) hopper::cp_async_4(hopper::smem_u32(dst), pool + src, 4);
        else *dst = pool[src];
      }
      if constexpr (M != kFp) {
        for (int i = tid; i < nb * L.scale_n; i += kThreads) {
          const int jb = i / L.scale_n, e = i - jb * L.scale_n;
          const size_t src = ((size_t)tbl[jb] * H + h) * L.scale_n + e;
          hopper::cp_async_4(hopper::smem_u32(dst_scale + i), scale + src, 4);
        }
      }
      hopper::cp_async_commit();
    };
    stage(stage_k, kp, scale_k, a.k_scale);
    stage(stage_v, vp, scale_v, a.v_scale);
    hopper::cp_async_wait<1>();
    __syncthreads();

    // 2. scores: 8 lanes a (query, column), 4 columns a warp at a time
    if (D <= kMaxD / 2)
      scores<T, M, R, kMaxD / 2 / kGroup>(a, stage_k, scale_k, qs, kns, sc,
                                          nq, ncols, ncap, j0, len, s0,
                                          ginv);
    else
      scores<T, M, R, kMaxD / kGroup>(a, stage_k, scale_k, qs, kns, sc, nq,
                                      ncols, ncap, j0, len, s0, ginv);
    __syncthreads();

    // 3. one warp a query: block maxima and their prefix max m_j (seeded
    // by the earlier rounds'), f_j = exp(m_j - m_last), the rescale g
    for (int r = warp; r < nq; r += kWarps) {
      const float* sr = sc + r * ncap;
      float bm = -FLT_MAX;
      if (lane < nb) {
#pragma unroll 4
        for (int c = 0, cc = lane % bs; c < bs; ++c) {   // rotated start
          bm = fmaxf(bm, sr[lane * bs + cc]);
          cc = cc + 1 == bs ? 0 : cc + 1;
        }
      }
      float m = lane == 0 ? fmaxf(m_run[r], bm) : bm;
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, m, o);
        if (lane >= o) m = fmaxf(m, y);
      }
      const float m_last = __shfl_sync(0xffffffffu, m, nb - 1);
      if (lane < nb) {
        mj[r * kMaxRound + lane] = m;
        fj[r * kMaxRound + lane] = expf(m - m_last);
      }
      if (lane == 0) {
        g_run[r] = expf(m_run[r] - m_last);
        m_run[r] = m_last;
      }
    }
    __syncthreads();

    // 4. kWarps / nq warps a query: the weights w_c = bf16(exp(s - m_j))
    // f_j in place of the scores; each warp's sums of p f_j (and the
    // residual lane's unrounded weight) go to its own slot
    {
      const int wpq = kWarps / nq, r = warp / wpq, wi = warp - r * wpq;
      if (r < nq) {
        float* sr = sc + r * ncap;
        const int qpos = len + s0 + r;
        float psum = 0.f, pself = 0.f;
#pragma unroll 2
        for (int c = wi * 32 + lane; c < ncols; c += 32 * wpq) {
          const int jb = bs_shift >= 0 ? c >> bs_shift : c / bs;
          const int col = j0 * bs + c;
          float w = 0.f;
          if (col <= qpos) {
            const float f = fj[r * kMaxRound + jb];
            const float p = expf(sr[c] - mj[r * kMaxRound + jb]);
            psum += p * f;
            if (R && col == qpos) pself = p * f;   // weighs v_new, unrounded
            else w = round_to<T>(p) * f;           // p.astype(v.dtype)
          }
          sr[c] = w;
        }
        psum = warp_sum(psum);
        pself = warp_sum(pself);
        if (lane == 0) {
          part_l[r * kWarps + wi] = psum;
          part_s[r * kWarps + wi] = pself;
        }
      }
    }
    hopper::cp_async_wait<0>();            // V
    __syncthreads();
    if (tid < nq) {                        // l, its slots summed in order
      float sum = 0.f;
      for (int wi = 0; wi < kWarps / nq; ++wi) sum += part_l[tid * kWarps + wi];
      l_run[tid] = l_run[tid] * g_run[tid] + sum;
    }

    // 5. acc += w V over this thread's columns of the round
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      if (k >= npairs) break;
      const int pair = pair0 + k * kThreads, r = pair / D, d = pair - r * D;
      if (r >= nq) continue;
      // four independent sums over the thread's columns c = my_split +
      // k splits (a weight of 0 adds 0: the values are finite)
      const float* wr = sc + r * ncap;
      float v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f;
      int c = my_split;
      for (; c + 3 * splits < ncols; c += 4 * splits) {
        v0 = fmaf(wr[c], kv_at<T, M>(stage_v, scale_v, c, d, D, G, ginv), v0);
        v1 = fmaf(wr[c + splits],
                  kv_at<T, M>(stage_v, scale_v, c + splits, d, D, G, ginv),
                  v1);
        v2 = fmaf(wr[c + 2 * splits],
                  kv_at<T, M>(stage_v, scale_v, c + 2 * splits, d, D, G,
                              ginv),
                  v2);
        v3 = fmaf(wr[c + 3 * splits],
                  kv_at<T, M>(stage_v, scale_v, c + 3 * splits, d, D, G,
                              ginv),
                  v3);
      }
      for (; c < ncols; c += splits)
        v0 = fmaf(wr[c], kv_at<T, M>(stage_v, scale_v, c, d, D, G, ginv), v0);
      float v = fmaf(acc[k], g_run[r], (v0 + v1) + (v2 + v3));
      if (R && my_split == 0) {
        float w_self = 0.f;
        for (int wi = 0; wi < kWarps / nq; ++wi)
          w_self += part_s[r * kWarps + wi];
        v = fmaf(w_self,
                 to_float(static_cast<const T*>(a.v_new)[qoff + pair]), v);
      }
      acc[k] = v;
    }
  }

  // merge the column groups' partials in group order; out = acc / (l or 1)
  T* out = static_cast<T*>(a.out) + qoff;
  __syncthreads();                       // l_run
  if (splits > 1) {
    if (npairs) red[tid] = acc[0];
    __syncthreads();
    if (tid < P && tid / D < nq) {
      float v = 0.f;
      for (int sp = 0; sp < splits; ++sp) v += red[sp * P + tid];
      const float l = l_run[tid / D];
      out[tid] = from_float<T>(v / (l == 0.f ? 1.f : l));
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      if (k >= npairs) break;
      const int pair = pair0 + k * kThreads, r = pair / D;
      if (r >= nq) continue;
      const float l = l_run[r];
      out[pair] = from_float<T>(acc[k] / (l == 0.f ? 1.f : l));
    }
  }
}

template <typename T, int M, bool R>
cudaError_t launch(Args a, cudaStream_t stream) {
  a.TQ = std::min(a.S, kMaxTQ);
  const int per_block = a.bs * row_bytes<T, M>(a.D) +
                        scales_per_block<M>(a.bs, a.G) * (int)sizeof(float);
  a.nbr = std::max(1, std::min({kStageBudget / (2 * per_block), kMaxRound,
                                a.NB}));
  const size_t smem = layout_of<T, M, R>(a).total;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T, M, R>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.S + a.TQ - 1) / a.TQ, a.H, a.B);
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
               G, scale, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_mode<float>(mode, residual, a, st);
  if (dtype == 1)
    return (int)launch_mode<__nv_bfloat16>(mode, residual, a, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
