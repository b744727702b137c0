// K2: bounded flash-decode attention over the stacked batched KV cache,
// with a fresh row (deferred writes) or without one, optionally with its
// softmax stats, in its tiled kernel; K2s, its speculative-verify mode with
// T query rows per slot, in its tiled kernel; and K2b, its block-attend
// mode for one slot's prefill tail, in its f32 (CUDA-core) kernel.  The
// split-row kernels of K2 and K2s are in flash_decode_split.cu, K2b's
// tensor-core mode in flash_block_tc.cu: each source is its own nvcc (the
// build runs them in parallel), so no one of them is the build's long
// pole.
//
// Replaces the Pallas kernel of fastllama_tpu/ops/pallas/flash_decode.py:
// flash_decode_batched (flash_decode.py:203, body _flash_kernel :67) in
// both of its modes:
//   * fresh (k_new/v_new given): the deferred-write path that
//     make_attn_batched_flash drives from models/batched.decode_step;
//     rows [0, pos[b]) plus the fresh row;
//   * non-fresh (k_new == null): rows [0, pos[b]] of a cache that already
//     holds the current token's row, the mask col <= pos of
//     flash_decode.py:144.  It serves flash_decode_single
//     (flash_decode.py:299) and, on the same function, the always-streaming
//     decode_attention_pallas (ops/pallas/attention.py:48) and
//     decode_attention_pallas_indexed (attention.py:110), which read all S
//     rows and mask; this kernel reads only the rows the mask keeps.
//
// One block per (slot b, kv head h).  The block reads pos[b] itself and
// loops over the rows it needs of layer `layer` only, in tiles of TS rows;
// the TPU kernel's host-bucketed s_bound window has no counterpart.  The
// math is _flash_kernel's (flash_decode.py:123-200), all in f32:
//   score = (q . k) * (1/sqrt(hs)), then times the K row scale (int8 cache);
//   fresh: strict mask (rows >= pos[b] are never read); non-fresh: rows
//   > pos[b] are never read;
//   online max and sum per query row;
//   exp(score - max) times the V row scale before P.V;
//   fresh: the fresh K/V row scored and merged last, un-quantized;
//   output = acc / sum, cast to q's dtype.
// Stats (m_out/l_out given; replaces flash_decode_batched(stats=True),
// flash_decode.py:186-200): the final running max and sum of each query
// row, after the fresh row is merged, as (B, n_kv, hgs) f32, so that the
// caller can merge the deferred staged rows outside the kernel
// (models/batched.decode_step_deferred).  The TPU's 128-lane padding of
// these outputs is a layout of that chip and is not kept.
// GQA: the hgs = n_heads / n_kv query rows of head group h share every
// cache row the block reads (template HGS in {1, 2, 4, 8}).
// pos[b] = 0 (idle slots park there) reads no cache row, and the result is
// exactly v_new: the running max starts at -1e30 as in the TPU kernel, so
// the empty softmax contributes exp(-1e30 - s_new) = 0 and no NaN.  The
// non-fresh mode always reads at least row 0.  At B = 1 (the single-stream
// engine) the grid is only n_kv blocks: 32 of 132 SMs at 7B, and each
// block walks its rows in a serial chain of tiles, which is why the
// wrapper sends every call with hs a multiple of 16 and 16-byte aligned
// caches and fresh rows to a split-row mode on the body of split_rows.cuh:
// the non-fresh calls without stats to flash_decode_split_kernel
// (flash_decode_split.cu), the fresh and stats calls to
// flash_decode_fresh_split_kernel (flash_decode_fresh.cu).  This kernel keeps the other head sizes and
// misaligned views.
//
// What bounds it on an H100: memory bytes.  Each step reads
// pos[b] * hs * 2 cache bytes (+ 8 bytes of row scales) per (slot, head)
// and does ~4 * hgs flops per byte.  The design reads only the live rows;
// loads are coalesced along hs within a warp.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "split_rows.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr int TS = 64;        // cache rows per tile
constexpr int HS_MAX = 256;   // head size limit (2 dims per thread)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// q, k_new, v_new, out: QT; caches CT; row scales f32 or null.
template <typename QT, typename CT, int HGS>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const QT* __restrict__ q,       // (B, n_kv, HGS, hs)
                    const CT* __restrict__ kc,      // (L, Bc, n_kv, S, hs)
                    const CT* __restrict__ vc,
                    const float* __restrict__ ks,   // (L, Bc, n_kv, S) or null
                    const float* __restrict__ vs,
                    const QT* __restrict__ k_new,   // (B, n_kv, hs) or null
                    const QT* __restrict__ v_new,
                    const int* __restrict__ pos,    // (B,)
                    QT* __restrict__ out,           // (B, n_kv, HGS, hs)
                    float* __restrict__ m_out,      // (B, n_kv, HGS) or null
                    float* __restrict__ l_out,
                    int layer, int Bc, int n_kv, int S, int hs, float scale) {
  __shared__ float qs[HGS][HS_MAX];
  __shared__ float sc[HGS][TS];
  __shared__ float m_s[HGS], l_s[HGS], corr_s[HGS], e_s[HGS];

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.x / n_kv;
  const int h = blockIdx.x % n_kv;
  const bool fresh = k_new != nullptr;
  // cache rows to read: [0, pos) with a fresh row, else [0, pos]
  const int p = min(max(pos[b], 0) + (fresh ? 0 : 1), S);
  const size_t row0 = ((size_t)(layer * Bc + b) * n_kv + h) * S;  // cache row index
  const size_t qoff = ((size_t)b * n_kv + h) * HGS * hs;
  const size_t foff = ((size_t)b * n_kv + h) * hs;

  for (int i = tid; i < HGS * hs; i += THREADS) qs[i / hs][i % hs] = to_f(q[qoff + i]);
  if (tid < HGS) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.0f;
  }
  float acc[HGS][2];
#pragma unroll
  for (int g = 0; g < HGS; ++g) acc[g][0] = acc[g][1] = 0.0f;
  __syncthreads();

  for (int r0 = 0; r0 < p; r0 += TS) {
    const int nrows = min(TS, p - r0);
    // scores: one warp per cache row, lanes split the head dims
    for (int r = warp; r < nrows; r += NWARPS) {
      const CT* krow = kc + (row0 + r0 + r) * hs;
      float part[HGS];
#pragma unroll
      for (int g = 0; g < HGS; ++g) part[g] = 0.0f;
      for (int d = lane; d < hs; d += 32) {
        const float kv = to_f(krow[d]);
#pragma unroll
        for (int g = 0; g < HGS; ++g) part[g] += qs[g][d] * kv;
      }
      const float ksc = ks != nullptr ? ks[row0 + r0 + r] : 1.0f;
#pragma unroll
      for (int g = 0; g < HGS; ++g) {
        const float dot = warp_sum(part[g]);
        if (lane == 0) sc[g][r] = ks != nullptr ? dot * scale * ksc : dot * scale;
      }
    }
    __syncthreads();
    // online softmax update, one warp per query row of the group
    for (int g = warp; g < HGS; g += NWARPS) {
      float mx = NEG_INF;
      for (int r = lane; r < nrows; r += 32) mx = fmaxf(mx, sc[g][r]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m2 = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int r = lane; r < nrows; r += 32) {
        const float e = expf(sc[g][r] - m2);
        sum += e;
        sc[g][r] = vs != nullptr ? e * vs[row0 + r0 + r] : e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_old - m2);
        corr_s[g] = c;
        m_s[g] = m2;
        l_s[g] = l_s[g] * c + sum;
      }
    }
    __syncthreads();
    // P.V: each thread owns head dims tid and tid + THREADS
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int d = tid + j * THREADS;
      if (d >= hs) continue;
#pragma unroll
      for (int g = 0; g < HGS; ++g) acc[g][j] *= corr_s[g];
      for (int r = 0; r < nrows; ++r) {
        const float vv = to_f(vc[(row0 + r0 + r) * hs + d]);
#pragma unroll
        for (int g = 0; g < HGS; ++g) acc[g][j] += sc[g][r] * vv;
      }
    }
    __syncthreads();
  }

  const size_t soff = ((size_t)b * n_kv + h) * HGS;
  if (!fresh) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int d = tid + j * THREADS;
      if (d >= hs) continue;
#pragma unroll
      for (int g = 0; g < HGS; ++g)
        out[qoff + (size_t)g * hs + d] = from_f<QT>(acc[g][j] / l_s[g]);
    }
    if (m_out != nullptr && tid < HGS) {
      m_out[soff + tid] = m_s[tid];
      l_out[soff + tid] = l_s[tid];
    }
    return;
  }

  // the fresh row: always attended, full precision
  for (int g = warp; g < HGS; g += NWARPS) {
    float part = 0.0f;
    for (int d = lane; d < hs; d += 32) part += qs[g][d] * to_f(k_new[foff + d]);
    const float s_new = warp_sum(part) * scale;
    if (lane == 0) {
      const float m2 = fmaxf(m_s[g], s_new);
      const float c = expf(m_s[g] - m2);
      const float e = expf(s_new - m2);
      corr_s[g] = c;
      e_s[g] = e;
      m_s[g] = m2;
      l_s[g] = l_s[g] * c + e;
    }
  }
  __syncthreads();
  if (m_out != nullptr && tid < HGS) {
    m_out[soff + tid] = m_s[tid];
    l_out[soff + tid] = l_s[tid];
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int d = tid + j * THREADS;
    if (d >= hs) continue;
    const float vn = to_f(v_new[foff + d]);
#pragma unroll
    for (int g = 0; g < HGS; ++g) {
      const float o = (acc[g][j] * corr_s[g] + e_s[g] * vn) / l_s[g];
      out[qoff + (size_t)g * hs + d] = from_f<QT>(o);
    }
  }
}

// K2s: speculative-verify attention, T query rows per slot (the tiled
// kernel: the calls flash_spec_split_kernel does not take, R = hgs * T
// above 8 or hs off the multiple of 16).
//
// Replaces _flash_spec_kernel / flash_spec_batched (flash_decode.py:579,
// :700).  Slot b's T rows sit at positions pos[b] .. pos[b]+T-1.  Each
// attends cache rows [0, pos[b]) of layer `layer` strictly (row pos[b] and
// later are stale and never read), then the fresh T x T block causally:
// query t sees fresh rows j <= t.  With k_self/v_self (exact_diag) the
// diagonal j == t scores and values use those rows instead of k_new/v_new.
// Cache, off-diagonal fresh rows and diagonal feed one online softmax in
// f32; the int8 rules are K2's (K scale on the score column, V scale on the
// probability before P.V); fresh rows carry no scale.  Output acc / sum in
// q's dtype.
//
// One block per (slot b, kv head h) holds R = hgs * T query rows, row
// r = g * T + t, which share every cache row the block reads.  Dynamic
// shared memory: the R query rows and R accumulator rows (f32, hs each),
// one tile of R x TS scores, and the running max / sum / correction per
// row.  The wrapper keeps R <= 64 and R * hs <= 8192.  Scores: one warp per
// cache row, the row held in registers, lanes split hs.  P.V: each thread
// owns head dims tid and tid + THREADS and walks the query rows 8 at a time
// in registers, so V is read once per 8 query rows.
//
// What bounds it on an H100: memory bytes, pos[b] * hs * 2 cache bytes (+8
// bytes of scales) per (slot, head), read once for all R rows; ~4 * R flops
// per cache byte.
constexpr int SPEC_RB = 8;    // query rows per register pass of P.V

__device__ void spec_online_update(float* sc, float* m_s, float* l_s,
                                   float* corr_s, int R, int nrows,
                                   const float* vsrow, int lane, int warp) {
  for (int r = warp; r < R; r += NWARPS) {
    float* row = sc + r * TS;
    float mx = NEG_INF;
    for (int j = lane; j < nrows; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    const float m_old = m_s[r];
    const float m2 = fmaxf(m_old, mx);
    float sum = 0.0f;
    for (int j = lane; j < nrows; j += 32) {
      const float e = expf(row[j] - m2);
      sum += e;
      row[j] = vsrow != nullptr ? e * vsrow[j] : e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float c = expf(m_old - m2);
      corr_s[r] = c;
      m_s[r] = m2;
      l_s[r] = l_s[r] * c + sum;
    }
  }
}

// Scores of R query rows (qs, f32, hs each) against nrows K rows (krows,
// stride hs) into sc[r * TS + j]: (q . k) * scale, times the row's K scale
// when ksrow is given.  One warp per K row, the row held in registers,
// lanes split hs.  causal: query row r sits at position t0 + r % TQ and
// K row j at j0 + j; rows past the query's position score -1e30.
template <typename KT>
__device__ __forceinline__ void tile_scores(const float* qs, int R, int hs,
                                            const KT* krows,
                                            const float* ksrow, int nrows,
                                            float scale, float* sc,
                                            bool causal, int j0, int t0,
                                            int TQ, int lane, int warp) {
  for (int j = warp; j < nrows; j += NWARPS) {
    const KT* krow = krows + (size_t)j * hs;
    float kr[HS_MAX / 32];
#pragma unroll
    for (int i = 0; i < HS_MAX / 32; ++i) {
      const int d = lane + 32 * i;
      kr[i] = d < hs ? to_f(krow[d]) : 0.0f;
    }
    const float f = ksrow != nullptr ? ksrow[j] : 1.0f;
#pragma unroll 4
    for (int r = 0; r < R; ++r) {
      const float* qr = qs + r * hs;
      float part = 0.0f;
#pragma unroll
      for (int i = 0; i < HS_MAX / 32; ++i) {
        const int d = lane + 32 * i;
        if (d < hs) part += qr[d] * kr[i];
      }
      const float dot = warp_sum(part);
      if (lane == 0)
        sc[r * TS + j] = causal && j0 + j > t0 + r % TQ ? NEG_INF
                                                        : dot * scale * f;
    }
  }
}

// acc[r] = acc[r] * corr[r] + sum_j sc[r * TS + j] * V row j, for the R
// accumulator rows (f32, hs each).  Each thread owns head dims tid and
// tid + THREADS and walks the rows SPEC_RB at a time in registers, so
// each V element is read once per SPEC_RB query rows.
template <typename VT>
__device__ __forceinline__ void tile_pv(float* acc, const float* sc,
                                        const float* corr_s, int R, int hs,
                                        const VT* vrows, int nrows,
                                        int tid) {
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int d = tid + jj * THREADS;
    if (d >= hs) continue;
    for (int rb = 0; rb < R; rb += SPEC_RB) {
      float a[SPEC_RB];
#pragma unroll
      for (int u = 0; u < SPEC_RB; ++u)
        a[u] = rb + u < R ? acc[(rb + u) * hs + d] * corr_s[rb + u] : 0.0f;
      for (int j = 0; j < nrows; ++j) {
        const float vv = to_f(vrows[(size_t)j * hs + d]);
#pragma unroll
        for (int u = 0; u < SPEC_RB; ++u)
          if (rb + u < R) a[u] += sc[(rb + u) * TS + j] * vv;
      }
#pragma unroll
      for (int u = 0; u < SPEC_RB; ++u)
        if (rb + u < R) acc[(rb + u) * hs + d] = a[u];
    }
  }
}

template <typename QT, typename CT>
__global__ void __launch_bounds__(THREADS)
flash_spec_kernel(const QT* __restrict__ q,        // (B, n_kv, R, hs)
                  const CT* __restrict__ kc,       // (L, Bc, n_kv, S, hs)
                  const CT* __restrict__ vc,
                  const float* __restrict__ ks,    // (L, Bc, n_kv, S) or null
                  const float* __restrict__ vs,
                  const QT* __restrict__ k_new,    // (B, n_kv, T, hs)
                  const QT* __restrict__ v_new,
                  const QT* __restrict__ k_self,   // (B, n_kv, T, hs) or null
                  const QT* __restrict__ v_self,
                  const int* __restrict__ pos,     // (B,)
                  QT* __restrict__ out,            // (B, n_kv, R, hs)
                  int layer, int Bc, int n_kv, int S, int hs, int T, int R,
                  float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                 // R * hs
  float* acc = qs + R * hs;         // R * hs
  float* sc = acc + R * hs;         // R * TS
  float* m_s = sc + R * TS;         // R
  float* l_s = m_s + R;             // R
  float* corr_s = l_s + R;          // R

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.x / n_kv;
  const int h = blockIdx.x % n_kv;
  const int p = min(max(pos[b], 0), S);           // cache rows [0, p)
  const size_t row0 = ((size_t)(layer * Bc + b) * n_kv + h) * S;
  const size_t qoff = ((size_t)b * n_kv + h) * R * hs;
  const size_t foff = ((size_t)b * n_kv + h) * T * hs;

  for (int i = tid; i < R * hs; i += THREADS) {
    qs[i] = to_f(q[qoff + i]);
    acc[i] = 0.0f;
  }
  for (int r = tid; r < R; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.0f;
  }
  __syncthreads();

  for (int r0 = 0; r0 < p; r0 += TS) {
    const int nrows = min(TS, p - r0);
    tile_scores(qs, R, hs, kc + (row0 + r0) * hs,
                ks != nullptr ? ks + row0 + r0 : nullptr, nrows, scale, sc,
                false, 0, 0, 1, lane, warp);
    __syncthreads();
    spec_online_update(sc, m_s, l_s, corr_s, R, nrows,
                       vs != nullptr ? vs + row0 + r0 : nullptr, lane, warp);
    __syncthreads();
    tile_pv(acc, sc, corr_s, R, hs, vc + (row0 + r0) * hs, nrows, tid);
    __syncthreads();
  }

  // the fresh block: one warp per (query row, fresh row) pair, causal
  for (int pr = warp; pr < R * T; pr += NWARPS) {
    const int r = pr / T, j = pr % T, t = r % T;
    if (j > t) {
      if (lane == 0) sc[r * TS + j] = NEG_INF;
      continue;
    }
    const QT* krow = (k_self != nullptr && j == t ? k_self : k_new) + foff
                     + (size_t)j * hs;
    float part = 0.0f;
    for (int d = lane; d < hs; d += 32) part += qs[r * hs + d] * to_f(krow[d]);
    const float dot = warp_sum(part);
    if (lane == 0) sc[r * TS + j] = dot * scale;
  }
  __syncthreads();
  spec_online_update(sc, m_s, l_s, corr_s, R, T, nullptr, lane, warp);
  __syncthreads();
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int d = tid + jj * THREADS;
    if (d >= hs) continue;
    for (int r = 0; r < R; ++r) {
      const int t = r % T;
      float a = acc[r * hs + d] * corr_s[r];
      for (int j = 0; j <= t; ++j) {
        const QT* src = v_self != nullptr && j == t ? v_self : v_new;
        a += sc[r * TS + j] * to_f(src[foff + (size_t)j * hs + d]);
      }
      out[qoff + (size_t)r * hs + d] = from_f<QT>(a / l_s[r]);
    }
  }
}

// K2b: block-attend, T query rows of ONE slot over that slot's cache rows
// [0, start) plus a causal fresh block (the prefix-cache tail prefill).
//
// Replaces _flash_block_kernel / flash_block_attend (flash_decode.py:331,
// :426).  q (n_kv, hgs, T, hs) at positions start .. start+T-1; the cache
// is read in place at (layer, slot), rows [0, start) strictly (:377);
// the fresh block k_new/v_new (n_kv, T, hs) is the raw projected K/V
// (never quantized: only the rows written to the cache are), and query t
// sees fresh rows j <= t (:408-410).  One online softmax in f32 over both
// parts; the int8 rules are K2's (K scale on the score, V scale on the
// probability before P.V); output acc / sum in q's dtype.  start = 0 reads
// no cache row.
//
// Unlike K2s, a tail is a whole prefill bucket (up to S rows), so the
// query rows are tiled across blocks: grid (kv head, query tile of TQ
// positions), R = hgs * TQ <= 64 rows a block, row r = g * TQ + tt at
// position t0 + tt (rows past T compute and are not written).  The cache
// part and the fresh block stream through the same 64-row tiles; fresh
// tiles wholly above the block's last position are skipped, and rows
// above the diagonal inside a tile score -1e30.  start, slot and layer
// are launch arguments (host ints).  Shared memory and the tile loops are
// K2s's (tile_scores, spec_online_update, tile_pv).
//
// What bounds it on an H100: at a 7B tail the cache bytes are few (start
// rows of hs int8 per kv head, re-read by each query tile from L2), so it
// is the f32 CUDA-core arithmetic, 4 * R flops per cache element per
// block.  Tensor cores are later work.
template <typename QT, typename CT>
__global__ void __launch_bounds__(THREADS)
flash_block_kernel(const QT* __restrict__ q,       // (n_kv, hgs, T, hs)
                   const CT* __restrict__ kc,      // (L, Bc, n_kv, S, hs)
                   const CT* __restrict__ vc,
                   const float* __restrict__ ks,   // (L, Bc, n_kv, S) or null
                   const float* __restrict__ vs,
                   const QT* __restrict__ k_new,   // (n_kv, T, hs)
                   const QT* __restrict__ v_new,
                   QT* __restrict__ out,           // (n_kv, hgs, T, hs)
                   int layer, int slot, int start, int Bc, int n_kv, int S,
                   int hs, int T, int hgs, int TQ, float scale) {
  extern __shared__ float smem[];
  const int R = hgs * TQ;
  float* qs = smem;                 // R * hs
  float* acc = qs + R * hs;         // R * hs
  float* sc = acc + R * hs;         // R * TS
  float* m_s = sc + R * TS;         // R
  float* l_s = m_s + R;             // R
  float* corr_s = l_s + R;          // R

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int h = blockIdx.x;
  const int t0 = blockIdx.y * TQ;
  const int t_end = min(t0 + TQ, T);              // positions [t0, t_end)
  const int p = min(max(start, 0), S);            // cache rows [0, p)
  const size_t row0 = ((size_t)(layer * Bc + slot) * n_kv + h) * S;
  const size_t foff = (size_t)h * T * hs;

  for (int i = tid; i < R * hs; i += THREADS) {
    const int r = i / hs, d = i % hs;
    const int t = t0 + r % TQ;
    qs[i] = t < T ? to_f(q[(((size_t)h * hgs + r / TQ) * T + t) * hs + d])
                  : 0.0f;
    acc[i] = 0.0f;
  }
  for (int r = tid; r < R; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.0f;
  }
  __syncthreads();

  for (int r0 = 0; r0 < p; r0 += TS) {
    const int nrows = min(TS, p - r0);
    tile_scores(qs, R, hs, kc + (row0 + r0) * hs,
                ks != nullptr ? ks + row0 + r0 : nullptr, nrows, scale, sc,
                false, 0, 0, 1, lane, warp);
    __syncthreads();
    spec_online_update(sc, m_s, l_s, corr_s, R, nrows,
                       vs != nullptr ? vs + row0 + r0 : nullptr, lane, warp);
    __syncthreads();
    tile_pv(acc, sc, corr_s, R, hs, vc + (row0 + r0) * hs, nrows, tid);
    __syncthreads();
  }
  // the fresh block, causal: fresh rows [0, t_end) only
  for (int j0 = 0; j0 < t_end; j0 += TS) {
    const int nrows = min(TS, t_end - j0);
    tile_scores(qs, R, hs, k_new + foff + (size_t)j0 * hs, nullptr, nrows,
                scale, sc, true, j0, t0, TQ, lane, warp);
    __syncthreads();
    spec_online_update(sc, m_s, l_s, corr_s, R, nrows, nullptr, lane, warp);
    __syncthreads();
    tile_pv(acc, sc, corr_s, R, hs, v_new + foff + (size_t)j0 * hs, nrows,
            tid);
    __syncthreads();
  }

  for (int i = tid; i < R * hs; i += THREADS) {
    const int r = i / hs, d = i % hs;
    const int t = t0 + r % TQ;
    if (t < T)
      out[(((size_t)h * hgs + r / TQ) * T + t) * hs + d] =
          from_f<QT>(acc[i] / l_s[r]);
  }
}

// dtype codes shared with ops/kernels/flash_decode.py
enum { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2 };


template <typename QT, typename CT>
int launch_spec(const void* q, const void* kc, const void* vc,
                const float* ks, const float* vs, const void* kn,
                const void* vn, const void* ke, const void* ve,
                const int* pos, void* out, int B, int layer, int Bc, int n_kv,
                int S, int hs, int T, int R, float scale, cudaStream_t st) {
  const size_t smem = (size_t)(2 * R * hs + R * TS + 3 * R) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_spec_kernel<QT, CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  flash_spec_kernel<QT, CT><<<dim3(B * n_kv), THREADS, smem, st>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(kc),
      static_cast<const CT*>(vc), ks, vs, static_cast<const QT*>(kn),
      static_cast<const QT*>(vn), static_cast<const QT*>(ke),
      static_cast<const QT*>(ve), pos, static_cast<QT*>(out), layer, Bc, n_kv,
      S, hs, T, R, scale);
  return (int)cudaGetLastError();
}

template <typename QT>
int launch_spec_q(const void* q, const void* kc, const void* vc,
                  const float* ks, const float* vs, const void* kn,
                  const void* vn, const void* ke, const void* ve,
                  const int* pos, void* out, int B, int layer, int Bc,
                  int n_kv, int S, int hs, int T, int R, float scale, int c_dt,
                  cudaStream_t st) {
  switch (c_dt) {
    case DT_I8:
      return launch_spec<QT, int8_t>(q, kc, vc, ks, vs, kn, vn, ke, ve, pos,
                                     out, B, layer, Bc, n_kv, S, hs, T, R,
                                     scale, st);
    case DT_BF16:
      return launch_spec<QT, __nv_bfloat16>(q, kc, vc, ks, vs, kn, vn, ke, ve,
                                            pos, out, B, layer, Bc, n_kv, S,
                                            hs, T, R, scale, st);
    case DT_F32:
      return launch_spec<QT, float>(q, kc, vc, ks, vs, kn, vn, ke, ve, pos,
                                    out, B, layer, Bc, n_kv, S, hs, T, R,
                                    scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename QT, typename CT>
int launch_cache(const void* q, const void* kc, const void* vc,
                 const float* ks, const float* vs, const void* kn,
                 const void* vn, const int* pos, void* out, float* m_out,
                 float* l_out, int B, int layer, int Bc, int n_kv, int S,
                 int hs, int hgs, float scale, cudaStream_t st) {
  const dim3 grid(B * n_kv);
#define FD_LAUNCH(G)                                                         \
  flash_decode_kernel<QT, CT, G><<<grid, THREADS, 0, st>>>(                  \
      static_cast<const QT*>(q), static_cast<const CT*>(kc),                 \
      static_cast<const CT*>(vc), ks, vs, static_cast<const QT*>(kn),        \
      static_cast<const QT*>(vn), pos, static_cast<QT*>(out), m_out, l_out,  \
      layer, Bc, n_kv, S, hs, scale)
  switch (hgs) {
    case 1: FD_LAUNCH(1); break;
    case 2: FD_LAUNCH(2); break;
    case 4: FD_LAUNCH(4); break;
    case 8: FD_LAUNCH(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef FD_LAUNCH
  return (int)cudaGetLastError();
}

template <typename QT>
int launch_q(const void* q, const void* kc, const void* vc, const float* ks,
             const float* vs, const void* kn, const void* vn, const int* pos,
             void* out, float* m_out, float* l_out, int B, int layer, int Bc,
             int n_kv, int S, int hs, int hgs, float scale, int c_dt,
             cudaStream_t st) {
  switch (c_dt) {
    case DT_I8:
      return launch_cache<QT, int8_t>(q, kc, vc, ks, vs, kn, vn, pos, out,
                                      m_out, l_out, B, layer, Bc, n_kv, S, hs,
                                      hgs, scale, st);
    case DT_BF16:
      return launch_cache<QT, __nv_bfloat16>(q, kc, vc, ks, vs, kn, vn, pos,
                                             out, m_out, l_out, B, layer, Bc,
                                             n_kv, S, hs, hgs, scale, st);
    case DT_F32:
      return launch_cache<QT, float>(q, kc, vc, ks, vs, kn, vn, pos, out,
                                     m_out, l_out, B, layer, Bc, n_kv, S, hs,
                                     hgs, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename QT, typename CT>
int launch_block(const void* q, const void* kc, const void* vc,
                 const float* ks, const float* vs, const void* kn,
                 const void* vn, void* out, int layer, int slot, int start,
                 int Bc, int n_kv, int S, int hs, int T, int hgs, int TQ,
                 float scale, cudaStream_t st) {
  const int R = hgs * TQ;
  const size_t smem = (size_t)(2 * R * hs + R * TS + 3 * R) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_block_kernel<QT, CT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(n_kv, (T + TQ - 1) / TQ);
  flash_block_kernel<QT, CT><<<grid, THREADS, smem, st>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(kc),
      static_cast<const CT*>(vc), ks, vs, static_cast<const QT*>(kn),
      static_cast<const QT*>(vn), static_cast<QT*>(out), layer, slot, start,
      Bc, n_kv, S, hs, T, hgs, TQ, scale);
  return (int)cudaGetLastError();
}

template <typename QT>
int launch_block_q(const void* q, const void* kc, const void* vc,
                   const float* ks, const float* vs, const void* kn,
                   const void* vn, void* out, int layer, int slot, int start,
                   int Bc, int n_kv, int S, int hs, int T, int hgs, int TQ,
                   float scale, int c_dt, cudaStream_t st) {
  switch (c_dt) {
    case DT_I8:
      return launch_block<QT, int8_t>(q, kc, vc, ks, vs, kn, vn, out, layer,
                                      slot, start, Bc, n_kv, S, hs, T, hgs,
                                      TQ, scale, st);
    case DT_BF16:
      return launch_block<QT, __nv_bfloat16>(q, kc, vc, ks, vs, kn, vn, out,
                                             layer, slot, start, Bc, n_kv, S,
                                             hs, T, hgs, TQ, scale, st);
    case DT_F32:
      return launch_block<QT, float>(q, kc, vc, ks, vs, kn, vn, out, layer,
                                     slot, start, Bc, n_kv, S, hs, T, hgs, TQ,
                                     scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K2.  m_out/l_out: (B, n_kv, hgs) f32 softmax stats, or both null.
extern "C" int flash_decode_launch(const void* q, const void* kc,
                                   const void* vc, const void* ks,
                                   const void* vs, const void* k_new,
                                   const void* v_new, const void* pos,
                                   void* out, void* m_out, void* l_out,
                                   int B, int layer, int Bc, int n_kv, int S,
                                   int hs, int hgs, float scale, int q_dt,
                                   int c_dt, void* stream) {
  if (hs > HS_MAX || (m_out == nullptr) != (l_out == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ksp = static_cast<const float*>(ks);
  const float* vsp = static_cast<const float*>(vs);
  const int* pp = static_cast<const int*>(pos);
  float* mp = static_cast<float*>(m_out);
  float* lp = static_cast<float*>(l_out);
  if (q_dt == DT_F32)
    return launch_q<float>(q, kc, vc, ksp, vsp, k_new, v_new, pp, out, mp, lp,
                           B, layer, Bc, n_kv, S, hs, hgs, scale, c_dt, st);
  if (q_dt == DT_BF16)
    return launch_q<__nv_bfloat16>(q, kc, vc, ksp, vsp, k_new, v_new, pp, out,
                                   mp, lp, B, layer, Bc, n_kv, S, hs, hgs,
                                   scale, c_dt, st);
  return (int)cudaErrorInvalidValue;
}

// K2s.  q (B, n_kv, hgs, T, hs) = R = hgs * T rows per (slot, kv head);
// fresh rows (B, n_kv, T, hs) in q's dtype; k_self/v_self null without
// exact_diag; caches and scales as flash_decode_launch.
extern "C" int flash_spec_launch(const void* q, const void* kc,
                                 const void* vc, const void* ks,
                                 const void* vs, const void* k_new,
                                 const void* v_new, const void* k_self,
                                 const void* v_self, const void* pos,
                                 void* out, int B, int layer, int Bc,
                                 int n_kv, int S, int hs, int T, int R,
                                 float scale, int q_dt, int c_dt,
                                 void* stream) {
  if (hs > HS_MAX || T < 1 || T > TS || R < T || R > 64 || R * hs > 8192)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ksp = static_cast<const float*>(ks);
  const float* vsp = static_cast<const float*>(vs);
  const int* pp = static_cast<const int*>(pos);
  if (q_dt == DT_F32)
    return launch_spec_q<float>(q, kc, vc, ksp, vsp, k_new, v_new, k_self,
                                v_self, pp, out, B, layer, Bc, n_kv, S, hs, T,
                                R, scale, c_dt, st);
  if (q_dt == DT_BF16)
    return launch_spec_q<__nv_bfloat16>(q, kc, vc, ksp, vsp, k_new, v_new,
                                        k_self, v_self, pp, out, B, layer, Bc,
                                        n_kv, S, hs, T, R, scale, c_dt, st);
  return (int)cudaErrorInvalidValue;
}

// K2b.  q (n_kv, hgs, T, hs); fresh block (n_kv, T, hs) in q's dtype;
// caches and scales as flash_decode_launch, read at (layer, slot), rows
// [0, start); TQ query positions a block, hgs * TQ <= 64.
extern "C" int flash_block_launch(const void* q, const void* kc,
                                  const void* vc, const void* ks,
                                  const void* vs, const void* k_new,
                                  const void* v_new, void* out, int layer,
                                  int slot, int start, int Bc, int n_kv,
                                  int S, int hs, int T, int hgs, int TQ,
                                  float scale, int q_dt, int c_dt,
                                  void* stream) {
  if (hs > HS_MAX || T < 1 || TQ < 1 || hgs < 1 || hgs * TQ > 64 ||
      start < 0 || start > S || slot < 0 || slot >= Bc)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ksp = static_cast<const float*>(ks);
  const float* vsp = static_cast<const float*>(vs);
  if (q_dt == DT_F32)
    return launch_block_q<float>(q, kc, vc, ksp, vsp, k_new, v_new, out,
                                 layer, slot, start, Bc, n_kv, S, hs, T, hgs,
                                 TQ, scale, c_dt, st);
  if (q_dt == DT_BF16)
    return launch_block_q<__nv_bfloat16>(q, kc, vc, ksp, vsp, k_new, v_new,
                                         out, layer, slot, start, Bc, n_kv, S,
                                         hs, T, hgs, TQ, scale, c_dt, st);
  return (int)cudaErrorInvalidValue;
}
