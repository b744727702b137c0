// K2: bounded flash-decode attention over the stacked batched KV cache,
// with a fresh row (deferred writes) or without one, optionally with its
// softmax stats; K2s, its speculative-verify mode with T query rows per
// slot, in a split-row mode (up to 8 query rows a (slot, kv head)) and a
// tiled one; and K2b, its block-attend mode for one slot's prefill tail
// (below), in an f32 mode and a tensor-core mode.
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
// the non-fresh calls without stats to flash_decode_split_kernel (below),
// the fresh and stats calls to flash_decode_fresh_split_kernel
// (flash_decode_fresh.cu).  This kernel keeps the other head sizes and
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

// K2, split-row mode: non-fresh decode attention without stats.
//
// Replaces, like flash_decode_kernel's non-fresh exit, the Pallas
// flash_decode_single (fastllama_tpu/ops/pallas/flash_decode.py:299; body
// _flash_kernel :67, mask col <= pos :144) and decode_attention_pallas
// (ops/pallas/attention.py:48), decode_attention_pallas_indexed (:110) and
// decode_attention_pallas_batched (:178), and flash_decode_batched
// (flash_decode.py:203) called without fresh rows.  The wrapper sends
// every non-fresh call without stats here when hs is a multiple of 16 (up
// to 256) and the caches start on a 16-byte boundary; the fresh and stats
// calls go to flash_decode_fresh_split_kernel (flash_decode_fresh.cu), on
// the same body; flash_decode_kernel keeps the other head sizes and
// misaligned views.
//
// What bounds it on an H100: memory bytes.  A (slot, kv head) reads
// p = pos[b] + 1 cache rows of K and V, p * hs * 2 elements (+ 8 bytes of
// row scales a row at int8), and does ~4 * hgs flops per element: at
// hgs <= 8 a GEMV, far below the f32 or tensor-core rates, so the design
// is about keeping loads in flight, not about the arithmetic.
//
// What held the tiled kernel back, and what this design does about it (the
// body, split_rows, is in split_rows.cuh):
//   * grid: one block per (slot, kv head), 32 blocks at B=1 on 132 SMs.
//     Here the grid is (B * n_kv, nsplit), with nsplit (ops/kernels/
//     flash_decode.py: split_count) from host ints only, about one wave of
//     16 warps an SM, and blocks of up to 16 warps at hgs 1, fewer at a
//     large B (split_warps, split_block_warps).  Each
//     block reads p from the device and takes rows [r0, r1) of [0, p):
//     chunks of max(ceil(p / nsplit), min_chunk) rows rounded up to
//     SPLIT_UNIT, so the work follows pos with no host sync; a split past
//     p returns at once;
//   * a serial chain of row loads (one warp a row, 4 scalar 2-byte loads a
//     lane, a 5-shuffle sum, a shared store, 16 round trips a tile): here
//     each lane loads 16 bytes of a row (8 bf16, 4 f32, or 16 int8; 8 int8
//     at hgs 8, where q and the accumulators would not fit in registers),
//     LPR lanes a row, so a warp load covers 32 / LPR rows, and a lane
//     issues U rows' K and V loads (4 of each) before it uses the first;
//     the partial dots are summed over the row's lanes with log2(LPR)
//     shuffles.  At hgs 1 a block takes 128 bf16 rows in one round trip;
//   * three barriers a 64-row tile and one warp a query row for the
//     softmax: here each warp owns its rows and keeps scores, running max
//     and sum and its dims' accumulators in registers; the warps merge
//     their (m, l, acc) through shared memory once, at the end;
//   * 2-byte P.V loads a thread: V comes in with K, 16 bytes a lane, and
//     each lane accumulates its own dims of its own rows;
//   * runtime loop bounds: the padded head size HSP (64/128/256, dims past
//     hs read as zeros), hgs, the cache type and the rows a warp step
//     takes are template constants; only the row loop follows p;
//   * long contexts: the time now grows with p / nsplit, not p.
// The merge of the splits, in the same launch: a merge across blocks
// costs ~2-3 us, a block's round trip ~1 (chip_smoke.py phase 5), so a
// split takes at least min_chunk rows (the wrapper's SPLIT_MIN_CHUNK: two
// round trips of a block at hgs 1), a short p uses fewer blocks than
// nsplit, and a cache of fewer than 1024 rows is not split at all; with
// one split holding rows its block writes the output.
// Otherwise each of the n_eff blocks with rows writes its (m, l, acc) to a
// workspace and takes a ticket; the last to finish merges them in split
// order, writes the output and puts its ticket back to 0 for the next
// call (and a later CUDA-graph capture).  The workspace and tickets belong
// to the wrapper and are shared by every launch: safe on one stream,
// which is all the port uses.  Tried and dropped (phase 5): a thread
// block cluster merging through distributed shared memory (no faster, and
// slower in clusters of 8 or 16 blocks); split 0 loading its first rows
// before pos arrives, and a second register stage prefetching the next
// step (slower: the rows past p cost load bandwidth of the few busy SMs,
// and the registers went to 128).
// Math as _flash_kernel's, all in f32: score = (q . k) * (1/sqrt(hs)) *
// k_scale; the running max starts at -1e30; e * v_scale before P.V;
// output acc / l in q's dtype.  Only the f32 sum order differs, across
// lanes, warps and splits.

// q (B, n_kv, HGS, hs) and out: f32 (q_bf16 = 0) or bf16; the rest as
// split_rows.
template <typename CT, int HSP, int HGS>
__global__ void __launch_bounds__(split_warps<CT, HGS>() * 32)
flash_decode_split_kernel(const void* __restrict__ q,      // (B, n_kv, HGS, hs)
                          const CT* __restrict__ kc,       // (L, Bc, n_kv, S, hs)
                          const CT* __restrict__ vc,
                          const float* __restrict__ ks,    // (L, Bc, n_kv, S) or null
                          const float* __restrict__ vs,
                          const int* __restrict__ pos,     // (B,)
                          void* __restrict__ out,          // (B, n_kv, HGS, hs)
                          float* __restrict__ part_acc,
                          float* __restrict__ part_ml,
                          int* __restrict__ ticket,
                          int layer, int Bc, int n_kv, int S, int hs,
                          int nsplit, int min_chunk, float scale, int q_bf16) {
  split_rows<CT, HSP, HGS, SplitIO<CT, HGS>, false>(
      q, kc, vc, ks, vs, nullptr, nullptr, nullptr, nullptr, pos, out,
      part_acc, part_ml, ticket, layer, Bc, n_kv, S, hs, 1, HGS, nsplit,
      min_chunk, scale, q_bf16);
}

// K2s, split-row mode: speculative-verify attention, R = hgs * T <= 8
// query rows per (slot, kv head).
//
// Replaces, like flash_spec_kernel below, _flash_spec_kernel /
// flash_spec_batched (fastllama_tpu/ops/pallas/flash_decode.py:579, :700):
// slot b's T rows at positions pos[b] .. pos[b]+T-1 attend the cache rows
// [0, pos[b]) of layer `layer` strictly, then the fresh T x T block
// causally (query t sees fresh rows j <= t, at j == t the exact rows
// k_self/v_self when given); one online softmax in f32 over both; K scale
// on the score, V scale on the probability before P.V; fresh rows carry
// no scale; output acc / l in q's dtype.  The wrapper sends every call
// with R <= 8 and hs a multiple of 16 (up to 256) here; flash_spec_kernel
// keeps the rest.
//
// What bounds it on an H100: the bytes bound is pos[b] * hs * 2 cache
// bytes (+ 8 bytes of row scales a row at int8) per (slot, kv head), read
// once for all R rows; but each element takes R f32 FMAs (scores, then
// P.V) and, at int8, its conversion, so at R >= 2 the f32 issue rate
// (and the warps an SM that hide its latencies) bounds it.  SpecIO
// converts int8 by a byte permute (2 full-rate ops), not I2F (quarter
// rate).
//
// What held the tiled kernel back, and what this design does about it:
// the tiled kernel's one warp a cache row with scalar 1-byte loads and a
// 5-shuffle sum a query row, its one warp a query row for the softmax
// (scores reread from shared memory), three barriers a 64-row tile, P.V
// one V element a thread with the R accumulator rows in shared memory,
// and its serial fresh block (one warp a (query row, fresh row) pair,
// then a serial loop a thread).  Here the cache part is K2's split-row
// loop (split_rows) with the R rows as its query rows: 16-byte loads a
// lane (8 bytes at int8), each warp's scores, (m, l) and accumulators for
// all RP rows in registers, one merge through shared memory; the grid is
// (B * n_kv, nsplit) with the splits and ticket merge of K2's split mode
// over [0, pos).  The fresh block is T more rows (k_new, and k_self at the
// diagonal), copied by cp.async into shared memory while the cache is
// read, that the warps of the split holding the last cache rows score and
// merge into their registers before the warps merge, so it enters the
// softmax once: split 0 alone at pos 0, where the running max starts at
// -1e30 and the empty cache part weighs exp(-1e30 - s) = 0.  Only the f32
// sum order differs from the plain version.  RP (2, 4 or 8) pads R; the
// least RP >= R is launched.
// Tuned on the card (phase 5 of chip_smoke.py; PERF.md): R rows of FMAs
// per element make it issue-bound, so warps an SM count most.  Each step's
// loads are issued before the previous step's arithmetic (split_rows's PF)
// with U = 1 row a lane (2 at RP 2: spec_loads), and at an int8 cache and
// RP 4 the launch bounds ask for 4 blocks an SM (128 registers; 2 with 16
// bytes a load, 3 with U = 2).
template <int RP> __host__ __device__ constexpr int spec_loads() {
  return RP >= 4 ? 1 : 2;
}
template <typename CT, int RP>
__host__ __device__ constexpr int spec_min_blocks() {
  return RP == 4 && sizeof(CT) == 1 ? 4 : 1;
}
template <typename CT, int HSP, int RP>
__global__ void __launch_bounds__(split_warps<CT, RP>() * 32,
                                  spec_min_blocks<CT, RP>())
flash_spec_split_kernel(const void* __restrict__ q,       // (B, n_kv, R, hs)
                        const CT* __restrict__ kc,        // (L, Bc, n_kv, S, hs)
                        const CT* __restrict__ vc,
                        const float* __restrict__ ks,     // (L, Bc, n_kv, S) or null
                        const float* __restrict__ vs,
                        const void* __restrict__ k_new,   // (B, n_kv, T, hs)
                        const void* __restrict__ v_new,
                        const void* __restrict__ k_self,  // (B, n_kv, T, hs) or null
                        const void* __restrict__ v_self,
                        const int* __restrict__ pos,      // (B,)
                        void* __restrict__ out,           // (B, n_kv, R, hs)
                        float* __restrict__ part_acc,
                        float* __restrict__ part_ml,
                        int* __restrict__ ticket,
                        int layer, int Bc, int n_kv, int S, int hs, int T,
                        int R, int nsplit, int min_chunk, float scale,
                        int q_bf16) {
  split_rows<CT, HSP, RP, SpecIO<CT>, true, spec_loads<RP>(), true>(
      q, kc, vc, ks, vs, k_new, v_new, k_self, v_self, pos, out, part_acc,
      part_ml, ticket, layer, Bc, n_kv, S, hs, T, R, nsplit, min_chunk,
      scale, q_bf16);
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

// K2b, TC mode: the same function on tensor cores, for bf16 q (and fresh
// block) over an int8 (row-scaled) or bf16 cache, hs % 16 == 0 (hs <= 128,
// or hgs <= 32 up to 256): the prefix cache's serving path.  Every other
// call (f32 q, an f32 cache, other head sizes) takes flash_block_kernel
// above, the f32 mode.  Replaces _flash_block_kernel / flash_block_attend
// (flash_decode.py:331, :426) as that kernel does, with one departure: the
// probabilities, e * v_scale for the cache part and e for the fresh block,
// are rounded to bf16 before P.V (as the Pallas kernel's default-precision
// dot_general feeds the MXU bf16, flash_decode.py:362-392).  q, bf16 K/V
// and int8 K/V are exact in bf16; scores, softmax and O stay in f32.
//
// What bounds it on an H100: memory bytes.  At the 7B tail (hs 128, start
// 256, T 32-256) a call reads start rows of int8 K and V per kv head
// (+8 bytes of scales a row), q, the fresh block and writes the output:
// 3.2 MB at T=32 and 10.6 MB at T=256, 0.96 and 3.15 us at 3.35 TB/s; the
// operations, at 989 TFLOP/s bf16, are 7x (T=32) and 2x (T=256) below.
// The f32 mode ran ~44x over its f32-ops bound in warp-per-key dot
// products with 5-shuffle sums, an accumulator in shared memory and three
// barriers a tile.  This design:
//   * grid (kv head, query tile of TQ positions), 4 warps; R = hgs * TQ
//     <= 64 query rows a block (32 past hs 128; row r = g * TQ + tt at
//     position t0 + tt, rows past T or past R compute and are not
//     written); block_rows picks R a multiple of 16 where it can.  The
//     warps form R / 16 row groups of 16 rows times WK = 1, 2 or 4 key
//     groups: each key group takes 64 / WK keys of every tile with its
//     own running max, sum and O, and the key groups of a row group merge
//     through shared memory at the end -- so a 16-row block (T=32 at
//     hgs 1) still runs 4 warps;
//   * every loop of a tile has constant bounds (templates on the head
//     size padded to 64, 128 or 256 -- K/V/Q dims past hs are zero -- and
//     on the keys a warp takes), so a step's fragment loads issue ahead of
//     its mma; runtime bounds put a branch after every mma and left each
//     load's latency exposed (the SASS showed it), at twice the time;
//     short score chains (16 or 32 keys a warp) use two accumulators;
//   * Q A-fragments loaded once from global memory into registers
//     (hs <= 128; from shared memory past that, where registers run out);
//   * K/V tiles of 64 rows (cache rows, then the fresh block's) staged
//     raw by 16-byte cp.async, TC_STAGES deep so two tiles load while one
//     computes, with the tile's K and V row scales beside them; rows past
//     the tile's end are zero-filled; row strides padded so the fragment
//     loads hit distinct banks;
//   * S = Q.K^T and O += P.V on mma.sync.m16n8k16 (bf16 in, f32 out),
//     int8 converted to bf16 (exactly) while the B fragments are built.
//     The k index of Q.K^T is permuted inside each 16-wide step, and the
//     output dims of P.V inside each 32-dim block, so that one 32-bit
//     (int8) or 64-bit (bf16) load gives a K fragment pair, and four give
//     V's fragments of four n-tiles (no ldmatrix: int8 has to be
//     converted in registers anyway).  Scores scaled by 1/sqrt(hs) and
//     the K row scale in the C layout, masked (cache rows >= start; fresh
//     rows above the diagonal), online max and sum in registers over the
//     lane quad that holds a row, the C fragments reused as P's A
//     fragments (FlashAttention-2), O in registers for the whole kernel;
//     two barriers a tile;
//   * fresh tiles wholly above a key group's last position are skipped.
// Left for later: wgmma and TMA loads; a split of the cache rows across
// blocks with a combine pass -- at T=32 the grid is n_kv x 2 = 64 blocks,
// half the 132 SMs, and each 64-row tile still adds ~2 us to a block's
// chain (chip_smoke.py phase 5 times it against start).
constexpr int TC_THREADS = 128;
constexpr int TC_ROWS = 64;   // query rows a block: 4 warps x 16
constexpr int TC_TS = 64;     // K/V rows a tile
constexpr int TC_STAGES = 3;  // K/V tiles in shared memory: 2 in flight
constexpr int TC_QROWS_256 = 32;  // query rows a block at hs > 128

// two bf16 as one 32-bit register of an mma.sync fragment, lo in the low
// half
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// d += a (16x16, row major) * b (16x8, column major), bf16 in, f32 out
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// signed byte i of w, and two of them as a bf16 pair (exact)
__device__ __forceinline__ int sbyte(uint32_t w, int i) {
  return (int)(int8_t)(w >> (8 * i));
}
__device__ __forceinline__ uint32_t bf2(int lo, int hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn((float)lo, (float)hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Q.K^T's B fragment (b0, b1) from elements 0-3 of a K row.  The k index
// is permuted inside each 16-wide step -- slots 2 t4, 2 t4 + 1, 2 t4 + 8,
// 2 t4 + 9 hold dims 4 t4 .. 4 t4 + 3 -- in Q's A fragments too, so one
// 32-bit (int8) or 64-bit (bf16) load feeds both registers.
__device__ __forceinline__ uint2 k_frag(const int8_t* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  return make_uint2(bf2(sbyte(w, 0), sbyte(w, 1)),
                    bf2(sbyte(w, 2), sbyte(w, 3)));
}
__device__ __forceinline__ uint2 k_frag(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint2*>(p);
}

// P.V's B fragments of 4 n-tiles from one 32-dim block.  The output dims
// are permuted: n-tile dl, column n holds dim 4 n + dl of the block, so
// lane g reads dims 4 g .. 4 g + 3 of the k-step's 4 key rows (p: key
// 2 t4; + str: 2 t4 + 1; + 8 str, + 9 str) in four loads and gets b of
// all 4 n-tiles.
__device__ __forceinline__ void v_frags(const int8_t* p, int str,
                                        uint32_t (&b)[4][2]) {
  const uint32_t w0 = *reinterpret_cast<const uint32_t*>(p);
  const uint32_t w1 = *reinterpret_cast<const uint32_t*>(p + str);
  const uint32_t w2 = *reinterpret_cast<const uint32_t*>(p + 8 * str);
  const uint32_t w3 = *reinterpret_cast<const uint32_t*>(p + 9 * str);
#pragma unroll
  for (int dl = 0; dl < 4; ++dl) {
    b[dl][0] = bf2(sbyte(w0, dl), sbyte(w1, dl));
    b[dl][1] = bf2(sbyte(w2, dl), sbyte(w3, dl));
  }
}
__device__ __forceinline__ void v_frags(const __nv_bfloat16* p, int str,
                                        uint32_t (&b)[4][2]) {
  const uint2 w0 = *reinterpret_cast<const uint2*>(p);
  const uint2 w1 = *reinterpret_cast<const uint2*>(p + str);
  const uint2 w2 = *reinterpret_cast<const uint2*>(p + 8 * str);
  const uint2 w3 = *reinterpret_cast<const uint2*>(p + 9 * str);
#pragma unroll
  for (int dl = 0; dl < 4; ++dl) {
    const unsigned sel = (dl & 1) ? 0x7632u : 0x5410u;
    b[dl][0] = __byte_perm(dl < 2 ? w0.x : w0.y, dl < 2 ? w1.x : w1.y, sel);
    b[dl][1] = __byte_perm(dl < 2 ? w2.x : w2.y, dl < 2 ? w3.x : w3.y, sel);
  }
}

// One 64-row K/V tile for a warp's 16 query rows (lane: rows g and g + 8,
// columns 2 t4 and 2 t4 + 1 of each 8-column C tile), over the warp's
// 8 NTK keys of it.  HS: the head size the tiles are laid out for (dims
// past the real one are zero).  Every loop bound is a constant, so the
// loads of a step are issued ahead of its mma.  kb/vb: the warp's first
// key row; ksb/vsb: their row scales or null; keys j < n are in the
// tile; causal: key j0 + j is seen by a row at position tpos only if
// j0 + j <= tpos.
template <typename TT, int HS, int NTK, bool QREG>
__device__ __forceinline__ void tc_tile(
    float (&o)[HS / 8][4], float (&m)[2], float (&l)[2],
    const uint32_t (&qf)[QREG ? HS / 16 : 1][4], const __nv_bfloat16* qw,
    const TT* kb, const TT* vb, const float* ksb, const float* vsb, int n,
    bool causal, int j0, const int (&tpos)[2], float scale, int g, int t4) {
  constexpr int KSTR = HS + 16;                       // elements a K row
  constexpr int VSTR = HS + 16 / (int)sizeof(TT);     // elements a V row
  constexpr int QSTR = HS + 16;
  // short score chains (few n-tiles) split over two accumulators
  constexpr int NACC = NTK < 8 ? 2 : 1;
  float s[NACC][NTK][4];
#pragma unroll
  for (int c = 0; c < NACC; ++c)
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][nt][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < HS / 16; ++kk) {
    uint32_t a[4];
    if constexpr (QREG) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
    } else {
      const uint2 lo = *reinterpret_cast<const uint2*>(qw + g * QSTR +
                                                        kk * 16 + 4 * t4);
      const uint2 hi = *reinterpret_cast<const uint2*>(
          qw + (g + 8) * QSTR + kk * 16 + 4 * t4);
      a[0] = lo.x;
      a[1] = hi.x;
      a[2] = lo.y;
      a[3] = hi.y;
    }
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt) {
      const uint2 b = k_frag(kb + (nt * 8 + g) * KSTR + kk * 16 + 4 * t4);
      const uint32_t bb[2] = {b.x, b.y};
      mma_16816(s[kk % NACC][nt], a, bb);
    }
  }
  // scale, K row scale, mask; the row max over the lane quad.  A row that
  // has seen no key yet keeps m = -1e30 and takes e = 0 (mu = 0).
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nt = 0; nt < NTK; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = nt * 8 + 2 * t4 + (e & 1);
      float v = s[0][nt][e];
      if constexpr (NACC == 2) v += s[1][nt][e];
      v *= scale;
      if (ksb != nullptr) v *= ksb[j];
      const bool ok = j < n && (!causal || j0 + j <= tpos[e >> 1]);
      s[0][nt][e] = ok ? v : NEG_INF;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[0][nt][e]);
    }
  float corr[2], mu[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 1));
    mx[hr] = fmaxf(mx[hr], __shfl_xor_sync(0xffffffffu, mx[hr], 2));
    mu[hr] = mx[hr] == NEG_INF ? 0.0f : mx[hr];
    corr[hr] = __expf(m[hr] - mu[hr]);
    m[hr] = mx[hr];
  }
  // e in f32 for the sum; e * v_scale rounded to bf16 as P's A fragments
  uint32_t pa[NTK / 2][4];
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int nt = 0; nt < NTK; ++nt) {
    float e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      e[i] = __expf(s[0][nt][i] - mu[i >> 1]);
      sum[i >> 1] += e[i];
    }
    if (vsb != nullptr) {
      const float2 w = *reinterpret_cast<const float2*>(vsb + nt * 8 + 2 * t4);
      e[0] *= w.x;
      e[1] *= w.y;
      e[2] *= w.x;
      e[3] *= w.y;
    }
    pa[nt / 2][(nt & 1) * 2] =
        pack_bf16(__float2bfloat16_rn(e[0]), __float2bfloat16_rn(e[1]));
    pa[nt / 2][(nt & 1) * 2 + 1] =
        pack_bf16(__float2bfloat16_rn(e[2]), __float2bfloat16_rn(e[3]));
  }
  // lane-partial sums: corr is the quad's, so the quad sum is taken once
  // at the end
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) l[hr] = l[hr] * corr[hr] + sum[hr];
#pragma unroll
  for (int d = 0; d < HS / 8; ++d) {
    o[d][0] *= corr[0];
    o[d][1] *= corr[0];
    o[d][2] *= corr[1];
    o[d][3] *= corr[1];
  }
#pragma unroll
  for (int kk = 0; kk < NTK / 2; ++kk) {
    const TT* vr = vb + (kk * 16 + 2 * t4) * VSTR + 4 * g;
#pragma unroll
    for (int blk = 0; blk < HS / 32; ++blk) {
      uint32_t bf[4][2];
      v_frags(vr + blk * 32, VSTR, bf);
#pragma unroll
      for (int dl = 0; dl < 4; ++dl) mma_16816(o[4 * blk + dl], pa[kk], bf[dl]);
    }
  }
}

template <typename CT, int HS, int NTK>
__global__ void __launch_bounds__(TC_THREADS)
flash_block_tc_kernel(const __nv_bfloat16* __restrict__ q,  // (n_kv, hgs, T, hs)
                      const CT* __restrict__ kc,     // (L, Bc, n_kv, S, hs)
                      const CT* __restrict__ vc,
                      const float* __restrict__ ks,  // (L, Bc, n_kv, S) or null
                      const float* __restrict__ vs,
                      const __nv_bfloat16* __restrict__ k_new,  // (n_kv, T, hs)
                      const __nv_bfloat16* __restrict__ v_new,
                      __nv_bfloat16* __restrict__ out,  // (n_kv, hgs, T, hs)
                      int layer, int slot, int start, int Bc, int n_kv, int S,
                      int hs, int T, int hgs, int TQ, float scale) {
  constexpr bool QREG = HS <= 128;
  // warps: 4 / WK row groups of 16 rows x WK key groups of 8 NTK keys
  constexpr int WK = 8 / NTK, KW = 8 * NTK;
  constexpr int QSTR = HS + 16;            // bf16 a Q row in shared memory
  constexpr int KBYTES = 2 * HS + 32;      // bytes a K row of a stage
  constexpr int VBYTES = 2 * HS + 16;      // bytes a V row
  constexpr int SBYTES = TC_TS * (KBYTES + VBYTES);
  extern __shared__ __align__(16) unsigned char smem_tc[];
  // TC_STAGES stages of K and V rows, their scales, then Q rows (hs 256)
  unsigned char* kv = smem_tc;
  float* scl = reinterpret_cast<float*>(kv + (size_t)TC_STAGES * SBYTES);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(scl + TC_STAGES * 2 * TC_TS);
  const int R = hgs * TQ, WR = 4 / WK;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = warp % WR, wk = warp / WR;
  const int h = blockIdx.x;
  const int t0 = blockIdx.y * TQ;
  const int t_end = min(t0 + TQ, T);               // positions [t0, t_end)
  const int p = min(max(start, 0), S);             // cache rows [0, p)
  const size_t row0 = ((size_t)(layer * Bc + slot) * n_kv + h) * S;
  const size_t foff = (size_t)h * T * hs;
  const int nc = (p + TC_TS - 1) / TC_TS;          // cache tiles
  const int ntiles = nc + (t_end + TC_TS - 1) / TC_TS;

  // tile i into stage i % TC_STAGES: cache rows [64 i, ...) of CT, then
  // the fresh block's rows [64 (i - nc), ...) of bf16.  A K row is HS + 16,
  // a V row HS + 16 / sizeof elements of the tile's type (strides that
  // keep the fragment loads free of bank conflicts); rows past the tile's
  // end, dims past hs and the missing rows' scales are zero-filled.
  auto issue = [&](int i) {
    unsigned char* kb = kv + (size_t)(i % TC_STAGES) * SBYTES;
    unsigned char* vb = kb + (size_t)TC_TS * KBYTES;
    float* ksb = scl + (i % TC_STAGES) * 2 * TC_TS;
    if (i < nc) {
      const int r0 = i * TC_TS, n = min(TC_TS, p - r0);
      const int rb = hs * (int)sizeof(CT);
      constexpr int CPR = HS * (int)sizeof(CT) / 16;   // chunks a row
      const unsigned char* ksrc =
          reinterpret_cast<const unsigned char*>(kc + (row0 + r0) * hs);
      const unsigned char* vsrc =
          reinterpret_cast<const unsigned char*>(vc + (row0 + r0) * hs);
      for (int c = tid; c < TC_TS * CPR; c += TC_THREADS) {
        const int r = c / CPR, off = (c % CPR) * 16;
        const bool in = r < n && off < rb;
        const size_t so = in ? (size_t)r * rb + off : 0;
        cp_async16(kb + r * (HS * (int)sizeof(CT) + 16 * (int)sizeof(CT)) + off,
                   ksrc + so, in ? 16 : 0);
        cp_async16(vb + r * (HS * (int)sizeof(CT) + 16) + off, vsrc + so,
                   in ? 16 : 0);
      }
      if (ks != nullptr)
        for (int r = tid; r < TC_TS; r += TC_THREADS) {
          const size_t at = row0 + r0 + (r < n ? r : 0);
          cp_async4(ksb + r, ks + at, r < n ? 4 : 0);
          cp_async4(ksb + TC_TS + r, vs + at, r < n ? 4 : 0);
        }
    } else {
      const int j0 = (i - nc) * TC_TS, n = min(TC_TS, t_end - j0);
      const int rb = hs * 2;
      constexpr int CPR = HS * 2 / 16;
      const unsigned char* ksrc =
          reinterpret_cast<const unsigned char*>(k_new + foff + (size_t)j0 * hs);
      const unsigned char* vsrc =
          reinterpret_cast<const unsigned char*>(v_new + foff + (size_t)j0 * hs);
      for (int c = tid; c < TC_TS * CPR; c += TC_THREADS) {
        const int r = c / CPR, off = (c % CPR) * 16;
        const bool in = r < n && off < rb;
        const size_t so = in ? (size_t)r * rb + off : 0;
        cp_async16(kb + r * KBYTES + off, ksrc + so, in ? 16 : 0);
        cp_async16(vb + r * VBYTES + off, vsrc + so, in ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  for (int i = 0; i < TC_STAGES - 1; ++i) {
    if (i < ntiles)
      issue(i);
    else
      cp_async_commit();
  }

  // the lane's two rows and the row group's last real position (-1: none)
  int tpos[2], wmax = -1;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) tpos[hr] = t0 + (wr * 16 + g + 8 * hr) % TQ;
  for (int r = wr * 16; r < min(wr * 16 + 16, R); ++r)
    if (t0 + r % TQ < T) wmax = max(wmax, t0 + r % TQ);

  // Q's A fragments, k-permuted as k_frag: from global memory into
  // registers (HS <= 128), else into shared memory; zero past T, R and hs
  uint32_t qf[QREG ? HS / 16 : 1][4];
  const __nv_bfloat16* qw = qs + wr * 16 * QSTR;
  if constexpr (QREG) {
    const __nv_bfloat16* qrow[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = wr * 16 + g + 8 * hr;
      qrow[hr] = r < R && tpos[hr] < T
                     ? q + (((size_t)h * hgs + r / TQ) * T + tpos[hr]) * hs
                     : nullptr;
    }
#pragma unroll
    for (int kk = 0; kk < HS / 16; ++kk) {
      uint2 f[2] = {make_uint2(0u, 0u), make_uint2(0u, 0u)};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        if (kk * 16 < hs && qrow[hr] != nullptr)
          f[hr] = *reinterpret_cast<const uint2*>(qrow[hr] + kk * 16 + 4 * t4);
      qf[kk][0] = f[0].x;
      qf[kk][1] = f[1].x;
      qf[kk][2] = f[0].y;
      qf[kk][3] = f[1].y;
    }
  } else {
    constexpr int QC = HS / 8;
    for (int i = tid; i < TC_QROWS_256 * QC; i += TC_THREADS) {
      const int r = i / QC, c = i % QC;
      const int t = t0 + r % TQ;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < R && t < T && c * 8 < hs)
        v = *reinterpret_cast<const uint4*>(
            q + (((size_t)h * hgs + r / TQ) * T + t) * hs + c * 8);
      *reinterpret_cast<uint4*>(qs + r * QSTR + c * 8) = v;
    }
  }
  float o[HS / 8][4];
#pragma unroll
  for (int d = 0; d < HS / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

  const int k0 = wk * KW;                          // the warp's first key
  for (int i = 0; i < ntiles; ++i) {
    if (i + TC_STAGES - 1 < ntiles)
      issue(i + TC_STAGES - 1);
    else
      cp_async_commit();
    cp_async_wait<TC_STAGES - 1>();
    __syncthreads();
    const unsigned char* kb = kv + (size_t)(i % TC_STAGES) * SBYTES;
    const unsigned char* vb = kb + (size_t)TC_TS * KBYTES;
    const float* ksb = scl + (i % TC_STAGES) * 2 * TC_TS + k0;
    if (i < nc) {
      constexpr int CK = HS + 16, CV = HS + 16 / (int)sizeof(CT);
      const int n = min(TC_TS, p - i * TC_TS) - k0;
      if (wmax >= 0 && n > 0)
        tc_tile<CT, HS, NTK, QREG>(
            o, m, l, qf, qw, reinterpret_cast<const CT*>(kb) + k0 * CK,
            reinterpret_cast<const CT*>(vb) + k0 * CV,
            ks != nullptr ? ksb : nullptr, ks != nullptr ? ksb + TC_TS : nullptr,
            n, false, 0, tpos, scale, g, t4);
    } else {
      const int j0 = (i - nc) * TC_TS + k0;
      const int n = min(TC_TS, t_end - (i - nc) * TC_TS) - k0;
      if (wmax >= j0 && n > 0)
        tc_tile<__nv_bfloat16, HS, NTK, QREG>(
            o, m, l, qf, qw,
            reinterpret_cast<const __nv_bfloat16*>(kb) + k0 * (HS + 16),
            reinterpret_cast<const __nv_bfloat16*>(vb) + k0 * (HS + 8),
            nullptr, nullptr, n, true, j0, tpos, scale, g, t4);
    }
    __syncthreads();
  }

  // the key groups of a row group merge into the first, through the
  // stages' shared memory: per warp, o in fragment order, then m and l
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
  if constexpr (WK > 1) {
    constexpr int NV = HS / 2 + 4;
    float* mg = reinterpret_cast<float*>(kv);
    if (wk > 0) {
      float* dst = mg + (size_t)warp * NV * 32 + lane;
#pragma unroll
      for (int d = 0; d < HS / 8; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[(4 * d + e) * 32] = o[d][e];
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        dst[(HS / 2 + hr) * 32] = m[hr];
        dst[(HS / 2 + 2 + hr) * 32] = l[hr];
      }
    }
    __syncthreads();
    if (wk == 0) {
#pragma unroll
      for (int k = 1; k < WK; ++k) {
        const float* src = mg + (size_t)(wr + k * WR) * NV * 32 + lane;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const float mk = src[(HS / 2 + hr) * 32];
          const float mm = fmaxf(m[hr], mk);
          const float mu = mm == NEG_INF ? 0.0f : mm;
          const float fa = __expf(m[hr] - mu), fb = __expf(mk - mu);
          l[hr] = l[hr] * fa + src[(HS / 2 + 2 + hr) * 32] * fb;
          m[hr] = mm;
#pragma unroll
          for (int d = 0; d < HS / 8; ++d)
#pragma unroll
            for (int e = 2 * hr; e < 2 * hr + 2; ++e)
              o[d][e] = o[d][e] * fa + src[(4 * d + e) * 32] * fb;
        }
      }
    }
  }
  if (wk != 0) return;

  // output dims: block blk's n-tile dl column c is dim 32 blk + 4 c + dl,
  // so the lane writes dims 32 blk + 8 t4 .. + 7 of each row (those < hs)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = wr * 16 + g + 8 * hr;
    if (r >= R || tpos[hr] >= T) continue;
    __nv_bfloat16* orow = out + (((size_t)h * hgs + r / TQ) * T + tpos[hr]) * hs;
    const float inv = 1.0f / l[hr];
#pragma unroll
    for (int blk = 0; blk < HS / 32; ++blk) {
      if (blk * 32 + 8 * t4 >= hs) continue;
      uint4 v;
      uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int dl = 0; dl < 4; dl += 2) {
        w[dl / 2] = pack_bf16(__float2bfloat16_rn(o[4 * blk + dl][2 * hr] * inv),
                              __float2bfloat16_rn(o[4 * blk + dl + 1][2 * hr] * inv));
        w[2 + dl / 2] =
            pack_bf16(__float2bfloat16_rn(o[4 * blk + dl][2 * hr + 1] * inv),
                      __float2bfloat16_rn(o[4 * blk + dl + 1][2 * hr + 1] * inv));
      }
      *reinterpret_cast<uint4*>(orow + blk * 32 + 8 * t4) = v;
    }
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

// K2's split-row mode: the padded head size and hgs as template constants
template <typename CT, int HSP, int HGS>
int launch_split_h(const void* q, const void* kc, const void* vc,
                   const float* ks, const float* vs, const int* pos,
                   void* out, float* part_acc, float* part_ml, int* ticket,
                   int B, int layer, int Bc, int n_kv, int S, int hs,
                   int nsplit, int min_chunk, int nw, float scale, int q_bf16,
                   cudaStream_t st) {
  if (nw < 4 || nw > split_warps<CT, HGS>()) return (int)cudaErrorInvalidValue;
  flash_decode_split_kernel<CT, HSP, HGS>
      <<<dim3(B * n_kv, nsplit), nw * 32, 0, st>>>(
          q, static_cast<const CT*>(kc), static_cast<const CT*>(vc), ks, vs,
          pos, out, part_acc, part_ml, ticket, layer, Bc, n_kv, S, hs, nsplit,
          min_chunk, scale, q_bf16);
  return (int)cudaGetLastError();
}

template <typename CT, int HSP>
int launch_split_g(const void* q, const void* kc, const void* vc,
                   const float* ks, const float* vs, const int* pos,
                   void* out, float* part_acc, float* part_ml, int* ticket,
                   int B, int layer, int Bc, int n_kv, int S, int hs, int hgs,
                   int nsplit, int min_chunk, int nw, float scale, int q_bf16,
                   cudaStream_t st) {
#define SPLIT_LAUNCH(G)                                                      \
  return launch_split_h<CT, HSP, G>(q, kc, vc, ks, vs, pos, out, part_acc,   \
                                    part_ml, ticket, B, layer, Bc, n_kv, S,  \
                                    hs, nsplit, min_chunk, nw, scale,        \
                                    q_bf16, st)
  switch (hgs) {
    case 1: SPLIT_LAUNCH(1);
    case 2: SPLIT_LAUNCH(2);
    case 4: SPLIT_LAUNCH(4);
    case 8: SPLIT_LAUNCH(8);
  }
#undef SPLIT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

template <typename CT>
int launch_split(const void* q, const void* kc, const void* vc,
                 const float* ks, const float* vs, const int* pos, void* out,
                 float* part_acc, float* part_ml, int* ticket, int B,
                 int layer, int Bc, int n_kv, int S, int hs, int hgs,
                 int nsplit, int min_chunk, int nw, float scale, int q_bf16,
                 cudaStream_t st) {
  if (hs <= 64)
    return launch_split_g<CT, 64>(q, kc, vc, ks, vs, pos, out, part_acc,
                                  part_ml, ticket, B, layer, Bc, n_kv, S, hs,
                                  hgs, nsplit, min_chunk, nw, scale, q_bf16,
                                  st);
  if (hs <= 128)
    return launch_split_g<CT, 128>(q, kc, vc, ks, vs, pos, out, part_acc,
                                   part_ml, ticket, B, layer, Bc, n_kv, S, hs,
                                   hgs, nsplit, min_chunk, nw, scale, q_bf16,
                                   st);
  return launch_split_g<CT, 256>(q, kc, vc, ks, vs, pos, out, part_acc,
                                 part_ml, ticket, B, layer, Bc, n_kv, S, hs,
                                 hgs, nsplit, min_chunk, nw, scale, q_bf16,
                                 st);
}

// K2s's split-row mode: its launch arguments, the padded head size and
// the padded query rows RP as template constants
struct SpecSplitArgs {
  const void *q, *kc, *vc;
  const float *ks, *vs;
  const void *kn, *vn, *ke, *ve;
  const int* pos;
  void* out;
  float *part_acc, *part_ml;
  int* ticket;
  int B, layer, Bc, n_kv, S, hs, T, R, nsplit, min_chunk, nw;
  float scale;
  int q_bf16;
};

template <typename CT, int HSP, int RP>
int launch_spec_split_h(const SpecSplitArgs& a, cudaStream_t st) {
  if (a.nw < 4 || a.nw > split_warps<CT, RP>())
    return (int)cudaErrorInvalidValue;
  flash_spec_split_kernel<CT, HSP, RP>
      <<<dim3(a.B * a.n_kv, a.nsplit), a.nw * 32, 0, st>>>(
          a.q, static_cast<const CT*>(a.kc), static_cast<const CT*>(a.vc),
          a.ks, a.vs, a.kn, a.vn, a.ke, a.ve, a.pos, a.out, a.part_acc,
          a.part_ml, a.ticket, a.layer, a.Bc, a.n_kv, a.S, a.hs, a.T, a.R,
          a.nsplit, a.min_chunk, a.scale, a.q_bf16);
  return (int)cudaGetLastError();
}

template <typename CT, int HSP>
int launch_spec_split_r(const SpecSplitArgs& a, cudaStream_t st) {
  if (a.R <= 2) return launch_spec_split_h<CT, HSP, 2>(a, st);
  if (a.R <= 4) return launch_spec_split_h<CT, HSP, 4>(a, st);
  return launch_spec_split_h<CT, HSP, 8>(a, st);
}

template <typename CT>
int launch_spec_split(const SpecSplitArgs& a, cudaStream_t st) {
  if (a.hs <= 64) return launch_spec_split_r<CT, 64>(a, st);
  if (a.hs <= 128) return launch_spec_split_r<CT, 128>(a, st);
  return launch_spec_split_r<CT, 256>(a, st);
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

template <typename CT, int HS, int NTK>
int launch_block_tc_h(const void* q, const void* kc, const void* vc,
                      const float* ks, const float* vs, const void* kn,
                      const void* vn, void* out, int layer, int slot,
                      int start, int Bc, int n_kv, int S, int hs, int T,
                      int hgs, int TQ, float scale, cudaStream_t st) {
  // the stages of K and V rows and their scales (which the key groups'
  // merge reuses at the end), then Q rows at HS 256
  const size_t stages = (size_t)TC_STAGES * TC_TS * (4 * HS + 48 + 2 * 4);
  const size_t merge = (size_t)4 * (HS / 2 + 4) * 32 * 4;
  const size_t smem = (stages > merge ? stages : merge) +
                      (HS > 128 ? (size_t)TC_QROWS_256 * (HS + 16) * 2 : 0);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_block_tc_kernel<CT, HS, NTK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(n_kv, (T + TQ - 1) / TQ);
  flash_block_tc_kernel<CT, HS, NTK><<<grid, TC_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const CT*>(kc),
      static_cast<const CT*>(vc), ks, vs,
      static_cast<const __nv_bfloat16*>(kn),
      static_cast<const __nv_bfloat16*>(vn), static_cast<__nv_bfloat16*>(out),
      layer, slot, start, Bc, n_kv, S, hs, T, hgs, TQ, scale);
  return (int)cudaGetLastError();
}

// the padded head size (64, 128, 256) and the keys a warp takes of each
// tile: 64 rows a block (4 row groups) take all 64, 32 rows 32, 16 rows 16
template <typename CT>
int launch_block_tc(const void* q, const void* kc, const void* vc,
                    const float* ks, const float* vs, const void* kn,
                    const void* vn, void* out, int layer, int slot, int start,
                    int Bc, int n_kv, int S, int hs, int T, int hgs, int TQ,
                    float scale, cudaStream_t st) {
  const int wr = (hgs * TQ + 15) / 16;             // 16-row groups
#define TC_LAUNCH(HS, NTK)                                                   \
  return launch_block_tc_h<CT, HS, NTK>(q, kc, vc, ks, vs, kn, vn, out,     \
                                        layer, slot, start, Bc, n_kv, S, hs, \
                                        T, hgs, TQ, scale, st)
  if (hs <= 64) {
    if (wr == 1) TC_LAUNCH(64, 2);
    if (wr == 2) TC_LAUNCH(64, 4);
    TC_LAUNCH(64, 8);
  }
  if (hs <= 128) {
    if (wr == 1) TC_LAUNCH(128, 2);
    if (wr == 2) TC_LAUNCH(128, 4);
    TC_LAUNCH(128, 8);
  }
  if (wr > 2) return (int)cudaErrorInvalidValue;   // registers: <= 32 rows
  if (wr == 1) TC_LAUNCH(256, 2);
  TC_LAUNCH(256, 4);
#undef TC_LAUNCH
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

// K2, split-row mode: non-fresh, no stats.  q and out (B, n_kv, hgs, hs)
// f32 or bf16 (q_dt); caches and scales as flash_decode_launch, the
// caches 16-byte aligned; hs a multiple of 16 up to 256; nsplit in
// [1, 16] blocks of nw warps (4 to 16, by hgs and the cache type) share a
// (slot, kv head)'s rows, each at least min_chunk (>= 1) of them; with
// nsplit > 1 the workspace part_acc (B * n_kv *
// nsplit * hgs * hs f32), part_ml (B * n_kv * nsplit * hgs * 2 f32) and
// ticket (B * n_kv int32, all 0 between launches: the merging block puts
// its ticket back).
extern "C" int flash_decode_split_launch(const void* q, const void* kc,
                                         const void* vc, const void* ks,
                                         const void* vs, const void* pos,
                                         void* out, void* part_acc,
                                         void* part_ml, void* ticket, int B,
                                         int layer, int Bc, int n_kv, int S,
                                         int hs, int hgs, int nsplit,
                                         int min_chunk, int nw, float scale,
                                         int q_dt, int c_dt, void* stream) {
  const uintptr_t align = (uintptr_t)kc | (uintptr_t)vc;
  if (hs < 16 || hs % 16 != 0 || hs > HS_MAX || nsplit < 1 ||
      nsplit > SPLIT_MAX || min_chunk < 1 ||
      (ks == nullptr) != (vs == nullptr) ||
      (ks != nullptr) != (c_dt == DT_I8) || (align & 15) != 0 ||
      (q_dt != DT_F32 && q_dt != DT_BF16) ||
      (nsplit > 1 &&
       (part_acc == nullptr || part_ml == nullptr || ticket == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ksp = static_cast<const float*>(ks);
  const float* vsp = static_cast<const float*>(vs);
  const int* pp = static_cast<const int*>(pos);
  float* pa = static_cast<float*>(part_acc);
  float* pml = static_cast<float*>(part_ml);
  int* tk = static_cast<int*>(ticket);
  const int qb = q_dt == DT_BF16;
  switch (c_dt) {
    case DT_I8:
      return launch_split<int8_t>(q, kc, vc, ksp, vsp, pp, out, pa, pml, tk,
                                  B, layer, Bc, n_kv, S, hs, hgs, nsplit,
                                  min_chunk, nw, scale, qb, st);
    case DT_BF16:
      return launch_split<__nv_bfloat16>(q, kc, vc, ksp, vsp, pp, out, pa,
                                         pml, tk, B, layer, Bc, n_kv, S, hs,
                                         hgs, nsplit, min_chunk, nw, scale,
                                         qb, st);
    case DT_F32:
      return launch_split<float>(q, kc, vc, ksp, vsp, pp, out, pa, pml, tk,
                                 B, layer, Bc, n_kv, S, hs, hgs, nsplit,
                                 min_chunk, nw, scale, qb, st);
  }
  return (int)cudaErrorInvalidValue;
}

// K2s, split-row mode.  q and out (B, n_kv, hgs, T, hs): R = hgs * T <= 8
// rows per (slot, kv head), f32 or bf16 (q_dt); the fresh rows k_new/v_new
// and, with the exact diagonal, k_self/v_self (B, n_kv, T, hs) in q's
// dtype (k_self/v_self both null without it); caches and scales as
// flash_decode_launch, the caches 16-byte aligned; hs a multiple of 16 up
// to 256; nsplit, min_chunk, nw and the workspace as
// flash_decode_split_launch, with nw up to split_warps at RP rows (RP: 2,
// 4 or 8, the least >= R) and the workspace for B * n_kv * nsplit * RP
// rows.
extern "C" int flash_spec_split_launch(
    const void* q, const void* kc, const void* vc, const void* ks,
    const void* vs, const void* k_new, const void* v_new, const void* k_self,
    const void* v_self, const void* pos, void* out, void* part_acc,
    void* part_ml, void* ticket, int B, int layer, int Bc, int n_kv, int S,
    int hs, int T, int R, int nsplit, int min_chunk, int nw, float scale,
    int q_dt, int c_dt, void* stream) {
  const uintptr_t align = (uintptr_t)kc | (uintptr_t)vc |
                          (uintptr_t)k_new | (uintptr_t)v_new |
                          (uintptr_t)k_self | (uintptr_t)v_self;
  if (hs < 16 || hs % 16 != 0 || hs > HS_MAX || T < 1 || R < T ||
      R % T != 0 || R > 8 || nsplit < 1 || nsplit > SPLIT_MAX ||
      min_chunk < 1 || k_new == nullptr || v_new == nullptr ||
      (k_self == nullptr) != (v_self == nullptr) ||
      (ks == nullptr) != (vs == nullptr) ||
      (ks != nullptr) != (c_dt == DT_I8) || (align & 15) != 0 ||
      (q_dt != DT_F32 && q_dt != DT_BF16) ||
      (nsplit > 1 &&
       (part_acc == nullptr || part_ml == nullptr || ticket == nullptr)))
    return (int)cudaErrorInvalidValue;
  const SpecSplitArgs a{q, kc, vc, static_cast<const float*>(ks),
                        static_cast<const float*>(vs), k_new, v_new, k_self,
                        v_self, static_cast<const int*>(pos), out,
                        static_cast<float*>(part_acc),
                        static_cast<float*>(part_ml),
                        static_cast<int*>(ticket), B, layer, Bc, n_kv, S, hs,
                        T, R, nsplit, min_chunk, nw, scale,
                        q_dt == DT_BF16};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c_dt) {
    case DT_I8: return launch_spec_split<int8_t>(a, st);
    case DT_BF16: return launch_spec_split<__nv_bfloat16>(a, st);
    case DT_F32: return launch_spec_split<float>(a, st);
  }
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

// K2b, TC mode.  q, the fresh block and out bf16; an int8 (with row
// scales) or bf16 cache; hs a multiple of 16 up to 256; every tensor
// pointer 16-byte aligned; otherwise as flash_block_launch.
extern "C" int flash_block_tc_launch(const void* q, const void* kc,
                                     const void* vc, const void* ks,
                                     const void* vs, const void* k_new,
                                     const void* v_new, void* out, int layer,
                                     int slot, int start, int Bc, int n_kv,
                                     int S, int hs, int T, int hgs, int TQ,
                                     float scale, int c_dt, void* stream) {
  const uintptr_t align = (uintptr_t)q | (uintptr_t)kc | (uintptr_t)vc |
                          (uintptr_t)k_new | (uintptr_t)v_new |
                          (uintptr_t)out;
  if (hs < 16 || hs % 16 != 0 || hs > HS_MAX || T < 1 || TQ < 1 ||
      hgs < 1 || hgs * TQ > TC_ROWS || start < 0 || start > S || slot < 0 ||
      slot >= Bc || (ks == nullptr) != (vs == nullptr) ||
      (ks != nullptr) != (c_dt == DT_I8) || (align & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ksp = static_cast<const float*>(ks);
  const float* vsp = static_cast<const float*>(vs);
  if (c_dt == DT_I8)
    return launch_block_tc<int8_t>(q, kc, vc, ksp, vsp, k_new, v_new, out,
                                   layer, slot, start, Bc, n_kv, S, hs, T,
                                   hgs, TQ, scale, st);
  if (c_dt == DT_BF16)
    return launch_block_tc<__nv_bfloat16>(q, kc, vc, ksp, vsp, k_new, v_new,
                                          out, layer, slot, start, Bc, n_kv,
                                          S, hs, T, hgs, TQ, scale, st);
  return (int)cudaErrorInvalidValue;
}
