// K2 and K2s in their split-row modes: flash_decode_split_kernel (K2,
// non-fresh, no stats) and flash_spec_split_kernel (K2s, R <= 8 query rows
// a (slot, kv head)), both on the body split_rows of split_rows.cuh.  The
// tiled kernels that take the other calls are in flash_decode.cu; K2's
// fresh and stats split mode is in flash_decode_fresh.cu.  Split from
// flash_decode.cu so that each family builds in its own nvcc.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "split_rows.cuh"

namespace {

constexpr int HS_MAX = 256;   // head size limit

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
// Replaces, like flash_spec_kernel (flash_decode.cu), _flash_spec_kernel /
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

// dtype codes shared with ops/kernels/flash_decode.py
enum { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2 };

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

}  // namespace

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
