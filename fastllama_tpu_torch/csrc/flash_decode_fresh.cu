// K2, fresh and stats split-row mode: the batched decode step's attention
// (a fresh row a (slot, kv head)) and the deferred-KV path's (the same with
// each query row's softmax max and sum).
//
// Replaces, like flash_decode_kernel (flash_decode.cu) for the calls this
// kernel does not take, the Pallas flash_decode_batched
// (fastllama_tpu/ops/pallas/flash_decode.py:203, body _flash_kernel :67)
// with fresh rows, with stats=True (:186-200), or both:
//   * fresh (k_new/v_new given): slot b's query rows attend the cache rows
//     [0, pos[b]) of layer `layer` strictly, then the fresh K/V row,
//     un-quantized; the deferred-write path that make_attn_batched_flash
//     drives from models/batched.decode_step;
//   * stats (m_out/l_out given): each query row's final running max and
//     sum (the sum of the probabilities without the V row scale), after
//     the fresh row, as (B, n_kv, hgs) f32, for
//     models/batched.decode_step_deferred; without a fresh row, rows
//     [0, pos[b]] as K2's non-fresh mode.
// The wrapper (ops/kernels/flash_decode.py: decode_mode) sends every such
// call here when hs is a multiple of 16 (up to 256), hgs is 1, 2, 4 or 8
// and the caches and fresh rows start on a 16-byte boundary;
// flash_decode_kernel keeps the rest.
//
// What bounds it on an H100: memory bytes.  A (slot, kv head) reads
// pos[b] * hs * 2 cache bytes (+ 8 bytes of row scales a row at int8) once
// for its hgs query rows, and does ~4 * hgs f32 operations an element, with
// 2 more an int8 element for its conversion: at 7B's hgs = 1 a GEMV, far
// below the f32 rate, so the design is about keeping loads in flight.
//
// What held the tiled kernel back (flash_decode_kernel: one warp a cache
// row with scalar 1-byte loads and a 5-shuffle sum, three barriers a
// 64-row tile, a softmax pass of one warp a query row over scores re-read
// from shared memory, P.V one V element a thread walking down its column),
// and what this design does about it: it is the split-row body that K2's
// non-fresh mode and K2s share (split_rows.cuh), in its SPEC form with
// T = 1 and no exact diagonal, where K2s's (B, n_kv, T, hs) fresh block is
// K2's (B, n_kv, hs) fresh row.  Each lane loads 8 bytes of a cache row
// (int8, converted by a byte permute), or 16 (bf16, f32), 2 rows a step,
// and issues the next step's loads before the current step's arithmetic;
// each warp keeps its scores, (m, l) and accumulators in registers; the
// warps merge once through shared memory.  The fresh row is copied by cp.async
// into shared memory while the cache is read, and the split holding the
// last cache rows scores and merges it once: split 0 alone at pos 0, where
// the running max starts at -1e30 and the result is exactly v_new (the
// idle-slot rule of the TPU kernel).  The hgs query rows are the block's
// rows as they are (HG = hgs): no padding to K2s's RP rows.  The splits
// of a long cache merge by ticket in the same launch (split_rows.cuh).
// The wrapper gives a block the most warps at which the grid still fits
// one wave of the card's resident blocks
// (flash_decode_fresh_split_resident, the runtime's occupancy count): 4 at
// the batched step's B=48, 8 at a long context's B=12.
// What still holds it back at the batched step (B=48, pos 107: 55 % of the
// bytes bound on an H100): each block's chain of dependent latencies, pos
// before the first load, then 7 steps of loads, the fresh row and the
// merge, in two waves of blocks; more rows a step cost registers and so
// blocks an SM (PERF.md).
// Math as _flash_kernel's, all in f32: score = (q . k) * (1/sqrt(hs)) *
// k_scale; the running max starts at -1e30; e * v_scale before P.V; the
// fresh row carries no scale; output acc / l in q's dtype.  Only the f32
// sum order differs from the plain version.
//
// The tuning constants below are the ones the card chose, timed in turns
// against the others by fastllama_tpu_torch/tools/fresh_split_design.py,
// which builds this file with other values (PERF.md).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "split_rows.cuh"

// bytes of an int8 cache row a lane loads: 8 or 16
#ifndef FRESH_SPLIT_INT8_BYTES
#define FRESH_SPLIT_INT8_BYTES 8
#endif
// loads of K (and of V) a lane issues a step (U = this / loads a row)
#ifndef FRESH_SPLIT_LOADS
#define FRESH_SPLIT_LOADS 2
#endif
// 1: a step's loads issued before the previous step's arithmetic
#ifndef FRESH_SPLIT_PF
#define FRESH_SPLIT_PF 1
#endif
// the launch bounds' least blocks an SM
#ifndef FRESH_SPLIT_MIN_BLOCKS
#define FRESH_SPLIT_MIN_BLOCKS 1
#endif

namespace {

// the cache rows' loads: int8 by byte permute, FRESH_SPLIT_INT8_BYTES a
// load; bf16 and f32 16 bytes a load, as K2's non-fresh mode
template <typename CT> struct FreshIO : SplitIO<CT, 1> {};
#if FRESH_SPLIT_INT8_BYTES == 8
template <> struct FreshIO<int8_t> : SpecIO<int8_t> {};
#else
template <> struct FreshIO<int8_t> {
  static constexpr int DPL = 16;
  using Raw = uint4;
  __device__ static void unpack(const uint4& r, float (&f)[16]) {
    const uint32_t w[4] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u,
                           r.z ^ 0x80808080u, r.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 16; ++i) f[i] = i8_magic(w[i / 4], i % 4);
  }
};
#endif

template <typename CT, int HSP, int HGS>
__global__ void __launch_bounds__(split_warps<CT, HGS>() * 32,
                                  FRESH_SPLIT_MIN_BLOCKS)
flash_decode_fresh_split_kernel(
    const void* __restrict__ q,        // (B, n_kv, HGS, hs)
    const CT* __restrict__ kc,         // (L, Bc, n_kv, S, hs)
    const CT* __restrict__ vc,
    const float* __restrict__ ks,      // (L, Bc, n_kv, S) or null
    const float* __restrict__ vs,
    const void* __restrict__ k_new,    // (B, n_kv, hs) or null
    const void* __restrict__ v_new,
    const int* __restrict__ pos,       // (B,)
    void* __restrict__ out,            // (B, n_kv, HGS, hs)
    float* __restrict__ m_out,         // (B, n_kv, HGS) or null
    float* __restrict__ l_out,
    float* __restrict__ part_acc, float* __restrict__ part_ml,
    int* __restrict__ ticket, int layer, int Bc, int n_kv, int S, int hs,
    int nsplit, int min_chunk, float scale, int q_bf16) {
  split_rows<CT, HSP, HGS, FreshIO<CT>, true, FRESH_SPLIT_LOADS,
             FRESH_SPLIT_PF != 0, true>(
      q, kc, vc, ks, vs, k_new, v_new, nullptr, nullptr, pos, out, part_acc,
      part_ml, ticket, layer, Bc, n_kv, S, hs, 1, HGS, nsplit, min_chunk,
      scale, q_bf16, m_out, l_out);
}

struct FreshArgs {
  const void *q, *kc, *vc;
  const float *ks, *vs;
  const void *kn, *vn;
  const int* pos;
  void* out;
  float *m_out, *l_out, *part_acc, *part_ml;
  int* ticket;
  int B, layer, Bc, n_kv, S, hs, hgs, nsplit, min_chunk, nw;
  float scale;
  int q_bf16;
};

// the launch, and the card's occupancy count (blocks an SM) of the
// instantiation, as functors over the template constants
struct Launch {
  const FreshArgs& a;
  cudaStream_t st;
  template <typename CT, int HSP, int HGS> int run() const {
    if (a.nw < 4 || a.nw > split_warps<CT, HGS>())
      return (int)cudaErrorInvalidValue;
    flash_decode_fresh_split_kernel<CT, HSP, HGS>
        <<<dim3(a.B * a.n_kv, a.nsplit), a.nw * 32, 0, st>>>(
            a.q, static_cast<const CT*>(a.kc), static_cast<const CT*>(a.vc),
            a.ks, a.vs, a.kn, a.vn, a.pos, a.out, a.m_out, a.l_out,
            a.part_acc, a.part_ml, a.ticket, a.layer, a.Bc, a.n_kv, a.S,
            a.hs, a.nsplit, a.min_chunk, a.scale, a.q_bf16);
    return (int)cudaGetLastError();
  }
};

struct Resident {
  int nw;
  int* blocks;
  template <typename CT, int HSP, int HGS> int run() const {
    if (nw < 4 || nw > split_warps<CT, HGS>())
      return (int)cudaErrorInvalidValue;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, flash_decode_fresh_split_kernel<CT, HSP, HGS>, nw * 32, 0);
  }
};

template <typename CT, int HSP, typename F>
int dispatch_g(int hgs, const F& f) {
  switch (hgs) {
    case 1: return f.template run<CT, HSP, 1>();
    case 2: return f.template run<CT, HSP, 2>();
    case 4: return f.template run<CT, HSP, 4>();
    case 8: return f.template run<CT, HSP, 8>();
  }
  return (int)cudaErrorInvalidValue;
}

template <typename CT, typename F>
int dispatch_h(int hs, int hgs, const F& f) {
  if (hs <= 64) return dispatch_g<CT, 64>(hgs, f);
  if (hs <= 128) return dispatch_g<CT, 128>(hgs, f);
  return dispatch_g<CT, 256>(hgs, f);
}

// dtype codes shared with ops/kernels/flash_decode.py
enum { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2 };

template <typename F>
int dispatch(int c_dt, int hs, int hgs, const F& f) {
  switch (c_dt) {
    case DT_I8: return dispatch_h<int8_t>(hs, hgs, f);
    case DT_BF16: return dispatch_h<__nv_bfloat16>(hs, hgs, f);
    case DT_F32: return dispatch_h<float>(hs, hgs, f);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K2, fresh and stats split-row mode.  q and out (B, n_kv, hgs, hs) f32 or
// bf16 (q_dt), hgs in {1, 2, 4, 8}; k_new/v_new (B, n_kv, hs) in q's dtype
// or both null; m_out/l_out (B, n_kv, hgs) f32 or both null; caches
// (L, Bc, n_kv, S, hs) f32, bf16 or int8 (c_dt) with (L, Bc, n_kv, S) f32
// row scales exactly at int8; the caches and fresh rows 16-byte aligned;
// hs a multiple of 16 up to 256; nsplit in [1, 16] blocks of nw warps (4
// to split_warps) share a (slot, kv head)'s rows, each at least min_chunk
// (>= 1) of them; with nsplit > 1 the workspace part_acc (B * n_kv *
// nsplit * hgs * hs f32), part_ml (B * n_kv * nsplit * hgs * 2 f32) and
// ticket (B * n_kv int32, all 0 between launches).
extern "C" int flash_decode_fresh_split_launch(
    const void* q, const void* kc, const void* vc, const void* ks,
    const void* vs, const void* k_new, const void* v_new, const void* pos,
    void* out, void* m_out, void* l_out, void* part_acc, void* part_ml,
    void* ticket, int B, int layer, int Bc, int n_kv, int S, int hs,
    int hgs, int nsplit, int min_chunk, int nw, float scale, int q_dt,
    int c_dt, void* stream) {
  const uintptr_t align = (uintptr_t)kc | (uintptr_t)vc |
                          (uintptr_t)k_new | (uintptr_t)v_new;
  if (hs < 16 || hs % 16 != 0 || hs > 256 || nsplit < 1 ||
      nsplit > SPLIT_MAX || min_chunk < 1 ||
      (k_new == nullptr) != (v_new == nullptr) ||
      (m_out == nullptr) != (l_out == nullptr) ||
      (ks == nullptr) != (vs == nullptr) ||
      (ks != nullptr) != (c_dt == DT_I8) || (align & 15) != 0 ||
      (q_dt != DT_F32 && q_dt != DT_BF16) ||
      (nsplit > 1 &&
       (part_acc == nullptr || part_ml == nullptr || ticket == nullptr)))
    return (int)cudaErrorInvalidValue;
  const FreshArgs a{q, kc, vc, static_cast<const float*>(ks),
                    static_cast<const float*>(vs), k_new, v_new,
                    static_cast<const int*>(pos), out,
                    static_cast<float*>(m_out), static_cast<float*>(l_out),
                    static_cast<float*>(part_acc),
                    static_cast<float*>(part_ml), static_cast<int*>(ticket),
                    B, layer, Bc, n_kv, S, hs, hgs, nsplit, min_chunk, nw,
                    scale, q_dt == DT_BF16};
  return dispatch(c_dt, hs, hgs, Launch{a, static_cast<cudaStream_t>(stream)});
}

// Blocks of nw warps of the instantiation for the cache dtype c_dt, hs and
// hgs that an SM of the current card holds at once (the CUDA runtime's
// occupancy count), into *blocks.
extern "C" int flash_decode_fresh_split_resident(int c_dt, int hs, int hgs,
                                                 int nw, int* blocks) {
  if (hs < 16 || hs % 16 != 0 || hs > 256 || blocks == nullptr)
    return (int)cudaErrorInvalidValue;
  return dispatch(c_dt, hs, hgs, Resident{nw, blocks});
}
