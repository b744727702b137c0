// K1: group-dequant matmul, out (T, O) = x (T, I) @ dequant(W (I, O)).
//
// Replaces the Pallas kernels of fastllama_tpu/ops/pallas/qmm.py:
// qmatmul_pallas (qmm.py:251, body _qmm_kernel -> _qmm_kernel_std and
// _qmm_chunk) and its layer-indexed form qmatmul_pallas_indexed
// (qmm.py:551, body _qmm_kernel_idx).  The layer-indexed form is this same
// kernel called on the layer's slice of the stacked (L, I, O) weight: a
// contiguous slice is a pointer offset, so no scalar prefetch is needed.
//
// Layout as in the JAX package: x row-major (T, I); W (I, O) int8/int16
// with O contiguous; group scales (I/gs, O), f32 or bf16.  Neighbouring
// threads read neighbouring output columns of W.
//
// Rounding follows _qmm_chunk (qmm.py:62-86):
//   * INT8, bf16 compute: the dequantized weight is bf16(bf16(w) * bf16(s)),
//     the product itself rounded to bf16; x is rounded to bf16; the dot
//     runs on the tensor cores (WMMA bf16 -> f32) with f32 accumulation.
//   * wide (INT16, or f32 compute): f32 dequant f32(w) * f32(s) and a full
//     f32 dot (CUDA-core FMA), like Precision.HIGHEST.
// The result is accumulated in f32 and written in x's dtype.
//
// K1f, the fused form (_qmm_kernel_idx_fused, qmm.py:470-527), is the same
// kernel with two optional operands:
//   * gain (I,) f32: an rmsnorm prologue.  Each block first computes the
//     inverse RMS of its rows over the WHOLE row of x (every block of a
//     split K needs it, so each reads the full rows: 22 KB of bf16 at
//     T=1, I=11008), then normalizes x as it stages it:
//     xn = to_x_dtype(x * (1/sqrt(mean(x^2) + eps)) * gain), one rounding,
//     as the Pallas prologue does (not ops/norms.rmsnorm's two roundings).
//   * res (T, O) in x's dtype: a residual epilogue, out = to_x_dtype(res +
//     x @ W) with one rounding at the end.  It is added exactly once: in
//     the split-K reduce pass when K is split, else in the main pass.
//
// What bounds it on an H100: decode (T <= 48) streams every weight byte
// once for few rows, so it is bound by memory bytes (1 B/param + scales);
// prefill waves (T up to 2048) are bound by tensor-core operations.  The
// INT8 path tiles 64x64 outputs per block and walks K in stages of 64
// rows: each thread loads its part of the next stage (16-byte vector loads
// of W, x and the group scales) into registers while the warps multiply
// the current stage from shared memory, so the weight stream stays in
// flight.  When the output tiles alone cannot fill the 132 SMs (decode
// shapes) K is split across blocks and a second small kernel sums the
// partials (deterministic).  Shapes whose rows are not 16-byte aligned
// (O % 16, I % 8) stage element by element instead.  No cp.async/TMA and
// no wgmma yet: those are later work.
//
// K1p, the packed INT4 mode, replaces the packed branches of
// qmatmul_pallas (qmm.py:266-296, body _qmm_kernel_p4 :368-402) and of
// qmatmul_pallas_indexed (qmm.py:571-612, body _qmm_kernel_p4_idx
// :418-440).  W is (I/2, O) int8 bytes in split-half order: byte row r
// holds logical K row r in its low nibble and row r + I/2 in its high
// nibble; the scales stay (I/gs, O).  A stage takes 32 packed rows, so one
// 16-byte load a thread gives 16 output columns of two logical rows, r and
// r + I/2.  The planes are not interleaved: the stage's weight tile holds
// the low plane in rows 0-31 and the high plane in rows 32-63, and the x
// tile holds x's columns [k0, k0 + 32) and [I/2 + k0, I/2 + k0 + 32) to
// match, so the tensor-core loop is K1's, unchanged.  Each nibble is
// sign-extended in registers and dequantized with ONE rounding,
// bf16(f32(nibble) * f32(scale)) (a bf16 scale enters as its exact f32
// value; the INT8 path rounds the scale first), and x is rounded to bf16,
// at any compute dtype: the packed kernel has no wide path, as in JAX.
// The K1f operands work as above; the residual is always added (the JAX
// indexed form never reads it, qmm.py:571-612).
//
// K1p's bound on an H100 is bytes at decode: a fused 7B layer at T = 48
// (wqkv 4096x12288, wo 4096x4096, w13 4096x22528, w2 11264x4096) moves
// 115.6 MB, 102.8 MB of nibbles and 12.8 MB of f32 scales: ~0.0345 ms at
// 3.35 TB/s; the classifier (4096x32000) at T = 1 moves 73.7 MB, ~0.022
// ms.  Against it the design streams half of K1's bytes per logical row
// with K1's register double-buffering and split-K, so it keeps half as
// many bytes in flight per stage; a deeper pipeline (cp.async/TMA stages,
// more packed rows a stage) is what would bring it nearer the bound.
//
// The groupdot mode of K1 and K1p (template flag GD) replaces the
// scale-after-dot variant of the Pallas kernels: _qmm_chunk_groupdot
// (qmm.py:89-106, run by _qmm_kernel at :109-119) and _groupdot_p4
// (:405-416, run by _qmm_kernel_p4 at :368-402).  The int8 values (or the
// sign-extended nibbles) are staged as bf16 with no scale, x as bf16, and
// each k = 16 tensor-core step goes into a fresh f32 partial; at the end of
// a group the partial is multiplied by the group's scale per output column
// (an exact f32 value: a bf16 scale is promoted, the product is not
// rounded) and added to the block's f32 accumulator.  WMMA's accumulator
// layout is opaque, so this mode runs mma.sync.m16n8k16 instead, whose
// register layout is documented: each thread knows the output columns it
// holds and scales its partial in registers, with no trip through shared
// memory.  The stage's group scales (one row of BN a k = 16 step) are
// prefetched into registers with the stage and staged in shared memory.
// A partial is flushed at the end of its group, at the end of each plane's
// half of a stage (K1p's stage holds 32 packed rows: half a 64-row group of
// each plane) and at the end of a split, so a group cut by a stage or a
// split is scaled in parts (linear: only the f32 sum order changes).  The
// group size must be a multiple of 16 so that no k = 16 step straddles two
// groups.  Its bound is K1's: bytes at decode.  It saves the per-element
// scale multiply of the dequant and adds a scale-and-add of the partials a
// group; a simple mode first, its speed is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int BM = 64;     // rows of x per block
constexpr int BN = 64;     // output columns per block
constexpr int BK = 64;     // contraction rows per stage on the INT8 path
constexpr int BKW = 16;    // contraction rows per stage on the f32 path

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f(int16_t v) { return (float)v; }

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

// K1f prologue: rinv[r] = 1 / sqrt(mean(x[m0 + r, :]^2) + eps) for the
// block's valid rows, over the whole row.  Every thread of the block calls
// it.  Deterministic: per-warp partial sums, summed in warp order.
template <typename XT, int NT>
__device__ void row_inv_rms(const XT* __restrict__ x, int T, int I, int m0,
                            float eps, float* rinv) {
  __shared__ float wsum[NT / 32][BM];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nrows = min(BM, T - m0);
  constexpr int V = 16 / sizeof(XT);
  const bool vec = I % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  for (int r = 0; r < nrows; ++r) {
    const XT* row = x + (size_t)(m0 + r) * I;
    float acc = 0.0f;
    if (vec) {
      for (int c = tid * V; c < I; c += NT * V) {
        const uint4 v = *reinterpret_cast<const uint4*>(row + c);
        const XT* e = reinterpret_cast<const XT*>(&v);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float f = to_f(e[j]);
          acc = fmaf(f, f, acc);
        }
      }
    } else {
      for (int c = tid; c < I; c += NT) {
        const float f = to_f(row[c]);
        acc = fmaf(f, f, acc);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) wsum[warp][r] = acc;
  }
  __syncthreads();
  for (int r = tid; r < nrows; r += NT) {
    float ss = 0.0f;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) ss += wsum[w][r];
    rinv[r] = 1.0f / sqrtf(ss / (float)I + eps);
  }
  __syncthreads();
}

// one normalized activation value, rounded to x's dtype (the prologue's
// single rounding), returned as f32
template <typename XT>
__device__ __forceinline__ float norm_x(float v, float rinv, float g) {
  return to_f(from_f<XT>(v * rinv * g));
}

// INT8 x bf16 path: WMMA 16x16x16 bf16 fragments, 4 warps, each warp owns
// a 32x32 quadrant of the 64x64 output tile.
constexpr int QT = 128;                 // threads
constexpr int LDA = BK + 8;             // bf16 row pitch of the x tile
constexpr int LDB = BN + 8;             // bf16 row pitch of the weight tile
constexpr int LDC = BN + 4;             // f32 row pitch of the output tile
constexpr int SMEM_AB = (BM * LDA + BK * LDB) * 2;
constexpr int SMEM_C = BM * LDC * 4;
constexpr int SMEM_Q = SMEM_AB > SMEM_C ? SMEM_AB : SMEM_C;

// One stage in registers (vector path).  Thread t owns the 16 weight
// columns 16*(t%4).. of rows t/4 and t/4+32 of the stage, with those
// columns' group scales already rounded to bf16, and XN 16-byte chunks of
// the x tile.
template <typename XT>
struct Stage {
  static constexpr int XV = 16 / sizeof(XT);            // x values per chunk
  static constexpr int XN = BM * BK / XV / QT;          // chunks per thread
  uint4 w[2];
  __nv_bfloat162 s[2][8];
  uint4 x[XN];
  float gsc[2];              // groupdot: two of the stage's group scales
};

// K1p's stage: 16 packed bytes (columns 16*(t%4).. of packed row t/4),
// the f32 scales of those columns for the low plane's logical row and the
// high plane's, and XN 16-byte chunks of the x tile.
template <typename XT>
struct StageP4 {
  static constexpr int XV = 16 / sizeof(XT);
  static constexpr int XN = BM * BK / XV / QT;
  uint4 w;
  float s[2][16];
  uint4 x[XN];
  float gsc[2];
};

__device__ __forceinline__ void load_scales_f32(float* dst, const float* src) {
  const float4* p = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = p[i];
    dst[4 * i] = v.x;
    dst[4 * i + 1] = v.y;
    dst[4 * i + 2] = v.z;
    dst[4 * i + 3] = v.w;
  }
}
__device__ __forceinline__ void load_scales_f32(float* dst,
                                                const __nv_bfloat16* src) {
  const uint4* p = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 v = p[i];
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[8 * i + j] = __bfloat162float(b[j]);
  }
}

// The sign-extended nibble of a packed byte: plane 0 the low nibble
// (logical row r), plane 1 the high (row r + I/2), both in [-8, 7].  The
// low one moves to the top of a byte first; >> on a signed integer is an
// arithmetic shift on nvcc, so both shifts sign-extend.
__device__ __forceinline__ int nibble(int8_t b, int plane) {
  return plane == 0 ? (int)(int8_t)((uint8_t)b << 4) >> 4 : (int)b >> 4;
}

__device__ __forceinline__ void load_scales(__nv_bfloat162* dst,
                                            const float* src) {
  const float4* p = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = p[i];
    dst[2 * i] = __floats2bfloat162_rn(v.x, v.y);
    dst[2 * i + 1] = __floats2bfloat162_rn(v.z, v.w);
  }
}
__device__ __forceinline__ void load_scales(__nv_bfloat162* dst,
                                            const __nv_bfloat16* src) {
  const uint4* p = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 v = p[i];
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[4 * i + j] = b[j];
  }
}

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

// x chunk -> bf16 in shared memory (round to nearest even, as
// astype(bfloat16)).
__device__ __forceinline__ void store_x(__nv_bfloat16* dst, const uint4& v,
                                        const __nv_bfloat16*) {
  *reinterpret_cast<uint4*>(dst) = v;
}
__device__ __forceinline__ void store_x(__nv_bfloat16* dst, const uint4& v,
                                        const float*) {
  const float4 f = *reinterpret_cast<const float4*>(&v);
  uint2 packed;
  __nv_bfloat162* r = reinterpret_cast<__nv_bfloat162*>(&packed);
  r[0] = __floats2bfloat162_rn(f.x, f.y);
  r[1] = __floats2bfloat162_rn(f.z, f.w);
  *reinterpret_cast<uint2*>(dst) = packed;
}

// K1f: an x chunk normalized (rinv, gain) and rounded to x's dtype, then
// to bf16 for the tensor cores
template <typename XT>
__device__ __forceinline__ void store_x_norm(__nv_bfloat16* dst,
                                             const uint4& v, float rinv,
                                             const float* __restrict__ g) {
  constexpr int XV = 16 / sizeof(XT);
  const XT* e = reinterpret_cast<const XT*>(&v);
#pragma unroll
  for (int j = 0; j < XV; ++j)
    dst[j] = __float2bfloat16_rn(norm_x<XT>(to_f(e[j]), rinv, __ldg(g + j)));
}

// P4: K1p, W the (I/2, O) packed bytes; k_per_split then counts packed
// rows.  GD: the groupdot mode (gs % 16 == 0).
template <typename XT, typename ST, bool VEC, bool P4, bool GD>
__global__ void __launch_bounds__(QT)
qmm_bf16_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                const ST* __restrict__ s, const float* __restrict__ gain,
                const XT* __restrict__ res, XT* __restrict__ out,
                float* __restrict__ partial, int T, int I, int O, int gs,
                int k_per_split, float eps) {
  __shared__ __align__(128) unsigned char smem[SMEM_Q];
  __shared__ float rinv[BM];
  // groupdot: the group scale of each k = 16 step of the stage, by column
  __shared__ float Ss[BK / 16][BN];
  __nv_bfloat16 (*As)[LDA] = reinterpret_cast<__nv_bfloat16 (*)[LDA]>(smem);
  __nv_bfloat16 (*Bs)[LDB] =
      reinterpret_cast<__nv_bfloat16 (*)[LDB]>(smem + BM * LDA * 2);
  float (*Cs)[LDC] = reinterpret_cast<float (*)[LDC]>(smem);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int Ih = I / 2;
  // rows of W walked (K1p: packed rows) and taken a stage
  constexpr int KS = P4 ? BK / 2 : BK;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(P4 ? Ih : I, kbeg + k_per_split);
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;
  using S = std::conditional_t<P4, StageP4<XT>, Stage<XT>>;
  const int wr = tid / 4;                  // weight rows wr and wr + 32
  const int wc = (tid % 4) * 16;           // weight columns wc .. wc + 15
  if (gain != nullptr) row_inv_rms<XT, QT>(x, T, I, m0, eps, rinv);
  // column c of the stage's x tile: x's column k0 + c; under K1p the low
  // plane's columns k0 + c for c < 32, the high plane's I/2 + k0 + c - 32
  // after.  in_k: its W row lies in this block's range.
  auto xcol = [&](int k0, int c) {
    return P4 && c >= KS ? Ih + k0 + c - KS : k0 + c;
  };
  auto in_k = [&](int k0, int c) { return k0 + c % KS < kend; };
  // groupdot: the scale of the group holding the stage's k = 16 step j
  // for the block's column c (0 past the edges: their partials are 0)
  auto group_scale = [&](int k0, int j, int c) {
    return in_k(k0, 16 * j) && n0 + c < O
               ? to_f(s[(size_t)(xcol(k0, 16 * j) / gs) * O + n0 + c])
               : 0.0f;
  };

  // vector path: registers <- global for the stage starting at k0
  auto load = [&](S& st, int k0) {
    if constexpr (P4) {
      const int gk = k0 + wr, gn = n0 + wc;
      if (gk < kend && gn < O) {
        st.w = *reinterpret_cast<const uint4*>(w + (size_t)gk * O + gn);
        if constexpr (!GD) {
          load_scales_f32(st.s[0], s + (size_t)(gk / gs) * O + gn);
          load_scales_f32(st.s[1], s + (size_t)((gk + Ih) / gs) * O + gn);
        }
      } else {                 // zero weight and scale: no NaN from 0 * junk
        st.w = make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int j = 0; j < 16; ++j) st.s[0][j] = st.s[1][j] = 0.0f;
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gk = k0 + wr + 32 * h, gn = n0 + wc;
        if (gk < kend && gn < O) {
          st.w[h] = *reinterpret_cast<const uint4*>(w + (size_t)gk * O + gn);
          if constexpr (!GD)
            load_scales(st.s[h], s + (size_t)(gk / gs) * O + gn);
        } else {               // zero weight and scale: no NaN from 0 * junk
          st.w[h] = make_uint4(0, 0, 0, 0);
#pragma unroll
          for (int j = 0; j < 8; ++j) st.s[h][j] = __floats2bfloat162_rn(0.0f, 0.0f);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < S::XN; ++i) {
      const int q = tid + QT * i;
      const int r = q / (BK / S::XV), c = (q % (BK / S::XV)) * S::XV;
      const int gr = m0 + r;
      st.x[i] = (gr < T && in_k(k0, c))
                    ? *reinterpret_cast<const uint4*>(x + (size_t)gr * I +
                                                      xcol(k0, c))
                    : make_uint4(0, 0, 0, 0);
    }
    if constexpr (GD) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = tid + QT * h;
        st.gsc[h] = group_scale(k0, e / BN, e % BN);
      }
    }
  };
  // vector path: shared memory <- registers, the weight dequantized to
  // bf16(bf16(w) * bf16(s)): the product rounded to bf16 (K1p: the low
  // plane to tile rows 0-31, the high plane to rows 32-63, each element
  // bf16(f32(nibble) * f32(scale)), rounded once); x normalized first
  // under the K1f prologue
  auto store = [&](const S& st, int k0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int8_t* q;
      if constexpr (P4)
        q = reinterpret_cast<const int8_t*>(&st.w);
      else
        q = reinterpret_cast<const int8_t*>(&st.w[h]);
      uint4 packed[2];
      __nv_bfloat162* v = reinterpret_cast<__nv_bfloat162*>(packed);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if constexpr (GD) {          // unscaled: exact in bf16
          if constexpr (P4)
            v[j] = __floats2bfloat162_rn((float)nibble(q[2 * j], h),
                                         (float)nibble(q[2 * j + 1], h));
          else
            v[j] = __floats2bfloat162_rn((float)q[2 * j], (float)q[2 * j + 1]);
        } else if constexpr (P4) {
          v[j] = __floats2bfloat162_rn(
              (float)nibble(q[2 * j], h) * st.s[h][2 * j],
              (float)nibble(q[2 * j + 1], h) * st.s[h][2 * j + 1]);
        } else {
          const float2 sc = __bfloat1622float2(st.s[h][j]);
          v[j] = __floats2bfloat162_rn((float)q[2 * j] * sc.x,
                                       (float)q[2 * j + 1] * sc.y);
        }
      }
      uint4* dst = reinterpret_cast<uint4*>(&Bs[wr + 32 * h][wc]);
      dst[0] = packed[0];
      dst[1] = packed[1];
    }
#pragma unroll
    for (int i = 0; i < S::XN; ++i) {
      const int q = tid + QT * i;
      const int r = q / (BK / S::XV), c = (q % (BK / S::XV)) * S::XV;
      if (gain != nullptr && m0 + r < T && in_k(k0, c))
        store_x_norm<XT>(&As[r][c], st.x[i], rinv[r], gain + xcol(k0, c));
      else
        store_x(&As[r][c], st.x[i], x);
    }
    if constexpr (GD) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = tid + QT * h;
        Ss[e / BN][e % BN] = st.gsc[h];
      }
    }
  };
  // scalar path: shared memory <- global, element by element
  auto stage_scalar = [&](int k0) {
    for (int idx = tid; idx < BM * BK; idx += QT) {
      const int r = idx / BK, c = idx % BK;
      const int gr = m0 + r, gc = xcol(k0, c);
      float v = 0.0f;
      if (gr < T && in_k(k0, c)) {
        v = to_f(x[(size_t)gr * I + gc]);
        if (gain != nullptr) v = norm_x<XT>(v, rinv[r], gain[gc]);
      }
      As[r][c] = __float2bfloat16_rn(v);
    }
    for (int idx = tid; idx < BK * BN; idx += QT) {
      const int r = idx / BN, c = idx % BN;
      const int gk = k0 + r % KS, gn = n0 + c;
      __nv_bfloat16 v = __float2bfloat16_rn(0.0f);
      if (gk < kend && gn < O) {
        if constexpr (GD) {
          v = __float2bfloat16_rn(
              P4 ? (float)nibble(w[(size_t)gk * O + gn], r / KS)
                 : (float)w[(size_t)gk * O + gn]);
        } else if constexpr (P4) {
          const int plane = r / KS, lk = gk + plane * Ih;
          v = __float2bfloat16_rn(
              (float)nibble(w[(size_t)gk * O + gn], plane) *
              to_f(s[(size_t)(lk / gs) * O + gn]));
        } else {
          const float wv = (float)w[(size_t)gk * O + gn];
          const float sv = __bfloat162float(
              __float2bfloat16_rn(to_f(s[(size_t)(gk / gs) * O + gn])));
          v = __float2bfloat16_rn(wv * sv);
        }
      }
      Bs[r][c] = v;
    }
    if constexpr (GD) {
      for (int e = tid; e < BK / 16 * BN; e += QT)
        Ss[e / BN][e % BN] = group_scale(k0, e / BN, e % BN);
    }
  };

  S st;
  if constexpr (GD) {
    // mma.sync m16n8k16: warp quadrant (wm, wn) as 2 x 4 tiles of 16 x 8;
    // lane (g, t4) holds rows g and g + 8, columns 2 * t4 and 2 * t4 + 1
    // of each tile
    constexpr int P = KS / 16;           // k = 16 steps of a plane a stage
    const int lane = tid % 32, g = lane >> 2, t4 = lane & 3;
    float part[2][4][4], acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = acc[i][j][e] = 0.0f;
    if constexpr (VEC) {
      if (kbeg < kend) load(st, kbeg);
    }
    for (int k0 = kbeg; k0 < kend; k0 += KS) {
      if constexpr (VEC)
        store(st, k0);
      else
        stage_scalar(k0);
      __syncthreads();
      if constexpr (VEC) {
        if (k0 + KS < kend) load(st, k0 + KS);
      }
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        const int kk = 16 * ks;
        if (!in_k(k0, kk)) continue;     // the same for the whole block
        uint32_t a[2][4], b[4][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = wm + 16 * i + g;
          a[i][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 2 * t4]);
          a[i][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 2 * t4]);
          a[i][2] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 2 * t4 + 8]);
          a[i][3] =
              *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 2 * t4 + 8]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = wn + 8 * j + g;
          b[j][0] = pack_bf16(Bs[kk + 2 * t4][c], Bs[kk + 2 * t4 + 1][c]);
          b[j][1] = pack_bf16(Bs[kk + 2 * t4 + 8][c], Bs[kk + 2 * t4 + 9][c]);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_16816(part[i][j], a[i], b[j]);
        // flush at the end of the group, of the plane's half of the
        // stage, or of the split
        if ((xcol(k0, kk) + 16) % gs == 0 || ks % P == P - 1 ||
            !in_k(k0, kk + 16)) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float s0 = Ss[ks][wn + 8 * j + 2 * t4];
            const float s1 = Ss[ks][wn + 8 * j + 2 * t4 + 1];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                acc[i][j][e] += part[i][j][e] * (e & 1 ? s1 : s0);
                part[i][j][e] = 0.0f;
              }
            }
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gr = m0 + wm + 16 * i + g + (e >= 2 ? 8 : 0);
          const int gn = n0 + wn + 8 * j + 2 * t4 + (e & 1);
          if (gr >= T || gn >= O) continue;
          const size_t o = (size_t)gr * O + gn;
          const float v = acc[i][j][e];
          if (partial != nullptr)
            partial[(size_t)blockIdx.z * T * O + o] = v;
          else
            out[o] = from_f<XT>(res != nullptr ? to_f(res[o]) + v : v);
        }
    return;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  if constexpr (VEC) {
    if (kbeg < kend) load(st, kbeg);
  }
  for (int k0 = kbeg; k0 < kend; k0 += KS) {
    if constexpr (VEC)
      store(st, k0);
    else
      stage_scalar(k0);
    __syncthreads();
    // the next stage's loads are in flight while this one is multiplied
    if constexpr (VEC) {
      if (k0 + KS < kend) load(st, k0 + KS);
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[wm + i * 16][kk], LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], &Bs[kk][wn + j * 16], LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Cs reuses the staging buffers: the loop ended on a barrier
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm + i * 16][wn + j * 16], acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();

  for (int idx = tid; idx < BM * BN; idx += QT) {
    const int r = idx / BN, c = idx % BN;
    const int gr = m0 + r, gn = n0 + c;
    if (gr >= T || gn >= O) continue;
    const size_t o = (size_t)gr * O + gn;
    if (partial != nullptr)
      partial[(size_t)blockIdx.z * T * O + o] = Cs[r][c];
    else
      out[o] = from_f<XT>(res != nullptr ? to_f(res[o]) + Cs[r][c]
                                         : Cs[r][c]);
  }
}

// Wide path: f32 dequant and f32 FMA.  256 threads, each a 4x4 block of
// outputs strided by 16 so shared-memory reads do not conflict.
template <typename XT, typename WT, typename ST>
__global__ void __launch_bounds__(256)
qmm_f32_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
               const ST* __restrict__ s, const float* __restrict__ gain,
               const XT* __restrict__ res, XT* __restrict__ out,
               float* __restrict__ partial, int T, int I, int O, int gs,
               int k_per_split, float eps) {
  __shared__ float As[BKW][BM + 4];
  __shared__ float Bs[BKW][BN + 4];
  __shared__ float rinv[BM];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(I, kbeg + k_per_split);
  if (gain != nullptr) row_inv_rms<XT, 256>(x, T, I, m0, eps, rinv);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = kbeg; k0 < kend; k0 += BKW) {
    for (int idx = tid; idx < BM * BKW; idx += blockDim.x) {
      const int r = idx / BKW, c = idx % BKW;
      const int gr = m0 + r, gk = k0 + c;
      float v = 0.0f;
      if (gr < T && gk < kend) {
        v = to_f(x[(size_t)gr * I + gk]);
        if (gain != nullptr) v = norm_x<XT>(v, rinv[r], gain[gk]);
      }
      As[c][r] = v;
    }
    for (int idx = tid; idx < BKW * BN; idx += blockDim.x) {
      const int r = idx / BN, c = idx % BN;
      const int gk = k0 + r, gn = n0 + c;
      float v = 0.0f;
      if (gk < kend && gn < O)
        v = to_f(w[(size_t)gk * O + gn]) * to_f(s[(size_t)(gk / gs) * O + gn]);
      Bs[r][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BKW; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = m0 + ty + 16 * i;
    if (gr >= T) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn >= O) continue;
      const size_t o = (size_t)gr * O + gn;
      if (partial != nullptr)
        partial[(size_t)blockIdx.z * T * O + o] = acc[i][j];
      else
        out[o] = from_f<XT>(res != nullptr ? to_f(res[o]) + acc[i][j]
                                           : acc[i][j]);
    }
  }
}

// Sum of the split-K partials (after the K1f residual, when given),
// written in x's dtype.
template <typename XT>
__global__ void splitk_reduce_kernel(const float* __restrict__ partial,
                                     const XT* __restrict__ res,
                                     XT* __restrict__ out, size_t n,
                                     int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float acc = res != nullptr ? to_f(res[i]) : 0.0f;
    for (int p = 0; p < splits; ++p) acc += partial[(size_t)p * n + i];
    out[i] = from_f<XT>(acc);
  }
}

// dtype codes shared with ops/kernels/qmm.py
enum { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2, DT_I16 = 3 };

template <typename XT>
int launch_typed(const void* x, const void* w, const void* s,
                 const float* gain, const void* res, float eps, void* out,
                 float* partial, int T, int I, int O, int gs, int splits,
                 int k_per_split, int w_dt, int s_dt, int wide, int vec,
                 int packed, int groupdot, cudaStream_t st) {
  const dim3 grid((O + BN - 1) / BN, (T + BM - 1) / BM, splits);
  float* part = splits > 1 ? partial : nullptr;
  const XT* xp = static_cast<const XT*>(x);
  const XT* rp = static_cast<const XT*>(res);
  XT* op = static_cast<XT*>(out);
  // the residual is added once: by the reduce pass when K is split
  const XT* rmain = splits > 1 ? nullptr : rp;
  if (packed && (wide || w_dt != DT_I8 || I % 2))
    return (int)cudaErrorInvalidValue;
  if (groupdot && (wide || gs % 16)) return (int)cudaErrorInvalidValue;
  if (!wide) {
    if (w_dt != DT_I8) return (int)cudaErrorInvalidValue;
    const int8_t* wp = static_cast<const int8_t*>(w);
#define QMM_BF16(ST, V, P, G)                                                \
  qmm_bf16_kernel<XT, ST, V, P, G><<<grid, QT, 0, st>>>(                     \
      xp, wp, static_cast<const ST*>(s), gain, rmain, op, part, T, I, O, gs,  \
      k_per_split, eps)
#define QMM_BF16_G(ST, V, P)                                                 \
  if (groupdot) QMM_BF16(ST, V, P, true); else QMM_BF16(ST, V, P, false)
#define QMM_BF16_S(ST, P)                                                    \
  if (vec) { QMM_BF16_G(ST, true, P); } else { QMM_BF16_G(ST, false, P); }
    if (s_dt == DT_F32) {
      if (packed) { QMM_BF16_S(float, true); } else { QMM_BF16_S(float, false); }
    } else {
      if (packed) { QMM_BF16_S(__nv_bfloat16, true); }
      else { QMM_BF16_S(__nv_bfloat16, false); }
    }
#undef QMM_BF16_S
#undef QMM_BF16_G
#undef QMM_BF16
  } else if (w_dt == DT_I8) {
    if (s_dt == DT_F32)
      qmm_f32_kernel<XT, int8_t, float><<<grid, 256, 0, st>>>(
          xp, static_cast<const int8_t*>(w), static_cast<const float*>(s),
          gain, rmain, op, part, T, I, O, gs, k_per_split, eps);
    else
      qmm_f32_kernel<XT, int8_t, __nv_bfloat16><<<grid, 256, 0, st>>>(
          xp, static_cast<const int8_t*>(w),
          static_cast<const __nv_bfloat16*>(s), gain, rmain, op, part, T, I,
          O, gs, k_per_split, eps);
  } else {
    if (s_dt == DT_F32)
      qmm_f32_kernel<XT, int16_t, float><<<grid, 256, 0, st>>>(
          xp, static_cast<const int16_t*>(w), static_cast<const float*>(s),
          gain, rmain, op, part, T, I, O, gs, k_per_split, eps);
    else
      qmm_f32_kernel<XT, int16_t, __nv_bfloat16><<<grid, 256, 0, st>>>(
          xp, static_cast<const int16_t*>(w),
          static_cast<const __nv_bfloat16*>(s), gain, rmain, op, part, T, I,
          O, gs, k_per_split, eps);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (splits > 1) {
    const size_t n = (size_t)T * O;
    const int blocks = (int)std::min<size_t>((n + 255) / 256, 4096);
    splitk_reduce_kernel<XT><<<blocks, 256, 0, st>>>(partial, rp, op, n,
                                                     splits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// out (T, O) in x's dtype; partial: splits*T*O f32 scratch when splits > 1;
// vec: 16-byte aligned rows (O % 16 == 0, I % 8 == 0, aligned pointers;
// K1p: I % 16 == 0).  K1f: gain (I,) f32 or null (rmsnorm prologue with
// eps), res (T, O) in x's dtype or null (residual epilogue).  packed: K1p,
// w the (I/2, O) split-half bytes, k_per_split in packed rows, wide 0.
// groupdot: the scale-after-dot mode (not wide, gs % 16 == 0).
extern "C" int qmm_launch(const void* x, const void* w, const void* s,
                          const void* gain, const void* res, float eps,
                          void* out, void* partial, int T, int I, int O,
                          int gs, int splits, int k_per_split, int x_dt,
                          int w_dt, int s_dt, int wide, int vec, int packed,
                          int groupdot, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  const float* g = static_cast<const float*>(gain);
  if (x_dt == DT_F32)
    return launch_typed<float>(x, w, s, g, res, eps, out, part, T, I, O, gs,
                               splits, k_per_split, w_dt, s_dt, wide, vec,
                               packed, groupdot, st);
  if (x_dt == DT_BF16)
    return launch_typed<__nv_bfloat16>(x, w, s, g, res, eps, out, part, T, I,
                                       O, gs, splits, k_per_split, w_dt, s_dt,
                                       wide, vec, packed, groupdot, st);
  return (int)cudaErrorInvalidValue;
}
