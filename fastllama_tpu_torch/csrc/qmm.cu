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
// a verify round (T = 128) sits near both bounds; prefill waves (T up to
// 2048) are bound by tensor-core operations.  Two kernels serve it:
//   * qmm_pipe_kernel, the pipelined mode (below, after qmm_f32_kernel),
//     takes every standard-mode call that is not wide, is 16-byte aligned,
//     has gs % 64 == 0 (an unpacked weight: gs % 32 == 0, the G32
//     instantiation qmm_pipe_g32_kernel below gs % 64) and T <= 128: the
//     batched decode step, the single stream with its K1f glue and the
//     speculative verify.  A cp.async ring of raw weight stages in shared
//     memory, dequantized straight into mma.sync fragments.  Its groupdot
//     instantiation, qmm_pipe_gd_kernel, takes the groupdot calls of the
//     same kind at gs % 64 == 0;
//   * qmm_bf16_kernel, the loop, takes the rest: prefill waves (T > 128)
//     that qmm_prefill.cu does not take, other group sizes (16, 80; the
//     groupdot mode's off 64) and (with the element path) unaligned rows.
//     It tiles 64x64 outputs per block and walks K in stages of 64 rows:
//     each thread loads its part of the next stage
//     (16-byte vector loads of W, x and the group scales) into registers
//     while the warps multiply the current stage from shared memory with
//     WMMA.  No TMA and no wgmma yet: prefill's loop is later work.
// When the output tiles alone cannot fill the 132 SMs (decode shapes) K is
// split across blocks and a second small kernel sums the partials
// (deterministic).  Shapes whose rows are not 16-byte aligned (O % 16,
// I % 8) stage element by element instead.
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
// ms; at T = 128 the operations bound it (0.0532 ms a layer).  Its calls
// up to T = 128 take the pipelined mode, whose stage of 32 packed rows
// keeps as many nibble bytes in flight as the ring holds; the loop's
// register double-buffering is left for prefill waves.
//
// The groupdot mode of K1 and K1p (template flag GD) replaces the
// scale-after-dot variant of the Pallas kernels: _qmm_chunk_groupdot
// (qmm.py:89-106, run by _qmm_kernel at :109-119) and _groupdot_p4
// (:405-416, run by _qmm_kernel_p4 at :368-402).  The int8 values (or the
// sign-extended nibbles) go to bf16 with no scale, x to bf16, and a group's
// product is contracted in f32 partials; each partial is multiplied by the
// group's scale per output column (an exact f32 value: a bf16 scale is
// promoted, the product is not rounded) and added to the block's f32
// accumulator.  Both kernels run it on mma.sync.m16n8k16, whose register
// layout is documented (WMMA's is opaque): each thread knows the output
// columns it holds and scales its partial in registers.  Only the f32 sum
// order differs from the plain version.  Its bound is K1's: bytes at
// decode.  It saves the per-element scale multiply of the dequant.
//   * On the pipelined ring (qmm_pipe_gd_kernel: T <= 128, gs % 64 == 0,
//     16-byte aligned rows) a stage's plane (64 W rows, or K1p's 32 packed
//     rows of one plane) lies in one group.  The plane's B fragments of
//     all four k-steps hold the exact integers (one LOP3 a byte or nibble,
//     no scale); each m-tile's product over them goes into a partial of
//     NJ x 4 registers that the lane's f32 scales fold into the
//     accumulators at once, so the mode needs few registers beside the
//     standard mode's.  A split ends on a stage, so on a flush.  K1p's
//     planes run one after the other.  At 128 rows it takes 8 warps of 2
//     n-tiles: 4 warps of 4 have no registers for the fragments.
//   * On the loop (qmm_bf16_kernel with GD; T > 128, gs of 16, 32, 80...,
//     unaligned rows) the stage's group scales (one row of BN a k = 16
//     step) are prefetched into registers with the stage and staged in
//     shared memory, and a partial is flushed at the end of its group, of
//     each plane's half of a stage and of a split, so a group cut by a
//     stage or a split is scaled in parts.  The group size must be a
//     multiple of 16 so that no k = 16 step straddles two groups.
//
// The wide mode's pipelined instantiation (qmm_pipe_wide_kernel) takes
// every wide call (f32 compute, or INT16 at any compute dtype) with T <=
// 128, gs % 32 == 0 (below gs % 64 its G32 instantiation,
// qmm_pipe_wide_g32_kernel) and 16-byte aligned rows: the batched decode
// step, the single stream with its K1f glue and the verify at f32 compute
// or on an INT16 weight.  It computes the JAX wide kernel's function (f32
// dequant and a Precision.HIGHEST dot, qmm.py:62-74) on bf16 tensor cores:
// the groupdot ring's body, whose B fragments hold the exact integers, with
// x split once a stage into three bf16 planes, hi = bf16(v), mid = bf16(v -
// hi), lo = bf16(v - hi - mid), which together hold f32's 24-bit
// significand.  Every m-tile's partial takes the planes' products in turn
// (lo, mid, then hi) against the same B fragments, and the lane's f32
// group scales fold it into the accumulators once a group.  A bf16 x (or
// K1f's prologue rounding to bf16) is exact in one plane: one pass.  It
// departs from the reference only in rounding: the reference rounds
// f32(w) * f32(s) once an element before the dot, this mode the group's
// partial times the scale once a group (with a bf16 scale both products
// are exact: only the f32 sum order differs).  Its bound is bytes up to
// T = 128 at three passes (0.059 ms of tensor work a 7B layer at T = 48,
// 0.0643 ms of bytes at T = 1).
//   * INT16 (its instantiation of weight bytes WB = 2): each value is
//     w = 256 hi + lo, hi = w >> 8 its signed high byte, lo = w & 0xFF its
//     unsigned low byte; bf16 holds lo and 256 hi exactly, and their
//     products with a bf16 plane of x are exact in f32, so both weight
//     planes go into the same group partial.  On the little-endian card
//     the two bytes of an int16 are the two planes: each becomes its exact
//     float by a byte permute into a magic float and an FADD (the high
//     byte, its sign bit flipped, in the low mantissa bits of 2^31, whose
//     unit there is 256), no int-to-float conversion.  A slot's W rows are
//     2 BN + 16 bytes; a lane's NJ columns are 2 NJ bytes, each k = 16
//     step builds a lo and a hi B fragment of them, and each x plane's
//     A fragments multiply both: two passes on bf16 x, six on f32 x.
// qmm_f32_kernel keeps the wide calls off gs % 32 == 0 (16, 80), unaligned
// rows and an offset residual (qmm_prefill.cu takes those above 128 rows).
//
// The G32 instantiations (qmm_pipe_g32_kernel, qmm_pipe_wide_g32_kernel;
// gs a multiple of 32 and not of 64, GGUF Q8_0's 32 and 96, unpacked
// weights): a stage's 64 rows are two 32-row halves (k = 16 steps 0-1 and
// 2-3), each in one group, and the stage holds a scale row a half, k0 / gs
// and (k0 + 32) / gs, the second in the 16-byte pads that end the slot's W
// rows (free bytes: the slot, the ring and the blocks an SM stay those of
// gs 64).  The standard mode dequantizes steps 2-3 with the second row
// (the same bf16(bf16(w) * bf16(s)) rounding); the wide mode scales the
// exact-integer partial into the accumulators twice a stage, after steps
// 0-1 by the first row and after 2-3 by the second.  The gs-64 kernels
// keep their code: the flag is a template argument of the body.
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
// outputs strided by 16 so shared-memory reads do not conflict.  The wide
// calls that neither qmm_pipe_wide_kernel nor qmm_wgmma_wide_kernel
// (qmm_prefill.cu) takes: other group sizes, unaligned rows, an offset
// residual.
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

// ---------------------------------------------------------------------------
// The pipelined mode (qmm_pipe_kernel): K1 and K1p at T <= 128, standard
// mode, not wide, 16-byte aligned, gs a multiple of 64 (its G32
// instantiations: an unpacked weight at gs a multiple of 32); its groupdot
// instantiation (qmm_pipe_gd_kernel, the same body with MODE PM_GD: see the
// groupdot notes at the top) the groupdot calls of that kind, and its wide
// instantiation (qmm_pipe_wide_kernel, MODE PM_WIDE, or PM_WIDE16 on an
// int16 weight: the groupdot body over three bf16 planes of x) the wide
// calls of that kind.
//
// A block computes all T rows (one row tile of 16 * MT rows: 16, 48, 64 or
// 128, the least that holds T) of BN = 8 * NJ * CG output columns over one
// split of K.  Its stages (64 logical K rows: 64 W
// rows, or K1p's 32 packed rows holding two planes, one group each since
// gs % 64 == 0; G32: each 32-row half in one group) sit in a ring of PK_NS
// slots in dynamic shared memory, each slot the raw weight bytes, the x
// tile as stored (T rows x 64 columns; K1p: the low plane's 32 columns,
// then the high plane's) and the stage's BN-wide row of group scales (K1p:
// one a plane; G32: one a half, the second in the W rows' pads), all moved
// by 16-byte
// cp.async with zero fill past the edges; the x rows from T to the tile's
// end are zeroed once.  PK_NS - 1 stages are in flight while one is
// multiplied: one barrier a stage (two when x has to be converted first).
// CG warps, each of NJ mma.sync.m16n8k16 n-tiles (8 * NJ columns; NJ 2
// halves the accumulators, so that more warps an SM keep the tensor cores
// fed) whose column n of tile j is the warp's column NJ n + j, so a lane's
// NJ columns are neighbouring bytes: one 32- (16-) bit shared load a W
// row feeds a B fragment register of all NJ tiles.  The weights are
// dequantized from those words straight into the B fragments:
//   * INT8: each byte becomes an exact float by a magic-exponent LOP3 (the
//     byte in the mantissa, no int-to-float conversion), two of them a bf16
//     pair (exact), times the bf16 scale pair in bf16 arithmetic: one
//     rounding, bf16(bf16(w) * bf16(s)), as _qmm_chunk;
//   * K1p: a k = 16 step takes 16 packed rows of ONE plane (the low
//     nibbles, or the high ones against x's columns I/2 + k), each nibble an
//     exact float the same way, times the f32 scale in f32, the pair rounded
//     to bf16 once: bf16(f32(nibble) * f32(s)), as _qmm_kernel_p4.
// x goes to the A fragments by ldmatrix from the slot (bf16 x) or from a
// bf16 copy that the block writes after the stage lands (f32 x, or the K1f
// prologue: x * rinv * gain rounded once; the wide mode's f32 x: three
// planes, hi, mid and lo, one after the other).  Under the prologue the block
// first puts its first PK_NS - 1 stages in flight, then reads its rows for the
// inverse RMS.  The mma chain has constant bounds and no branch: a step
// past the split multiplies zero-filled weights.  A split-K launch writes
// f32 partials that splitk_reduce_kernel sums (deterministic; the residual
// is added there).  Summing them in the kernel instead, by each column
// tile's last block to finish, measured slower on an H100 at T = 48 and
// 128.
constexpr int PK_X = 64;               // x tile columns a stage
constexpr int PK_XB = PK_X * 2 + 16;   // bf16 x row pitch (bytes)
constexpr int PK_SMEM_BLOCK = 232448;  // shared memory a block may use
// the ring's depth: deeper rings leave fewer blocks an SM, which read
// slower on an H100 (PERF.md, PR 10)
constexpr int PK_NS = 3;
// The wide mode's tuning macros (tools/wide_pipe_design.py builds
// variants and times them in turns):
//   QMM_WIDE_STAGES48, QMM_WIDE_MIN_BLOCKS48: the wide ring's depth and
//     least blocks an SM at 48 rows (the batched step's T): a two-stage
//     ring leaves shared memory for three blocks on f32 x, and ptxas fits
//     them in 168 registers; 17 % faster a 7B layer than three stages and
//     two blocks on an H100 (PERF.md), where the other row tiles
//     keep PK_NS stages;
//   QMM_WIDE_PLANES: the planes of f32 x it multiplies; 3 holds f32's
//     significand, fewer is a diagnostic of what the passes cost (it
//     misses the reference's accuracy);
//   QMM_WIDE16_STAGES48, QMM_WIDE16_MIN_BLOCKS48, QMM_WIDE16_SPLIT48: the
//     same two at INT16, whose W rows take twice the bytes, and whether its
//     48-row tile multiplies the two weight planes in two passes over x's
//     planes a k = 16 step (one plane's B fragments live at a time, x's A
//     fragments loaded twice; 0: one pass, both live): two stages, three
//     blocks an SM and two passes, which ptxas fits in 168 registers
//     without a spill, 18 % faster a 7B layer on bf16 x than three stages,
//     two blocks and one pass on an H100 (PERF.md); the other row tiles
//     keep PK_NS stages and one pass
#ifndef QMM_WIDE16_STAGES48
#define QMM_WIDE16_STAGES48 2
#endif
#ifndef QMM_WIDE16_MIN_BLOCKS48
#define QMM_WIDE16_MIN_BLOCKS48 3
#endif
#ifndef QMM_WIDE16_SPLIT48
#define QMM_WIDE16_SPLIT48 1
#endif
#ifndef QMM_WIDE_STAGES48
#define QMM_WIDE_STAGES48 2
#endif
#ifndef QMM_WIDE_MIN_BLOCKS48
#define QMM_WIDE_MIN_BLOCKS48 3
#endif
#ifndef QMM_WIDE_PLANES
#define QMM_WIDE_PLANES 3
#endif


// bytes of one ring slot: W rows of wb-byte weights at a pitch of wb bn +
// 16, the x tile at a pitch of its row + 16, the scale rows (K1p: two; the
// G32 instantiations' second row lives in the W rows' 16-byte pads)
__host__ __device__ constexpr int pipe_stage_bytes(bool p4, int s_size,
                                                   int mt, int bn,
                                                   int x_size, int wb = 1) {
  return (p4 ? 32 : 64) * (wb * bn + 16) + 16 * mt * (PK_X * x_size + 16) +
         (p4 ? 2 : 1) * bn * s_size;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mma_16816 without `volatile`: a pure function of its registers, so the
// compiler may schedule the next fragments' loads ahead of the chain
__device__ __forceinline__ void mma_16816_sched(float (&d)[4],
                                                const uint32_t (&a)[4],
                                                const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a * b, the chain's first step: C is a zero register, so d needs no
// zeroing first
__device__ __forceinline__ void mma_16816_first(float (&d)[4],
                                                const uint32_t (&a)[4],
                                                const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.0f));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"((uint32_t)__cvta_generic_to_shared(p)));
}

// The signed field of BITS bits at bit pos (pos + BITS <= 20) of v as an
// exact float: the field, its sign bit flipped, becomes the low mantissa
// bits of 2^(23 - pos) (one LOP3), and the bias 2^(23 - pos) +
// 2^(BITS - 1) comes off exactly.
template <int BITS>
__device__ __forceinline__ float field_f(uint32_t v, int pos) {
  const uint32_t mask = ((1u << BITS) - 1) << pos;
  const uint32_t magic = (1u << (BITS - 1 + pos)) | ((150u - pos) << 23);
  return __uint_as_float((v & mask) ^ magic) -
         (float)((1 << (23 - pos)) + (1 << (BITS - 1)));
}
// byte j of v
__device__ __forceinline__ float byte_f(uint32_t v, int j) {
  return field_f<8>(j >= 2 ? v >> 16 : v, (j & 1) * 8);
}
// plane p's nibble of byte j of v (p 0: the low nibble); vh = v >> 12
__device__ __forceinline__ float nib_f(uint32_t v, uint32_t vh, int p, int j) {
  const int pos = 8 * j + 4 * p;
  return pos < 20 ? field_f<4>(v, pos) : field_f<4>(vh, pos - 12);
}
// the bf16 pair (lo, hi) of two floats that bf16 holds exactly
__device__ __forceinline__ uint32_t exact_pair(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
__device__ __forceinline__ uint32_t bf16_mul2(uint32_t a, __nv_bfloat162 s) {
  const __nv_bfloat162 r = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&a), s);
  return *reinterpret_cast<const uint32_t*>(&r);
}
__device__ __forceinline__ uint32_t round_pair(float lo, float hi) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&r);
}
// N (2, 4 or 8) neighbouring group scales as f32 (a bf16 one promoted
// exactly)
template <int N>
__device__ __forceinline__ void scales_f(float (&d)[N], const unsigned char* p,
                                         bool f32) {
  if (f32) {
    if constexpr (N >= 4) {
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 v = reinterpret_cast<const float4*>(p)[q];
        d[4 * q] = v.x; d[4 * q + 1] = v.y; d[4 * q + 2] = v.z;
        d[4 * q + 3] = v.w;
      }
    } else {
      const float2 v = *reinterpret_cast<const float2*>(p);
      d[0] = v.x; d[1] = v.y;
    }
  } else {
    uint4 v = make_uint4(0, 0, 0, 0);
    if constexpr (N == 8) v = *reinterpret_cast<const uint4*>(p);
    else if constexpr (N == 4) {
      const uint2 h = *reinterpret_cast<const uint2*>(p);
      v.x = h.x; v.y = h.y;
    } else v.x = *reinterpret_cast<const uint32_t*>(p);
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < N; ++j) d[j] = __bfloat162float(b[j]);
  }
}
// The G32 instantiations' second scale row, held in the 16-byte pads that
// end the slot's W rows (its chunk q in the pad of W row q; wbn the W
// row's bytes, wp its pitch): N (2, 4 or 8) neighbouring scales as f32
// from column c, read in pieces that each lie in one pad (c a multiple of
// N, so at most 16 bytes a piece)
template <int N>
__device__ __forceinline__ void pad_scales(float (&d)[N],
                                           const unsigned char* wsl, int wp,
                                           int wbn, int c, int ssz) {
  constexpr int H = N > 4 ? N / 2 : N;
#pragma unroll
  for (int q = 0; q < N / H; ++q) {
    const int off = (c + q * H) * ssz;
    float v[H];
    scales_f<H>(v, wsl + (off >> 4) * wp + wbn + (off & 15), ssz == 4);
#pragma unroll
    for (int j = 0; j < H; ++j) d[q * H + j] = v[j];
  }
}
// N (4 or 8) f32 at p
template <int N>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[N]) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q)
    reinterpret_cast<float4*>(p)[q] =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}
template <int N>
__device__ __forceinline__ void add_f32(float (&v)[N], const float* p) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    const float4 a = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] += a.x; v[4 * q + 1] += a.y; v[4 * q + 2] += a.z;
    v[4 * q + 3] += a.w;
  }
}
// N (4 or 8) values rounded to bf16 at p
template <int N>
__device__ __forceinline__ void store_bf16(__nv_bfloat16* p,
                                           const float (&v)[N]) {
  uint32_t u[N / 2];
#pragma unroll
  for (int q = 0; q < N / 2; ++q) u[q] = round_pair(v[2 * q], v[2 * q + 1]);
  if constexpr (N == 8)
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  else
    *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
}
template <int N>
__device__ __forceinline__ void add_bf16(float (&v)[N],
                                         const __nv_bfloat16* p) {
  uint32_t u[N / 2];
  if constexpr (N == 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    u[0] = a.x; u[1] = a.y; u[2] = a.z; u[3] = a.w;
  } else {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    u[0] = a.x; u[1] = a.y;
  }
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(u);
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = __bfloat162float(e[j]) + v[j];
}

// the instantiations of the ring's body: standard, groupdot, wide (an
// int8-held weight), wide on an int16 weight
enum { PM_STD = 0, PM_GD = 1, PM_WIDE = 2, PM_WIDE16 = 3 };
// the launch functions' mode flag of the G32 instantiations (a scale row a
// 32-row half of a stage), or'ed into PM_STD, PM_WIDE or PM_WIDE16
constexpr int PM_G32 = 4;

__host__ __device__ constexpr bool pipe_wide(int mode) {
  return mode == PM_WIDE || mode == PM_WIDE16;
}
// bytes a weight
__host__ __device__ constexpr int pipe_wb(int mode) {
  return mode == PM_WIDE16 ? 2 : 1;
}

// the bf16 x planes of a ring block: three in the wide mode on f32 x, else
// one (a bf16 value is exact in one)
__host__ __device__ constexpr int pipe_x_planes(int mode, int x_f32) {
  return pipe_wide(mode) && x_f32 ? QMM_WIDE_PLANES : 1;
}

// the ring's depth of an instantiation of MT m-tiles
__host__ __device__ constexpr int pipe_stages(int mode, int mt) {
  return mt != 3              ? PK_NS
         : mode == PM_WIDE    ? QMM_WIDE_STAGES48
         : mode == PM_WIDE16  ? QMM_WIDE16_STAGES48
                              : PK_NS;
}

// INT16's planes (the wide mode's WB = 2): int16 half h (0 the low) of
// the word v.  Its low byte, unsigned, is the low mantissa byte of 2^23;
// its high byte, the sign bit flipped, that of 2^31, whose mantissa unit
// is 256; the bias comes off exactly: lo and 256 hi as exact floats.
__device__ __forceinline__ float lo16_f(uint32_t v, int h) {
  return __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7650u | (2 * h))) -
         8388608.0f;
}
__device__ __forceinline__ float hi16_f(uint32_t v, int h) {
  return __uint_as_float(__byte_perm(v ^ 0x80008000u, 0x4F000000u,
                                     0x7650u | (2 * h + 1))) -
         2147516416.0f;
}

// v (8 f32) as three bf16 planes, hi = bf16(v), mid = bf16(v - hi), lo =
// bf16(v - hi - mid), round to nearest; each difference is exact in f32, so
// hi + mid + lo == v (the 24-bit significand in three 8-bit parts)
__device__ __forceinline__ void split3_store(__nv_bfloat16* dst, int plane,
                                             float (&v)[8]) {
#pragma unroll
  for (int p = 0; p < QMM_WIDE_PLANES; ++p) {
    uint32_t u[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * h], v[2 * h + 1]);
      u[h] = *reinterpret_cast<const uint32_t*>(&b);
      const float2 f = __bfloat1622float2(b);
      v[2 * h] -= f.x;
      v[2 * h + 1] -= f.y;
    }
    *reinterpret_cast<uint4*>(dst + p * plane) =
        make_uint4(u[0], u[1], u[2], u[3]);
  }
}

// G32: a group size that is a multiple of 32 (not of 64): each 32-row half
// of a stage lies in one group, and the stage holds a scale row a half
// (unpacked weights; the standard and wide modes)
template <bool P4, int MT, int CG, int NJ, int MODE, bool G32 = false>
__device__ __forceinline__ void qmm_pipe_body(
    const void* __restrict__ xv, const int8_t* __restrict__ w,
    const unsigned char* __restrict__ s, const float* __restrict__ gain,
    const void* __restrict__ resv, void* __restrict__ outv,
    float* __restrict__ partial, int T, int I, int O, int gs,
    int k_per_split, int x_f32, int s_f32, float eps) {
  // the wide mode is the groupdot body over the planes of x
  constexpr bool GD = MODE != PM_STD, WIDE = pipe_wide(MODE);
  static_assert(!(WIDE && P4), "the wide mode takes unpacked weights");
  static_assert(!(G32 && (P4 || MODE == PM_GD)),
                "two scale rows a stage: unpacked, standard or wide");
  constexpr int NS = pipe_stages(MODE, MT);
  constexpr int NW = CG, NT = NW * 32, BN = 8 * NJ * CG, BMR = 16 * MT;
  constexpr int KS = P4 ? 32 : 64;     // W rows a stage
  constexpr int KSTEPS = KS / 16;      // k = 16 steps a stage (K1p: a plane)
  constexpr int WB = pipe_wb(MODE);    // bytes a weight
  constexpr int WP = WB * BN + 16;     // W row pitch in the slot (bytes)
  constexpr int NP = P4 ? 2 : 1;       // planes
  extern __shared__ __align__(128) unsigned char psm[];
  __shared__ float rinv[BMR];
  __shared__ float wsum[NW][BMR];
  const int esz = x_f32 ? 4 : 2, ssz = s_f32 ? 4 : 2;
  const int XP = PK_X * esz + 16;      // x row pitch in the slot (bytes)
  const int stage = pipe_stage_bytes(P4, ssz, MT, BN, esz, WB);
  const bool conv = x_f32 || gain != nullptr;
  __nv_bfloat16* xbuf = reinterpret_cast<__nv_bfloat16*>(psm + NS * stage);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * BN;
  const int Ih = I / 2;
  const int kbeg = blockIdx.y * k_per_split;
  const int kend = min(P4 ? Ih : I, kbeg + k_per_split);
  const int nst = (kend - kbeg + KS - 1) / KS;
  const char* xb = static_cast<const char*>(xv);
  const int xlg = x_f32 ? 4 : 3;       // log2 of an x row's 16-byte chunks

  // Each thread copies the same 16-byte column of every stage: its W
  // chunks sit in rows wr0, wr0 + WR, ... of the slot, its x chunks in
  // rows xr0, xr0 + XR, ... (under T), its scale chunk (if any) in plane
  // sp's row; a stage only moves the sources on by its k0.
  constexpr int WC = WB * BN / 16, WR = NT / WC;
  const int wc = (tid % WC) * 16, wr0 = tid / WC;   // wc: a byte offset
  const bool w_in = n0 + wc / WB < O;
  const int8_t* wsrc = w + ((size_t)wr0 * O + n0) * WB + wc;
  const int xr0 = tid >> xlg, XR = NT >> xlg;
  const int xc = (tid & ((1 << xlg) - 1)) << (4 - (esz >> 1));
  const char* xsrc =
      xb + ((size_t)xr0 * I + (P4 && xc >= 32 ? Ih + xc - 32 : xc)) * esz;
  const int sc = BN * ssz / 16;        // 16-byte chunks of a scale row
  const int sp = tid / sc, scol = (tid % sc) * 16 / ssz;
  auto copy_stage = [&](int slot, int k0) {
    unsigned char* wsl = psm + slot * stage;
    const int8_t* wp = wsrc + (size_t)k0 * O * WB;
#pragma unroll
    for (int i = 0; i < KS / WR; ++i) {
      const bool in = w_in && k0 + wr0 + i * WR < kend;
      cp_async16(wsl + (wr0 + i * WR) * WP + wc,
                 in ? wp + (size_t)i * WR * O * WB : w, in ? 16 : 0);
    }
    // column xc of the x tile: x's k0 + xc, under K1p the high plane's
    // I/2 + k0 + xc - 32 for xc >= 32 (rows from T on stay zero)
    unsigned char* xsl = wsl + KS * WP;
    const bool xin = P4 ? k0 + (xc & 31) < Ih : k0 + xc < I;
    const char* xp = xsrc + (size_t)k0 * esz;
    for (int r = xr0; r < T; r += XR, xp += (size_t)XR * I * esz)
      cp_async16(xsl + r * XP + xc * esz, xin ? xp : xb, xin ? 16 : 0);
    // the stage's scale row (K1p: the low plane's, then the high plane's;
    // G32: the first half's, then the second's into the pads that end W
    // rows 0, 1, ..., a 16-byte chunk a pad; zero past I)
    if constexpr (G32) {
      if (sp < 2) {
        const int kh = k0 + 32 * sp;
        const bool in = n0 + scol < O && kh < I;
        cp_async16(sp == 0 ? xsl + BMR * XP + scol * ssz
                           : wsl + (tid % sc) * WP + WB * BN,
                   in ? s + ((size_t)(kh / gs) * O + n0 + scol) * ssz : s,
                   in ? 16 : 0);
      }
    } else if (sp < NP) {
      const size_t row = (size_t)((sp * Ih + k0) / gs);
      const bool in = n0 + scol < O;
      cp_async16(xsl + BMR * XP + (sp * BN + scol) * ssz,
                 in ? s + (row * O + n0 + scol) * ssz : s, in ? 16 : 0);
    }
  };

  // zero the x rows past T of every slot: the mma reads the whole tile
  for (int sl = 0; sl < NS; ++sl) {
    unsigned char* xsl = psm + sl * stage + KS * WP;
    for (int q = tid; q < (BMR - T) * XP / 16; q += NT)
      *reinterpret_cast<uint4*>(xsl + T * XP + q * 16) = make_uint4(0, 0, 0, 0);
  }
  for (int st = 0; st < NS - 1; ++st) {
    if (st < nst) copy_stage(st, kbeg + st * KS);
    cp_async_commit();
  }
  // K1f prologue, while those stages land: the inverse RMS of each row
  // over the whole row (per-warp partial sums, summed in warp order)
  if (gain != nullptr) {
    for (int r = 0; r < T; ++r) {
      float a = 0.0f;
      if (x_f32) {
        const float* row = reinterpret_cast<const float*>(xv) + (size_t)r * I;
        for (int c = tid * 4; c < I; c += NT * 4) {
          const float4 v = *reinterpret_cast<const float4*>(row + c);
          a = fmaf(v.x, v.x, fmaf(v.y, v.y, fmaf(v.z, v.z, fmaf(v.w, v.w, a))));
        }
      } else {
        const __nv_bfloat16* row =
            reinterpret_cast<const __nv_bfloat16*>(xv) + (size_t)r * I;
        for (int c = tid * 8; c < I; c += NT * 8) {
          const uint4 v = *reinterpret_cast<const uint4*>(row + c);
          const __nv_bfloat162* e = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(e[j]);
            a = fmaf(f.x, f.x, fmaf(f.y, f.y, a));
          }
        }
      }
      a = warp_sum(a);
      if (lane == 0) wsum[warp][r] = a;
    }
    __syncthreads();
    for (int r = tid; r < BMR; r += NT) {
      float ss = 0.0f;
      if (r < T) {
#pragma unroll
        for (int v = 0; v < NW; ++v) ss += wsum[v][r];
      }
      rinv[r] = r < T ? 1.0f / sqrtf(ss / (float)I + eps) : 0.0f;
    }
  }

  float acc[MT][NJ][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  const int cb = warp * 8 * NJ + NJ * g;   // the lane's first column

  for (int it = 0; it < nst; ++it) {
    cp_async_wait<NS - 2>();
    __syncthreads();                   // stage it landed; slot it - 1 free
    {
      const int st = it + NS - 1;
      if (st < nst) copy_stage(st % NS, kbeg + st * KS);
      cp_async_commit();
    }
    const int k0 = kbeg + it * KS;
    const unsigned char* wsl = psm + (it % NS) * stage;
    const unsigned char* xsl = wsl + KS * WP;
    const unsigned char* ssl = xsl + BMR * XP;
    const __nv_bfloat16* xa = reinterpret_cast<const __nv_bfloat16*>(xsl);
    int xpe = XP / 2;
    if (conv) {                        // x -> bf16, normalized under K1f
      for (int q = tid; q < BMR * (PK_X / 8); q += NT) {
        const int r = q / (PK_X / 8), c = (q % (PK_X / 8)) * 8;
        float v[8];
        if (x_f32) {
          const float4* p = reinterpret_cast<const float4*>(xsl + r * XP + c * 4);
          const float4 a = p[0], b = p[1];
          v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
          v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
        } else {
          const uint4 u = *reinterpret_cast<const uint4*>(xsl + r * XP + c * 2);
          const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(e[j]);
        }
        if (gain != nullptr) {
          const int col = P4 && c >= 32 ? Ih + k0 + c - 32 : k0 + c;
          const bool in = P4 ? k0 + (c & 31) < Ih : col < I;
          const float ri = rinv[r];
          const float* gp = gain + (in ? col : 0);
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = in ? v[j] * ri * __ldg(gp + j) : 0.0f;
        }
        if constexpr (WIDE) {
          if (x_f32) {                 // f32 x: three planes
            split3_store(xbuf + r * (PK_XB / 2) + c, BMR * (PK_XB / 2), v);
            continue;
          }
        }
        uint4 o;
        o.x = round_pair(v[0], v[1]);
        o.y = round_pair(v[2], v[3]);
        o.z = round_pair(v[4], v[5]);
        o.w = round_pair(v[6], v[7]);
        *reinterpret_cast<uint4*>(xbuf + r * (PK_XB / 2) + c) = o;
      }
      __syncthreads();
      xa = xbuf;
      xpe = PK_XB / 2;
    }
    // the lane's NJ bytes of W row r of the stage
    auto wbytes = [&](int r) -> uint32_t {
      const unsigned char* p = wsl + r * WP + cb;
      if constexpr (NJ == 4) return *reinterpret_cast<const uint32_t*>(p);
      else return *reinterpret_cast<const uint16_t*>(p);
    };
    if constexpr (GD) {
      // groupdot, plane by plane: the plane's B fragments of all KSTEPS
      // k-steps hold the exact integers; each m-tile's product over them
      // goes into a partial (the stage's plane lies in one group, gs %
      // 64 == 0) that is scaled into acc by the lane's accumulator
      // columns' f32 group scales (tile j's elements 0/2: warp column
      // 2 NJ t4 + j, 1/3: 2 NJ t4 + NJ + j).  One m-tile's partial at a
      // time: NJ * 4 registers beside the accumulators, not MT * NJ * 4.
      // Above 16 rows K1p's planes run one after the other (the loop not
      // unrolled), so that ptxas does not hold the second plane's
      // fragments beside the first's: that spilled at 48 and 128 rows
#pragma unroll(MT == 1 ? NP : 1)
      for (int p = 0; p < NP; ++p) {
        if constexpr (WB == 2) {
          // INT16 (the wide mode): a k = 16 step at a time, the lane's lo
          // and hi B fragments of its NJ columns (column j the int16 half
          // j & 1 of the row's word j / 2) from the same words; each plane
          // of x (lo, mid, hi; one on bf16 x) multiplies both (at 48 rows
          // one after the other, QMM_WIDE16_SPLIT48) into every m-tile's
          // partial (its products exact in f32), scaled into acc
          // once a stage as the int8 wide mode's (the scales read after the
          // k-steps: their registers are not live across the chain).
          // G32: scaled after each half's k-steps by its own row; at 64
          // and 128 rows the m-tiles in groups of two (MTG), each a pass
          // over the stage with a partial of its own (its B fragments
          // built again a group): with every m-tile's partial, or groups
          // of four, the second fold a stage left 255 registers short
          // (ptxas spilled 4-12 bytes on an H100 build)
          constexpr int MTG = G32 && MT >= 4 ? 2 : MT, MG = MT / MTG;
          const __nv_bfloat16* xr =
              xa + (lane & 15) * xpe + (lane >> 4) * 8;
          // weight planes a pass over x's planes, passes a k-step
          constexpr int PP = MT == 3 && QMM_WIDE16_SPLIT48 ? 1 : 2;
          constexpr int PASSES = 2 / PP;
#pragma unroll
          for (int mg = 0; mg < MG; ++mg) {
            float part[MTG][NJ][4];
#pragma unroll
            for (int i = 0; i < MTG; ++i)
#pragma unroll
              for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
            // acc += part times the lane's columns' scales: the stage's
            // row, or at G32 the second half's (last_half), in the W rows'
            // pads
            auto fold = [&](bool last_half) {
              float sa[2 * NJ];
              if (G32 && last_half)
                pad_scales<2 * NJ>(sa, wsl, WP, WB * BN,
                                   warp * 8 * NJ + 2 * NJ * t4, ssz);
              else
                scales_f<2 * NJ>(
                    sa, ssl + (warp * 8 * NJ + 2 * NJ * t4) * ssz, s_f32);
#pragma unroll
              for (int i = 0; i < MTG; ++i)
#pragma unroll
                for (int j = 0; j < NJ; ++j)
#pragma unroll
                  for (int e = 0; e < 4; ++e)
                    acc[mg * MTG + i][j][e] =
                        fmaf(part[i][j][e], sa[(e & 1) * NJ + j],
                             acc[mg * MTG + i][j][e]);
            };
#pragma unroll
            for (int kp = 0; kp < KSTEPS; ++kp) {
#pragma unroll
              for (int ps = 0; ps < PASSES; ++ps) {
                uint32_t v[4][NJ / 2];   // rows r0, r0 + 1, r0 + 8, r0 + 9
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                  const int r = 16 * kp + 2 * t4 + (q & 1) + 8 * (q >> 1);
                  const unsigned char* wq = wsl + r * WP + 2 * cb;
                  if constexpr (NJ == 4) {
                    const uint2 u = *reinterpret_cast<const uint2*>(wq);
                    v[q][0] = u.x;
                    v[q][1] = u.y;
                  } else {
                    v[q][0] = *reinterpret_cast<const uint32_t*>(wq);
                  }
                }
                uint32_t b[PP][NJ][2];   // plane ps * PP + u: 0 lo, 1 hi
#pragma unroll
                for (int u = 0; u < PP; ++u)
#pragma unroll
                  for (int j = 0; j < NJ; ++j) {
                    const int c = j >> 1, h = j & 1;
#pragma unroll
                    for (int f = 0; f < 2; ++f)
                      b[u][j][f] =
                          ps * PP + u == 0
                              ? exact_pair(lo16_f(v[2 * f][c], h),
                                           lo16_f(v[2 * f + 1][c], h))
                              : exact_pair(hi16_f(v[2 * f][c], h),
                                           hi16_f(v[2 * f + 1][c], h));
                  }
                for (int q = pipe_x_planes(MODE, x_f32) - 1; q >= 0; --q) {
                  const __nv_bfloat16* xq = xr + q * BMR * (PK_XB / 2);
                  uint32_t a[MTG][4];
#pragma unroll
                  for (int i = 0; i < MTG; ++i)
                    ldmatrix_x4(a[i],
                                xq + 16 * (mg * MTG + i) * xpe + 16 * kp);
#pragma unroll
                  for (int i = 0; i < MTG; ++i)
#pragma unroll
                    for (int j = 0; j < NJ; ++j)
#pragma unroll
                      for (int u = 0; u < PP; ++u)
                        mma_16816_sched(part[i][j], a[i], b[u][j]);
                }
              }
              if (G32 && kp == KSTEPS / 2 - 1) {
                // the first half's group ends: its partial scaled into
                // acc by the first scale row, then started again
                fold(false);
#pragma unroll
                for (int i = 0; i < MTG; ++i)
#pragma unroll
                  for (int j = 0; j < NJ; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
              }
            }
            fold(true);
          }
          continue;
        }
        float sa[2 * NJ];
        scales_f<2 * NJ>(
            sa, ssl + (p * BN + warp * 8 * NJ + 2 * NJ * t4) * ssz, s_f32);
        uint32_t b[KSTEPS][NJ][2];
        // the plane's B fragments, its nibble place a constant (PL)
        auto fragments = [&](auto pl) {
          constexpr int PL = decltype(pl)::value;
#pragma unroll
          for (int kp = 0; kp < KSTEPS; ++kp) {
            const int r0 = 16 * kp + 2 * t4;
            const uint32_t w0 = wbytes(r0), w1 = wbytes(r0 + 1);
            const uint32_t w8 = wbytes(r0 + 8), w9 = wbytes(r0 + 9);
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              if constexpr (P4) {      // a nibble is exact in bf16
                b[kp][j][0] = exact_pair(nib_f(w0, w0 >> 12, PL, j),
                                         nib_f(w1, w1 >> 12, PL, j));
                b[kp][j][1] = exact_pair(nib_f(w8, w8 >> 12, PL, j),
                                         nib_f(w9, w9 >> 12, PL, j));
              } else {
                b[kp][j][0] = exact_pair(byte_f(w0, j), byte_f(w1, j));
                b[kp][j][1] = exact_pair(byte_f(w8, j), byte_f(w9, j));
              }
            }
          }
        };
        if (P4 && p == 1)
          fragments(std::integral_constant<int, 1>{});
        else
          fragments(std::integral_constant<int, 0>{});
        const __nv_bfloat16* xr =
            xa + (lane & 15) * xpe + 32 * p + (lane >> 4) * 8;
        if constexpr (WIDE) {
          // every m-tile's partial at once: the planes' products against
          // the same B fragments, the smallest plane first (lo, mid, hi;
          // one plane on bf16 x), in MT x NJ chains (one m-tile's partial
          // at a time, as groupdot keeps them, read even on an H100).
          // G32: a partial a 32-row half (its k-steps 0-1, then 2-3), each
          // scaled by its own scale row
          constexpr int NH = G32 ? 2 : 1, KH = KSTEPS / NH;
#pragma unroll
          for (int hf = 0; hf < NH; ++hf) {
            float part[MT][NJ][4];
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
              for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
            for (int q = pipe_x_planes(MODE, x_f32) - 1; q >= 0; --q) {
              const __nv_bfloat16* xq = xr + q * BMR * (PK_XB / 2);
#pragma unroll
              for (int kp = hf * KH; kp < (hf + 1) * KH; ++kp) {
                uint32_t a[MT][4];
#pragma unroll
                for (int i = 0; i < MT; ++i)
                  ldmatrix_x4(a[i], xq + 16 * i * xpe + 16 * kp);
#pragma unroll
                for (int i = 0; i < MT; ++i)
#pragma unroll
                  for (int j = 0; j < NJ; ++j)
                    mma_16816_sched(part[i][j], a[i], b[kp][j]);
              }
            }
            if (hf == 1)                 // the second half's scale row
              pad_scales<2 * NJ>(sa, wsl, WP, WB * BN,
                                 warp * 8 * NJ + 2 * NJ * t4, ssz);
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
              for (int j = 0; j < NJ; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  acc[i][j][e] =
                      fmaf(part[i][j][e], sa[(e & 1) * NJ + j], acc[i][j][e]);
          }
          continue;
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          float part[NJ][4];
#pragma unroll
          for (int kp = 0; kp < KSTEPS; ++kp) {
            uint32_t a[4];
            ldmatrix_x4(a, xr + 16 * i * xpe + 16 * kp);
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              if (kp == 0) mma_16816_first(part[j], a, b[kp][j]);
              else mma_16816_sched(part[j], a, b[kp][j]);
            }
          }
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[i][j][e] =
                  fmaf(part[j][e], sa[(e & 1) * NJ + j], acc[i][j][e]);
        }
      }
      continue;
    }
    // the stage's scales of the lane's NJ columns, by plane (G32: by
    // half, the second from the W rows' pads; INT8 rounds them to bf16)
    float sf[P4 || G32 ? 2 : 1][NJ];
#pragma unroll
    for (int p = 0; p < NP; ++p)
      scales_f<NJ>(sf[p], ssl + (p * BN + cb) * ssz, s_f32);
    if constexpr (G32) pad_scales<NJ>(sf[1], wsl, WP, WB * BN, cb, ssz);
    __nv_bfloat162 sb[G32 ? 2 : 1][NJ];
    if constexpr (!P4) {
#pragma unroll
      for (int h = 0; h < (G32 ? 2 : 1); ++h)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          sb[h][j] = __floats2bfloat162_rn(sf[h][j], sf[h][j]);
    }
#pragma unroll
    for (int kp = 0; kp < KSTEPS; ++kp) {
      const int r0 = 16 * kp + 2 * t4;
      const uint32_t w0 = wbytes(r0), w1 = wbytes(r0 + 1);
      const uint32_t w8 = wbytes(r0 + 8), w9 = wbytes(r0 + 9);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        uint32_t b[NJ][2];
        if constexpr (P4) {
          const uint32_t h0 = w0 >> 12, h1 = w1 >> 12, h8 = w8 >> 12,
                         h9 = w9 >> 12;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            b[j][0] = round_pair(nib_f(w0, h0, p, j) * sf[p][j],
                                 nib_f(w1, h1, p, j) * sf[p][j]);
            b[j][1] = round_pair(nib_f(w8, h8, p, j) * sf[p][j],
                                 nib_f(w9, h9, p, j) * sf[p][j]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            // the half's scales: k-steps 0-1 the first row, 2-3 (G32) the
            // second
            const __nv_bfloat162 sh = sb[G32 && kp >= KSTEPS / 2][j];
            b[j][0] = bf16_mul2(exact_pair(byte_f(w0, j), byte_f(w1, j)), sh);
            b[j][1] = bf16_mul2(exact_pair(byte_f(w8, j), byte_f(w9, j)), sh);
          }
        }
        const __nv_bfloat16* xr =
            xa + (lane & 15) * xpe + 32 * p + 16 * kp + (lane >> 4) * 8;
        uint32_t a[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) ldmatrix_x4(a[i], xr + 16 * i * xpe);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NJ; ++j) mma_16816_sched(acc[i][j], a[i], b[j]);
      }
    }
  }

  // lane (g, t4) holds, per m-tile, rows g and g + 8 of its warp's
  // columns 2 NJ t4 .. 2 NJ t4 + 2 NJ - 1: tile j's elements 0/2 are
  // column 2 NJ t4 + j, elements 1/3 column 2 NJ t4 + NJ + j
  const int col = n0 + warp * 8 * NJ + 2 * NJ * t4;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * i + g + 8 * h;
      if (row >= T || col >= O) continue;
      float v[2 * NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        v[j] = acc[i][j][2 * h];
        v[NJ + j] = acc[i][j][2 * h + 1];
      }
      const size_t o = (size_t)row * O + col;
      if (partial != nullptr) {
        store_f32(partial + (size_t)blockIdx.y * T * O + o, v);
      } else if (x_f32) {
        if (resv != nullptr) add_f32(v, static_cast<const float*>(resv) + o);
        store_f32(static_cast<float*>(outv) + o, v);
      } else {
        if (resv != nullptr)
          add_bf16(v, static_cast<const __nv_bfloat16*>(resv) + o);
        store_bf16(static_cast<__nv_bfloat16*>(outv) + o, v);
      }
    }
}

#define QMM_PIPE_PARAMS                                                       \
  const void* __restrict__ xv, const int8_t* __restrict__ w,                  \
      const unsigned char* __restrict__ s, const float* __restrict__ gain,    \
      const void* __restrict__ resv, void* __restrict__ outv,                 \
      float* __restrict__ partial, int T, int I, int O, int gs,               \
      int k_per_split, int x_f32, int s_f32, float eps
#define QMM_PIPE_ARGS                                                         \
  xv, w, s, gain, resv, outv, partial, T, I, O, gs, k_per_split, x_f32,       \
      s_f32, eps

template <bool P4, int MT, int CG, int NJ>
__global__ void __launch_bounds__(CG * 32) qmm_pipe_kernel(QMM_PIPE_PARAMS) {
  qmm_pipe_body<P4, MT, CG, NJ, PM_STD>(QMM_PIPE_ARGS);
}

// The groupdot instantiation: its least blocks an SM, so that ptxas fits
// the B fragments and the partial into the registers of that many blocks
// (left free it interleaves the m-tiles' partials): 16 rows 6 blocks of
// 128 threads; 48 rows 3 (the standard mode holds 4); 64 rows 2, since 3
// spilled; 128 rows 2 of 256 threads, as the standard mode
__host__ __device__ constexpr int pipe_gd_min_blocks(int mt) {
  return mt == 1 ? 6 : mt == 3 ? 3 : 2;
}

template <bool P4, int MT, int CG, int NJ>
__global__ void __launch_bounds__(CG * 32, pipe_gd_min_blocks(MT))
    qmm_pipe_gd_kernel(QMM_PIPE_PARAMS) {
  qmm_pipe_body<P4, MT, CG, NJ, PM_GD>(QMM_PIPE_ARGS);
}

// The wide instantiation's least blocks an SM: as many as its shared
// memory leaves on f32 x (three x planes beside the ring: 16 rows 4
// blocks, 48 rows 3 on its two-stage ring, 64 rows 2, 128 rows 1), so
// that ptxas may give the partials the registers those blocks leave; at
// INT16 (WB = 2) the same but at 48 rows QMM_WIDE16_MIN_BLOCKS48
__host__ __device__ constexpr int pipe_wide_min_blocks(int mt, int wb) {
  return mt == 1   ? 4
         : mt == 8 ? 1
         : mt == 3 ? (wb == 2 ? QMM_WIDE16_MIN_BLOCKS48 : QMM_WIDE_MIN_BLOCKS48)
                   : 2;
}

// WB: bytes a weight (1 int8-held, 2 INT16)
template <int MT, int CG, int NJ, int WB>
__global__ void __launch_bounds__(CG * 32, pipe_wide_min_blocks(MT, WB))
    qmm_pipe_wide_kernel(QMM_PIPE_PARAMS) {
  qmm_pipe_body<false, MT, CG, NJ, WB == 2 ? PM_WIDE16 : PM_WIDE>(
      QMM_PIPE_ARGS);
}

// The G32 instantiations (a group size that is a multiple of 32 and not of
// 64, such as GGUF Q8_0's 32): the standard and the wide mode with a scale
// row a 32-row half of a stage, kernels of their own so that the gs-64
// instantiations keep their code
template <int MT, int CG, int NJ>
__global__ void __launch_bounds__(CG * 32)
    qmm_pipe_g32_kernel(QMM_PIPE_PARAMS) {
  qmm_pipe_body<false, MT, CG, NJ, PM_STD, true>(QMM_PIPE_ARGS);
}
// the G32 wide instantiation's least blocks an SM: the wide ones', but 2 at
// 48 rows, whose second fold a stage does not fit in the 168 registers of 3
// (ptxas spilled 32-72 bytes there on an H100 build; 222-238 registers at
// 2)
__host__ __device__ constexpr int pipe_wide_g32_min_blocks(int mt, int wb) {
  return mt == 3 ? 2 : pipe_wide_min_blocks(mt, wb);
}
template <int MT, int CG, int NJ, int WB>
__global__ void __launch_bounds__(CG * 32, pipe_wide_g32_min_blocks(MT, WB))
    qmm_pipe_wide_g32_kernel(QMM_PIPE_PARAMS) {
  qmm_pipe_body<false, MT, CG, NJ, WB == 2 ? PM_WIDE16 : PM_WIDE, true>(
      QMM_PIPE_ARGS);
}

// the __global__ function of the (standard, groupdot or wide; G32)
// instantiation
template <bool P4, int MT, int CG, int NJ, int MODE, bool G32 = false>
constexpr auto pipe_kernel() {
  if constexpr (G32 && MODE == PM_WIDE16)
    return qmm_pipe_wide_g32_kernel<MT, CG, NJ, 2>;
  else if constexpr (G32 && MODE == PM_WIDE)
    return qmm_pipe_wide_g32_kernel<MT, CG, NJ, 1>;
  else if constexpr (G32) return qmm_pipe_g32_kernel<MT, CG, NJ>;
  else if constexpr (MODE == PM_WIDE16) return qmm_pipe_wide_kernel<MT, CG, NJ, 2>;
  else if constexpr (MODE == PM_WIDE) return qmm_pipe_wide_kernel<MT, CG, NJ, 1>;
  else if constexpr (MODE == PM_GD) return qmm_pipe_gd_kernel<P4, MT, CG, NJ>;
  else return qmm_pipe_kernel<P4, MT, CG, NJ>;
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

// A pipelined block's dynamic shared memory: the ring, and the bf16 x
// planes (pipe_x_planes) when x is f32 or the norm prologue runs (conv)
template <bool P4, int MT, int CG, int NJ, int MODE, bool G32>
int pipe_smem(int x_f32, int s_f32, int conv) {
  return pipe_stages(MODE, MT) * pipe_stage_bytes(P4, s_f32 ? 4 : 2, MT,
                                                  8 * NJ * CG,
                                                  x_f32 ? 4 : 2,
                                                  pipe_wb(MODE)) +
         (conv ? pipe_x_planes(MODE, x_f32) * 16 * MT * PK_XB : 0);
}

// Lets the instantiation launch with smem bytes of dynamic shared memory.
template <bool P4, int MT, int CG, int NJ, int MODE, bool G32>
int pipe_allow_smem(int smem) {
  // the kernel's static arrays (rinv, wsum) share the block's budget
  const int stat = (int)sizeof(float) * 16 * MT * (1 + CG);
  if (smem + stat > PK_SMEM_BLOCK) return (int)cudaErrorInvalidValue;
  // this instantiation's dynamic smem limit, raised on its first launch:
  // without it the limit is 48 KB less the static arrays (a wide 16-row
  // block on f32 x asks for exactly 48 KB)
  static int allowed = 0;
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        pipe_kernel<P4, MT, CG, NJ, MODE, G32>(),
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) {
      cudaGetLastError();              // not left for the next launch
      return (int)e;
    }
    allowed = smem;
  }
  return 0;
}

// The blocks of the instantiation that one SM holds at once, by the
// runtime's occupancy count (registers, shared memory, threads).
template <bool P4, int MT, int CG, int NJ, int MODE, bool G32>
int pipe_resident_t(int x_f32, int s_f32, int conv, int* blocks) {
  const int smem = pipe_smem<P4, MT, CG, NJ, MODE, G32>(x_f32, s_f32, conv);
  const int e = pipe_allow_smem<P4, MT, CG, NJ, MODE, G32>(smem);
  if (e != 0) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, pipe_kernel<P4, MT, CG, NJ, MODE, G32>(), CG * 32, smem);
}

template <bool P4, int MT, int CG, int NJ, int MODE, bool G32>
int launch_pipe_t(const void* x, const int8_t* w, const void* s,
                  const float* gain, const void* res, float eps, void* out,
                  float* partial, int T, int I, int O, int gs, int splits,
                  int k_per_split, int x_f32, int s_f32, cudaStream_t st) {
  constexpr int BN = 8 * NJ * CG;
  const int smem = pipe_smem<P4, MT, CG, NJ, MODE, G32>(
      x_f32, s_f32, x_f32 || gain != nullptr);
  const int e = pipe_allow_smem<P4, MT, CG, NJ, MODE, G32>(smem);
  if (e != 0) return e;
  const dim3 grid((O + BN - 1) / BN, splits);
  // the residual is added once: by the reduce pass when K is split
  const auto kernel = pipe_kernel<P4, MT, CG, NJ, MODE, G32>();
  kernel<<<grid, CG * 32, smem, st>>>(
      x, w, static_cast<const unsigned char*>(s), gain,
      splits > 1 ? nullptr : res, out, splits > 1 ? partial : nullptr, T, I,
      O, gs, k_per_split, x_f32, s_f32, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t n = (size_t)T * O;
  const int blocks = (int)std::min<size_t>((n + 255) / 256, 4096);
  if (x_f32)
    splitk_reduce_kernel<float><<<blocks, 256, 0, st>>>(
        partial, static_cast<const float*>(res), static_cast<float*>(out), n,
        splits);
  else
    splitk_reduce_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        partial, static_cast<const __nv_bfloat16*>(res),
        static_cast<__nv_bfloat16*>(out), n, splits);
  return (int)cudaGetLastError();
}

// Calls F's template on the instantiation of (packed, rows, warps, mode,
// g32): row tiles of 16, 48, 64 or 128 rows, 4 warps of 4 n-tiles, or 8 of
// 2 at 128 rows, 128 output columns a block; the groupdot and wide modes
// have no 4-warp instantiation at 128 rows (pipe_shape gives them 8), the
// wide modes none on a packed weight, the G32 ones (g32) none on a packed
// weight or in the groupdot mode
#define QMM_PIPE_DISPATCH(F, ...)                                             \
  do {                                                                        \
    if (rows == 16 && warps == 4) QMM_PIPE_CALL(F, 1, 4, 4, __VA_ARGS__);     \
    if (rows == 48 && warps == 4) QMM_PIPE_CALL(F, 3, 4, 4, __VA_ARGS__);     \
    if (rows == 64 && warps == 4) QMM_PIPE_CALL(F, 4, 4, 4, __VA_ARGS__);     \
    if (rows == 128 && warps == 4 && mode == PM_STD)                          \
      QMM_PIPE_CALL_STD(F, 8, 4, 4, __VA_ARGS__);                             \
    if (rows == 128 && warps == 8) QMM_PIPE_CALL(F, 8, 8, 2, __VA_ARGS__);    \
    return (int)cudaErrorInvalidValue;                                        \
  } while (0)
#define QMM_PIPE_CALL(F, MT, CG, NJ, ...)                                     \
  do {                                                                        \
    if (g32 && (packed || mode == PM_GD)) return (int)cudaErrorInvalidValue;  \
    if (g32 && mode == PM_WIDE)                                               \
      return F<false, MT, CG, NJ, PM_WIDE, true>(__VA_ARGS__);                \
    if (g32 && mode == PM_WIDE16)                                             \
      return F<false, MT, CG, NJ, PM_WIDE16, true>(__VA_ARGS__);              \
    if (mode == PM_WIDE)                                                      \
      return packed ? (int)cudaErrorInvalidValue                              \
                    : F<false, MT, CG, NJ, PM_WIDE, false>(__VA_ARGS__);      \
    if (mode == PM_WIDE16)                                                    \
      return packed ? (int)cudaErrorInvalidValue                              \
                    : F<false, MT, CG, NJ, PM_WIDE16, false>(__VA_ARGS__);    \
    if (mode == PM_GD)                                                        \
      return packed ? F<true, MT, CG, NJ, PM_GD, false>(__VA_ARGS__)          \
                    : F<false, MT, CG, NJ, PM_GD, false>(__VA_ARGS__);        \
    QMM_PIPE_CALL_STD(F, MT, CG, NJ, __VA_ARGS__);                            \
  } while (0)
#define QMM_PIPE_CALL_STD(F, MT, CG, NJ, ...)                                 \
  do {                                                                        \
    if (g32)                                                                  \
      return packed ? (int)cudaErrorInvalidValue                              \
                    : F<false, MT, CG, NJ, PM_STD, true>(__VA_ARGS__);        \
    return packed ? F<true, MT, CG, NJ, PM_STD, false>(__VA_ARGS__)           \
                  : F<false, MT, CG, NJ, PM_STD, false>(__VA_ARGS__);         \
  } while (0)

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
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

// The pipelined mode (qmm_pipe_kernel): out (T, O) in x's dtype, T <= rows.
// rows x warps: 16, 48, 64 or 128 x 4, or 128 x 8 (a block's row tile and
// its warps over 128 output columns); k_per_split in W rows (K1p: packed
// rows), a multiple of 64 (K1p: 32); partial: splits*T*O f32 scratch when
// splits > 1.  x f32/bf16, scales f32/bf16, w int8 (packed: the (I/2, O)
// split-half bytes); rows 16-byte aligned (O % 16, I % 8, K1p I % 16; x,
// w, s and res at 16-byte aligned addresses) and gs % 64 == 0, or with
// the flag PM_G32 (4) gs % 32 == 0.  gain / res as qmm_launch's.  mode: 0
// standard; 1 the groupdot instantiation (no gain, no res; rows x warps
// 128 x 4 refused); 2 the wide one (f32 compute; not packed; rows x warps
// 128 x 4 refused); 3 the wide one on an int16 weight (w the (I, O) int16
// values; INT16 at any compute dtype; rows x warps 128 x 4 refused); 0, 2
// or 3 or'ed with PM_G32 their G32 instantiation (a scale row a 32-row
// half; not packed).
extern "C" int qmm_pipe_launch(const void* x, const void* w, const void* s,
                               const void* gain, const void* res, float eps,
                               void* out, void* partial, int T, int I, int O,
                               int gs, int splits, int k_per_split, int x_dt,
                               int s_dt, int packed, int rows, int warps,
                               int mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* wp = static_cast<const int8_t*>(w);
  const float* g = static_cast<const float*>(gain);
  float* part = static_cast<float*>(partial);
  const bool g32 = (mode & PM_G32) != 0;
  mode &= ~PM_G32;
  if (T < 1 || T > rows || gs < 32 || gs % (g32 ? 32 : 64) || O % 16 ||
      I % (packed ? 16 : 8) || (g32 && (packed || mode == PM_GD)) ||
      splits < 1 || k_per_split % (packed ? 32 : 64) || misaligned(x) ||
      misaligned(w) || misaligned(s) || misaligned(res) ||
      (x_dt != DT_F32 && x_dt != DT_BF16) ||
      (s_dt != DT_F32 && s_dt != DT_BF16) ||
      (mode != PM_STD && mode != PM_GD && !pipe_wide(mode)) ||
      (mode == PM_GD && (gain != nullptr || res != nullptr)) ||
      (pipe_wide(mode) && packed))
    return (int)cudaErrorInvalidValue;
  const int xf = x_dt == DT_F32, sf = s_dt == DT_F32;
  QMM_PIPE_DISPATCH(launch_pipe_t, x, wp, s, g, res, eps, out, part, T, I, O,
                    gs, splits, k_per_split, xf, sf, st);
}

// *blocks: how many blocks of the pipelined instantiation (packed, rows,
// warps, mode as qmm_pipe_launch's, PM_G32 too) for x_dt, s_dt and conv
// (f32 x or the norm prologue) one SM of the current device holds at once;
// the host's split rule reads it.
extern "C" int qmm_pipe_resident(int packed, int rows, int warps, int mode,
                                 int x_dt, int s_dt, int conv, int* blocks) {
  const bool g32 = (mode & PM_G32) != 0;
  mode &= ~PM_G32;
  if ((x_dt != DT_F32 && x_dt != DT_BF16) || (s_dt != DT_F32 && s_dt != DT_BF16))
    return (int)cudaErrorInvalidValue;
  QMM_PIPE_DISPATCH(pipe_resident_t, x_dt == DT_F32, s_dt == DT_F32, conv,
                    blocks);
}
