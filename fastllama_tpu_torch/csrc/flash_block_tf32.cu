// K2b, split-TF32 mode: the prefix cache's block-attend on Hopper's tensor
// cores for the calls its TC mode (flash_block_tc.cu: flash_block_tc_kernel,
// bf16 q over an int8 or bf16 cache) does not take: f32 q over any cache,
// bf16 q over an f32 cache (the default f32 KV cache of both packages at
// bf16 compute), and bf16 q over a bf16 or int8 cache at a head size off
// the multiple of 16.
//
// Replaces _flash_block_kernel / flash_block_attend
// (fastllama_tpu/ops/pallas/flash_decode.py:331, :426) for those calls, as
// flash_block_kernel (flash_decode.cu, the CUDA-core f32 mode) does for the
// rest (head sizes off the multiple of 8, misaligned views).  The function
// is flash_block_plain's (ops/kernels/flash_decode.py): T query rows of one
// slot over that slot's cache rows [0, start) of layer `layer` and the
// causal fresh block (query t sees fresh rows j <= t); one online softmax
// in f32; at an int8 cache the K row scale on the score and the V row scale
// on the probability before P.V; output acc / sum in q's dtype.
//
// What bounds it on an H100: operations.  At the 7B tail (32 heads of 128,
// start 256, T = 256) a call does 1.61 GFLOP over ≈ 17 MB: 0.024 ms at
// the f32 CUDA-core rate (67 TFLOP/s), 0.0065 ms for two TF32 passes at
// 495 TFLOP/s, against 0.005 ms of bytes (H100 SXM data-sheet rates).
// The CUDA-core mode ran 44-72x over its f32 bound: a warp a key row
// with 5-shuffle sums, the accumulator in shared memory, three barriers a
// tile.  This mode reads 0.0198 / 0.0447 ms at T = 32 / 256 for bf16 q
// over an f32 cache, against 0.1705 / 1.0900 for the CUDA-core mode (H100
// 80GB HBM3 at 700 W; PERF.md's kernel table), held by instruction
// throughput and latency: each row-group warp splits the f32 K/V
// elements it reads, and a warp's Q.K is a chain of 16 dependent mma's
// at hs 128.
//
// Precision: a TF32 operand keeps 10 mantissa bits, about three decimal
// digits, short of the f32 contract (1e-4 x max|ref|).  So an f32 operand
// x is split into big = cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big)
// (22 bits in all) and a product of two split operands is big.big +
// big.small + small.big on mma.sync.m16n8k8.tf32 with f32 accumulation
// (3xTF32); small.small, below 2^-20 of the product, is dropped.  An
// operand exact in TF32 takes no small part, so its products take 2
// passes: bf16 q, bf16 K/V and int8 K/V (exact as floats; the row scales
// are applied in f32 in the C layout, as in the TC mode).  P, the
// probabilities, is split for f32 q and rounded once to TF32 for bf16 q,
// whose output is bf16 (held to 1e-2 x max|ref|).  Passes a product:
//   q f32,  cache f32 : Q.K 3, P.V 3 (fresh block f32: 3, 3)
//   q f32,  cache int8 or bf16: Q.K 2, P.V 2 (fresh block f32: 3, 3)
//   q bf16, cache f32 : Q.K 2, P.V 2 (fresh block bf16: 1, 1)
//   q bf16, cache bf16 or int8 (hs % 16 != 0): 1, 1
//
// The design is the TC mode's skeleton:
//   * grid (kv head, query tile of TQ positions), 4 warps; R = hgs * TQ
//     <= 64 query rows a block (16 past hs 128, where O takes 128
//     registers a lane; row r = g * TQ + tt at position t0 + tt;
//     rows past T or R compute and are not written), as 4 / WK row groups
//     of 16 rows times WK = 1, 2 or 4 key groups, each key group with its
//     own running max, sum and O, merged through shared memory at the end;
//   * loops with constant bounds, templates on the head size padded to 64,
//     128 or 256 (dims past hs are zero in Q and K) and on the keys a warp
//     takes of each tile;
//   * K/V tiles of TK = 32 rows (cache rows, then the fresh block's)
//     staged raw by cp.async (16 bytes; 8 for int8 rows off 16 bytes),
//     TF_STAGES = 2 deep, with their row scales; rows past a tile's end
//     are zero-filled.  An f32 K+V row is 8 hs bytes, 4x an int8 row: at
//     hs 128 a 32-row stage is 35 KB, so two stages and the block's Q
//     (36 KB, f32) take 108 KB and two blocks share an SM; 64-row tiles
//     or a third stage leave one block an SM and were slower;
//   * Q staged once in shared memory as f32 and split as its A fragments
//     are read (kept in registers its big and small fragments would take
//     128 registers a lane at hs 128);
//   * S = Q.K^T and O += P.V on mma.sync.m16n8k8 (tf32 in, f32 out); up
//     to hs 128 the big.big products into one accumulator and the cross
//     terms into another for S, so that the passes are two chains;
//   * the k index of Q.K^T is permuted inside each 16-dim block (k-step
//     2b + s, slot t holds dim 16 b + 4 t + 2 s, slot t + 4 dim
//     16 b + 4 t + 2 s + 1), so one 16-byte load of a K row (8 bytes bf16,
//     4 int8) feeds two k-steps; the output dims of P.V inside each
//     32-dim block (n-tile dl, column n is dim 32 blk + 4 n + dl), so one
//     load of a V row feeds four n-tiles;
//   * the C->A mismatch of m16n8k8.tf32 (a lane holds columns 2t, 2t+1 of
//     S's C fragment, P.V's A fragment wants columns t, t+4) is met by the
//     key order of V's B fragment: slot t of a k-step is key 2t, slot t+4
//     key 2t + 1, so the C registers are P's A registers with no shuffle;
//   * scores scaled, masked (cache rows >= start; fresh rows above the
//     diagonal) and reduced over the lane quad in registers, O in
//     registers for the whole kernel; two barriers a tile; fresh tiles
//     wholly above a row group's last position are skipped.
// Shared-memory row strides: K rows HS + 16 elements, V rows HS +
// 16 / sizeof elements, Q rows HS + 16 floats, so that each fragment load
// of a quarter (16 bytes), half (8 bytes) or whole warp (4 bytes) hits
// distinct banks.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "split_rows.cuh"

namespace {

// Tuning macros (tools/block_tf32_design.py builds other values): K/V
// rows a tile up to hs 128 (32 past it, where two 64-row f32 stages do not
// fit); stages; Q.K's accumulator chains a cross-term kind (2: even and odd
// k-steps apart).  The defaults were the fastest (PERF.md's design calls
// of K2b's TF32 mode).
#ifndef FLASH_BLOCK_TF32_TK
#define FLASH_BLOCK_TF32_TK 32
#endif
#ifndef FLASH_BLOCK_TF32_STAGES
#define FLASH_BLOCK_TF32_STAGES 2
#endif
#ifndef FLASH_BLOCK_TF32_CHAINS
#define FLASH_BLOCK_TF32_CHAINS 1
#endif

constexpr int TF_THREADS = 128;
constexpr int TF_ROWS = 64;      // query rows a block: 4 warps x 16
constexpr int TF_ROWS_256 = 16;  // query rows a block at hs > 128
constexpr int TF_STAGES = FLASH_BLOCK_TF32_STAGES;  // K/V tiles in flight + 1
constexpr int TF_CHAINS = FLASH_BLOCK_TF32_CHAINS;
constexpr int TF_HS_MAX = 256;
// K/V rows a tile
template <int HS> __host__ __device__ constexpr int tf_tk() {
  return HS > 128 ? 32 : FLASH_BLOCK_TF32_TK;
}

// dtype codes shared with ops/kernels/flash_decode.py
enum { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2 };

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small, both TF32 (round to nearest, ties away from zero)
__device__ __forceinline__ void tf32_split(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d += a (16x8, row major) * b (8x8, column major), tf32 in, f32 out
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(src_bytes));
}

// Four consecutive elements of a row of TT (shared or global memory) as
// f32; SPLIT: f32 values need a small part, the others are exact in TF32
template <typename TT> struct Tf32Row;
template <> struct Tf32Row<float> {
  static constexpr bool SPLIT = true;
  __device__ static float4 ld4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
};
template <> struct Tf32Row<__nv_bfloat16> {
  static constexpr bool SPLIT = false;
  __device__ static float4 ld4(const __nv_bfloat16* p) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    return make_float4(bf_lo(w.x), bf_hi(w.x), bf_lo(w.y), bf_hi(w.y));
  }
};
template <> struct Tf32Row<int8_t> {
  static constexpr bool SPLIT = false;
  __device__ static float4 ld4(const int8_t* p) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
    return make_float4(i8_magic(w, 0), i8_magic(w, 1), i8_magic(w, 2),
                       i8_magic(w, 3));
  }
};

// bytes of a K and a V row of TT in a stage
template <typename TT, int HS> __host__ __device__ constexpr int tf_kbytes() {
  return (HS + 16) * (int)sizeof(TT);
}
template <typename TT, int HS> __host__ __device__ constexpr int tf_vbytes() {
  return HS * (int)sizeof(TT) + 16;
}
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
// a stage holds the cache's rows (CT) or the fresh block's (QT)
template <typename QT, typename CT, int HS>
__host__ __device__ constexpr int tf_koff() {
  return tf_tk<HS>() * cmax(tf_kbytes<QT, HS>(), tf_kbytes<CT, HS>());
}
template <typename QT, typename CT, int HS>
__host__ __device__ constexpr int tf_stage_bytes() {
  return tf_koff<QT, CT, HS>() +
         tf_tk<HS>() * cmax(tf_vbytes<QT, HS>(), tf_vbytes<CT, HS>());
}

// Rows [0, n) of a tile of TT (row stride hs) into a stage's K and V rows,
// zero-filled past n and past hs up to HS.  Rows of hs int8 bytes that are
// not a multiple of 16 bytes are copied 8 bytes at a time.
template <typename TT, int HS>
__device__ __forceinline__ void tf32_copy_rows(unsigned char* kd,
                                               unsigned char* vd,
                                               const TT* ksrc, const TT* vsrc,
                                               int n, int hs, int tid) {
  constexpr int KB = tf_kbytes<TT, HS>(), VB = tf_vbytes<TT, HS>();
  constexpr int TK = tf_tk<HS>();
  const int rb = hs * (int)sizeof(TT);
  const unsigned char* k8 = reinterpret_cast<const unsigned char*>(ksrc);
  const unsigned char* v8 = reinterpret_cast<const unsigned char*>(vsrc);
  if (sizeof(TT) == 1 && (rb & 15) != 0) {
    constexpr int CPR = HS / 8;
    for (int c = tid; c < TK * CPR; c += TF_THREADS) {
      const int r = c / CPR, off = (c % CPR) * 8;
      const bool in = r < n && off < rb;
      const size_t so = in ? (size_t)r * rb + off : 0;
      cp_async8(kd + r * KB + off, k8 + so, in ? 8 : 0);
      cp_async8(vd + r * VB + off, v8 + so, in ? 8 : 0);
    }
  } else {
    constexpr int CPR = HS * (int)sizeof(TT) / 16;
    for (int c = tid; c < TK * CPR; c += TF_THREADS) {
      const int r = c / CPR, off = (c % CPR) * 16;
      const bool in = r < n && off < rb;
      const size_t so = in ? (size_t)r * rb + off : 0;
      cp_async16(kd + r * KB + off, k8 + so, in ? 16 : 0);
      cp_async16(vd + r * VB + off, v8 + so, in ? 16 : 0);
    }
  }
}

// One tile for a warp's 16 query rows (lane: rows g and g + 8, columns
// 2 t4 and 2 t4 + 1 of each 8-key C tile) over its 8 NTK keys of it.  qw:
// the row group's Q rows (f32, stride HS + 16); kb/vb: the warp's first
// key row of TT; ksb/vsb: their row scales or null; keys j < n are in the
// tile; causal: key j0 + j is seen by a row at position tpos only if
// j0 + j <= tpos.  QS: q is f32 (Q and P split).
template <typename TT, bool QS, int HS, int NTK>
__device__ __forceinline__ void tf32_tile(
    float (&o)[HS / 8][4], float (&m)[2], float (&l)[2], const float* qw,
    const TT* kb, const TT* vb, const float* ksb, const float* vsb, int n,
    bool causal, int j0, const int (&tpos)[2], float scale, int g, int t4) {
  constexpr int KSTR = HS + 16;
  constexpr int VSTR = HS + 16 / (int)sizeof(TT);
  constexpr int QSTR = HS + 16;
  constexpr bool KS = Tf32Row<TT>::SPLIT;
  // the cross terms in chains of their own (past hs 128, where O takes
  // 128 registers, in the big.big chains); TF_CHAINS: even and odd k-steps
  // apart
  constexpr bool LO = (KS || QS) && HS <= 128;
  constexpr int NC = TF_CHAINS;
  float s[NC][NTK][4], sl[LO ? NC : 1][NTK][4];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[c][nt][e] = 0.0f;
        sl[LO ? c : 0][nt][e] = 0.0f;
      }
#pragma unroll
  for (int b = 0; b < HS / 16; ++b) {
    const float4 qa = *reinterpret_cast<const float4*>(qw + g * QSTR +
                                                       16 * b + 4 * t4);
    const float4 qb = *reinterpret_cast<const float4*>(
        qw + (g + 8) * QSTR + 16 * b + 4 * t4);
    const float qv[2][4] = {{qa.x, qb.x, qa.y, qb.y},
                            {qa.z, qb.z, qa.w, qb.w}};
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int st = 0; st < 2; ++st)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (QS)
          tf32_split(qv[st][e], ah[st][e], al[st][e]);
        else
          ah[st][e] = __float_as_uint(qv[st][e]);
      }
#pragma unroll
    for (int nt = 0; nt < NTK; ++nt) {
      const float4 kv =
          Tf32Row<TT>::ld4(kb + (nt * 8 + g) * KSTR + 16 * b + 4 * t4);
      const float kx[2][2] = {{kv.x, kv.y}, {kv.z, kv.w}};
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        uint32_t kh[2], kl[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if constexpr (KS)
            tf32_split(kx[st][e], kh[e], kl[e]);
          else
            kh[e] = __float_as_uint(kx[st][e]);
        }
        float(&hi)[4] = s[st % NC][nt];
        float(&lo)[4] = LO ? sl[LO ? st % NC : 0][nt] : s[st % NC][nt];
        mma_tf32(hi, ah[st], kh[0], kh[1]);
        if constexpr (KS) mma_tf32(lo, ah[st], kl[0], kl[1]);
        if constexpr (QS) mma_tf32(lo, al[st], kh[0], kh[1]);
      }
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
      if constexpr (LO) v += sl[0][nt][e];
      if constexpr (NC == 2) {
        v += s[1][nt][e];
        if constexpr (LO) v += sl[1][nt][e];
      }
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
#pragma unroll
  for (int d = 0; d < HS / 8; ++d) {
    o[d][0] *= corr[0];
    o[d][1] *= corr[0];
    o[d][2] *= corr[1];
    o[d][3] *= corr[1];
  }
  // e in f32 for the sum; e * v_scale as P's A fragment of k-step kk = nt:
  // slot t4 is key 2 t4 (C registers 0 and 2), slot t4 + 4 key 2 t4 + 1
  // (registers 1 and 3), matching V's B fragment below
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int kk = 0; kk < NTK; ++kk) {
    float e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      e[i] = __expf(s[0][kk][i] - mu[i >> 1]);
      sum[i >> 1] += e[i];
    }
    if (vsb != nullptr) {
      const float2 w = *reinterpret_cast<const float2*>(vsb + kk * 8 + 2 * t4);
      e[0] *= w.x;
      e[1] *= w.y;
      e[2] *= w.x;
      e[3] *= w.y;
    }
    const float pv[4] = {e[0], e[2], e[1], e[3]};
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (QS)
        tf32_split(pv[i], ph[i], pl[i]);
      else
        ph[i] = tf32_rna(pv[i]);
    }
    // lane g reads dims 4 g .. 4 g + 3 of each 32-dim block of keys 2 t4
    // and 2 t4 + 1: b0 and b1 of the block's 4 n-tiles
    const TT* vr = vb + (kk * 8 + 2 * t4) * VSTR + 4 * g;
#pragma unroll
    for (int blk = 0; blk < HS / 32; ++blk) {
      const float4 v0 = Tf32Row<TT>::ld4(vr + blk * 32);
      const float4 v1 = Tf32Row<TT>::ld4(vr + VSTR + blk * 32);
      const float x0[4] = {v0.x, v0.y, v0.z, v0.w};
      const float x1[4] = {v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int dl = 0; dl < 4; ++dl) {
        uint32_t h0, h1, l0, l1;
        if constexpr (KS) {
          tf32_split(x0[dl], h0, l0);
          tf32_split(x1[dl], h1, l1);
        } else {
          h0 = __float_as_uint(x0[dl]);
          h1 = __float_as_uint(x1[dl]);
        }
        mma_tf32(o[4 * blk + dl], ph, h0, h1);
        if constexpr (KS) mma_tf32(o[4 * blk + dl], ph, l0, l1);
        if constexpr (QS) mma_tf32(o[4 * blk + dl], pl, h0, h1);
      }
    }
  }
  // lane-partial sums: corr is the quad's, so the quad sum is taken once
  // at the end
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) l[hr] = l[hr] * corr[hr] + sum[hr];
}

template <typename QT, typename CT, int HS, int WK>
__global__ void __launch_bounds__(TF_THREADS, 1)
flash_block_tf32_kernel(const QT* __restrict__ q,       // (n_kv, hgs, T, hs)
                        const CT* __restrict__ kc,      // (L, Bc, n_kv, S, hs)
                        const CT* __restrict__ vc,
                        const float* __restrict__ ks,   // (L, Bc, n_kv, S) or null
                        const float* __restrict__ vs,
                        const QT* __restrict__ k_new,   // (n_kv, T, hs)
                        const QT* __restrict__ v_new,
                        QT* __restrict__ out,           // (n_kv, hgs, T, hs)
                        int layer, int slot, int start, int Bc, int n_kv,
                        int S, int hs, int T, int hgs, int TQ, float scale) {
  constexpr bool QS = std::is_same<QT, float>::value;
  // warps: WR row groups of 16 rows x WK key groups of KW = 8 NTK keys
  constexpr int TK = tf_tk<HS>();
  constexpr int NTK = TK / 8 / WK, WR = 4 / WK, KW = 8 * NTK;
  constexpr int QSTR = HS + 16;
  constexpr int SBYTES = tf_stage_bytes<QT, CT, HS>();
  constexpr int KOFF = tf_koff<QT, CT, HS>();
  extern __shared__ __align__(16) unsigned char smem_tf[];
  // TF_STAGES stages of K and V rows, their scales, then Q rows (f32)
  unsigned char* kv = smem_tf;
  float* scl = reinterpret_cast<float*>(kv + (size_t)TF_STAGES * SBYTES);
  float* qs = scl + TF_STAGES * 2 * TK;
  const int R = hgs * TQ;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr = warp % WR, wk = warp / WR;
  const int h = blockIdx.x;
  const int t0 = blockIdx.y * TQ;
  const int t_end = min(t0 + TQ, T);               // positions [t0, t_end)
  const int p = min(max(start, 0), S);             // cache rows [0, p)
  const size_t row0 = ((size_t)(layer * Bc + slot) * n_kv + h) * S;
  const size_t foff = (size_t)h * T * hs;
  const int nc = (p + TK - 1) / TK;          // cache tiles
  const int ntiles = nc + (t_end + TK - 1) / TK;

  // tile i into stage i % TF_STAGES: cache rows [TK i, ...) of CT, then
  // the fresh block's rows [TK (i - nc), ...) of QT; the missing rows'
  // scales zero-filled
  auto load_tile = [&](int i) {
    unsigned char* kb = kv + (size_t)(i % TF_STAGES) * SBYTES;
    unsigned char* vb = kb + KOFF;
    float* ksb = scl + (i % TF_STAGES) * 2 * TK;
    if (i < nc) {
      const int r0 = i * TK, n = min(TK, p - r0);
      tf32_copy_rows<CT, HS>(kb, vb, kc + (row0 + r0) * hs,
                             vc + (row0 + r0) * hs, n, hs, tid);
      if (ks != nullptr)
        for (int r = tid; r < TK; r += TF_THREADS) {
          const size_t at = row0 + r0 + (r < n ? r : 0);
          cp_async4(ksb + r, ks + at, r < n ? 4 : 0);
          cp_async4(ksb + TK + r, vs + at, r < n ? 4 : 0);
        }
    } else {
      const int j0 = (i - nc) * TK, n = min(TK, t_end - j0);
      tf32_copy_rows<QT, HS>(kb, vb, k_new + foff + (size_t)j0 * hs,
                             v_new + foff + (size_t)j0 * hs, n, hs, tid);
    }
    cp_async_commit();
  };
  for (int i = 0; i < TF_STAGES - 1; ++i) {
    if (i < ntiles)
      load_tile(i);
    else
      cp_async_commit();
  }

  // Q rows as f32 into shared memory, zero past T, R and hs
  for (int i = tid; i < 16 * WR * (HS / 4); i += TF_THREADS) {
    const int r = i / (HS / 4), c = i % (HS / 4);
    const int t = t0 + r % TQ;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < R && t < T && c * 4 < hs)
      v = Tf32Row<QT>::ld4(q + (((size_t)h * hgs + r / TQ) * T + t) * hs +
                           c * 4);
    *reinterpret_cast<float4*>(qs + r * QSTR + c * 4) = v;
  }

  // the lane's two rows and the row group's last real position (-1: none)
  int tpos[2], wmax = -1;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) tpos[hr] = t0 + (wr * 16 + g + 8 * hr) % TQ;
  for (int r = wr * 16; r < min(wr * 16 + 16, R); ++r)
    if (t0 + r % TQ < T) wmax = max(wmax, t0 + r % TQ);

  const float* qw = qs + wr * 16 * QSTR;
  float o[HS / 8][4];
#pragma unroll
  for (int d = 0; d < HS / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

  const int k0 = wk * KW;                          // the warp's first key
  for (int i = 0; i < ntiles; ++i) {
    if (i + TF_STAGES - 1 < ntiles)
      load_tile(i + TF_STAGES - 1);
    else
      cp_async_commit();
    cp_async_wait<TF_STAGES - 1>();
    __syncthreads();
    const unsigned char* kb = kv + (size_t)(i % TF_STAGES) * SBYTES;
    const unsigned char* vb = kb + KOFF;
    const float* ksb = scl + (i % TF_STAGES) * 2 * TK + k0;
    if (i < nc) {
      constexpr int CK = HS + 16, CV = HS + 16 / (int)sizeof(CT);
      const int n = min(TK, p - i * TK) - k0;
      if (wmax >= 0 && n > 0)
        tf32_tile<CT, QS, HS, NTK>(
            o, m, l, qw, reinterpret_cast<const CT*>(kb) + k0 * CK,
            reinterpret_cast<const CT*>(vb) + k0 * CV,
            ks != nullptr ? ksb : nullptr,
            ks != nullptr ? ksb + TK : nullptr, n, false, 0, tpos, scale,
            g, t4);
    } else {
      constexpr int FK = HS + 16, FV = HS + 16 / (int)sizeof(QT);
      const int j0 = (i - nc) * TK + k0;
      const int n = min(TK, t_end - (i - nc) * TK) - k0;
      if (wmax >= j0 && n > 0)
        tf32_tile<QT, QS, HS, NTK>(
            o, m, l, qw, reinterpret_cast<const QT*>(kb) + k0 * FK,
            reinterpret_cast<const QT*>(vb) + k0 * FV, nullptr, nullptr, n,
            true, j0, tpos, scale, g, t4);
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
    QT* orow = out + (((size_t)h * hgs + r / TQ) * T + tpos[hr]) * hs;
    const float inv = 1.0f / l[hr];
#pragma unroll
    for (int blk = 0; blk < HS / 32; ++blk) {
      if (blk * 32 + 8 * t4 >= hs) continue;
      float v[8];
#pragma unroll
      for (int dl = 0; dl < 4; ++dl) {
        v[dl] = o[4 * blk + dl][2 * hr] * inv;
        v[4 + dl] = o[4 * blk + dl][2 * hr + 1] * inv;
      }
      QT* dst = orow + blk * 32 + 8 * t4;
      if constexpr (QS) {
        reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
        uint4 w;
        uint32_t* wp = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const __nv_bfloat162 b2 = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
          wp[i] = *reinterpret_cast<const uint32_t*>(&b2);
        }
        *reinterpret_cast<uint4*>(dst) = w;
      }
    }
  }
}

template <typename QT, typename CT, int HS, int WK>
int launch_tf32_h(const void* q, const void* kc, const void* vc,
                  const float* ks, const float* vs, const void* kn,
                  const void* vn, void* out, int layer, int slot, int start,
                  int Bc, int n_kv, int S, int hs, int T, int hgs, int TQ,
                  float scale, cudaStream_t st) {
  // the stages and their scales, then Q rows; the key groups' merge
  // reuses them at the end
  constexpr int WR = 4 / WK;
  const size_t main = (size_t)TF_STAGES * tf_stage_bytes<QT, CT, HS>() +
                      (size_t)TF_STAGES * 2 * tf_tk<HS>() * 4 +
                      (size_t)16 * WR * (HS + 16) * 4;
  const size_t merge = (size_t)4 * (HS / 2 + 4) * 32 * 4;
  const size_t smem = main > merge ? main : merge;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_block_tf32_kernel<QT, CT, HS, WK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(n_kv, (T + TQ - 1) / TQ);
  flash_block_tf32_kernel<QT, CT, HS, WK><<<grid, TF_THREADS, smem, st>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(kc),
      static_cast<const CT*>(vc), ks, vs, static_cast<const QT*>(kn),
      static_cast<const QT*>(vn), static_cast<QT*>(out), layer, slot, start,
      Bc, n_kv, S, hs, T, hgs, TQ, scale);
  return (int)cudaGetLastError();
}

// the padded head size (64, 128, 256) and the key groups a tile is split
// into: none for 64 or 48 rows a block (4 row groups), 2 for 32 rows, 4
// for 16; at most 16 rows past hs 128
template <typename QT, typename CT>
int launch_tf32(const void* q, const void* kc, const void* vc,
                const float* ks, const float* vs, const void* kn,
                const void* vn, void* out, int layer, int slot, int start,
                int Bc, int n_kv, int S, int hs, int T, int hgs, int TQ,
                float scale, cudaStream_t st) {
  const int wr = (hgs * TQ + 15) / 16;             // 16-row groups
#define TF_LAUNCH(HS, WK)                                                   \
  return launch_tf32_h<QT, CT, HS, WK>(q, kc, vc, ks, vs, kn, vn, out,      \
                                        layer, slot, start, Bc, n_kv, S, hs, \
                                        T, hgs, TQ, scale, st)
#define TF_LAUNCH_HS(HS)   \
  {                        \
    if (wr == 1) TF_LAUNCH(HS, 4); \
    if (wr == 2) TF_LAUNCH(HS, 2); \
    TF_LAUNCH(HS, 1);      \
  }
  if (hs <= 64) TF_LAUNCH_HS(64)
  if (hs <= 128) TF_LAUNCH_HS(128)
  if (wr > 1) return (int)cudaErrorInvalidValue;   // registers: <= 16 rows
  TF_LAUNCH(256, 4);
#undef TF_LAUNCH_HS
#undef TF_LAUNCH
}

template <typename QT>
int launch_tf32_q(const void* q, const void* kc, const void* vc,
                  const float* ks, const float* vs, const void* kn,
                  const void* vn, void* out, int layer, int slot, int start,
                  int Bc, int n_kv, int S, int hs, int T, int hgs, int TQ,
                  float scale, int c_dt, cudaStream_t st) {
  switch (c_dt) {
    case DT_F32:
      return launch_tf32<QT, float>(q, kc, vc, ks, vs, kn, vn, out, layer,
                                    slot, start, Bc, n_kv, S, hs, T, hgs, TQ,
                                    scale, st);
    case DT_BF16:
      return launch_tf32<QT, __nv_bfloat16>(q, kc, vc, ks, vs, kn, vn, out,
                                            layer, slot, start, Bc, n_kv, S,
                                            hs, T, hgs, TQ, scale, st);
    case DT_I8:
      return launch_tf32<QT, int8_t>(q, kc, vc, ks, vs, kn, vn, out, layer,
                                     slot, start, Bc, n_kv, S, hs, T, hgs,
                                     TQ, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K2b, split-TF32 mode.  q, the fresh block and out f32 or bf16 (q_dt);
// an f32, bf16 or int8 (with row scales) cache (c_dt); hs a multiple of 8
// up to 256; TQ query positions a block, hgs * TQ <= 64 (16 past hs
// 128); every tensor
// pointer 16-byte aligned; otherwise as flash_block_launch
// (flash_decode.cu).
extern "C" int flash_block_tf32_launch(const void* q, const void* kc,
                                       const void* vc, const void* ks,
                                       const void* vs, const void* k_new,
                                       const void* v_new, void* out,
                                       int layer, int slot, int start,
                                       int Bc, int n_kv, int S, int hs,
                                       int T, int hgs, int TQ, float scale,
                                       int q_dt, int c_dt, void* stream) {
  const uintptr_t align = (uintptr_t)q | (uintptr_t)kc | (uintptr_t)vc |
                          (uintptr_t)k_new | (uintptr_t)v_new |
                          (uintptr_t)out;
  if (hs < 8 || hs % 8 != 0 || hs > TF_HS_MAX || T < 1 || TQ < 1 ||
      hgs < 1 || hgs * TQ > (hs > 128 ? TF_ROWS_256 : TF_ROWS) ||
      start < 0 || start > S || slot < 0 ||
      slot >= Bc || (ks == nullptr) != (vs == nullptr) ||
      (ks != nullptr) != (c_dt == DT_I8) || (align & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ksp = static_cast<const float*>(ks);
  const float* vsp = static_cast<const float*>(vs);
  if (q_dt == DT_F32)
    return launch_tf32_q<float>(q, kc, vc, ksp, vsp, k_new, v_new, out,
                                layer, slot, start, Bc, n_kv, S, hs, T, hgs,
                                TQ, scale, c_dt, st);
  if (q_dt == DT_BF16)
    return launch_tf32_q<__nv_bfloat16>(q, kc, vc, ksp, vsp, k_new, v_new,
                                        out, layer, slot, start, Bc, n_kv, S,
                                        hs, T, hgs, TQ, scale, c_dt, st);
  return (int)cudaErrorInvalidValue;
}
