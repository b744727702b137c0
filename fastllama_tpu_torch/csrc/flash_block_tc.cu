// K2b in its tensor-core mode: flash_block_tc_kernel, bf16 q over an int8
// or bf16 cache (the prefix cache's serving path).  The f32 (CUDA-core)
// mode, flash_block_kernel, is in flash_decode.cu, the split-TF32 mode in
// flash_block_tf32.cu.  Split from flash_decode.cu so that it builds in its
// own nvcc.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "split_rows.cuh"

namespace {

constexpr int HS_MAX = 256;   // head size limit

// K2b, TC mode: the same function on tensor cores, for bf16 q (and fresh
// block) over an int8 (row-scaled) or bf16 cache, hs % 16 == 0 (hs <= 128,
// or hgs <= 32 up to 256): the prefix cache's serving path.  Every other
// call (f32 q, an f32 cache, other head sizes) takes flash_block_kernel
// (flash_decode.cu), the f32 mode.  Replaces _flash_block_kernel / flash_block_attend
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
