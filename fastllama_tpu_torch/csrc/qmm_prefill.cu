// K1, K1f and K1p prefill mode: out (T, O) = x (T, I) @ dequant(W) for
// T > 128 rows, on Hopper's TMA, mbarriers and wgmma.
//
// Replaces the calls of more than 128 rows of the Pallas kernels of
// fastllama_tpu/ops/pallas/qmm.py: qmatmul_pallas (:313, _qmm_kernel), its
// layer-indexed form (:685, _qmm_kernel_idx), the fused glue form (:656,
// _qmm_kernel_idx_fused) and the packed INT4 kernels (:271 _qmm_kernel_p4,
// :601 _qmm_kernel_p4_idx).  These are the batched engines' prefill waves
// (up to 2048 rows), the prefix cache's whole prefills and K1f's glue on a
// single-stream block of more than 128 tokens.  It takes every such call
// that is not wide (bf16 compute, or a packed weight at any compute dtype)
// with gs a multiple of 64 (an unpacked weight: of 32, with I % 64 == 0;
// below gs % 64 its G32 kernel, qmm_wgmma_g32_kernel) and 16-byte aligned
// rows and residual; the loop (qmm_bf16_kernel in qmm.cu) keeps the rest.
// Its wide mode (qmm_wgmma_wide_kernel, below the design notes) takes the
// wide calls of that kind (f32 compute, or an INT16 weight); qmm_f32_kernel
// keeps the other wide calls.
//
// It computes what the loop computes (qmm_fused_plain / qmm_p4_plain in
// ops/kernels/qmm.py); only the f32 sum order differs:
//   * INT8: each weight bf16(bf16(w) * bf16(s)), one rounding of the exact
//     product; x rounded to bf16; f32 sums;
//   * K1p: split-half nibbles (byte row r holds K row r low, r + I/2 high),
//     each bf16(f32(nibble) * f32(s)), x rounded to bf16 at any compute
//     dtype, the residual always added;
//   * K1f: xn = to_x_dtype(x * rsqrt(mean(x^2) + eps) * gain) in f32, one
//     rounding, then bf16 for the tensor cores; out = to_x_dtype(residual +
//     xn @ W), one rounding at the end.
//
// What bounds it on an H100: a prefill wave is bound by tensor-core
// operations (a 7B layer at T = 2048 is 829 GFLOP against 0.2 GB of weights
// and 16 MB of x: 0.838 ms at 989 TFLOP/s, 0.07 ms of bytes); operations
// bind from about T = 190 rows at INT8 and 110 at INT4, bytes below.
//
// Design.  The product is computed transposed, out^T = W^T x^T, so that the
// dequantized weight is wgmma's A operand held in registers: a thread
// dequantizes straight from the raw int8 stage into its A fragments, with no
// bf16 copy of the weight written to and read back from shared memory, no
// proxy fence and no barrier between the dequant and the MMA.  x is the B
// operand, read by wgmma from shared memory where TMA put it.
//   * A block computes 128 output columns x 256 rows of x: two consumer
//     warpgroups of 64 columns (one m64 tile) each against the same x tile
//     (wgmma m64n256k16, 128 f32 accumulators a thread), and a producer
//     warpgroup whose first thread issues the copies.  Against 128 rows
//     (two m64 tiles a warpgroup, the same accumulators) the 256-row tile
//     dequantizes each weight half as often a flop, and read 12-15 %
//     faster on an H100 (PERF.md).  The producer gives its registers to
//     the consumers (setmaxnreg 40 and 232): at the 168 registers that
//     384 threads get at launch, ptxas
//     serializes every wgmma (each waits for the one before, its A
//     fragments' registers being reused; PF_SETMAXNREG 0, PERF.md).
//   * A stage is 64 logical K rows: the raw weight (a TMA box of 128
//     columns, 64 int8 rows or K1p's 32 packed rows, 128-byte swizzle), x as
//     two planes of 256 rows x 32 columns (two TMA boxes, 64-byte swizzle:
//     K1 columns k0 and k0 + 32, K1p k0 and I/2 + k0, matching the nibble
//     planes) and the stage's scale row(s) (a TMA box of 128, one a plane
//     for K1p; gs % 64 == 0 puts each plane in one group; the G32 kernel
//     takes one a 32-row part, (k0 + 32) / gs the second, and part 1's
//     FFMA offset comes from it).  pf_stages
//     stages ring in dynamic shared memory; each completes on a full
//     barrier with expect_tx (a box that runs off T or O still counts its
//     bytes: TMA zero-fills it), and the eight consumer warps release it on
//     an empty barrier.
//   * A thread's A rows are chosen so that one ldmatrix gives its weight
//     bytes: the .trans form of four 8 x 8 b16 matrices over a part's 32 W
//     rows and the warp's 16 columns hands lane (g, t4) rows 2 t4 and
//     2 t4 + 1 (and + 8, + 16, + 24) of the byte pair at columns 2 g,
//     which become logical rows g and g + 8 of its m64 tile (the 128-byte
//     swizzle keeps each matrix's rows on distinct banks).  Each byte, its
//     sign bit flipped, becomes the exact float 2^23 + b + 128 by one
//     PRMT, and one FFMA with
//     the offset -(2^23 + 128) * bf16(s) (exact in f32 for a bf16 s) gives
//     the exact product b * bf16(s), rounded to bf16 once with its pair
//     (the same column, the next K row).  K1p: each nibble an exact float
//     by a magic-exponent LOP3 and an FADD, times the f32 scale in f32,
//     the pair rounded once.  The epilogue writes a thread's two
//     neighbouring columns of a row of x as one 4- (bf16) or 8-byte (f32)
//     store.
//   * A stage is multiplied in two parts (a plane each), 2 wgmma a part on
//     A fragments of its own: one part's MMAs are in flight while the next
//     part is dequantized, and wait_group 1 after each commit retires the
//     part before (then the stage before is released).  With the fragments
//     fenced and 232 registers, ptxas keeps the wgmma asynchronous.
//   * A pre-pass kernel writes x as bf16 once a call (the K1f norm in f32
//     with one rounding to x's dtype, or f32 x rounded) into scratch that
//     the wrapper allocates; TMA reads that.  bf16 x without the norm is
//     read in place.
//   * When the output tiles are fewer than the SMs (T = 256 on the narrow
//     projections) K is split across blocks by the host's plan, and
//     prefill_reduce_kernel sums the f32 partials in split order after the
//     residual (deterministic).
//
// The wide mode (qmm_wgmma_wide_kernel) takes every wide call (f32
// compute, or INT16 at any compute dtype) above 128 rows with gs % 32 == 0
// (I % 64 == 0; below gs % 64 its G32 kernel, qmm_wgmma_wide_g32_kernel)
// and 16-byte aligned rows and residual: the batched prefill waves at f32
// compute or INT16 and K1f's glue on a single-stream block of more than 128
// tokens there.  It computes the JAX wide kernel's
// function (f32 dequant and a Precision.HIGHEST dot, qmm.py:62-74) as the
// wide ring of qmm.cu does: the A operand holds the exact integers (no
// scale), x goes in as three bf16 planes, hi = bf16(v), mid = bf16(v - hi),
// lo = bf16(v - hi - mid), whose products (lo, mid, hi) go into one f32
// partial a group, folded into the accumulators times the group's f32 (or
// bf16) scale once the group ends; a bf16 x is exact in one plane, one
// pass.  K1f: xn = to_x_dtype(x * rsqrt(mean(x^2) + eps) * gain) in f32,
// then the planes; the residual added once at the end; split-K partials
// summed in split order after it.  Its bound is operations: three bf16
// passes, 0.629 ms a 7B layer at T = 512 at 989 TFLOP/s.
//   * A block computes 128 output columns x 128 rows of x (wgmma
//     m64n128k16): 64 accumulators and a 64-register partial a thread
//     (m64n256 would leave no registers for the partial).  The same
//     warpgroups, register hand-over and ldmatrix.trans A rows as above.
//   * A stage is 64 W rows: the W box, each 32-row part's x planes (TMA
//     boxes of 128 rows x 32 columns, 64-byte swizzle, from the pre-pass's
//     (T, planes x I) scratch) and the group's scale row; the ring holds as
//     many stages as fit (3 on f32 x).  The two parts' A fragments are
//     register sets of their own: a part is dequantized while the part
//     before is in flight, never over fragments an MMA still reads.
//   * Each byte becomes its exact integer in f32 by a PRMT into a magic
//     float and one FADD, the pair exact in bf16 by a PRMT: no scale, so
//     one A fragment of a k16 step serves every plane's wgmma.
//   * The partial is folded once its group (or the split) ends, after
//     wait_group 0: a drain of the warpgroup's MMAs once a group, which
//     the other consumer warpgroup's MMAs fill (two partials used in
//     turn were slower: a design call, PERF.md).  A group's first wgmma
//     has scale-d 0, so a partial needs no zeroing.  The G32 kernel (gs
//     32, 96: each 32-row part in one group, a scale row a part) folds the
//     partial after every part's drain, the next part's fragments built
//     while the part's MMAs run (PF_WIDE_G32_PARTIALS; two partials, one a
//     part folded after one drain a stage, are the other design, PERF.md).
//   * The pre-pass writes x's planes once a call (the norm first when a
//     gain is given); a bf16 x without the norm is read in place.
//   * INT16 (WT int16_t): each value is w = 256 hi + lo, hi = w >> 8 its
//     signed high byte, lo = w & 0xFF its unsigned low byte, both exact
//     in bf16 (256 hi too), so both weight planes go into the same f32
//     partial.  A stage's W is two TMA boxes of 64 int16 columns x 64 rows
//     (128-byte rows, 128-byte swizzle), one a consumer warpgroup.  An
//     ldmatrix.trans of a k16 step hands lane (g, t4) the int16 pairs of
//     rows 2 t4, 2 t4 + 1 (and + 8) at its warp's columns g and 8 + g (its
//     logical rows g and g + 8): each register's two low bytes make a lo
//     A register and its two high bytes a hi one (a byte permute into a
//     magic float and an FADD each, the high byte in the low mantissa
//     bits of 2^31, whose unit is 256).  Each x plane's wgmma runs on the
//     lo then the hi fragments: two passes on bf16 x, six on f32 x.  The
//     thread's two columns are 8 apart, so the fold reads two scales and
//     the epilogue stores single elements.
//
// The host builds the three CUtensorMaps a call (cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint, so the library needs no -lcuda)
// and passes them as __grid_constant__ parameters.  w[layer] of a stacked
// weight is a pointer offset of layer * I * O bytes, so TMA's 16-byte base
// and stride rules hold whenever the rows are 16-byte aligned.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int PF_XK = 32;           // x columns a plane (64-byte rows)
// Tuning macros (tools/prefill_design.py builds variants and times them in
// turns):
//   PF_STAGES, PF_STAGES_P4: the ring's depth for K1 and K1p (5, the most
//     that fits K1's stage, and 4);
//   PF_SETMAXNREG: 0 leaves out the register hand-over (a diagnostic:
//     at the 168 registers a thread of 384 gets at launch, ptxas
//     serializes every wgmma);
//   PF_DIAG: 1 leaves out the dequant's arithmetic (the A fragments are
//     the raw weight words): a diagnostic of what the conversion costs,
//     whose output is wrong.
#ifndef PF_STAGES
#define PF_STAGES 5
#endif
#ifndef PF_STAGES_P4
#define PF_STAGES_P4 4
#endif
#ifndef PF_DIAG
#define PF_DIAG 0
#endif
#ifndef PF_SETMAXNREG
#define PF_SETMAXNREG 1
#endif
// The wide mode's tuning macros (the same tool): PF_WIDE_STAGES, the most
// stages its ring takes (it takes as many as fit, up to this);
// PF_WIDE_G32_PARTIALS, how its G32 kernel keeps a stage's two parts'
// partials: 1 one partial, folded after a drain at the end of each part
// (the next part's fragments built while the part's MMAs run), 2 one a part,
// both folded after the stage's one drain (64 more registers a thread).
#ifndef PF_WIDE_STAGES
#define PF_WIDE_STAGES 8
#endif
#ifndef PF_WIDE_G32_PARTIALS
#define PF_WIDE_G32_PARTIALS 1
#endif
constexpr int PF_ROWS = 256;        // rows of x a block (the wgmma N)
constexpr int PF_WG_COLS = 64;      // output columns a consumer warpgroup
constexpr int PF_COLS = 128;        // output columns a block: one W box
constexpr int PF_THREADS = 384;     // two consumer warpgroups, a producer's
constexpr int PF_PRODUCER_REGS = 40;   // registers a producer thread keeps
constexpr int PF_CONSUMER_REGS = 232;  // and a consumer thread takes
constexpr int PF_SMEM_BLOCK = 232448;
constexpr int PF_X_PLANE = PF_ROWS * PF_XK * 2;   // bytes of an x plane
constexpr int PF_S_ROW = 1024;      // bytes of a scale row's slot

// the ring's depth
__host__ __device__ constexpr int pf_stages(bool p4) {
  return p4 ? PF_STAGES_P4 : PF_STAGES;
}
// W rows a stage (K1p: packed rows, each two logical K rows)
__host__ __device__ constexpr int pf_ks(bool p4) { return p4 ? 32 : 64; }
// bytes of the W box: PF_COLS columns x pf_ks rows
__host__ __device__ constexpr int pf_w_box(bool p4) {
  return pf_ks(p4) * PF_COLS;
}
// a ring slot: the W box, two x planes, two scale rows (each piece a
// multiple of 1024 bytes, so every tile keeps its swizzle atom's alignment)
__host__ __device__ constexpr int pf_stage_bytes(bool p4) {
  return pf_w_box(p4) + 2 * PF_X_PLANE + 2 * PF_S_ROW;
}
// dynamic shared memory of a block: the ring and 1 KB to align its base
__host__ __device__ constexpr int pf_smem(bool p4) {
  return pf_stages(p4) * pf_stage_bytes(p4) + 1024;
}
constexpr int PFW_ROWS = 128;       // the wide mode: rows of x a block
constexpr int PFW_KS = 64;          // W rows a stage: two parts of 32
constexpr int PFW_X_BOX = PFW_ROWS * PF_XK * 2;   // bytes of an x box
// bf16 planes of x: three hold an f32 x, one a bf16 x
__host__ __device__ constexpr int pfw_planes(bool x_f32) {
  return x_f32 ? 3 : 1;
}
// a wide ring slot: the W box(es) of wb-byte weights (int8 one box of 128
// columns, int16 two of 64), each part's x planes, the scale row (g32: one
// a 32-row part; each piece a multiple of 1024 bytes)
__host__ __device__ constexpr int pfw_stage_bytes(int planes, int wb = 1,
                                                  bool g32 = false) {
  return wb * PFW_KS * PF_COLS + 2 * planes * PFW_X_BOX +
         (g32 ? 2 : 1) * PF_S_ROW;
}
// the wide ring's depth: as many stages as fit beside their two barriers
// and the 1 KB that aligns the ring, up to PF_WIDE_STAGES
__host__ __device__ constexpr int pfw_stages(int planes, int wb = 1,
                                             bool g32 = false) {
  return (PF_SMEM_BLOCK - 1024) / (pfw_stage_bytes(planes, wb, g32) + 16) <
                 PF_WIDE_STAGES
             ? (PF_SMEM_BLOCK - 1024) / (pfw_stage_bytes(planes, wb, g32) + 16)
             : PF_WIDE_STAGES;
}
__host__ __device__ constexpr int pfw_smem(int planes, int wb = 1,
                                           bool g32 = false) {
  return pfw_stages(planes, wb, g32) * pfw_stage_bytes(planes, wb, g32) +
         1024;
}
static_assert(pfw_stages(3, 1, true) >= 2 && pfw_stages(3, 2, true) >= 2,
              "the wide ring needs two stages");
// the producer's registers cover the consumers' rise: all from 65536
static_assert(128 * PF_PRODUCER_REGS + 256 * PF_CONSUMER_REGS <= 65536,
              "the warpgroups' registers exceed an SM's");
// with the two barriers a stage, in static shared memory
static_assert(pf_smem(false) + 16 * pf_stages(false) <= PF_SMEM_BLOCK &&
                  pf_smem(true) + 16 * pf_stages(true) <= PF_SMEM_BLOCK,
              "the ring does not fit a block's shared memory");

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// -- mbarriers and TMA --------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(b)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(b))
               : "memory");
}
// until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  const uint32_t a = smem_u32(b);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}
// a 2D box at element coordinates (c0 inner, c1 outer) into dst, completing
// on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// -- wgmma ----------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving the definition or a use of v across the
// asm around it: a fragment is complete before wgmma.fence, and no
// instruction but a wgmma touches it until the wait that retires it (else
// ptxas serializes every wgmma of the function)
__device__ __forceinline__ void reg_fence(float& v) {
  asm volatile("" : "+f"(v)::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t (&a)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// The shared memory descriptor of a K-major bf16 operand tile written by TMA
// with the 64-byte swizzle: rows of 64 bytes, 8-row atoms 512 bytes apart
// (stride byte offset), the leading byte offset unused (a k16 step, 32
// bytes, lies in one row), layout type 2 (SWIZZLE_64B); the tile starts on
// a 512-byte boundary, so the base offset is 0.
__device__ __forceinline__ uint64_t desc_sw64(const void* p) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

#define PF_D8(b)                                                             \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]),            \
      "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])

// d (64 rows x 256 columns, f32, the warpgroup's m64n256 accumulator
// fragment, 128 registers a thread) += a (64 x 16 bf16, registers) * b
// (16 x 256 bf16, K-major in shared memory at desc)
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127},"
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : PF_D8(0), PF_D8(8), PF_D8(16), PF_D8(24), PF_D8(32), PF_D8(40),
        PF_D8(48), PF_D8(56), PF_D8(64), PF_D8(72), PF_D8(80), PF_D8(88),
        PF_D8(96), PF_D8(104), PF_D8(112), PF_D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}
// d (64 rows x 128 columns, f32, 64 registers a thread) = a (64 x 16
// bf16, registers) * b (16 x 128 bf16, K-major in shared memory at desc)
// + (scale_d ? d : 0)
__device__ __forceinline__ void wgmma_rs128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t desc, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : PF_D8(0), PF_D8(8), PF_D8(16), PF_D8(24), PF_D8(32), PF_D8(40),
        PF_D8(48), PF_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(scale_d));
}
#undef PF_D8

// -- dequant (the magic-exponent conversions of qmm.cu) ---------------------

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

// ldmatrix .trans of four 8x8 b16 matrices: lanes 8 j .. 8 j + 7 give the
// rows of matrix j; register j of lane (g, t4) gets its rows 2 t4 and
// 2 t4 + 1 at b16 column g (low and high half)
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// byte b of rx (a weight word with its sign bits flipped) as the float
// 2^23 + b + 128, exact
__device__ __forceinline__ float magic8(uint32_t rx, int b) {
  return __uint_as_float(__byte_perm(rx, 0x4B000000u, 0x7650u | b));
}
// The A fragments of two k16 steps from ldmatrix's registers r: r[2 ks +
// hh] holds, for the step's rows 8 hh + 2 t4 and + 1 (bytes 0, 1 and 2,
// 3), the thread's columns 2 g and 2 g + 1 (its logical rows g and g + 8).
// Register 2 hh + h of a[ks]: row g + 8 h at the step's k 8 hh + 2 t4 and
// + 1, the lower k in the low half.  INT8: b * bf16(s) as one FFMA from
// the magic float (exact: c = -(2^23 + 128) * s is exact for a bf16 s, so
// the FFMA's one rounding meets an exact product), the pair rounded to
// bf16 once.
__device__ __forceinline__ void deq8_ldsm(uint32_t (&a)[2][4],
                                          const uint32_t (&r)[4],
                                          const float (&sb)[2][2],
                                          const float (&cb)[2][2]) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const uint32_t rx = r[2 * ks + hh] ^ 0x80808080u;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#if PF_DIAG
        a[ks][2 * hh + h] = rx ^ h;
#else
        a[ks][2 * hh + h] =
            round_pair(fmaf(magic8(rx, h), sb[ks][h], cb[ks][h]),
                       fmaf(magic8(rx, h + 2), sb[ks][h], cb[ks][h]));
#endif
      }
    }
}
// The wide mode's A fragments of two k16 steps (the registers of
// deq8_ldsm): the exact integers, each byte's magic float less its bias
// (one FADD, exact), the pair exact in bf16.
__device__ __forceinline__ void deq8_exact(uint32_t (&a)[2][4],
                                           const uint32_t (&r)[4]) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const uint32_t rx = r[2 * ks + hh] ^ 0x80808080u;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a[ks][2 * hh + h] = exact_pair(magic8(rx, h) - 8388736.0f,
                                       magic8(rx, h + 2) - 8388736.0f);
    }
}
// INT16's planes: int16 half h (0 the low) of the word v.  Its low byte,
// unsigned, is the low mantissa byte of 2^23; its high byte, the sign bit
// flipped, that of 2^31, whose mantissa unit is 256; the bias comes off
// exactly: lo and 256 hi as exact floats.
__device__ __forceinline__ float lo16_f(uint32_t v, int h) {
  return __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7650u | (2 * h))) -
         8388608.0f;
}
__device__ __forceinline__ float hi16_f(uint32_t v, int h) {
  return __uint_as_float(__byte_perm(v ^ 0x80008000u, 0x4F000000u,
                                     0x7650u | (2 * h + 1))) -
         2147516416.0f;
}
// The INT16 wide mode's A fragments of one k16 step from ldmatrix's
// registers r (register j: the step's rows 2 t4, 2 t4 + 1 of k half j / 2
// at the column g + 8 (j & 1), the lower k in the low half, which is
// wgmma's A register j): lo the low bytes, hi 256 times the high bytes,
// each pair exact in bf16.
__device__ __forceinline__ void deq16_exact(uint32_t (&lo)[4],
                                            uint32_t (&hi)[4],
                                            const uint32_t (&r)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lo[j] = exact_pair(lo16_f(r[j], 0), lo16_f(r[j], 1));
    hi[j] = exact_pair(hi16_f(r[j], 0), hi16_f(r[j], 1));
  }
}
// K1p: plane p's nibbles, bf16(f32(nibble) * f32(s))
__device__ __forceinline__ void deq4_ldsm(uint32_t (&a)[2][4],
                                          const uint32_t (&r)[4], int p,
                                          const float (&sb)[2][2]) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const uint32_t v = r[2 * ks + hh];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#if PF_DIAG
        a[ks][2 * hh + h] = v ^ (p + h);
#else
        a[ks][2 * hh + h] = round_pair(nib_f(v, v >> 12, p, h) * sb[ks][h],
                                       nib_f(v, v >> 12, p, h + 2) * sb[ks][h]);
#endif
      }
    }
}
// the two scales of the thread's columns 2 g, 2 g + 1 at p, as f32
__device__ __forceinline__ void scales2(float (&v)[2], const unsigned char* p,
                                        float) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  v[0] = f.x; v[1] = f.y;
}
__device__ __forceinline__ void scales2(float (&v)[2], const unsigned char* p,
                                        __nv_bfloat16) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  v[0] = f.x; v[1] = f.y;
}
// the scale at p, as f32
__device__ __forceinline__ float scale1(const unsigned char* p, float) {
  return *reinterpret_cast<const float*>(p);
}
__device__ __forceinline__ float scale1(const unsigned char* p,
                                        __nv_bfloat16) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
}
// two neighbouring outputs of a row at p (x's dtype), after the residual
__device__ __forceinline__ void store2(float* p, float v0, float v1,
                                       const float* res) {
  if (res != nullptr) {
    const float2 r = *reinterpret_cast<const float2*>(res);
    v0 = r.x + v0; v1 = r.y + v1;
  }
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1,
                                       const __nv_bfloat16* res) {
  if (res != nullptr) {
    const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(res));
    v0 = r.x + v0; v1 = r.y + v1;
  }
  *reinterpret_cast<uint32_t*>(p) = round_pair(v0, v1);
}

// P4: K1p (W the (I/2, O) split-half bytes; k_per_split in packed rows).
// XT: x's (and the output's and residual's) dtype; ST: the scales'.  G32:
// an unpacked weight at gs % 32 == 0 (the G32 kernel): each 32-row part of
// a stage lies in one group and reads its own scale row.
// Grid (ceil(O / PF_COLS), ceil(T / PF_ROWS), splits); PF_THREADS threads;
// pf_smem(P4) bytes of dynamic shared memory.  partial non-null: write the
// split's f32 partials (res unused).
template <bool P4, typename XT, typename ST, bool G32>
__device__ __forceinline__ void wgmma_body(
    const CUtensorMap& tm_x, const CUtensorMap& tm_w, const CUtensorMap& tm_s,
    const XT* __restrict__ res, XT* __restrict__ out,
    float* __restrict__ partial, int T, int I, int O, int gs,
    int k_per_split) {
  static_assert(!(P4 && G32), "the G32 kernel takes unpacked weights");
  extern __shared__ unsigned char pf_smem_raw[];
  constexpr int NS = pf_stages(P4);
  __shared__ __align__(8) uint64_t full[NS], empty[NS];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(pf_smem_raw) + 1023) & ~uintptr_t(1023));
  constexpr int KS = pf_ks(P4), WB = pf_w_box(P4);
  constexpr int STAGE = pf_stage_bytes(P4);
  constexpr int XOFF = WB, SOFF = XOFF + 2 * PF_X_PLANE;
  const int o0 = blockIdx.x * PF_COLS, t0 = blockIdx.y * PF_ROWS;
  const int k_rows = P4 ? I / 2 : I;
  const int kbeg = blockIdx.z * k_per_split;
  const int nst = (min(k_rows, kbeg + k_per_split) - kbeg) / KS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);        // the eight consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {                    // the producer warpgroup
#if PF_SETMAXNREG
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        PF_PRODUCER_REGS));
#endif
    if (warp == 8 && lane == 0) {
      constexpr uint32_t TX =
          XOFF + 2 * PF_X_PLANE + (P4 || G32 ? 2 : 1) * PF_COLS * sizeof(ST);
      for (int i = 0; i < nst; ++i) {
        const int s = i % NS;
        if (i >= NS) mbar_wait(&empty[s], ((i / NS) - 1) & 1);
        unsigned char* st = smem + s * STAGE;
        const int kr = kbeg + i * KS;   // the stage's first W row
        mbar_expect_tx(&full[s], TX);
        tma_load(st, &tm_w, &full[s], o0, kr);
        tma_load(st + XOFF, &tm_x, &full[s], kr, t0);
        tma_load(st + XOFF + PF_X_PLANE, &tm_x, &full[s],
                 P4 ? I / 2 + kr : kr + PF_XK, t0);
        tma_load(st + SOFF, &tm_s, &full[s], o0, kr / gs);
        if (P4)
          tma_load(st + SOFF + PF_S_ROW, &tm_s, &full[s], o0, (I / 2 + kr) / gs);
        if (G32)                        // the second part's scale row
          tma_load(st + SOFF + PF_S_ROW, &tm_s, &full[s], o0, (kr + PF_XK) / gs);
      }
    }
    return;
  }

  // the consumers: warpgroup wg's 64 columns 64 wg .. of the block, one
  // m64 tile
#if PF_SETMAXNREG
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      PF_CONSUMER_REGS));
#endif
  const int wg = warp / 4, q = warp % 4, g = lane / 4, t4 = lane % 4;
  float acc[128];
#pragma unroll
  for (int j = 0; j < 128; ++j) {
    acc[j] = 0.0f;
    reg_fence(acc[j]);
  }

  // a stage's four k16 steps in two parts, a plane each (step ks of part p
  // at x plane p's columns 16 ks), each part's A fragments a register set
  // of its own: part p's MMAs run while the next part is dequantized, and
  // the wait after each commit keeps one part in flight (four parts of a
  // k16 step each, three in flight, read slower on an H100).  ldmatrix:
  // lane l gives W row l (of the part's 32) at the warp's 16 columns
  // 64 wg + 16 q, four matrices of 8 rows: the part's two k16 steps.
  const int col = PF_WG_COLS * wg + 16 * q;
  uint32_t a[2][2][4];                    // [part][k16 step][register]
  for (int i = 0; i < nst; ++i) {
    const int s = i % NS;
    mbar_wait(&full[s], (i / NS) & 1);
    const unsigned char* st = smem + s * STAGE;
    auto ldsm_part = [&](uint32_t (&r)[4], int r0) {
      const int kr = r0 + lane;
      ldsm_x4_t(r, st + kr * 128 + (((col >> 4) ^ (kr & 7)) << 4));
    };
    // the thread's columns col + 2 g + h: their scales (a bf16 rounding
    // first for INT8; the same for both k16 steps; K1p one a plane, G32 one
    // a part) and INT8's FFMA offsets
    float sb[2][2][2], cb[G32 ? 2 : 1][2][2];
#pragma unroll
    for (int pl = 0; pl < (P4 || G32 ? 2 : 1); ++pl) {
      scales2(sb[pl][0], st + SOFF + pl * PF_S_ROW + (col + 2 * g) *
                                                         sizeof(ST), ST());
      sb[pl][1][0] = sb[pl][0][0];
      sb[pl][1][1] = sb[pl][0][1];
    }
    uint32_t r4[4];                       // K1p: the stage's registers
    if constexpr (P4) {
      ldsm_part(r4, 0);
    } else {
#pragma unroll
      for (int pl = 0; pl < (G32 ? 2 : 1); ++pl)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            sb[pl][e][h] =
                __bfloat162float(__float2bfloat16_rn(sb[pl][e][h]));
            cb[pl][e][h] = -8388736.0f * sb[pl][e][h];
          }
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      if constexpr (P4) {
        deq4_ldsm(a[p], r4, p, sb[p]);
      } else {
        uint32_t r[4];
        ldsm_part(r, 32 * p);
        deq8_ldsm(a[p], r, sb[G32 ? p : 0], cb[G32 ? p : 0]);
      }
      reg_fence(a[p]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        wgmma_rs(acc, a[p][ks],
                 desc_sw64(st + XOFF + p * PF_X_PLANE + 32 * ks));
      wgmma_commit();
      wgmma_wait<1>();
      // the stage before is retired once its last part is
      if (p == 0 && i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % NS]);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < 128; ++j) reg_fence(acc[j]);

  // accumulator register 4 j + 2 h + c: logical row g + 8 h, the column
  // col + 2 g + h, and row 8 j + 2 t4 + c of x
  const int o = o0 + col + 2 * g;
  if (o < O) {                            // O % 2 == 0: both or none
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int t = t0 + 8 * j + 2 * t4 + c;
        if (t >= T) continue;
        const size_t e = (size_t)t * O + o;
        if (partial != nullptr)
          store2(partial + (size_t)blockIdx.z * T * O + e, acc[4 * j + c],
                 acc[4 * j + 2 + c], static_cast<const float*>(nullptr));
        else
          store2(out + e, acc[4 * j + c], acc[4 * j + 2 + c],
                 res != nullptr ? res + e : nullptr);
      }
  }
}

template <bool P4, typename XT, typename ST>
__global__ void __launch_bounds__(PF_THREADS, 1)
    qmm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w,
                     const __grid_constant__ CUtensorMap tm_s,
                     const XT* __restrict__ res, XT* __restrict__ out,
                     float* __restrict__ partial, int T, int I, int O, int gs,
                     int k_per_split) {
  wgmma_body<P4, XT, ST, false>(tm_x, tm_w, tm_s, res, out, partial, T, I, O,
                                gs, k_per_split);
}
// The G32 kernel: gs a multiple of 32 and not of 64 (GGUF Q8_0's 32), an
// unpacked weight; a kernel of its own, so that the gs-64 ones keep their
// code
template <typename XT, typename ST>
__global__ void __launch_bounds__(PF_THREADS, 1)
    qmm_wgmma_g32_kernel(const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_w,
                         const __grid_constant__ CUtensorMap tm_s,
                         const XT* __restrict__ res, XT* __restrict__ out,
                         float* __restrict__ partial, int T, int I, int O,
                         int gs, int k_per_split) {
  wgmma_body<false, XT, ST, true>(tm_x, tm_w, tm_s, res, out, partial, T, I,
                                  O, gs, k_per_split);
}

// The wide mode.  XT: x's (and the output's and residual's) dtype, which
// sets the planes (f32 three, bf16 one); ST: the scales'; WT: the weight's
// (int8_t, or int16_t: INT16's two planes).  tm_x maps the (T, planes x I)
// bf16 planes (plane q of row t at columns q I ..), or a bf16 x read in
// place; tm_w the weight in boxes of 128 (int16: 64) columns x 64 rows.
// Grid (ceil(O / PF_COLS), ceil(T / PFW_ROWS), splits); PF_THREADS
// threads; pfw_smem(planes, sizeof(WT)) bytes of dynamic shared memory.
// partial non-null: write the split's f32 partials (res unused).
// G32: gs % 32 == 0 (the G32 kernel), a scale row a 32-row part, each
// part's partial folded apart.
template <typename XT, typename ST, typename WT, bool G32>
__device__ __forceinline__ void wgmma_wide_body(
    const CUtensorMap& tm_x, const CUtensorMap& tm_w, const CUtensorMap& tm_s,
    const XT* __restrict__ res, XT* __restrict__ out,
    float* __restrict__ partial, int T, int I, int O, int gs,
    int k_per_split) {
  extern __shared__ unsigned char pf_smem_raw[];
  constexpr int WB = sizeof(WT);       // bytes a weight
  constexpr int NPL = pfw_planes(sizeof(XT) == 4),
                NS = pfw_stages(NPL, WB, G32);
  constexpr int KS = PFW_KS, NP = 2;   // W rows, parts a stage
  constexpr int STAGE = pfw_stage_bytes(NPL, WB, G32);
  constexpr int WBOX = KS * 128;       // bytes of a W box (128-byte rows)
  constexpr int XOFF = WB * WBOX, SOFF = XOFF + NP * NPL * PFW_X_BOX;
  __shared__ __align__(8) uint64_t full[NS], empty[NS];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(pf_smem_raw) + 1023) & ~uintptr_t(1023));
  const int o0 = blockIdx.x * PF_COLS, t0 = blockIdx.y * PFW_ROWS;
  const int kbeg = blockIdx.z * k_per_split;
  const int nst = (min(I, kbeg + k_per_split) - kbeg) / KS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);        // the eight consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {                    // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        PF_PRODUCER_REGS));
    if (warp == 8 && lane == 0) {
      // INT16: the second W box (columns o0 + 64 ..) is not asked for
      // where it lies wholly past O; its consumer's outputs are not stored
      const bool box2 = WB == 2 && o0 + 64 < O;
      const uint32_t TX = SOFF + (G32 ? 2 : 1) * PF_COLS * sizeof(ST) -
                          (WB == 2 && !box2 ? WBOX : 0);
      for (int i = 0; i < nst; ++i) {
        const int s = i % NS;
        if (i >= NS) mbar_wait(&empty[s], ((i / NS) - 1) & 1);
        unsigned char* st = smem + s * STAGE;
        const int kr = kbeg + i * KS;   // the stage's first W row
        mbar_expect_tx(&full[s], TX);
        tma_load(st, &tm_w, &full[s], o0, kr);
        if (box2) tma_load(st + WBOX, &tm_w, &full[s], o0 + 64, kr);
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int q = 0; q < NPL; ++q)
            tma_load(st + XOFF + (p * NPL + q) * PFW_X_BOX, &tm_x, &full[s],
                     q * I + kr + PF_XK * p, t0);
        tma_load(st + SOFF, &tm_s, &full[s], o0, kr / gs);
        if (G32)                        // the second part's scale row
          tma_load(st + SOFF + PF_S_ROW, &tm_s, &full[s], o0,
                   (kr + PF_XK) / gs);
      }
    }
    return;
  }

  // the consumers: warpgroup wg's 64 columns 64 wg .. of the block, one
  // m64 tile, warp wq's 16 of them
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      PF_CONSUMER_REGS));
  const int wg = warp / 4, wq = warp % 4, g = lane / 4, t4 = lane % 4;
  const int col = PF_WG_COLS * wg + 16 * wq;
  // the thread's logical row g + 8 h (its accumulators' column): col + 2 g
  // + h at int8, col + g + 8 h at int16
  const int c0 = WB == 2 ? col + g : col + 2 * g, dc = WB == 2 ? 8 : 1;
  float acc[64], pa[64];              // the accumulators, the partial
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    acc[j] = pa[j] = 0.0f;
    reg_fence(acc[j]);
    reg_fence(pa[j]);
  }
  // acc += pt * the scales sv of the thread's columns c0 + dc h
  // (accumulator register 4 j + 2 h + c), once pt's MMAs have retired
  auto fold = [&](float (&pt)[64], const float (&sv)[2]) {
#pragma unroll
    for (int j = 0; j < 64; ++j) reg_fence(pt[j]);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          acc[4 * j + 2 * h + c] =
              fmaf(pt[4 * j + 2 * h + c], sv[h], acc[4 * j + 2 * h + c]);
  };
  auto release = [&](int i) {
    if (lane == 0) mbar_arrive(&empty[i % NS]);
  };
  bool held = false;     // the stage before is held: its MMAs may run
  float sp[2] = {0.0f, 0.0f};   // the scales of the partial to fold
  // [part][k16 step][register]: int8's exact integers, or INT16's lo plane
  // (a) and hi plane (ah)
  uint32_t a[NP][2][4], ah[WB == 2 ? NP : 1][2][4];
  // the A fragments of stage st's part p, and their fence
  auto fragments = [&](const unsigned char* st, int p) {
    if constexpr (WB == 2) {
      // one ldmatrix a k16 step: lane l gives row 16 ks + 8 (l >> 4) +
      // (l & 7) of the part at the 16-byte chunk 2 wq + ((l >> 3) & 1) of
      // its warpgroup's box
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t r[4];
        const int wr = 32 * p + 16 * ks + 8 * (lane >> 4) + (lane & 7);
        const int ch = 2 * wq + ((lane >> 3) & 1);
        ldsm_x4_t(r, st + wg * WBOX + wr * 128 + ((ch ^ (wr & 7)) << 4));
        deq16_exact(a[p][ks], ah[p][ks], r);
      }
      reg_fence(ah[p]);
    } else {
      uint32_t r[4];
      const int wr = 32 * p + lane;   // lane l gives the part's W row l
      ldsm_x4_t(r, st + wr * 128 + (((col >> 4) ^ (wr & 7)) << 4));
      deq8_exact(a[p], r);
    }
    reg_fence(a[p]);
    wgmma_fence();
  };
  // part p's wgmma of stage st into cur, planes lo, mid, hi (INT16: each
  // on the lo then the hi weight plane); fresh: the first starts the
  // partial (scale-d 0)
  auto mmas = [&](float (&cur)[64], const unsigned char* st, int p,
                  bool fresh) {
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int q = NPL - 1; q >= 0; --q) {
        const uint64_t d =
            desc_sw64(st + XOFF + (p * NPL + q) * PFW_X_BOX + 32 * ks);
        wgmma_rs128(cur, a[p][ks], d,
                    fresh && ks == 0 && q == NPL - 1 ? 0 : 1);
        if constexpr (WB == 2) wgmma_rs128(cur, ah[p][ks], d, 1);
      }
    wgmma_commit();
  };
  // after part 0's commit and wait: the part before, the stage before's
  // last, has retired
  auto retire_before = [&](int i) {
    if (held) release(i - 1);
    held = false;
  };
  const auto group_end = [&](int i) {
    return (kbeg + i * KS + KS) % gs == 0 || i == nst - 1;
  };
  // the scales of stage st's part p (its own scale row at G32) into v
  auto part_scales = [&](float (&v)[2], const unsigned char* st, int p) {
    const unsigned char* sr = st + SOFF + p * PF_S_ROW;
    if constexpr (WB == 2) {
      v[0] = scale1(sr + c0 * sizeof(ST), ST());
      v[1] = scale1(sr + (c0 + 8) * sizeof(ST), ST());
    } else {
      scales2(v, sr + c0 * sizeof(ST), ST());
    }
  };
  if constexpr (G32) {
#if PF_WIDE_G32_PARTIALS == 2
    // a partial a part (pa, pb), both folded after the stage's one drain
    float pb[64], sq[2];
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      pb[j] = 0.0f;
      reg_fence(pb[j]);
    }
    for (int i = 0; i < nst; ++i) {
      const int s = i % NS;
      mbar_wait(&full[s], (i / NS) & 1);
      const unsigned char* st = smem + s * STAGE;
      fragments(st, 0);
      mmas(pa, st, 0, true);
      fragments(st, 1);
      mmas(pb, st, 1, true);
      part_scales(sp, st, 0);
      part_scales(sq, st, 1);
      wgmma_wait<0>();
      fold(pa, sp);
      fold(pb, sq);
      release(i);
    }
#else
    // each part's partial folded after a drain (every part lies in one
    // group), the next part's fragments built while its MMAs run
    if (nst > 0) {
      mbar_wait(&full[0], 0);
      fragments(smem, 0);
    }
    for (int i = 0; i < nst; ++i) {
      const unsigned char* st = smem + (i % NS) * STAGE;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        wgmma_fence();                // after the last fold's reads of pa
        mmas(pa, st, p, true);
        part_scales(sp, st, p);
        if (p == 0) {
          fragments(st, 1);
        } else if (i + 1 < nst) {
          const int s1 = (i + 1) % NS;
          mbar_wait(&full[s1], ((i + 1) / NS) & 1);
          fragments(smem + s1 * STAGE, 0);
        }
        wgmma_wait<0>();
        fold(pa, sp);
      }
      release(i);
    }
#endif
  } else {
    bool fresh = true;   // the next MMA starts the partial
    for (int i = 0; i < nst; ++i) {
      const int s = i % NS;
      mbar_wait(&full[s], (i / NS) & 1);
      const unsigned char* st = smem + s * STAGE;
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        fragments(st, p);
        mmas(pa, st, p, fresh && p == 0);
        wgmma_wait<1>();
        if (p == 0) retire_before(i);
      }
      fresh = group_end(i);
      if (fresh) {                    // fold after a drain, release
        part_scales(sp, st, 0);
        wgmma_wait<0>();
        fold(pa, sp);
        release(i);
      } else {
        held = true;
      }
    }
  }
  // the last stage folded after a drain; said again so that ptxas sees
  // every MMA retired before the epilogue reuses the partial's registers
  wgmma_wait<0>();

  // accumulator register 4 j + 2 h + c: the column c0 + dc h and row
  // 8 j + 2 t4 + c of x
  const int o = o0 + c0;
  if (o0 + col < O) {                     // O % 16 == 0: the warp's 16
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int t = t0 + 8 * j + 2 * t4 + c;
        if (t >= T) continue;
        const size_t e = (size_t)t * O + o;
        if constexpr (WB == 2) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const size_t eh = e + dc * h;
            const float v = acc[4 * j + 2 * h + c];
            if (partial != nullptr)
              partial[(size_t)blockIdx.z * T * O + eh] = v;
            else
              out[eh] = from_f<XT>(res != nullptr ? to_f(res[eh]) + v : v);
          }
        } else if (partial != nullptr) {
          store2(partial + (size_t)blockIdx.z * T * O + e, acc[4 * j + c],
                 acc[4 * j + 2 + c], static_cast<const float*>(nullptr));
        } else {
          store2(out + e, acc[4 * j + c], acc[4 * j + 2 + c],
                 res != nullptr ? res + e : nullptr);
        }
      }
  }
}

template <typename XT, typename ST, typename WT>
__global__ void __launch_bounds__(PF_THREADS, 1)
    qmm_wgmma_wide_kernel(const __grid_constant__ CUtensorMap tm_x,
                          const __grid_constant__ CUtensorMap tm_w,
                          const __grid_constant__ CUtensorMap tm_s,
                          const XT* __restrict__ res, XT* __restrict__ out,
                          float* __restrict__ partial, int T, int I, int O,
                          int gs, int k_per_split) {
  wgmma_wide_body<XT, ST, WT, false>(tm_x, tm_w, tm_s, res, out, partial, T,
                                     I, O, gs, k_per_split);
}
// The wide mode's G32 kernel (gs a multiple of 32 and not of 64)
template <typename XT, typename ST, typename WT>
__global__ void __launch_bounds__(PF_THREADS, 1)
    qmm_wgmma_wide_g32_kernel(const __grid_constant__ CUtensorMap tm_x,
                              const __grid_constant__ CUtensorMap tm_w,
                              const __grid_constant__ CUtensorMap tm_s,
                              const XT* __restrict__ res,
                              XT* __restrict__ out,
                              float* __restrict__ partial, int T, int I,
                              int O, int gs, int k_per_split) {
  wgmma_wide_body<XT, ST, WT, true>(tm_x, tm_w, tm_s, res, out, partial, T,
                                    I, O, gs, k_per_split);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The pre-pass: row blockIdx.x of x as bf16 into xb, normalized first when
// gain is given (xn = to_x_dtype(x * rinv * gain), rinv = 1 / sqrt(mean(x^2)
// + eps), per-thread sums of squares summed by warps in order:
// deterministic).  planes 3 (the wide mode on f32 x): the row's three bf16
// planes hi, mid, lo (each the rest's rounding to nearest; their sum is the
// value) at columns 0, I and 2 I of a row of 3 I; else one plane, rounded.
// 256 threads; x's rows 16-byte aligned (I % 8 == 0).
template <typename XT>
__global__ void __launch_bounds__(256)
    prefill_x_kernel(const XT* __restrict__ x, const float* __restrict__ gain,
                     float eps, __nv_bfloat16* __restrict__ xb, int I,
                     int planes) {
  __shared__ float wsum[8];
  constexpr int V = 16 / sizeof(XT);
  const int tid = threadIdx.x;
  const XT* row = x + (size_t)blockIdx.x * I;
  __nv_bfloat16* dst = xb + (size_t)blockIdx.x * planes * I;
  float rinv = 1.0f;
  if (gain != nullptr) {
    float acc = 0.0f;
    for (int c = tid * V; c < I; c += 256 * V) {
      const uint4 u = *reinterpret_cast<const uint4*>(row + c);
      const XT* e = reinterpret_cast<const XT*>(&u);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float f = to_f(e[j]);
        acc = fmaf(f, f, acc);
      }
    }
    acc = warp_sum(acc);
    if (tid % 32 == 0) wsum[tid / 32] = acc;
    __syncthreads();
    float ss = 0.0f;
#pragma unroll
    for (int w = 0; w < 8; ++w) ss += wsum[w];
    rinv = 1.0f / sqrtf(ss / (float)I + eps);
  }
  for (int c = tid * V; c < I; c += 256 * V) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + c);
    const XT* e = reinterpret_cast<const XT*>(&u);
    float v[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      v[j] = to_f(e[j]);
      if (gain != nullptr) v[j] = to_f(from_f<XT>(v[j] * rinv * gain[c + j]));
    }
    for (int q = 0; q < planes; ++q) {
      uint32_t p[V / 2];
#pragma unroll
      for (int j = 0; j < V / 2; ++j) {
        p[j] = round_pair(v[2 * j], v[2 * j + 1]);
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&p[j]));
        v[2 * j] -= f.x;                  // exact: the next plane's rest
        v[2 * j + 1] -= f.y;
      }
      if constexpr (V == 8)
        *reinterpret_cast<uint4*>(dst + q * I + c) =
            make_uint4(p[0], p[1], p[2], p[3]);
      else
        *reinterpret_cast<uint2*>(dst + q * I + c) = make_uint2(p[0], p[1]);
    }
  }
}

// Sum of the split-K partials (after the K1f residual, when given), in
// split order, written in x's dtype.
template <typename XT>
__global__ void prefill_reduce_kernel(const float* __restrict__ partial,
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

// -- host ----------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2D map of a row-major (outer, inner) tensor at base, rows row_bytes
// apart, boxes of box_in x box_out elements; 0 or cudaErrorInvalidValue.
int make_map(CUtensorMap* map, CUtensorMapDataType dt, const void* base,
             uint64_t inner, uint64_t outer, uint64_t row_bytes,
             uint32_t box_in, uint32_t box_out, CUtensorMapSwizzle sw) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_in, box_out};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, dt, 2, const_cast<void*>(base), dims, strides,
                        box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Raises kernel's dynamic shared memory limit to smem before its first
// launch (allowed: the instantiation's flag); 0 or the runtime's error,
// not left for the next launch.
template <typename K>
int allow_smem(K* kernel, int smem, bool& allowed) {
  if (allowed) return 0;
  const cudaError_t a = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (a != cudaSuccess) {
    cudaGetLastError();
    return (int)a;
  }
  allowed = true;
  return 0;
}

// After a prefill launch: its error, and with splits > 1 the reduce pass
// (the residual added once, there)
template <typename XT>
int reduce_splits(const float* partial, const XT* res, XT* out, int T, int O,
                  int splits, cudaStream_t st) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t n = (size_t)T * O;
  const int blocks = (int)std::min<size_t>((n + 255) / 256, 4096);
  prefill_reduce_kernel<XT><<<blocks, 256, 0, st>>>(partial, res, out, n,
                                                    splits);
  return (int)cudaGetLastError();
}

// G32: the G32 kernel (an unpacked weight at gs % 32 == 0)
template <bool P4, typename XT, typename ST, bool G32>
int launch_t(const __nv_bfloat16* xsrc, const int8_t* w, const void* s,
             const void* res, void* out, float* partial, int T, int I, int O,
             int gs, int splits, int k_per_split, cudaStream_t st) {
  CUtensorMap tx, tw, ts;
  int e = make_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, xsrc, I, T,
                   (uint64_t)I * 2, PF_XK, PF_ROWS,
                   CU_TENSOR_MAP_SWIZZLE_64B);
  if (e == 0)
    e = make_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, O, P4 ? I / 2 : I,
                 (uint64_t)O, 128, pf_ks(P4),
                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == 0)
    e = make_map(&ts,
                 sizeof(ST) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                 s, O, I / gs, (uint64_t)O * sizeof(ST), PF_COLS, 1,
                 CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != 0) return e;
  constexpr int smem = pf_smem(P4);
  static bool allowed = false;
  const auto kernel = [] {
    if constexpr (G32) return qmm_wgmma_g32_kernel<XT, ST>;
    else return qmm_wgmma_kernel<P4, XT, ST>;
  }();
  e = allow_smem(kernel, smem, allowed);
  if (e != 0) return e;
  const dim3 grid((O + PF_COLS - 1) / PF_COLS, (T + PF_ROWS - 1) / PF_ROWS,
                  splits);
  const XT* rp = static_cast<const XT*>(res);
  XT* op = static_cast<XT*>(out);
  // the residual is added once: by the reduce pass when K is split
  kernel<<<grid, PF_THREADS, smem, st>>>(
      tx, tw, ts, splits > 1 ? nullptr : rp, op,
      splits > 1 ? partial : nullptr, T, I, O, gs, k_per_split);
  return reduce_splits<XT>(partial, rp, op, T, O, splits, st);
}

template <typename XT, typename ST, typename WT, bool G32>
int launch_wide_t(const __nv_bfloat16* xsrc, const void* w, const void* s,
                  const void* res, void* out, float* partial, int T, int I,
                  int O, int gs, int splits, int k_per_split,
                  cudaStream_t st) {
  constexpr int npl = pfw_planes(sizeof(XT) == 4), wb = sizeof(WT);
  CUtensorMap tx, tw, ts;
  int e = make_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, xsrc,
                   (uint64_t)npl * I, T, (uint64_t)npl * I * 2, PF_XK,
                   PFW_ROWS, CU_TENSOR_MAP_SWIZZLE_64B);
  // W boxes of 128-byte rows: 128 int8 or 64 int16 columns
  if (e == 0)
    e = make_map(&tw, wb == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                              : CU_TENSOR_MAP_DATA_TYPE_UINT8,
                 w, O, I, (uint64_t)O * wb, 128 / wb, PFW_KS,
                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == 0)
    e = make_map(&ts,
                 sizeof(ST) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                 s, O, I / gs, (uint64_t)O * sizeof(ST), PF_COLS, 1,
                 CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != 0) return e;
  constexpr int smem = pfw_smem(npl, wb, G32);
  static bool allowed = false;
  const auto kernel = [] {
    if constexpr (G32) return qmm_wgmma_wide_g32_kernel<XT, ST, WT>;
    else return qmm_wgmma_wide_kernel<XT, ST, WT>;
  }();
  e = allow_smem(kernel, smem, allowed);
  if (e != 0) return e;
  const dim3 grid((O + PF_COLS - 1) / PF_COLS, (T + PFW_ROWS - 1) / PFW_ROWS,
                  splits);
  const XT* rp = static_cast<const XT*>(res);
  XT* op = static_cast<XT*>(out);
  kernel<<<grid, PF_THREADS, smem, st>>>(
      tx, tw, ts, splits > 1 ? nullptr : rp, op,
      splits > 1 ? partial : nullptr, T, I, O, gs, k_per_split);
  return reduce_splits<XT>(partial, rp, op, T, O, splits, st);
}

// dtype codes shared with ops/kernels/qmm.py
enum { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2, DT_I16 = 3 };

bool misaligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 != 0;
}

// The pre-pass over x (x_dt) into xb, planes bf16 planes a row, the norm
// first when gain is given; 0 or the launch's error.
int prepass(const void* x, int x_dt, const float* gain, float eps,
            __nv_bfloat16* xb, int T, int I, int planes, cudaStream_t st) {
  if (x_dt == DT_F32)
    prefill_x_kernel<float><<<T, 256, 0, st>>>(static_cast<const float*>(x),
                                               gain, eps, xb, I, planes);
  else
    prefill_x_kernel<__nv_bfloat16><<<T, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), gain, eps, xb, I, planes);
  return (int)cudaGetLastError();
}

}  // namespace

// The prefill mode (qmm_wgmma_kernel): out (T, O) in x's dtype.  x (T, I)
// f32/bf16; w int8 (I, O), or packed (I/2, O) split-half bytes; scales
// (I/gs, O) f32/bf16; gs % 64 == 0 (packed: (I/2) % gs == 0), or for an
// unpacked weight gs % 32 == 0 and I % 64 == 0 (below gs % 64 the G32
// kernel); O % 16 == 0, I % 8 == 0 (packed I % 16), x, w, s and res 16-byte
// aligned.  gain (I,)
// f32 or null (the rmsnorm prologue with eps), res (T, O) in x's dtype or
// null (the residual epilogue).  xb: (T, I) bf16 scratch that the pre-pass
// fills, required when x is f32 or gain is given, else null (bf16 x is
// read in place).  splits blocks along K of k_per_split W rows each (packed:
// packed rows; a multiple of 64, packed 32), none empty; partial:
// splits*T*O f32 scratch when splits > 1.  Returns the launches'
// cudaGetLastError().
extern "C" int qmm_prefill_launch(const void* x, const void* w, const void* s,
                                  const void* gain, const void* res, float eps,
                                  void* out, void* partial, void* xb, int T,
                                  int I, int O, int gs, int splits,
                                  int k_per_split, int x_dt, int s_dt,
                                  int packed, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int k_rows = packed ? I / 2 : I, ks = pf_ks(packed != 0);
  const bool conv = x_dt == DT_F32 || gain != nullptr;
  const bool g32 = !packed && gs % 64 != 0;
  if (T < 1 || I < 1 || O < 16 || gs < 32 || gs % (packed ? 64 : 32) ||
      O % 16 || I % (packed ? 16 : 8) || k_rows % gs || k_rows % ks ||
      splits < 1 || k_per_split < ks || k_per_split % ks ||
      (long long)(splits - 1) * k_per_split >= k_rows ||
      (x_dt != DT_F32 && x_dt != DT_BF16) ||
      (s_dt != DT_F32 && s_dt != DT_BF16) || misaligned(x) || misaligned(w) ||
      misaligned(s) || misaligned(res) || misaligned(xb) ||
      (conv != (xb != nullptr)) || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* xsrc = static_cast<const __nv_bfloat16*>(x);
  if (conv) {
    const int e = prepass(x, x_dt, static_cast<const float*>(gain), eps,
                          static_cast<__nv_bfloat16*>(xb), T, I, 1, st);
    if (e != 0) return e;
    xsrc = static_cast<const __nv_bfloat16*>(xb);
  }
  const int8_t* wp = static_cast<const int8_t*>(w);
  float* part = static_cast<float*>(partial);
#define PF_CALL(P, XT, ST)                                                    \
  return g32 ? launch_t<false, XT, ST, true>(xsrc, wp, s, res, out, part, T,  \
                                             I, O, gs, splits, k_per_split,  \
                                             st)                             \
             : launch_t<P, XT, ST, false>(xsrc, wp, s, res, out, part, T, I,  \
                                          O, gs, splits, k_per_split, st)
#define PF_S(P, XT)                                                           \
  if (s_dt == DT_F32) PF_CALL(P, XT, float);                                  \
  else PF_CALL(P, XT, __nv_bfloat16)
#define PF_X(P)                                                               \
  if (x_dt == DT_F32) { PF_S(P, float); }                                     \
  else { PF_S(P, __nv_bfloat16); }
  if (packed) { PF_X(true); } else { PF_X(false); }
#undef PF_X
#undef PF_S
#undef PF_CALL
  return (int)cudaErrorInvalidValue;
}

// The wide mode (qmm_wgmma_wide_kernel): out (T, O) in x's dtype, at f32
// compute or on an INT16 weight.  x (T, I) f32/bf16; w (I, O) int8 (INT8,
// or INT4 held in int8; w_dt 2) or int16 (INT16; w_dt 3); scales (I/gs, O)
// f32/bf16; gs % 64 == 0, or gs % 32 == 0 and I % 64 == 0 (below gs % 64
// the G32 kernel); O % 16 == 0, x, w, s and res 16-byte aligned.  gain (I,) f32 or null (the rmsnorm prologue with eps),
// res (T, O) in x's dtype or null (the residual epilogue).  xb: (T, planes
// x I) bf16 scratch that the pre-pass fills (planes 3 for f32 x, 1 for
// bf16), required when x is f32 or gain is given, else null (bf16 x is read
// in place).  splits blocks along K of k_per_split W rows each (a multiple
// of 64), none empty; partial: splits*T*O f32 scratch when
// splits > 1.  Returns the launches' cudaGetLastError().
extern "C" int qmm_prefill_wide_launch(const void* x, const void* w,
                                       const void* s, const void* gain,
                                       const void* res, float eps, void* out,
                                       void* partial, void* xb, int T, int I,
                                       int O, int gs, int splits,
                                       int k_per_split, int x_dt, int s_dt,
                                       int w_dt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool conv = x_dt == DT_F32 || gain != nullptr;
  const bool g32 = gs % 64 != 0;
  if (T < 1 || I < 1 || O < 16 || gs < 32 || gs % 32 || O % 16 || I % gs ||
      I % PFW_KS ||
      splits < 1 || k_per_split < PFW_KS || k_per_split % PFW_KS ||
      (long long)(splits - 1) * k_per_split >= I ||
      (x_dt != DT_F32 && x_dt != DT_BF16) ||
      (s_dt != DT_F32 && s_dt != DT_BF16) || misaligned(x) || misaligned(w) ||
      misaligned(s) || misaligned(res) || misaligned(xb) ||
      (w_dt != DT_I8 && w_dt != DT_I16) ||
      (conv != (xb != nullptr)) || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* xsrc = static_cast<const __nv_bfloat16*>(x);
  if (conv) {
    const int e = prepass(x, x_dt, static_cast<const float*>(gain), eps,
                          static_cast<__nv_bfloat16*>(xb), T, I,
                          pfw_planes(x_dt == DT_F32), st);
    if (e != 0) return e;
    xsrc = static_cast<const __nv_bfloat16*>(xb);
  }
  float* part = static_cast<float*>(partial);
#define PFW_CALL(XT, ST, WT)                                                  \
  return g32 ? launch_wide_t<XT, ST, WT, true>(xsrc, w, s, res, out, part, T, \
                                               I, O, gs, splits,             \
                                               k_per_split, st)              \
             : launch_wide_t<XT, ST, WT, false>(xsrc, w, s, res, out, part,  \
                                                T, I, O, gs, splits,         \
                                                k_per_split, st)
#define PFW_W(XT, ST)                                                         \
  if (w_dt == DT_I16) PFW_CALL(XT, ST, int16_t);                              \
  PFW_CALL(XT, ST, int8_t)
  if (x_dt == DT_F32) {
    if (s_dt == DT_F32) { PFW_W(float, float); }
    PFW_W(float, __nv_bfloat16);
  }
  if (s_dt == DT_F32) { PFW_W(__nv_bfloat16, float); }
  PFW_W(__nv_bfloat16, __nv_bfloat16);
#undef PFW_W
#undef PFW_CALL
}

// The pre-pass alone, as both modes launch it (to time it apart from the
// kernel it feeds): xb (T, planes x I) bf16 from x (T, I) f32/bf16, the
// norm first when gain (I,) f32 is given.  planes 1, or 3 for f32 x;
// I % 8 == 0, x and xb 16-byte aligned.  Returns cudaGetLastError().
extern "C" int qmm_prefill_x_launch(const void* x, const void* gain,
                                    float eps, void* xb, int T, int I,
                                    int planes, int x_dt, void* stream) {
  if (T < 1 || I < 8 || I % 8 || (planes != 1 && planes != 3) ||
      (planes == 3 && x_dt != DT_F32) ||
      (x_dt != DT_F32 && x_dt != DT_BF16) || misaligned(x) ||
      misaligned(xb))
    return (int)cudaErrorInvalidValue;
  return prepass(x, x_dt, static_cast<const float*>(gain), eps,
                 static_cast<__nv_bfloat16*>(xb), T, I, planes,
                 static_cast<cudaStream_t>(stream));
}
