// The split-row body that K2's split-row modes (flash_decode_split.cu:
// flash_decode_split_kernel; flash_decode_fresh.cu:
// flash_decode_fresh_split_kernel) and K2s's (flash_decode_split.cu:
// flash_spec_split_kernel) share, with its loads, conversions and merge.
// The design notes are with the kernels.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

constexpr int SPLIT_UNIT = 16;   // a split's rows: a multiple of this
constexpr int SPLIT_LOADS = 4;   // K (and V) loads a lane issues a step
constexpr int SPLIT_MAX = 16;    // splits a (slot, kv head)

// the most warps a block: 16 at hgs 1 (8 over int8), 8 at hgs 2, 4 from
// hgs 4 on, where q and the accumulators take more registers; the launch
// takes 4 to this many (ops/kernels/flash_decode.py: split_warps)
template <typename CT, int HGS>
__host__ __device__ constexpr int split_warps() {
  return HGS >= 4 ? 4 : HGS == 2 ? 8 : sizeof(CT) == 1 ? 8 : 16;
}

template <int BYTES> struct RawVec;
template <> struct RawVec<16> { using type = uint4; };
template <> struct RawVec<8> { using type = uint2; };

__device__ __forceinline__ float neg_infinity() { return __int_as_float(0xff800000); }
__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// DPL cache elements of a row as one 16-byte (8-byte for int8 at hgs 8)
// load, and their f32 values
template <typename CT, int HGS> struct SplitIO;
template <int HGS> struct SplitIO<float, HGS> {
  static constexpr int DPL = 4;
  using Raw = uint4;
  __device__ static void unpack(const Raw& r, float (&f)[DPL]) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};
template <int HGS> struct SplitIO<__nv_bfloat16, HGS> {
  static constexpr int DPL = 8;
  using Raw = uint4;
  __device__ static void unpack(const Raw& r, float (&f)[DPL]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = bf_lo(w[i]);
      f[2 * i + 1] = bf_hi(w[i]);
    }
  }
};
template <int HGS> struct SplitIO<int8_t, HGS> {
  static constexpr int DPL = HGS >= 8 ? 8 : 16;
  using Raw = typename RawVec<DPL>::type;
  __device__ static void unpack(const uint4& r, float (&f)[16]) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) f[i] = (float)(int8_t)(w[i / 4] >> (8 * (i % 4)));
  }
  __device__ static void unpack(const uint2& r, float (&f)[8]) {
    const uint32_t w[2] = {r.x, r.y};
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = (float)(int8_t)(w[i / 4] >> (8 * (i % 4)));
  }
};

template <typename Raw> __device__ __forceinline__ Raw ld_raw(const void* p) {
  return __ldg(reinterpret_cast<const Raw*>(p));
}

// (m, l, acc) of another lane merged into this one's: both rescaled to the
// larger max.  Two empty states (m = -1e30, l = 0, acc = 0) stay empty.
__device__ __forceinline__ void merge_weights(float m_a, float m_b, float& w_a,
                                              float& w_b, float& m) {
  m = fmaxf(m_a, m_b);
  w_a = expf(m_a - m);
  w_b = expf(m_b - m);
}

// cp.async of `bytes` (16 or 4) with zero fill past src_bytes (0: zeros)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
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

// K2s's split-row mode reads an int8 cache through a byte permute: the
// byte x + 128 placed in the mantissa of 2^23 is the float 2^23 + x + 128
// exactly, so an element costs a PRMT and an FADD, against the I2F
// conversion's quarter rate (the XOR that adds 128 serves four bytes).
__device__ __forceinline__ float i8_magic(uint32_t u, int i) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
         8388736.0f;
}
template <typename CT> struct SpecIO : SplitIO<CT, 1> {};
template <> struct SpecIO<int8_t> : SplitIO<int8_t, 8> {
  __device__ static void unpack(const uint2& r, float (&f)[8]) {
    const uint32_t w[2] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 8; ++i) f[i] = i8_magic(w[i / 4], i % 4);
  }
};

// element `at` of a row in q's dtype (K2s's fresh rows, in shared
// memory), as f32
__device__ __forceinline__ float ld_qt(const unsigned char* p, int at,
                                       int q_bf16) {
  return q_bf16 ? __bfloat162float(
                      reinterpret_cast<const __nv_bfloat16*>(p)[at])
                : reinterpret_cast<const float*>(p)[at];
}

// U rows' K and V loads of a lane from `base` (split_rows's prefetch);
// none past r1
template <typename CT, typename Raw, int U, int CPL, int RPI>
__device__ __forceinline__ void split_load(
    const CT* kb, const CT* vb, const float* ks, const float* vs,
    size_t row0, int base, int r1, int rg, int hs, const int (&col)[CPL],
    Raw (&kr)[U][CPL], Raw (&vr)[U][CPL], float (&ksc)[U], float (&vsc)[U]) {
  if (base >= r1) return;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = min(base + u * RPI + rg, r1 - 1);
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      kr[u][c] = ld_raw<Raw>(kb + (size_t)r * hs + col[c]);
      vr[u][c] = ld_raw<Raw>(vb + (size_t)r * hs + col[c]);
    }
    if (ks != nullptr) {
      ksc[u] = __ldg(ks + row0 + r);
      vsc[u] = __ldg(vs + row0 + r);
    }
  }
}

// The split-row body that K2's split mode and K2s's split mode share.
// SPEC false: cache rows [0, pos] and HG = hgs query rows.  SPEC true:
// cache rows [0, pos) strictly, nq = hgs * T <= HG query rows (row
// g * T + t at position pos + t; rows past nq read q = 0 and are never
// written), then the causal fresh block (flash_spec_split_kernel).  IO
// loads and unpacks the cache rows; LOADS sets the rows a lane loads a
// step; PF issues each step's loads before the previous step's
// arithmetic.  K2FS (with SPEC, T = 1: flash_decode_fresh_split_kernel):
// K2's fresh and stats form, where the fresh row is optional (k_new null:
// rows [0, pos] as without SPEC) and, when m_out is given, each query
// row's final max and sum (after the fresh row and the merges) go to
// m_out / l_out (B*n_kv, nq) f32, written wherever the output is.
// q, out: f32 (q_bf16 = 0) or bf16;
// caches CT; row scales f32 or null; part_acc (B*n_kv, nsplit, HG, hs),
// part_ml (B*n_kv, nsplit, HG, 2) and ticket (B*n_kv) only used when more
// than one split has rows.
template <typename CT, int HSP, int HG, typename IO, bool SPEC,
          int LOADS = SPLIT_LOADS, bool PF = false, bool K2FS = false>
__device__ __forceinline__ void split_rows(
    const void* __restrict__ q, const CT* __restrict__ kc,
    const CT* __restrict__ vc, const float* __restrict__ ks,
    const float* __restrict__ vs, const void* __restrict__ k_new,
    const void* __restrict__ v_new, const void* __restrict__ k_self,
    const void* __restrict__ v_self, const int* __restrict__ pos,
    void* __restrict__ out, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int* __restrict__ ticket, int layer, int Bc,
    int n_kv, int S, int hs, int T, int nq, int nsplit, int min_chunk,
    float scale, int q_bf16, float* __restrict__ m_out = nullptr,
    float* __restrict__ l_out = nullptr) {
  static_assert(!K2FS || SPEC, "K2's fresh and stats form is a SPEC form");
  using Raw = typename IO::Raw;
  constexpr int W = split_warps<CT, HG>();            // warps a block, most
  constexpr int DPL = IO::DPL;                        // elements a load
  constexpr int CHUNKS = HSP / DPL;                   // loads a row
  constexpr int LPR = CHUNKS < 32 ? CHUNKS : 32;      // lanes a row
  constexpr int CPL = CHUNKS / LPR;                   // loads a lane a row
  constexpr int RPI = 32 / LPR;                       // rows a warp load
  constexpr int U = LOADS > CPL ? LOADS / CPL : 1;    // rows a lane a step
  constexpr int RS = RPI * U;                         // rows a warp step
  constexpr int DL = CPL * DPL;                       // dims a lane holds
  static_assert(U >= 1 && LPR * RPI == 32, "split tiling");
  // (K2s copies its fresh rows into this space with 16-byte cp.async)
  __shared__ alignas(SPEC ? 16 : 4) float sm_acc[W][HG][HSP];
  __shared__ float sm_m[W][HG], sm_l[W][HG];
  __shared__ float pm[SPLIT_MAX][HG], pl[SPLIT_MAX][HG];
  __shared__ int last;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nw = blockDim.x / 32, nthreads = blockDim.x;  // warps: 4 .. W
  const int rg = lane / LPR, li = lane % LPR;         // row group, lane in row
  const int bh = blockIdx.x, split = blockIdx.y;
  const int b = bh / n_kv, h = bh % n_kv;
  const size_t row0 = ((size_t)(layer * Bc + b) * n_kv + h) * S;
  const CT* kb = kc + row0 * hs;
  const CT* vb = vc + row0 * hs;
  const size_t qoff = (size_t)bh * nq * hs;

  // K2FS without a fresh row reads [0, pos] as K2's non-fresh mode does
  const bool fresh = SPEC && (!K2FS || k_new != nullptr);
  const int p = min(max(pos[b], 0) + (fresh ? 0 : 1), S);
  const int per = max((p + nsplit - 1) / nsplit, min_chunk);
  const int chunk = (per + SPLIT_UNIT - 1) / SPLIT_UNIT * SPLIT_UNIT;
  // the splits with rows; the others have nothing to do.  With fresh rows
  // and no cache row (pos 0) split 0 takes the fresh block alone.
  int n_eff = (p + chunk - 1) / chunk;
  if constexpr (SPEC) n_eff = max(n_eff, 1);
  if (split >= n_eff) return;
  const int r0 = min(split * chunk, p), r1 = min(r0 + chunk, p);

  // this lane's dims: load c covers dims (c * LPR + li) * DPL + [0, DPL);
  // a load past hs reads the row's first elements instead, against q = 0
  int col[CPL];
  float qf[HG][DL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int d0 = (c * LPR + li) * DPL;
    const bool ok = d0 < hs;
    col[c] = ok ? d0 : 0;
#pragma unroll
    for (int g = 0; g < HG; ++g)
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const size_t at = qoff + (size_t)g * hs + d0 + i;
        float v = 0.0f;
        if (ok && (!SPEC || g < nq))
          v = q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[at])
                     : static_cast<const float*>(q)[at];
        qf[g][c * DPL + i] = v;
      }
  }
  float m[HG], l[HG], acc[HG][DL];
#pragma unroll
  for (int g = 0; g < HG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.0f;
#pragma unroll
    for (int d = 0; d < DL; ++d) acc[g][d] = 0.0f;
  }

  // K2s: the block that takes the fresh block copies its rows (k_new,
  // k_self, v_new, v_self: T x hs each in q's dtype) into the space of
  // sm_acc while it reads the cache
  unsigned char* fbuf = reinterpret_cast<unsigned char*>(&sm_acc[0][0][0]);
  const int row_b = hs * (q_bf16 ? 2 : 4), part_b = T * row_b;
  const bool fresh_here = fresh && split == n_eff - 1;
  if constexpr (SPEC) {
    if (fresh_here) {
      for (int c = tid * 16; c < 4 * part_b; c += nthreads * 16) {
        const int which = c / part_b, off = c % part_b;
        const void* src = which == 0 ? k_new : which == 1 ? k_self
                          : which == 2 ? v_new : v_self;
        if (src != nullptr)
          cp_async16(fbuf + c,
                     static_cast<const unsigned char*>(src) +
                         (size_t)bh * part_b + off, 16);
      }
      cp_async_commit();
    }
  }

  // with PF each step's loads are issued before the previous step's
  // arithmetic (pk/pv: the next step's rows)
  Raw pk[U][CPL], pv[U][CPL];
  float pks[U], pvs[U];
  if constexpr (PF)
    split_load<CT, Raw, U, CPL, RPI>(kb, vb, ks, vs, row0, r0 + warp * RS,
                                     r1, rg, hs, col, pk, pv, pks, pvs);

  for (int base = r0 + warp * RS; base < r1; base += nw * RS) {
    // every K and V load of the step first; rows past r1 re-read row
    // r1 - 1 (just loaded, so cached) and are masked below.  K2's own
    // loads stay written out here: through split_load its instantiations
    // took other registers (phase 1)
    Raw kr[U][CPL], vr[U][CPL];
    float ksc[U], vsc[U];
    if constexpr (PF) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          kr[u][c] = pk[u][c];
          vr[u][c] = pv[u][c];
        }
        ksc[u] = pks[u];
        vsc[u] = pvs[u];
      }
      split_load<CT, Raw, U, CPL, RPI>(kb, vb, ks, vs, row0, base + nw * RS,
                                       r1, rg, hs, col, pk, pv, pks, pvs);
    } else {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = min(base + u * RPI + rg, r1 - 1);
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          kr[u][c] = ld_raw<Raw>(kb + (size_t)r * hs + col[c]);
          vr[u][c] = ld_raw<Raw>(vb + (size_t)r * hs + col[c]);
        }
        if (ks != nullptr) {
          ksc[u] = __ldg(ks + row0 + r);
          vsc[u] = __ldg(vs + row0 + r);
        }
      }
    }
    // scores: this lane's partial dots, summed over the row's LPR lanes
    float s[U][HG];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int g = 0; g < HG; ++g) s[u][g] = 0.0f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        float kf[DPL];
        IO::unpack(kr[u][c], kf);
#pragma unroll
        for (int g = 0; g < HG; ++g)
#pragma unroll
          for (int i = 0; i < DPL; ++i) s[u][g] += qf[g][c * DPL + i] * kf[i];
      }
#pragma unroll
      for (int g = 0; g < HG; ++g)
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], o);
    }
    // online softmax over the step's rows, then P.V into this lane's dims
    float pe[U][HG];
#pragma unroll
    for (int g = 0; g < HG; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float v = s[u][g] * scale;
        if (ks != nullptr) v *= ksc[u];
        s[u][g] = base + u * RPI + rg < r1 ? v : NEG_INF;
        mx = fmaxf(mx, s[u][g]);
      }
      const float corr = expf(m[g] - mx);
      m[g] = mx;
      float sum = 0.0f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        // a masked row takes exp(-inf) = 0, with no branch
        const float x = s[u][g] - mx;
        const float e = expf(base + u * RPI + rg < r1 ? x : neg_infinity());
        sum += e;
        pe[u][g] = vs != nullptr ? e * vsc[u] : e;
      }
      l[g] = l[g] * corr + sum;
#pragma unroll
      for (int d = 0; d < DL; ++d) acc[g][d] *= corr;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        float vf[DPL];
        IO::unpack(vr[u][c], vf);
#pragma unroll
        for (int g = 0; g < HG; ++g)
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[g][c * DPL + i] += pe[u][g] * vf[i];
      }
  }

  if constexpr (SPEC) {
    // the causal fresh block, in the split that holds the last cache rows
    // (so it enters the merge once), from shared memory: fresh row j in
    // row group j % RPI of warp (j / RPI) % nw; query row g, at position
    // pos + g % T, sees j <= g % T, at j == g % T the exact row
    // k_self/v_self when given
    if (fresh_here) {
      cp_async_wait<0>();
      __syncthreads();
      const bool exact = k_self != nullptr;
      for (int j0 = warp * RPI; j0 < T; j0 += nw * RPI) {
        const int j = j0 + rg;
        const int kn_at = min(j, T - 1) * hs;
        float sn[HG], se[HG];
#pragma unroll
        for (int g = 0; g < HG; ++g) sn[g] = se[g] = 0.0f;
#pragma unroll
        for (int c = 0; c < CPL; ++c)
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            const int ix = kn_at + col[c] + i;
            const float kn = ld_qt(fbuf, ix, q_bf16);
            const float ke = exact ? ld_qt(fbuf + part_b, ix, q_bf16) : 0.0f;
#pragma unroll
            for (int g = 0; g < HG; ++g) {
              sn[g] += qf[g][c * DPL + i] * kn;
              se[g] += qf[g][c * DPL + i] * ke;
            }
          }
        float pn[HG], pd[HG];
#pragma unroll
        for (int g = 0; g < HG; ++g) {
#pragma unroll
          for (int o = LPR / 2; o > 0; o >>= 1) {
            sn[g] += __shfl_xor_sync(0xffffffffu, sn[g], o);
            se[g] += __shfl_xor_sync(0xffffffffu, se[g], o);
          }
          const int t = g % T;
          const bool diag = exact && j == t;
          const float s = (diag ? se[g] : sn[g]) * scale;
          const float mx = fmaxf(m[g], j <= t ? s : NEG_INF);
          const float corr = expf(m[g] - mx);
          const float e = expf(j <= t ? s - mx : neg_infinity());
          m[g] = mx;
          l[g] = l[g] * corr + e;
          pn[g] = diag ? 0.0f : e;
          pd[g] = diag ? e : 0.0f;
#pragma unroll
          for (int d = 0; d < DL; ++d) acc[g][d] *= corr;
        }
#pragma unroll
        for (int c = 0; c < CPL; ++c)
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            const int ix = kn_at + col[c] + i;
            const float vn = ld_qt(fbuf + 2 * part_b, ix, q_bf16);
            const float ve =
                exact ? ld_qt(fbuf + 3 * part_b, ix, q_bf16) : 0.0f;
#pragma unroll
            for (int g = 0; g < HG; ++g)
              acc[g][c * DPL + i] += pn[g] * vn + pd[g] * ve;
          }
      }
      __syncthreads();   // the fresh rows are read before sm_acc is written
    }
  }

  // the warp's row groups merged into lanes 0 .. LPR-1, then to shared
#pragma unroll
  for (int o = LPR; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < HG; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o);
      float wa, wb, mm;
      merge_weights(m[g], mo, wa, wb, mm);
      m[g] = mm;
      l[g] = l[g] * wa + lo * wb;
#pragma unroll
      for (int d = 0; d < DL; ++d)
        acc[g][d] = acc[g][d] * wa +
                    __shfl_xor_sync(0xffffffffu, acc[g][d], o) * wb;
    }
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < HG; ++g) {
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int i = 0; i < DPL; ++i)
          sm_acc[warp][g][(c * LPR + li) * DPL + i] = acc[g][c * DPL + i];
      if (li == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();

  // the block's (m, l, acc): the warps merged in order; with one split
  // holding rows, the output
  for (int i = tid; i < nq * hs; i += nthreads) {
    const int g = i / hs, d = i % hs;
    // every slot is read (no branch, so the loads go out together); the
    // slots of warps past nw are selected away
    float mb = NEG_INF;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float mw = sm_m[w][g];
      mb = fmaxf(mb, w < nw ? mw : NEG_INF);
    }
    float lb = 0.0f, ab = 0.0f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float mw = sm_m[w][g], lw = sm_l[w][g], aw = sm_acc[w][g][d];
      const float f = expf(mw - mb);
      lb += w < nw ? lw * f : 0.0f;
      ab += w < nw ? aw * f : 0.0f;
    }
    if (n_eff == 1) {
      if constexpr (K2FS) {
        if (m_out != nullptr && d == 0) {
          m_out[(size_t)bh * nq + g] = mb;
          l_out[(size_t)bh * nq + g] = lb;
        }
      }
      if (q_bf16)
        static_cast<__nv_bfloat16*>(out)[qoff + i] = __float2bfloat16_rn(ab / lb);
      else
        static_cast<float*>(out)[qoff + i] = ab / lb;
    } else {
      const size_t pidx = ((size_t)bh * nsplit + split) * HG + g;
      part_acc[pidx * hs + d] = ab;
      if (d == 0) {
        part_ml[2 * pidx] = mb;
        part_ml[2 * pidx + 1] = lb;
      }
    }
  }
  if (n_eff == 1) return;

  // the last of the n_eff blocks to finish merges them in split order and
  // puts the ticket back to 0.  The barrier orders the block's writes
  // before thread 0's release fence (fences are cumulative), so one
  // acq_rel fence a side does what a __threadfence in every thread would.
  __syncthreads();
  if (tid == 0) {
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
    last = atomicAdd(ticket + bh, 1) == n_eff - 1;
    if (last) asm volatile("fence.acq_rel.gpu;" ::: "memory");
  }
  __syncthreads();
  if (!last) return;
  if (tid < n_eff * HG) {
    const size_t pidx = (size_t)bh * nsplit * HG + tid;
    pm[tid / HG][tid % HG] = __ldcg(part_ml + 2 * pidx);
    pl[tid / HG][tid % HG] = __ldcg(part_ml + 2 * pidx + 1);
  }
  __syncthreads();
  for (int i = tid; i < nq * hs; i += nthreads) {
    const int g = i / hs, d = i % hs;
    float ar[SPLIT_MAX];
#pragma unroll
    for (int r = 0; r < SPLIT_MAX; ++r)
      ar[r] = r < n_eff ? __ldcg(part_acc + (((size_t)bh * nsplit + r) * HG + g) * hs + d)
                        : 0.0f;
    float mt = NEG_INF;
    for (int r = 0; r < n_eff; ++r) mt = fmaxf(mt, pm[r][g]);
    float lt = 0.0f, at = 0.0f;
#pragma unroll
    for (int r = 0; r < SPLIT_MAX; ++r) {
      if (r < n_eff) {
        const float f = expf(pm[r][g] - mt);
        lt += pl[r][g] * f;
        at += ar[r] * f;
      }
    }
    if (q_bf16)
      static_cast<__nv_bfloat16*>(out)[qoff + i] = __float2bfloat16_rn(at / lt);
    else
      static_cast<float*>(out)[qoff + i] = at / lt;
    if constexpr (K2FS) {
      if (m_out != nullptr && d == 0) {
        m_out[(size_t)bh * nq + g] = mt;
        l_out[(size_t)bh * nq + g] = lt;
      }
    }
  }
  if (tid == 0) ticket[bh] = 0;
}

}  // namespace
