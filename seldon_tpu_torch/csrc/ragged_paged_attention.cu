// Ragged paged-attention partials for Hopper (sm_90a).
//
// Replaces the TPU kernel seldon_tpu/ops/ragged_paged_attention.py::_rpa_kernel
// (launched by partials_pallas). Contract, identical to the TPU kernel's:
// for every query row (b, h, g, s) it returns the online-softmax partials
//   m   = max_t s_t                 (NEG_INF when no position is live)
//   l   = sum_t exp(s_t - m)
//   acc = sum_t exp(s_t - m) [* v_scale_t] * v_t          (f32, unnormalised)
// over the pool positions t < bound[b, s], read through the block table:
// position t lives in pool block table[b, t / block] at offset t % block.
// s_t = (q . k_t) * Dh^-0.5 [* k_scale_t], the dot summed in f32 from bf16
// products (int8 codes are exact in bf16). p stays f32 in the value
// product, as the TPU kernel's f32 PV dot keeps it. A row with bound = 0
// comes out exactly (NEG_INF, 0, 0), NEG_INF = -1e30; dead lanes have p
// re-zeroed, never exp(0). The table entries of live columns must be pool
// block ids in [0, NB) (the engine writes only allocator ids and the trash
// block 0). They are not range-checked here: an id out of range is a
// fault, as it is for the plain version's indexing, never a silent read of
// another block.
//
// Both routes gather the slot's live K/V rows through the table by
// cp.async 16-byte copies into a ring of stages in shared memory, kept in
// their pool type (bf16, or int8 codes with bf16 scales); positions past
// the walk are zero-filled and read nothing. The entry point picks the
// route from R = G * Sq, the query rows of one (slot, kv-head):
//
// Decode route (R < 64; the serving path's decode wave has R = 4).
//   What bounds it: bytes. R = 4 does ~4 operations per byte of K/V read,
//   far below the card's ~295 bf16 operations per byte, so the math runs on
//   the CUDA cores and the design is about bytes in flight and latency:
//  * split-KV: the grid is (B * Hkv, n_split, row tiles); split i takes the
//    pool positions [i * span, (i + 1) * span) of its slot, span = 128.
//    The host sets n_split = ceil(nbs * block / span) from the table width,
//    never from `bound` (reading it would wait for the device): a 2047-
//    position slot of a 2048-position table has 16 live splits, the
//    serving burst's slots (<= ~430 positions) up to 4. Short splits keep
//    the serving burst's few live slots walked by many CTAs at once; at
//    256 positions the burst's decode launches took longer (PERF.md).
//    A CTA reads its rows' bounds first and exits at once when its range
//    starts past all of them. With one split the CTA writes the outputs;
//    otherwise it writes its
//    (m, l, acc) to a workspace and rpa_merge_kernel, launched right after
//    by the same entry-point call, folds the live splits of each row:
//      m = max m_i, l = sum l_i e^(m_i - m), acc = sum acc_i e^(m_i - m),
//    rows with no live split exactly (NEG_INF, 0, 0);
//  * steps of 32 positions (any block size: a step may start inside a
//    block) in a 3-stage cp.async ring: steps j + 1 and j + 2 are in flight
//    while step j is computed, one CTA barrier per step. 53 KB of shared
//    memory per CTA at Dh 128, bf16 pool, R = 4: four CTAs per SM (with
//    64-position steps, two; PERF.md has both). K rows are padded
//    by 16 bytes so a warp's 16-byte reads of 32 different rows hit all
//    banks;
//  * 4 warps, each owning TR / 4 query rows: lane c holds the score of
//    column c, the row's max and sum are warp shuffles (no barrier), p goes
//    through a per-warp buffer in shared memory, and in the value product
//    each lane owns Dh / 32 head-dim columns (Dh 16: 8 lanes per row, four
//    column groups folded by shuffles at the end). The int8 scales of a
//    lane's column are loaded into registers one step ahead, and int8 codes
//    become f32 by a byte permute and one add, not by the int-to-float
//    unit (16 conversions per SM per clock), which made the int8 decode
//    route slower than the bf16 one (PERF.md).
//
// Prefill route (R >= 64; the serving path's prefill wave has R = 512).
//   What bounds it: at the serving burst bytes (most rows have bound 0:
//   first chunks and idle slots); at a full synthetic wave operations and
//   bytes together (~4 * R * Dh operations per K/V position read: the QK
//   and PV products, PV twice over for p's hi and lo halves). The math runs
//   on the tensor cores:
//  * one CTA of two consumer warpgroups (256 threads) per (slot * kv-head,
//    tile of 128 query rows, 64 per warpgroup). Rows are r = g * Sq + s, so
//    Q is gathered row by row by cp.async into the swizzled layout of
//    hopper_mma.cuh;
//  * dead work first: every warp reads the tile's bounds (4 per lane) and
//    reduces their max by shuffles before anything else is loaded; a tile
//    whose rows all have bound 0 writes (NEG_INF, 0, 0) with 16-byte
//    streaming stores and exits, and a warpgroup whose 64 rows are all
//    dead skips the math;
//  * K/V tiles of 64 positions (64 / block whole blocks; a block that does
//    not divide 64 leaves masked columns at the end of the tile) in a
//    3-stage ring, bf16 in the swizzled layout, read by wgmma in place; an
//    int8 step is staged raw and converted to bf16 in shared memory (exact)
//    with its scales beside it, a second barrier per step;
//  * S = Q K^T by wgmma m64n64k16 (A = Q, B = K K-major, both from shared
//    memory) over Dh / 16 chained k-steps, f32; then * Dh^-0.5, then
//    * k_scale, the mask (-1e30) and the online softmax in registers in the
//    accumulator layout (quad shuffles; l sums the unrounded f32 p);
//  * O += P V with p kept in f32 by splitting it: pw = p [* v_scale],
//    hi = bf16_rn(pw), lo = bf16_rn(pw - hi), and two wgmma m64n{Dh}k16 RS
//    chains (A = hi, then A = lo, from registers; B = the V tile,
//    MN-major) into one f32 accumulator. v is exact in bf16, so the only
//    error is pw - hi - lo, ~2^-16 of each weight: far inside the 1e-4
//    gate, where a single bf16 p (2^-8) would fail it. Each step runs QK,
//    the softmax and PV one after the other in both warpgroups; overlapping
//    them is the next step (ROADMAP.md queue B).
//
// The kernels' dynamic shared-memory limits are set once per instance
// (hopper::allow_smem), not on every launch. Times: PERF.md
// (chip_smoke.py, NVIDIA H100 80GB HBM3). ptxas (chip_smoke.py's build
// phase): no spill in any instance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_mma.cuh"

namespace {

using namespace hopper;

constexpr int TK = 64;             // prefill tile positions; the largest block
constexpr float NEG_INF = -1e30f;  // the JAX package's mask fill
constexpr unsigned FULL = 0xffffffffu;

// Four int8 codes (one 32-bit word, lowest byte first) as exact f32
// without the int-to-float unit (16 conversions per SM per clock): code
// b + 128 goes into the low mantissa bits of 2^23 and the bias is
// subtracted.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* out) {
  const uint32_t u = w ^ 0x80808080u;  // b + 128, as unsigned bytes
#pragma unroll
  for (int t = 0; t < 4; ++t)
    out[t] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | t)) -
             8388736.f;
}

// The 16 bytes at `p` (8 bf16 or 16 int8 values) as f32.
template <typename KV>
__device__ __forceinline__ void chunk_to_f32(const uint8_t* p, float* out) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same_v<KV, int8_t>) {
      i8x4_to_f32(ws[i], out + 4 * i);
    } else {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&ws[i]));
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
}

// Issues the cp.async copies of the K and V rows of the pool positions
// pos0 + c, c < ROWS, of the slot whose table row is `trow`: position t
// lives in block trow[t / block] at offset t % block. Positions at or past
// pos_end are zero-filled and read nothing. KD(c, ch) and VD(c, ch) are
// the shared-memory byte offsets of 16-byte chunk ch of row c from k_st
// and v_st.
template <int DH, typename KV, int ROWS, int NTH, typename KDst,
          typename VDst>
__device__ __forceinline__ void issue_step(
    uint32_t k_st, uint32_t v_st, const KV* __restrict__ k_pool,
    const KV* __restrict__ v_pool, const int32_t* __restrict__ trow,
    int pos0, int pos_end, int block, int h, int Hkv, KDst kd, VDst vd) {
  constexpr int CPR = DH * static_cast<int>(sizeof(KV)) / 16;
  constexpr int TOTAL = ROWS * CPR;
  constexpr int EPC = 16 / static_cast<int>(sizeof(KV));  // elements per chunk
#pragma unroll
  for (int u = 0; u < (TOTAL + NTH - 1) / NTH; ++u) {
    const int i = threadIdx.x + u * NTH;
    if (TOTAL % NTH == 0 || i < TOTAL) {
      const int c = i / CPR, ch = i % CPR, t = pos0 + c;
      const bool live = t < pos_end;
      int64_t at = 0;
      if (live) {
        const int bid = __ldg(trow + t / block);
        at = ((static_cast<int64_t>(bid) * Hkv + h) * block + t % block) *
                 DH + ch * EPC;
      }
      cp_async16(k_st + kd(c, ch), k_pool + at, live ? 16 : 0);
      cp_async16(v_st + vd(c, ch), v_pool + at, live ? 16 : 0);
    }
  }
}

// ---------------------------------------------------------------------------
// Decode route: split-KV on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int DEC_NT = 128;  // threads per CTA: 4 warps
constexpr int DEC_TK = 32;   // pool positions per step
constexpr int DEC_NS = 3;    // cp.async ring stages

template <int DH, int TR, typename KV>
struct DecGeom {
  static constexpr int KROW = DH * sizeof(KV) + 16;  // padded: banks spread
  static constexpr int VROW = DH * sizeof(KV);
  static constexpr int STAGE = DEC_TK * (KROW + VROW);
  static constexpr int RPW = TR / 4;  // query rows per warp
  static constexpr int SMEM =
      TR * DH * 4 + DEC_NS * STAGE + 4 * DEC_TK * RPW * 4;
};

// DPL consecutive values of one V row (at `p`) as f32.
template <typename KV, int DPL>
__device__ __forceinline__ void load_vals(const uint8_t* p, float (&out)[DPL]) {
  if constexpr (std::is_same_v<KV, __nv_bfloat16>) {
    if constexpr (DPL == 4) {
      const uint2 w = *reinterpret_cast<const uint2*>(p);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
      const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
      out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
    } else {
      const float2 a =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
      out[0] = a.x; out[1] = a.y;
    }
  } else {
    float f[4];
    i8x4_to_f32(DPL == 4 ? *reinterpret_cast<const uint32_t*>(p)
                         : *reinterpret_cast<const uint16_t*>(p),
                f);
#pragma unroll
    for (int e = 0; e < DPL; ++e) out[e] = f[e];
  }
}

template <int DH, int TR, typename KV, bool QUANT>
__global__ void __launch_bounds__(DEC_NT, 1) rpa_decode_kernel(
    const __nv_bfloat16* __restrict__ q,        // [B, Sq, Hkv, G, DH]
    const KV* __restrict__ k_pool,              // [NB, Hkv, block, DH]
    const KV* __restrict__ v_pool,              // [NB, Hkv, block, DH]
    const __nv_bfloat16* __restrict__ k_scale,  // [NB, Hkv, block] or null
    const __nv_bfloat16* __restrict__ v_scale,  // [NB, Hkv, block] or null
    const int32_t* __restrict__ table,          // [B, nbs]
    const int32_t* __restrict__ bound,          // [B, Sq]
    float* __restrict__ m_out,    // [B * Hkv, n_split, R]: outputs at 1 split
    float* __restrict__ l_out,    // [B * Hkv, n_split, R]
    float* __restrict__ acc_out,  // [B * Hkv, n_split, R, DH]
    int Sq, int Hkv, int G, int block, int nbs, int span,
    float inv_sqrt_dh) {
  using DG = DecGeom<DH, TR, KV>;
  constexpr int RPW = DG::RPW;
  constexpr int DPL = DH >= 64 ? DH / 32 : 2;  // value columns per lane
  constexpr int LD = DH / DPL;                 // lanes per row (32 or 8)
  constexpr int CG = 32 / LD;                  // column groups of P V
  constexpr int VEC = 16 / static_cast<int>(sizeof(KV));
  constexpr int NCOL = DEC_TK / 32;            // score columns per lane
  static_assert(TR % 4 == 0 && TR <= 32, "rows per warp");

  extern __shared__ __align__(16) uint8_t smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [TR][DH] f32
  uint8_t* ring = smem + TR * DH * 4;           // DEC_NS x (K rows, V rows)
  float* p_s = reinterpret_cast<float*>(ring + DEC_NS * DG::STAGE);

  const int bh = blockIdx.x, b = bh / Hkv, h = bh % Hkv;
  const int split = blockIdx.y;
  const int R = G * Sq, row0 = blockIdx.z * TR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t out_row0 =
      (static_cast<int64_t>(bh) * gridDim.y + split) * R + row0;

  // The rows' bounds before anything else: lane r holds row r's, and every
  // warp reduces the tile's max by shuffles.
  int my_b = 0;
  if (lane < TR && row0 + lane < R)
    my_b = bound[static_cast<int64_t>(b) * Sq + (row0 + lane) % Sq];
  int mx = my_b;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = max(mx, __shfl_xor_sync(FULL, mx, off));
  const int pos_end = min(mx, nbs * block);  // the tile's walk
  const int p0 = split * span;               // this split's first position
  if (p0 >= pos_end) {
    if (gridDim.y == 1) {  // no merge follows: the rows are (NEG_INF, 0, 0)
      const int nr = min(TR, R - row0);
      for (int i = threadIdx.x; i < nr; i += DEC_NT) {
        m_out[out_row0 + i] = NEG_INF;
        l_out[out_row0 + i] = 0.f;
      }
      for (int i = threadIdx.x; i < nr * DH; i += DEC_NT)
        acc_out[out_row0 * DH + i] = 0.f;
    }
    return;
  }
  const int q_end = min(p0 + span, pos_end);
  const int n_steps = (q_end - p0 + DEC_TK - 1) / DEC_TK;
  int bnd[RPW];
#pragma unroll
  for (int v = 0; v < RPW; ++v) bnd[v] = __shfl_sync(FULL, my_b, warp + 4 * v);

  const int32_t* trow = table + static_cast<int64_t>(b) * nbs;
  const uint32_t ring_u = smem_u32(ring);
  auto issue = [&](int i) {
    if (i < n_steps) {
      const uint32_t st = ring_u + (i % DEC_NS) * DG::STAGE;
      issue_step<DH, KV, DEC_TK, DEC_NT>(
          st, st + DEC_TK * DG::KROW, k_pool, v_pool, trow,
          p0 + i * DEC_TK, q_end, block, h, Hkv,
          [](int c, int ch) { return uint32_t(c * DG::KROW + ch * 16); },
          [](int c, int ch) { return uint32_t(c * DG::VROW + ch * 16); });
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < DEC_NS - 1; ++i) issue(i);

  // Query rows as f32 (zeros past R), published by the first step's barrier.
  for (int i = threadIdx.x; i < TR * DH / 8; i += DEC_NT) {
    const int r = i / (DH / 8), ch = i % (DH / 8), rr = row0 + r;
    float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
    if (rr < R) {
      const int g = rr / Sq, s = rr % Sq;
      const uint4 w = *reinterpret_cast<const uint4*>(
          q + ((static_cast<int64_t>(b) * Sq + s) * Hkv + h) * G * DH +
          static_cast<int64_t>(g) * DH + ch * 8);
      const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&w);
      const float2 a = __bfloat1622float2(x[0]), bb = __bfloat1622float2(x[1]);
      const float2 c = __bfloat1622float2(x[2]), d = __bfloat1622float2(x[3]);
      lo = make_float4(a.x, a.y, bb.x, bb.y);
      hi = make_float4(c.x, c.y, d.x, d.y);
    }
    float4* dst = reinterpret_cast<float4*>(q_s + r * DH + ch * 8);
    dst[0] = lo;
    dst[1] = hi;
  }

  // int8: the scales of this lane's columns, loaded one step ahead.
  float ks[NCOL], vs[NCOL];
  auto load_scales = [&](int i, float (&kn)[NCOL], float (&vn)[NCOL]) {
#pragma unroll
    for (int u = 0; u < NCOL; ++u) {
      const int t = p0 + i * DEC_TK + lane + 32 * u;
      kn[u] = vn[u] = 0.f;
      if (i < n_steps && t < q_end) {
        const int64_t at =
            (static_cast<int64_t>(__ldg(trow + t / block)) * Hkv + h) *
                block + t % block;
        kn[u] = __bfloat162float(k_scale[at]);
        vn[u] = __bfloat162float(v_scale[at]);
      }
    }
  };
  if constexpr (QUANT) load_scales(0, ks, vs);

  float m_r[RPW], l_r[RPW], acc[RPW][DPL];
#pragma unroll
  for (int v = 0; v < RPW; ++v) {
    m_r[v] = NEG_INF;
    l_r[v] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[v][e] = 0.f;
  }
  float* pw_s = p_s + warp * DEC_TK * RPW;  // this warp's p, [DEC_TK][RPW]
  const int cgp = lane / LD, dl = lane % LD;

  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<DEC_NS - 2>();
    __syncthreads();  // step i is in; every warp is done with step i - 1
    issue(i + DEC_NS - 1);
    float ksn[NCOL], vsn[NCOL];
    if constexpr (QUANT) load_scales(i + 1, ksn, vsn);
    const uint8_t* kst = ring + (i % DEC_NS) * DG::STAGE;
    const uint8_t* vst = kst + DEC_TK * DG::KROW;

    // Scores of columns lane + 32 u for the warp's rows.
    float s[RPW][NCOL];
#pragma unroll
    for (int v = 0; v < RPW; ++v)
#pragma unroll
      for (int u = 0; u < NCOL; ++u) s[v][u] = 0.f;
#pragma unroll 4
    for (int ch = 0; ch < DH / VEC; ++ch) {
      float kf[NCOL][VEC];
#pragma unroll
      for (int u = 0; u < NCOL; ++u)
        chunk_to_f32<KV>(kst + (lane + 32 * u) * DG::KROW + ch * 16, kf[u]);
#pragma unroll
      for (int v = 0; v < RPW; ++v) {
        const float4* qv = reinterpret_cast<const float4*>(
            q_s + (warp + 4 * v) * DH + ch * VEC);
#pragma unroll
        for (int t4 = 0; t4 < VEC / 4; ++t4) {
          const float4 x = qv[t4];
#pragma unroll
          for (int u = 0; u < NCOL; ++u) {
            float a = s[v][u];
            a = fmaf(x.x, kf[u][4 * t4], a);
            a = fmaf(x.y, kf[u][4 * t4 + 1], a);
            a = fmaf(x.z, kf[u][4 * t4 + 2], a);
            a = fmaf(x.w, kf[u][4 * t4 + 3], a);
            s[v][u] = a;
          }
        }
      }
    }

    // Online softmax, one row per shuffle reduction.
    const int pos0 = p0 + i * DEC_TK;
    const int lim = min(DEC_TK, q_end - pos0);  // this split's positions
#pragma unroll
    for (int v = 0; v < RPW; ++v) {
      bool live[NCOL];
      float rmx = NEG_INF;
#pragma unroll
      for (int u = 0; u < NCOL; ++u) {
        const int c = lane + 32 * u;
        live[u] = c < lim && pos0 + c < bnd[v];
        float x = __fmul_rn(s[v][u], inv_sqrt_dh);
        if constexpr (QUANT) x = __fmul_rn(x, ks[u]);
        s[v][u] = live[u] ? x : NEG_INF;
        rmx = fmaxf(rmx, s[v][u]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rmx = fmaxf(rmx, __shfl_xor_sync(FULL, rmx, off));
      const float m_new = fmaxf(m_r[v], rmx);
      const float alpha = expf(m_r[v] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < NCOL; ++u) {
        const float p = live[u] ? expf(s[v][u] - m_new) : 0.f;
        sum += p;
        pw_s[(lane + 32 * u) * RPW + v] = QUANT ? p * vs[u] : p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(FULL, sum, off);
      l_r[v] = l_r[v] * alpha + sum;
      m_r[v] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[v][e] *= alpha;
    }
    __syncwarp();

    // acc[v][:] += sum_c pw[c][v] * V[c][:]; lane (cgp, dl) takes the
    // columns c = cgp (mod CG) and the value columns dl * DPL + [0, DPL).
#pragma unroll 4
    for (int c = cgp; c < lim; c += CG) {
      float vf[DPL];
      load_vals<KV, DPL>(vst + c * DG::VROW + dl * DPL * sizeof(KV), vf);
      const float* pc = pw_s + c * RPW;
#pragma unroll
      for (int v = 0; v < RPW; ++v) {
        const float p = pc[v];
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[v][e] = fmaf(p, vf[e], acc[v][e]);
      }
    }
    __syncwarp();  // the next step rewrites this warp's p
    if constexpr (QUANT) {
#pragma unroll
      for (int u = 0; u < NCOL; ++u) {
        ks[u] = ksn[u];
        vs[u] = vsn[u];
      }
    }
  }

  if constexpr (CG > 1) {  // fold the column groups (Dh 16)
#pragma unroll
    for (int off = LD; off < 32; off <<= 1)
#pragma unroll
      for (int v = 0; v < RPW; ++v)
#pragma unroll
        for (int e = 0; e < DPL; ++e)
          acc[v][e] += __shfl_xor_sync(FULL, acc[v][e], off);
  }
#pragma unroll
  for (int v = 0; v < RPW; ++v) {
    const int r = warp + 4 * v;
    if (row0 + r >= R) continue;
    if (lane == 0) {
      m_out[out_row0 + r] = m_r[v];
      l_out[out_row0 + r] = l_r[v];
    }
    if (cgp == 0) {
      float* dst = acc_out + (out_row0 + r) * DH + dl * DPL;
      if constexpr (DPL == 4)
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[v][0], acc[v][1], acc[v][2], acc[v][3]);
      else
        *reinterpret_cast<float2*>(dst) = make_float2(acc[v][0], acc[v][1]);
    }
  }
}

// Folds the splits of every row: one warp per row of [B * Hkv, R]. Split
// i holds positions [i * span_pos, (i + 1) * span_pos) and is live for a
// row iff i * span_pos < bound; only live splits are read.
template <int DH>
__global__ void __launch_bounds__(128) rpa_merge_kernel(
    const float* __restrict__ ws_m, const float* __restrict__ ws_l,
    const float* __restrict__ ws_acc, const int32_t* __restrict__ bound,
    float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ acc_out, int n_rows, int R, int Sq, int Hkv,
    int n_split, int span_pos) {
  constexpr int DPL = DH >= 32 ? DH / 32 : 1;
  const int row = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const int bh = row / R, r = row % R;
  const int bnd = bound[static_cast<int64_t>(bh / Hkv) * Sq + r % Sq];
  const int n_live = bnd > 0 ? min(n_split, (bnd + span_pos - 1) / span_pos)
                             : 0;
  const int64_t first = static_cast<int64_t>(bh) * n_split * R + r;
  float m = NEG_INF;
  for (int i = 0; i < n_live; ++i) m = fmaxf(m, ws_m[first + i * R]);
  float l = 0.f, acc[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) acc[e] = 0.f;
  const bool active = lane * DPL < DH;
  for (int i = 0; i < n_live; ++i) {
    const int64_t at = first + static_cast<int64_t>(i) * R;
    const float w = expf(ws_m[at] - m);
    l += ws_l[at] * w;
    if (active) {
      const float* a = ws_acc + at * DH + lane * DPL;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[e] = fmaf(a[e], w, acc[e]);
    }
  }
  if (lane == 0) {
    m_out[row] = m;
    l_out[row] = l;
  }
  if (active) {
    float* dst = acc_out + static_cast<int64_t>(row) * DH + lane * DPL;
#pragma unroll
    for (int e = 0; e < DPL; ++e) dst[e] = acc[e];
  }
}

// ---------------------------------------------------------------------------
// Prefill route: wgmma on the tensor cores
// ---------------------------------------------------------------------------

constexpr int PF_NT = 256;  // two consumer warpgroups
constexpr int PF_BQ = 128;  // query rows per CTA, 64 per warpgroup
constexpr int PF_NS = 3;    // cp.async ring stages

template <int DH, bool QUANT>
struct PfGeom {
  static constexpr int Q_BYTES = PF_BQ * DH * 2;   // swizzled bf16 Q tile
  static constexpr int TILE = TK * DH * 2;         // swizzled bf16 K or V
  static constexpr int RAW = QUANT ? TK * DH : TILE;  // one staged K or V
  static constexpr int CONV = QUANT ? 2 * TILE : 0;   // converted K, V
  static constexpr int RING = PF_NS * 2 * RAW;
  static constexpr int SCALES = QUANT ? 2 * TK * 4 : 0;
  static constexpr int SMEM = Q_BYTES + CONV + RING + SCALES + 1024;
};

template <int DH, bool QUANT>
__global__ void __launch_bounds__(PF_NT, 1) rpa_prefill_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, Sq, Hkv, G, DH]
    const void* __restrict__ k_pool_v,    // [NB, Hkv, block, DH] bf16 / int8
    const void* __restrict__ v_pool_v,
    const __nv_bfloat16* __restrict__ k_scale,  // [NB, Hkv, block] or null
    const __nv_bfloat16* __restrict__ v_scale,
    const int32_t* __restrict__ table,  // [B, nbs]
    const int32_t* __restrict__ bound,  // [B, Sq]
    float* __restrict__ m_out,          // [B * Hkv, R]
    float* __restrict__ l_out,          // [B * Hkv, R]
    float* __restrict__ acc_out,        // [B * Hkv, R, DH]
    int Sq, int Hkv, int G, int block, int nbs, float inv_sqrt_dh) {
  using KV = std::conditional_t<QUANT, int8_t, __nv_bfloat16>;
  using PG = PfGeom<DH, QUANT>;
  using SW = Swizzle<DH>;
  constexpr int NO = DH / 8;   // n-blocks of 8 columns in O
  constexpr int KP = TK / 16;  // k-steps of P V
  const KV* k_pool = static_cast<const KV*>(k_pool_v);
  const KV* v_pool = static_cast<const KV*>(v_pool_v);

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t sQ = (raw0 + 1023) & ~1023u;
  const uint32_t sConv = sQ + PG::Q_BYTES;  // int8: converted K, then V
  const uint32_t sRing = sConv + PG::CONV;
  float* ks_s = reinterpret_cast<float*>(smem_raw + (sRing + PG::RING - raw0));
  float* vs_s = ks_s + TK;

  const int bh = blockIdx.x, b = bh / Hkv, h = bh % Hkv;
  const int R = G * Sq, row0 = blockIdx.y * PF_BQ;
  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int64_t out0 = static_cast<int64_t>(bh) * R + row0;
  const int n_rows = min(PF_BQ, R - row0);
  const int32_t* brow = bound + static_cast<int64_t>(b) * Sq;

  // Dead work first: the tile's bounds (lane + 32 k, k < 4) and their max,
  // and this warpgroup's (k = 2 wg, 2 wg + 1), by shuffles.
  int tmx = 0, wmx = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int rr = row0 + lane + 32 * k;
    const int bd = rr < R ? brow[rr % Sq] : 0;
    tmx = max(tmx, bd);
    if (k / 2 == wg) wmx = max(wmx, bd);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    tmx = max(tmx, __shfl_xor_sync(FULL, tmx, off));
    wmx = max(wmx, __shfl_xor_sync(FULL, wmx, off));
  }
  if (tmx == 0) {  // every row is dead: (NEG_INF, 0, 0), streaming stores
    for (int i = tid; i < n_rows; i += PF_NT) {
      m_out[out0 + i] = NEG_INF;
      l_out[out0 + i] = 0.f;
    }
    float4* a4 = reinterpret_cast<float4*>(acc_out + out0 * DH);
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = tid; i < n_rows * DH / 4; i += PF_NT) __stcs(a4 + i, z);
    return;
  }
  const int n_live = min((tmx + block - 1) / block, nbs);
  const int cb = TK / block, P = cb * block;
  const int n_steps = (n_live + cb - 1) / cb;
  const int w_steps = (min((wmx + block - 1) / block, nbs) + cb - 1) / cb;
  const int32_t* trow = table + static_cast<int64_t>(b) * nbs;

  // Q rows gathered into the swizzled tile (zeros past R): copy group 0.
  for (int i = tid; i < PF_BQ * (DH / 8); i += PF_NT) {
    const int r = i / (DH / 8), ch = i % (DH / 8), rr = row0 + r;
    const bool live = rr < R;
    const __nv_bfloat16* src =
        live ? q + ((static_cast<int64_t>(b) * Sq + rr % Sq) * Hkv + h) *
                       G * DH +
                   static_cast<int64_t>(rr / Sq) * DH + ch * 8
             : q;
    cp_async16(sQ + tile_offset<DH>(r, ch, PF_BQ), src, live ? 16 : 0);
  }
  auto issue = [&](int i) {
    if (i < n_steps) {
      const uint32_t st = sRing + (i % PF_NS) * 2 * PG::RAW;
      const int pos0 = i * cb * block;
      const int pos_end = min(pos0 + P, n_live * block);
      if constexpr (QUANT) {
        auto rowmajor = [](int c, int ch) { return uint32_t(c * DH + ch * 16); };
        issue_step<DH, KV, TK, PF_NT>(st, st + PG::RAW, k_pool, v_pool, trow,
                                      pos0, pos_end, block, h, Hkv, rowmajor,
                                      rowmajor);
      } else {
        auto swz = [](int c, int ch) { return tile_offset<DH>(c, ch, TK); };
        issue_step<DH, KV, TK, PF_NT>(st, st + PG::RAW, k_pool, v_pool, trow,
                                      pos0, pos_end, block, h, Hkv, swz, swz);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < PF_NS - 1; ++i) issue(i);

  // int8: position tid's scales (tid < TK), loaded into registers one step
  // ahead and written to shared memory in the step's conversion pass.
  float ks_r = 0.f, vs_r = 0.f;
  auto load_scales = [&](int i) {
    ks_r = vs_r = 0.f;
    const int c = tid, j = i * cb + c / block;
    if (c < P && i < n_steps && j < n_live) {
      const int64_t at =
          (static_cast<int64_t>(__ldg(trow + j)) * Hkv + h) * block + c % block;
      ks_r = __bfloat162float(k_scale[at]);
      vs_r = __bfloat162float(v_scale[at]);
    }
  };
  if constexpr (QUANT) load_scales(0);

  // Accumulator layout: rows ra and ra + 8 of the warpgroup's 64; in each
  // 8-column n-block, columns cq and cq + 1.
  const int ra = 16 * warp + lane / 4, cq = 2 * (lane % 4);
  const int row_a = row0 + 64 * wg + ra, row_b = row_a + 8;
  const int bnd_a = row_a < R ? brow[row_a % Sq] : 0;
  const int bnd_b = row_b < R ? brow[row_b % Sq] : 0;

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF;  // running max of rows ra, ra + 8
  float l_a = 0.f, l_b = 0.f;          // this thread's share of their sums

  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<PF_NS - 2>();
    if constexpr (!QUANT) fence_proxy_async();
    __syncthreads();  // step i is in; everyone is done with step i - 1
    issue(i + PF_NS - 1);
    uint32_t kS, vS;
    if constexpr (QUANT) {  // int8 codes -> bf16 tiles (exact), scales
      const uint8_t* rk = smem_raw + (sRing + (i % PF_NS) * 2 * PG::RAW - raw0);
      const uint8_t* rv = rk + PG::RAW;
      for (int idx = tid; idx < TK * (DH / 16); idx += PF_NT) {
        const int c = idx / (DH / 16), ch = idx % (DH / 16);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          float f[16];
          chunk_to_f32<int8_t>((t ? rv : rk) + c * DH + ch * 16, f);
          uint32_t pk[8];
#pragma unroll
          for (int x = 0; x < 8; ++x) pk[x] = pack_bf16(f[2 * x], f[2 * x + 1]);
          const uint32_t dst = sConv + t * PG::TILE;
          asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                           dst + tile_offset<DH>(c, 2 * ch, TK)),
                       "r"(pk[0]), "r"(pk[1]), "r"(pk[2]), "r"(pk[3])
                       : "memory");
          asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                           dst + tile_offset<DH>(c, 2 * ch + 1, TK)),
                       "r"(pk[4]), "r"(pk[5]), "r"(pk[6]), "r"(pk[7])
                       : "memory");
        }
      }
      if (tid < TK) {
        ks_s[tid] = ks_r;
        vs_s[tid] = vs_r;
      }
      load_scales(i + 1);
      fence_proxy_async();
      __syncthreads();  // the converted tiles and the scales are in
      kS = sConv;
      vS = sConv + PG::TILE;
    } else {
      kS = sRing + (i % PF_NS) * 2 * PG::RAW;
      vS = kS + PG::RAW;
    }
    if (i >= w_steps) continue;  // warpgroup-uniform: all its rows are done

    // S = Q K^T on the tensor cores.
    float s[32];
    const uint32_t qW = sQ + 64 * wg * SW::ROWB;  // this warpgroup's rows
    wgmma_fence();
    wgmma_ss_n64<false>(s, kmajor_desc<DH>(qW, PF_BQ, 0),
                        kmajor_desc<DH>(kS, TK, 0));
#pragma unroll
    for (int kk = 1; kk < DH / 16; ++kk)
      wgmma_ss_n64<true>(s, kmajor_desc<DH>(qW, PF_BQ, kk),
                         kmajor_desc<DH>(kS, TK, kk));
    wgmma_commit();
    wgmma_wait_all();

    // Scale, then k_scale, then the mask; the online softmax in registers.
    const int pos0 = i * cb * block;
    const int lim = min(P, (n_live - i * cb) * block);
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int jl = 0; jl < 8; ++jl)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = s[4 * jl + e];
        pin(x);
        const int col = 8 * jl + cq + (e & 1);
        x = __fmul_rn(x, inv_sqrt_dh);
        if constexpr (QUANT) x = __fmul_rn(x, ks_s[col]);
        const bool live = col < lim && pos0 + col < (e < 2 ? bnd_a : bnd_b);
        x = live ? x : NEG_INF;
        if (e < 2) mx_a = fmaxf(mx_a, x);
        else mx_b = fmaxf(mx_b, x);
      }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, off));
    }
    const float alpha_a = expf(m_a - mx_a), alpha_b = expf(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int jl = 0; jl < 8; ++jl)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& x = s[4 * jl + e];
        const int col = 8 * jl + cq + (e & 1);
        const bool live = col < lim && pos0 + col < (e < 2 ? bnd_a : bnd_b);
        const float p = live ? expf(x - (e < 2 ? mx_a : mx_b)) : 0.f;
        if (e < 2) sum_a += p;
        else sum_b += p;
        x = QUANT ? p * vs_s[col] : p;  // the weight of v
      }
    l_a = alpha_a * l_a + sum_a;
    l_b = alpha_b * l_b + sum_b;
    // pw = hi + lo, each bf16, as the A fragments of P V: k-step kk covers
    // the S n-blocks 2 kk and 2 kk + 1.
    uint32_t ph[KP][4], pl[KP][4];
#pragma unroll
    for (int kk = 0; kk < KP; ++kk)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float x0 = s[8 * kk + 2 * t], x1 = s[8 * kk + 2 * t + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(hi);
        ph[kk][t] = *reinterpret_cast<const uint32_t*>(&hi);
        pl[kk][t] = pack_bf16(x0 - hf.x, x1 - hf.y);
      }
#pragma unroll
    for (int jn = 0; jn < NO; ++jn) {
      o[4 * jn] *= alpha_a;
      o[4 * jn + 1] *= alpha_a;
      o[4 * jn + 2] *= alpha_b;
      o[4 * jn + 3] *= alpha_b;
    }

    // O += hi V + lo V on the tensor cores.
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KP; ++kk)
      wgmma_rs<DH>(o, ph[kk], mnmajor_desc<DH>(vS, TK, kk));
#pragma unroll
    for (int kk = 0; kk < KP; ++kk)
      wgmma_rs<DH>(o, pl[kk], mnmajor_desc<DH>(vS, TK, kk));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int x = 0; x < DH / 2; ++x) pin(o[x]);
#pragma unroll
    for (int kk = 0; kk < KP; ++kk)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        pin(ph[kk][t]);
        pin(pl[kk][t]);
      }
  }

  // The quad's partial sums, then the partials of rows ra and ra + 8.
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(FULL, l_a, off);
    l_b += __shfl_xor_sync(FULL, l_b, off);
  }
  const int64_t oa = static_cast<int64_t>(bh) * R + row_a;
  if (row_a < R) {
    if (lane % 4 == 0) {
      m_out[oa] = m_a;
      l_out[oa] = l_a;
    }
#pragma unroll
    for (int jn = 0; jn < NO; ++jn)
      __stcs(reinterpret_cast<float2*>(acc_out + oa * DH + 8 * jn + cq),
             make_float2(o[4 * jn], o[4 * jn + 1]));
  }
  if (row_b < R) {
    if (lane % 4 == 0) {
      m_out[oa + 8] = m_b;
      l_out[oa + 8] = l_b;
    }
#pragma unroll
    for (int jn = 0; jn < NO; ++jn)
      __stcs(reinterpret_cast<float2*>(acc_out + (oa + 8) * DH + 8 * jn + cq),
             make_float2(o[4 * jn + 2], o[4 * jn + 3]));
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *ks, *vs, *table, *bound;
  void *m, *l, *acc, *ws;
  int B, Sq, Hkv, G, block, nbs, n_split, span;
  cudaStream_t st;
};

template <int DH, int TR, typename KV, bool QUANT>
cudaError_t launch_decode(const Args& a) {
  constexpr int smem = DecGeom<DH, TR, KV>::SMEM;
  constexpr auto kern = rpa_decode_kernel<DH, TR, KV, QUANT>;
  if constexpr (smem > 48 * 1024) {
    const cudaError_t e = allow_smem<kern>(smem);
    if (e != cudaSuccess) return e;
  }
  const int R = a.G * a.Sq;
  const int64_t N = static_cast<int64_t>(a.B) * a.Hkv * a.n_split * R;
  float* ws = static_cast<float*>(a.ws);
  const bool split = a.n_split > 1;
  float* m = split ? ws + N * DH : static_cast<float*>(a.m);
  float* l = split ? ws + N * DH + N : static_cast<float*>(a.l);
  float* acc = split ? ws : static_cast<float*>(a.acc);
  const dim3 grid(a.B * a.Hkv, a.n_split, (R + TR - 1) / TR);
  kern<<<grid, DEC_NT, smem, a.st>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const __nv_bfloat16*>(a.ks),
      static_cast<const __nv_bfloat16*>(a.vs),
      static_cast<const int32_t*>(a.table),
      static_cast<const int32_t*>(a.bound), m, l, acc, a.Sq, a.Hkv, a.G,
      a.block, a.nbs, a.span, 1.0f / sqrtf(static_cast<float>(DH)));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !split) return e;
  const int n_rows = a.B * a.Hkv * R;
  rpa_merge_kernel<DH><<<(n_rows + 3) / 4, 128, 0, a.st>>>(
      m, l, acc, static_cast<const int32_t*>(a.bound),
      static_cast<float*>(a.m), static_cast<float*>(a.l),
      static_cast<float*>(a.acc), n_rows, R, a.Sq, a.Hkv, a.n_split,
      a.span);
  return cudaGetLastError();
}

template <int DH, typename KV, bool QUANT>
cudaError_t launch_decode_rows(const Args& a) {
  const int R = a.G * a.Sq;
  if (R <= 4) return launch_decode<DH, 4, KV, QUANT>(a);
  if (R <= 16) return launch_decode<DH, 16, KV, QUANT>(a);
  return launch_decode<DH, 32, KV, QUANT>(a);
}

template <int DH, bool QUANT>
cudaError_t launch_prefill(const Args& a) {
  constexpr int smem = PfGeom<DH, QUANT>::SMEM;
  constexpr auto kern = rpa_prefill_kernel<DH, QUANT>;
  const cudaError_t e = allow_smem<kern>(smem);
  if (e != cudaSuccess) return e;
  const int R = a.G * a.Sq;
  const dim3 grid(a.B * a.Hkv, (R + PF_BQ - 1) / PF_BQ);
  kern<<<grid, PF_NT, smem, a.st>>>(
      static_cast<const __nv_bfloat16*>(a.q), a.k, a.v,
      static_cast<const __nv_bfloat16*>(a.ks),
      static_cast<const __nv_bfloat16*>(a.vs),
      static_cast<const int32_t*>(a.table),
      static_cast<const int32_t*>(a.bound), static_cast<float*>(a.m),
      static_cast<float*>(a.l), static_cast<float*>(a.acc), a.Sq, a.Hkv, a.G,
      a.block, a.nbs, 1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dh(const Args& a, int quantized) {
  const int R = a.G * a.Sq;
  if (R < 64) {
    if (quantized) return launch_decode_rows<DH, int8_t, true>(a);
    return launch_decode_rows<DH, __nv_bfloat16, false>(a);
  }
  if (quantized) return launch_prefill<DH, true>(a);
  return launch_prefill<DH, false>(a);
}

}  // namespace

// C entry point, loaded with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 = launched); cudaErrorInvalidValue for a head dim,
// block size or split plan the kernels do not take. R = G * Sq < 64 runs
// the decode route: `n_split` splits of `span` block columns (span a whole
// number of 64 / block steps, n_split = ceil(nbs / span)), and with more
// than one split `workspace` holds B * Hkv * n_split * R * (Dh + 2) f32
// (acc, then m, then l). R >= 64 runs the prefill route (n_split = 1, no
// workspace).
extern "C" int rpa_partials(const void* q, const void* k, const void* v,
                            const void* k_scale, const void* v_scale,
                            const void* table, const void* bound, void* m,
                            void* l, void* acc, void* workspace, int B,
                            int Sq, int Hkv, int G, int Dh, int block,
                            int nbs, int NB, int quantized, int n_split,
                            int span, void* stream) {
  if (block < 1 || block > TK || B < 1 || Sq < 1 || Hkv < 1 || G < 1 ||
      nbs < 1 || NB < 1 || n_split < 1 || span < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int R = G * Sq;
  if (R < 64) {
    const int64_t positions = static_cast<int64_t>(nbs) * block;
    if (span % DEC_TK != 0 || n_split != (positions + span - 1) / span ||
        n_split > 65535 || (n_split > 1 && workspace == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (n_split != 1 || (R + PF_BQ - 1) / PF_BQ > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q, k, v, k_scale, v_scale, table, bound, m, l, acc, workspace,
               B, Sq, Hkv, G, block, nbs, n_split, span,
               static_cast<cudaStream_t>(stream)};
  switch (Dh) {
    case 16:
      return launch_dh<16>(a, quantized);
    case 64:
      return launch_dh<64>(a, quantized);
    case 128:
      return launch_dh<128>(a, quantized);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
