// Ragged paged-attention partials for f32 queries on Hopper (sm_90a): the
// CUDA cores below 64 query rows, the tensor cores (3xTF32) from 64 up.
//
// Replaces the TPU kernel seldon_tpu/ops/ragged_paged_attention.py::_rpa_kernel
// (launched by partials_pallas) for f32 models (ModelConfig.dtype =
// "float32"): f32 queries against an f32 pool, or against an int8 pool with
// bf16 scales. bf16 queries run ragged_paged_attention.cu. Contract,
// identical to the TPU kernel's, for every query row (b, h, g, s):
//   m   = max_t s_t                 (NEG_INF when no position is live)
//   l   = sum_t exp(s_t - m)
//   acc = sum_t exp(s_t - m) [* v_scale_t] * v_t          (f32, unnormalised)
// over the pool positions t < bound[b, s], read through the block table:
// position t lives in pool block table[b, t / block] at offset t % block.
// s_t = (q . k_t) * Dh^-0.5 [* k_scale_t]: the dot's products and sums in
// f32 (int8 codes are exact in f32), then the scale, then the key scale,
// as the TPU kernel's dot_general(q, k.astype(f32), preferred f32) * scale.
// A row with bound = 0 comes out exactly (NEG_INF, 0, 0), NEG_INF = -1e30;
// dead lanes have p re-zeroed, never exp(0). The table entries of live
// columns must be pool block ids in [0, NB); they are not range-checked
// here, as in ragged_paged_attention.cu.
//
// What bounds it on this card, and the two routes the entry point picks
// from R = G * Sq, the query rows of one (slot, kv-head):
//
// Decode route (R < 64; the serving decode wave has R = 4, the verify wave
// R = 20). Bytes: ~2 operations per byte of f32 K/V read. All of its math
// runs in f32 FMA on the CUDA cores. Its design is the split-KV decode
// route of ragged_paged_attention.cu with f32 operands:
//  * the grid is (B * Hkv, n_split, tiles of TR query rows), TR in 4, 16,
//    32 by R. The walk is cut into splits of span = 128 positions (n_split
//    from the table's width, never from `bound`) and rpa_f32_merge_kernel,
//    launched right after by the same entry-point call, folds the live
//    splits of each row:
//      m = max m_i, l = sum l_i e^(m_i - m), acc = sum acc_i e^(m_i - m),
//    rows with no live split exactly (NEG_INF, 0, 0);
//  * a CTA reads its rows' bounds first and exits at once when its range
//    starts past all of them;
//  * steps of 32 positions gathered through the table by cp.async 16-byte
//    copies in a 3-stage ring (steps j + 1 and j + 2 in flight while step j
//    is computed, one CTA barrier per step); K rows padded by 16 bytes so a
//    warp's 16-byte reads of 32 rows hit all banks;
//  * 4 warps, each owning TR / 4 query rows: lane c holds the score of
//    column c (its dot a chain of Dh FMAs in order of d), the row's max and
//    sum are warp shuffles, p goes through a per-warp buffer in shared
//    memory, and in the value product each lane owns Dh / 32 head-dim
//    columns (Dh 16: 8 lanes per row, four column groups folded by
//    shuffles at the end). int8 codes become f32 by a byte permute and
//    one add; their bf16 scales are loaded one step ahead.
//
// Tensor-core route (R >= 64; the serving prefill wave has R = 512).
// Operations: 4 * R * Dh per K/V position, ~60 per byte of f32 K/V at R =
// 512. On the CUDA cores (67 TFLOP/s) that route reached 0.20 of its bound;
// here the products run on the tensor cores as 3xTF32 wgmma chains
// (hopper_tf32.cuh: 3 passes at 495 TFLOP/s, an effective 165; 2 passes
// against an int8 pool, whose codes are exact in TF32):
//  * one CTA of two consumer warpgroups (256 threads) per (slot * kv-head,
//    tile of 128 query rows, 64 per warpgroup); the grid is (B * Hkv,
//    ceil(R / 128)), one walk of the whole slot per CTA, no workspace;
//  * dead work first: every warp reads the tile's bounds and reduces their
//    max by shuffles; a tile whose rows all have bound 0 writes (NEG_INF,
//    0, 0) and exits, and a warpgroup skips the math of the steps past its
//    own rows' longest bound;
//  * Q is read once, split into hi and lo and stored as two swizzled
//    TF32 tiles (rows r = g * Sq + s gathered row by row);
//  * each step of 32 positions is two sub-tiles, K then V, gathered
//    through the table by cp.async into a 3-stage ring of raw sub-tiles
//    (pool type, rows padded by 16 bytes), two sub-tiles ahead. A sub-tile
//    is split into hi and lo (int8: codes as f32, no lo) into one
//    conversion slot of swizzled TF32 tiles: K K-major, its keys permuted
//    in each group of 8 (tf32::kperm) so that S's accumulator layout is
//    P V's A fragment layout; V transposed to V^T (positions contiguous),
//    since wgmma takes a .tf32 B operand K-major only (hopper_mma.cuh's
//    MN-major descriptor serves 16-bit types alone). Two barriers a
//    sub-tile: the raw sub-tile is in, then the conversion is;
//  * S = Q K^T by wgmma m64n32k8 .tf32 (A and B from shared memory): for
//    each quarter of Dh (halves at Dh 16) an accumulator of its own takes
//    three chains over the quarter's k-steps, the small products first:
//    Q lo K hi, Q hi K lo, Q hi K hi (int8: Q lo K, Q hi K); the quarters
//    are summed in f32 (tf32::sum_quarters). The tensor cores' f32
//    accumulation inside a chain is not IEEE round-to-nearest, and its
//    error grows with each step added into a large partial sum: with one
//    chain over all of Dh the f32 burst's prefill leg read acc / l
//    9.24e-6 against the 1e-5 gate, with quarters 6.68e-6 (PERF.md, PR
//    19). Then * Dh^-0.5, then * k_scale, the mask and the online softmax
//    in registers in the accumulator layout (quad shuffles);
//  * O_step = P V by wgmma m64n{Dh}k8 .tf32 with pw = p [* v_scale] split
//    into hi and lo in registers (A) against V^T hi and lo (B): pw lo V hi,
//    pw hi V lo, pw hi V hi (int8: pw lo V, pw hi V), into a fresh
//    accumulator; then acc = acc * alpha + O_step in f32 FMA, so the
//    tensor cores' accumulation spans one step and the sum over steps
//    rounds as the plain version's does;
//  * shared memory at Dh 128: Q hi and lo 128 KB, one conversion slot
//    (hi and lo) 32 KB, the raw ring 3 x 16.5 KB: 210.5 KB with 1 KB of
//    alignment slack, one CTA per SM. Registers at Dh 128: O and O_step
//    (64 each), p (16) and the A fragments (32) while P V runs, S's four
//    accumulators (64) while Q K^T does; ptxas' registers, shared memory
//    and spills are printed by chip_smoke.py's build phase (no spill in
//    any instance).
// The tensor cores idle while a sub-tile is split and at its two
// barriers; a producer warpgroup that splits while the consumers multiply
// is the next design (flash_attention_f32.cu's notes, PERF.md, PR 19).
// Times: PERF.md (chip_smoke.py, NVIDIA H100 80GB HBM3).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_mma.cuh"
#include "hopper_tf32.cuh"

namespace {

using namespace hopper;
using hopper::tf32::i8x4_to_f32;

constexpr float NEG_INF = -1e30f;  // the JAX package's mask fill
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_BLOCK = 64;  // the largest pool block the wrapper takes

constexpr int NT = 128;  // threads per CTA: 4 warps
constexpr int TK = 32;   // pool positions per step
constexpr int NS = 3;    // cp.async ring stages

// The 16 bytes at `p` (4 f32 or 16 int8 values) as f32.
template <typename KV>
__device__ __forceinline__ void chunk_to_f32(const uint8_t* p, float* out) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (std::is_same_v<KV, int8_t>)
      i8x4_to_f32(ws[i], out + 4 * i);
    else
      out[i] = __uint_as_float(ws[i]);
  }
}

// DPL consecutive values of one V row (at `p`) as f32.
template <typename KV, int DPL>
__device__ __forceinline__ void load_vals(const uint8_t* p, float (&out)[DPL]) {
  if constexpr (std::is_same_v<KV, float>) {
    if constexpr (DPL == 4) {
      const float4 w = *reinterpret_cast<const float4*>(p);
      out[0] = w.x; out[1] = w.y; out[2] = w.z; out[3] = w.w;
    } else {
      const float2 w = *reinterpret_cast<const float2*>(p);
      out[0] = w.x; out[1] = w.y;
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

template <int DH, int TR, typename KV>
struct Geom {
  static constexpr int KROW = DH * sizeof(KV) + 16;  // padded: banks spread
  static constexpr int VROW = DH * sizeof(KV);
  static constexpr int STAGE = TK * (KROW + VROW);
  static constexpr int RPW = TR / 4;  // query rows per warp
  static constexpr int SMEM = TR * DH * 4 + NS * STAGE + 4 * TK * RPW * 4;
};

// Issues the cp.async copies of the K and V rows of the pool positions
// pos0 + c, c < TK, of the slot whose table row is `trow`. Positions at or
// past pos_end are zero-filled and read nothing.
template <int DH, typename KV>
__device__ __forceinline__ void issue_step(
    uint32_t k_st, uint32_t v_st, const KV* __restrict__ k_pool,
    const KV* __restrict__ v_pool, const int32_t* __restrict__ trow,
    int pos0, int pos_end, int block, int h, int Hkv) {
  using G = Geom<DH, 4, KV>;
  constexpr int CPR = DH * static_cast<int>(sizeof(KV)) / 16;
  constexpr int TOTAL = TK * CPR;
  constexpr int EPC = 16 / static_cast<int>(sizeof(KV));  // elements per chunk
#pragma unroll
  for (int u = 0; u < (TOTAL + NT - 1) / NT; ++u) {
    const int i = threadIdx.x + u * NT;
    if (TOTAL % NT == 0 || i < TOTAL) {
      const int c = i / CPR, ch = i % CPR, t = pos0 + c;
      const bool live = t < pos_end;
      int64_t at = 0;
      if (live) {
        const int bid = __ldg(trow + t / block);
        at = ((static_cast<int64_t>(bid) * Hkv + h) * block + t % block) *
                 DH + ch * EPC;
      }
      cp_async16(k_st + c * G::KROW + ch * 16, k_pool + at, live ? 16 : 0);
      cp_async16(v_st + c * G::VROW + ch * 16, v_pool + at, live ? 16 : 0);
    }
  }
}

template <int DH, int TR, typename KV, bool QUANT>
__global__ void __launch_bounds__(NT, 1) rpa_f32_kernel(
    const float* __restrict__ q,                // [B, Sq, Hkv, G, DH]
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
  using GM = Geom<DH, TR, KV>;
  constexpr int RPW = GM::RPW;
  constexpr int DPL = DH >= 64 ? DH / 32 : 2;  // value columns per lane
  constexpr int LD = DH / DPL;                 // lanes per row (32 or 8)
  constexpr int CG = 32 / LD;                  // column groups of P V
  constexpr int VEC = 16 / static_cast<int>(sizeof(KV));
  static_assert(TR % 4 == 0 && TR <= 32, "rows per warp");

  extern __shared__ __align__(16) uint8_t smem[];
  float* q_s = reinterpret_cast<float*>(smem);  // [TR][DH] f32
  uint8_t* ring = smem + TR * DH * 4;           // NS x (K rows, V rows)
  float* p_s = reinterpret_cast<float*>(ring + NS * GM::STAGE);

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
      for (int i = threadIdx.x; i < nr; i += NT) {
        m_out[out_row0 + i] = NEG_INF;
        l_out[out_row0 + i] = 0.f;
      }
      for (int i = threadIdx.x; i < nr * DH; i += NT)
        acc_out[out_row0 * DH + i] = 0.f;
    }
    return;
  }
  const int q_end = min(p0 + span, pos_end);
  const int n_steps = (q_end - p0 + TK - 1) / TK;
  int bnd[RPW];
#pragma unroll
  for (int v = 0; v < RPW; ++v) bnd[v] = __shfl_sync(FULL, my_b, warp + 4 * v);

  const int32_t* trow = table + static_cast<int64_t>(b) * nbs;
  const uint32_t ring_u = smem_u32(ring);
  auto issue = [&](int i) {
    if (i < n_steps) {
      const uint32_t st = ring_u + (i % NS) * GM::STAGE;
      issue_step<DH, KV>(st, st + TK * GM::KROW, k_pool, v_pool, trow,
                         p0 + i * TK, q_end, block, h, Hkv);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) issue(i);

  // Query rows (zeros past R), published by the first step's barrier.
  for (int i = threadIdx.x; i < TR * DH / 4; i += NT) {
    const int r = i / (DH / 4), ch = i % (DH / 4), rr = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (rr < R) {
      const int g = rr / Sq, s = rr % Sq;
      x = *reinterpret_cast<const float4*>(
          q + ((static_cast<int64_t>(b) * Sq + s) * Hkv + h) * G * DH +
          static_cast<int64_t>(g) * DH + ch * 4);
    }
    reinterpret_cast<float4*>(q_s + r * DH)[ch] = x;
  }

  // int8: the scales of this lane's column, loaded one step ahead.
  float ks = 0.f, vs = 0.f;
  auto load_scales = [&](int i, float& kn, float& vn) {
    const int t = p0 + i * TK + lane;
    kn = vn = 0.f;
    if (i < n_steps && t < q_end) {
      const int64_t at =
          (static_cast<int64_t>(__ldg(trow + t / block)) * Hkv + h) * block +
          t % block;
      kn = __bfloat162float(k_scale[at]);
      vn = __bfloat162float(v_scale[at]);
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
  float* pw_s = p_s + warp * TK * RPW;  // this warp's p, [TK][RPW]
  const int cgp = lane / LD, dl = lane % LD;

  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // step i is in; every warp is done with step i - 1
    issue(i + NS - 1);
    float ksn = 0.f, vsn = 0.f;
    if constexpr (QUANT) load_scales(i + 1, ksn, vsn);
    const uint8_t* kst = ring + (i % NS) * GM::STAGE;
    const uint8_t* vst = kst + TK * GM::KROW;

    // Score of column `lane` for the warp's rows: one FMA chain over d.
    float s[RPW];
#pragma unroll
    for (int v = 0; v < RPW; ++v) s[v] = 0.f;
#pragma unroll 4
    for (int ch = 0; ch < DH / VEC; ++ch) {
      float kf[VEC];
      chunk_to_f32<KV>(kst + lane * GM::KROW + ch * 16, kf);
#pragma unroll
      for (int v = 0; v < RPW; ++v) {
        const float4* qv = reinterpret_cast<const float4*>(
            q_s + (warp + 4 * v) * DH + ch * VEC);
        float a = s[v];
#pragma unroll
        for (int t4 = 0; t4 < VEC / 4; ++t4) {
          const float4 x = qv[t4];
          a = fmaf(x.x, kf[4 * t4], a);
          a = fmaf(x.y, kf[4 * t4 + 1], a);
          a = fmaf(x.z, kf[4 * t4 + 2], a);
          a = fmaf(x.w, kf[4 * t4 + 3], a);
        }
        s[v] = a;
      }
    }

    // Online softmax, one row per shuffle reduction.
    const int pos0 = p0 + i * TK;
    const int lim = min(TK, q_end - pos0);  // this split's positions
#pragma unroll
    for (int v = 0; v < RPW; ++v) {
      const bool live = lane < lim && pos0 + lane < bnd[v];
      float x = __fmul_rn(s[v], inv_sqrt_dh);
      if constexpr (QUANT) x = __fmul_rn(x, ks);
      x = live ? x : NEG_INF;
      float rmx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        rmx = fmaxf(rmx, __shfl_xor_sync(FULL, rmx, off));
      const float m_new = fmaxf(m_r[v], rmx);
      const float alpha = expf(m_r[v] - m_new);
      const float p = live ? expf(x - m_new) : 0.f;
      pw_s[lane * RPW + v] = QUANT ? p * vs : p;
      float sum = p;
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
      load_vals<KV, DPL>(vst + c * GM::VROW + dl * DPL * sizeof(KV), vf);
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
      ks = ksn;
      vs = vsn;
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
// i holds positions [i * span, (i + 1) * span) and is live for a row iff
// i * span < bound; only live splits are read.
template <int DH>
__global__ void __launch_bounds__(128) rpa_f32_merge_kernel(
    const float* __restrict__ ws_m, const float* __restrict__ ws_l,
    const float* __restrict__ ws_acc, const int32_t* __restrict__ bound,
    float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ acc_out, int n_rows, int R, int Sq, int Hkv,
    int n_split, int span) {
  constexpr int DPL = DH >= 32 ? DH / 32 : 1;
  const int row = blockIdx.x * 4 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const int bh = row / R, r = row % R;
  const int bnd = bound[static_cast<int64_t>(bh / Hkv) * Sq + r % Sq];
  const int n_live = bnd > 0 ? min(n_split, (bnd + span - 1) / span) : 0;
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
// Tensor-core route (R >= 64): 3xTF32 wgmma
// ---------------------------------------------------------------------------

constexpr int TC_NT = 256;  // two consumer warpgroups
constexpr int TC_BQ = 128;  // query rows per CTA, 64 per warpgroup
constexpr int TC_TK = 32;   // pool positions per step (a K and a V sub-tile)
constexpr int TC_NS = 3;    // raw sub-tiles in the cp.async ring

template <int DH, typename KV>
struct TcGeom {
  static constexpr bool QUANT = std::is_same_v<KV, int8_t>;
  static constexpr int Q_TILE = TC_BQ * DH * 4;        // Q hi, or Q lo
  static constexpr int SUB = TC_TK * DH * 4;           // a K or V^T tile
  static constexpr int CONV = QUANT ? SUB : 2 * SUB;   // hi (and lo)
  static constexpr int RAW_ROW = DH * static_cast<int>(sizeof(KV)) + 16;
  static constexpr int RAW = TC_TK * RAW_ROW;          // one raw sub-tile
  static constexpr int SCALES = QUANT ? 2 * TC_TK * 4 : 0;
  static constexpr int SMEM = 2 * Q_TILE + CONV + TC_NS * RAW + SCALES + 1024;
};

template <int DH, typename KV>
__global__ void __launch_bounds__(TC_NT, 1) rpa_f32_tc_kernel(
    const float* __restrict__ q,                // [B, Sq, Hkv, G, DH]
    const KV* __restrict__ k_pool,              // [NB, Hkv, block, DH]
    const KV* __restrict__ v_pool,              // [NB, Hkv, block, DH]
    const __nv_bfloat16* __restrict__ k_scale,  // [NB, Hkv, block] or null
    const __nv_bfloat16* __restrict__ v_scale,  // [NB, Hkv, block] or null
    const int32_t* __restrict__ table,          // [B, nbs]
    const int32_t* __restrict__ bound,          // [B, Sq]
    float* __restrict__ m_out,                  // [B * Hkv, R]
    float* __restrict__ l_out,                  // [B * Hkv, R]
    float* __restrict__ acc_out,                // [B * Hkv, R, DH]
    int Sq, int Hkv, int G, int block, int nbs, float inv_sqrt_dh) {
  using TG = TcGeom<DH, KV>;
  constexpr bool QUANT = TG::QUANT;
  constexpr int QRB = DH * 4;     // bytes of a Q or K row (TF32)
  constexpr int VRB = TC_TK * 4;  // bytes of a V^T row
  constexpr int NO = DH / 8;      // n-blocks of 8 columns in O
  constexpr int KQ = DH / 8;      // k-steps of Q K^T
  constexpr int KP = TC_TK / 8;   // k-steps of P V
  constexpr int NQA = KQ < 4 ? KQ : 4;  // S accumulators (see sum_quarters)
  constexpr int KPA = KQ / NQA;          // k-steps in each
  constexpr int EPC = 16 / static_cast<int>(sizeof(KV));  // values a chunk
  constexpr int CPR = DH / EPC;   // 16-byte chunks of a raw row
  static_assert(TC_TK == 32, "convert() stages 32-position sub-tiles");
  using namespace tf32;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t sQh = (raw0 + 1023) & ~1023u;
  const uint32_t sQl = sQh + TG::Q_TILE;
  const uint32_t sC = sQl + TG::Q_TILE;  // the conversion slot: hi, then lo
  const uint32_t sRaw = sC + TG::CONV;
  const uint8_t* raw_g = smem_raw + (sRaw - raw0);
  float* ks_s = reinterpret_cast<float*>(smem_raw +
                                         (sRaw + TC_NS * TG::RAW - raw0));
  float* vs_s = ks_s + TC_TK;

  const int bh = blockIdx.x, b = bh / Hkv, h = bh % Hkv;
  const int R = G * Sq, row0 = blockIdx.y * TC_BQ;
  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int64_t out0 = static_cast<int64_t>(bh) * R + row0;
  const int n_rows = min(TC_BQ, R - row0);
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
    for (int i = tid; i < n_rows; i += TC_NT) {
      m_out[out0 + i] = NEG_INF;
      l_out[out0 + i] = 0.f;
    }
    float4* a4 = reinterpret_cast<float4*>(acc_out + out0 * DH);
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = tid; i < n_rows * DH / 4; i += TC_NT) __stcs(a4 + i, z);
    return;
  }
  const int pos_end = min(tmx, nbs * block);  // the tile's walk
  const int n_steps = (pos_end + TC_TK - 1) / TC_TK;
  const int w_steps = (min(wmx, pos_end) + TC_TK - 1) / TC_TK;
  const int32_t* trow = table + static_cast<int64_t>(b) * nbs;

  // Raw sub-tile u (K of step u / 2 when u is even, else V) into ring
  // stage u % TC_NS; positions past the walk are zero-filled. One copy
  // group per u, empty past the end.
  auto issue = [&](int u) {
    if (u < 2 * n_steps) {
      const KV* pool = (u & 1) ? v_pool : k_pool;
      const int pos0 = (u >> 1) * TC_TK;
      const uint32_t st = sRaw + (u % TC_NS) * TG::RAW;
      constexpr int TOTAL = TC_TK * CPR;
#pragma unroll
      for (int x0 = 0; x0 < TOTAL; x0 += TC_NT) {
        const int x = x0 + tid;
        if (TOTAL % TC_NT == 0 || x < TOTAL) {
          const int c = x / CPR, ch = x % CPR, t = pos0 + c;
          const bool live = t < pos_end;
          int64_t at = 0;
          if (live) {
            const int bid = __ldg(trow + t / block);
            at = ((static_cast<int64_t>(bid) * Hkv + h) * block + t % block) *
                     DH + ch * EPC;
          }
          cp_async16(st + c * TG::RAW_ROW + ch * 16, pool + at,
                     live ? 16 : 0);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int u = 0; u < TC_NS - 1; ++u) issue(u);

  // Q rows (zeros past R), split into the hi and lo tiles; published by
  // the first sub-tile's barriers.
  for (int x = tid; x < TC_BQ * (DH / 4); x += TC_NT) {
    const int r = x / (DH / 4), ch = x % (DH / 4), rr = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (rr < R)
      v = *reinterpret_cast<const float4*>(
          q + ((static_cast<int64_t>(b) * Sq + rr % Sq) * Hkv + h) * G * DH +
          static_cast<int64_t>(rr / Sq) * DH + ch * 4);
    float hi[4], lo[4];
    split(v.x, hi[0], lo[0]);
    split(v.y, hi[1], lo[1]);
    split(v.z, hi[2], lo[2]);
    split(v.w, hi[3], lo[3]);
    const uint32_t off = offset<QRB>(r, ch, TC_BQ);
    st_v4(sQh + off, hi[0], hi[1], hi[2], hi[3]);
    st_v4(sQl + off, lo[0], lo[1], lo[2], lo[3]);
  }

  // int8: the scales of position tid of the next step (tid < TC_TK), in
  // registers one step ahead, written to shared memory by the conversion.
  float ks_r = 0.f, vs_r = 0.f;
  auto load_scales = [&](int i) {
    ks_r = vs_r = 0.f;
    const int t = i * TC_TK + tid;
    if (tid < TC_TK && i < n_steps && t < pos_end) {
      const int64_t at =
          (static_cast<int64_t>(__ldg(trow + t / block)) * Hkv + h) * block +
          t % block;
      ks_r = __bfloat162float(k_scale[at]);
      vs_r = __bfloat162float(v_scale[at]);
    }
  };
  if constexpr (QUANT) load_scales(0);

  // Accumulator layout: rows ra and ra + 8 of the warpgroup's 64; in each
  // 8-column n-block j, the keys 8 j + t4 and 8 j + t4 + 4 (kperm).
  const int ra = 16 * warp + lane / 4, t4 = lane % 4;
  const int row_a = row0 + 64 * wg + ra, row_b = row_a + 8;
  const int lim_a = min(row_a < R ? brow[row_a % Sq] : 0, pos_end);
  const int lim_b = min(row_b < R ? brow[row_b % Sq] : 0, pos_end);

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF;  // running max of rows ra, ra + 8
  float l_a = 0.f, l_b = 0.f;          // this thread's share of their sums
  float alpha_a = 1.f, alpha_b = 1.f;  // this step's rescale
  float p[16];                         // this step's p, S's layout

  for (int i = 0; i < n_steps; ++i) {
#pragma unroll
    for (int kind = 0; kind < 2; ++kind) {  // the K, then the V sub-tile
      const int u = 2 * i + kind;
      cp_async_wait<TC_NS - 2>();
      __syncthreads();  // raw u is in; everyone is done with the slot
      {  // raw u -> the conversion slot
        const uint8_t* rs_ = raw_g + (u % TC_NS) * TG::RAW;
        if (kind == 0)
          convert<DH, KV, TC_NT, TG::RAW_ROW, false>(rs_, sC);
        else
          convert<DH, KV, TC_NT, TG::RAW_ROW, true>(rs_, sC);
        if constexpr (QUANT) {
          if (kind == 0 && tid < TC_TK) ks_s[tid] = ks_r;
          if (kind == 1) {
            if (tid < TC_TK) vs_s[tid] = vs_r;
            load_scales(i + 1);
          }
        }
      }
      fence_proxy_async();
      __syncthreads();  // the slot is in; raw stage u % TC_NS is free
      issue(u + TC_NS - 1);
      if (i >= w_steps) continue;  // warpgroup-uniform: all its rows done

      if (kind == 0) {
        // S = Q K^T: Q lo K hi, Q hi K lo, Q hi K hi (int8: Q lo K, Q hi K)
        // in NQA accumulators of KQ / NQA k-steps each, summed in f32.
        const uint32_t qh = sQh + 64 * wg * Layout<QRB>::ROWB;
        const uint32_t ql = sQl + 64 * wg * Layout<QRB>::ROWB;
        float sa[NQA][16];
        wgmma_fence();
#pragma unroll
        for (int a = 0; a < NQA; ++a) {
#pragma unroll
          for (int kk = a * KPA; kk < (a + 1) * KPA; ++kk)
            ss_n32(sa[a], kdesc<QRB>(ql, TC_BQ, kk),
                   kdesc<QRB>(sC, TC_TK, kk), kk - a * KPA);
          if constexpr (!QUANT) {
#pragma unroll
            for (int kk = a * KPA; kk < (a + 1) * KPA; ++kk)
              ss_n32(sa[a], kdesc<QRB>(qh, TC_BQ, kk),
                     kdesc<QRB>(sC + TG::SUB, TC_TK, kk), 1);
          }
#pragma unroll
          for (int kk = a * KPA; kk < (a + 1) * KPA; ++kk)
            ss_n32(sa[a], kdesc<QRB>(qh, TC_BQ, kk),
                   kdesc<QRB>(sC, TC_TK, kk), 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        float s[16];
#pragma unroll
        for (int x = 0; x < 16; ++x) {
#pragma unroll
          for (int a = 0; a < NQA; ++a) pin(sa[a][x]);
          s[x] = sum_quarters<NQA>(sa, x);
        }

        // Scale, then k_scale, then the mask; the online softmax.
        const int pos0 = i * TC_TK;
        float mx_a = m_a, mx_b = m_b;
#pragma unroll
        for (int jl = 0; jl < 4; ++jl)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& x = s[4 * jl + e];
            const int key = 8 * jl + t4 + 4 * (e & 1);
            x = __fmul_rn(x, inv_sqrt_dh);
            if constexpr (QUANT) x = __fmul_rn(x, ks_s[key]);
            const bool live = pos0 + key < (e < 2 ? lim_a : lim_b);
            x = live ? x : NEG_INF;
            if (e < 2) mx_a = fmaxf(mx_a, x);
            else mx_b = fmaxf(mx_b, x);
          }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx_a = fmaxf(mx_a, __shfl_xor_sync(FULL, mx_a, off));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(FULL, mx_b, off));
        }
        alpha_a = expf(m_a - mx_a);
        alpha_b = expf(m_b - mx_b);
        m_a = mx_a;
        m_b = mx_b;
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int jl = 0; jl < 4; ++jl)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = 8 * jl + t4 + 4 * (e & 1);
            const bool live = pos0 + key < (e < 2 ? lim_a : lim_b);
            const float pe =
                live ? expf(s[4 * jl + e] - (e < 2 ? mx_a : mx_b)) : 0.f;
            if (e < 2) sum_a += pe;
            else sum_b += pe;
            p[4 * jl + e] = pe;
          }
        l_a = alpha_a * l_a + sum_a;
        l_b = alpha_b * l_b + sum_b;
      } else {
        // pw = p [* v_scale] as hi and lo A fragments; O_step = pw lo V hi
        // + pw hi V lo + pw hi V hi (int8: pw lo V + pw hi V).
        uint32_t fh[KP][4], fl[KP][4];
#pragma unroll
        for (int jl = 0; jl < KP; ++jl) {
          float x[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            x[e] = p[4 * jl + e];
            if constexpr (QUANT) x[e] *= vs_s[8 * jl + t4 + 4 * (e & 1)];
          }
          frag_split(x, fh[jl], fl[jl]);
        }
        float os[DH / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KP; ++kk)
          rs<DH>(os, fl[kk], kdesc<VRB>(sC, DH, kk), kk);
        if constexpr (!QUANT) {
#pragma unroll
          for (int kk = 0; kk < KP; ++kk)
            rs<DH>(os, fh[kk], kdesc<VRB>(sC + TG::SUB, DH, kk), 1);
        }
#pragma unroll
        for (int kk = 0; kk < KP; ++kk)
          rs<DH>(os, fh[kk], kdesc<VRB>(sC, DH, kk), 1);
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int kk = 0; kk < KP; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pin(fh[kk][e]);
            pin(fl[kk][e]);
          }
#pragma unroll
        for (int jn = 0; jn < NO; ++jn) {
#pragma unroll
          for (int e = 0; e < 4; ++e) pin(os[4 * jn + e]);
          o[4 * jn] = fmaf(o[4 * jn], alpha_a, os[4 * jn]);
          o[4 * jn + 1] = fmaf(o[4 * jn + 1], alpha_a, os[4 * jn + 1]);
          o[4 * jn + 2] = fmaf(o[4 * jn + 2], alpha_b, os[4 * jn + 2]);
          o[4 * jn + 3] = fmaf(o[4 * jn + 3], alpha_b, os[4 * jn + 3]);
        }
      }
    }
  }

  // The quad's partial sums, then the partials of rows ra and ra + 8.
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(FULL, l_a, off);
    l_b += __shfl_xor_sync(FULL, l_b, off);
  }
  const int64_t oa = static_cast<int64_t>(bh) * R + row_a;
  const int cq = 2 * t4;
  if (row_a < R) {
    if (t4 == 0) {
      m_out[oa] = m_a;
      l_out[oa] = l_a;
    }
#pragma unroll
    for (int jn = 0; jn < NO; ++jn)
      __stcs(reinterpret_cast<float2*>(acc_out + oa * DH + 8 * jn + cq),
             make_float2(o[4 * jn], o[4 * jn + 1]));
  }
  if (row_b < R) {
    if (t4 == 0) {
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
cudaError_t launch(const Args& a) {
  constexpr int smem = Geom<DH, TR, KV>::SMEM;
  constexpr auto kern = rpa_f32_kernel<DH, TR, KV, QUANT>;
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
  kern<<<grid, NT, smem, a.st>>>(
      static_cast<const float*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const __nv_bfloat16*>(a.ks),
      static_cast<const __nv_bfloat16*>(a.vs),
      static_cast<const int32_t*>(a.table),
      static_cast<const int32_t*>(a.bound), m, l, acc, a.Sq, a.Hkv, a.G,
      a.block, a.nbs, a.span, 1.0f / sqrtf(static_cast<float>(DH)));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !split) return e;
  const int n_rows = a.B * a.Hkv * R;
  rpa_f32_merge_kernel<DH><<<(n_rows + 3) / 4, 128, 0, a.st>>>(
      m, l, acc, static_cast<const int32_t*>(a.bound),
      static_cast<float*>(a.m), static_cast<float*>(a.l),
      static_cast<float*>(a.acc), n_rows, R, a.Sq, a.Hkv, a.n_split,
      a.span);
  return cudaGetLastError();
}

template <int DH, typename KV, bool QUANT>
cudaError_t launch_rows(const Args& a) {
  const int R = a.G * a.Sq;
  if (R <= 4) return launch<DH, 4, KV, QUANT>(a);
  if (R <= 16) return launch<DH, 16, KV, QUANT>(a);
  return launch<DH, 32, KV, QUANT>(a);
}

template <int DH, typename KV>
cudaError_t launch_tc(const Args& a) {
  constexpr int smem = TcGeom<DH, KV>::SMEM;
  constexpr auto kern = rpa_f32_tc_kernel<DH, KV>;
  const cudaError_t e = allow_smem<kern>(smem);
  if (e != cudaSuccess) return e;
  const int R = a.G * a.Sq;
  const dim3 grid(a.B * a.Hkv, (R + TC_BQ - 1) / TC_BQ);
  kern<<<grid, TC_NT, smem, a.st>>>(
      static_cast<const float*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const __nv_bfloat16*>(a.ks),
      static_cast<const __nv_bfloat16*>(a.vs),
      static_cast<const int32_t*>(a.table),
      static_cast<const int32_t*>(a.bound), static_cast<float*>(a.m),
      static_cast<float*>(a.l), static_cast<float*>(a.acc), a.Sq, a.Hkv, a.G,
      a.block, a.nbs, 1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dh(const Args& a, int quantized) {
  if (a.G * a.Sq >= 64) {
    if (quantized) return launch_tc<DH, int8_t>(a);
    return launch_tc<DH, float>(a);
  }
  if (quantized) return launch_rows<DH, int8_t, true>(a);
  return launch_rows<DH, float, false>(a);
}

}  // namespace

// C entry point, loaded with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 = launched); cudaErrorInvalidValue for a head dim,
// block size or split plan the kernel does not take. q is f32; the pool is
// f32 (quantized = 0) or int8 with bf16 scales (quantized = 1). R = G * Sq
// < 64: `n_split` splits of `span` positions (span a whole number of the
// 32-position steps, n_split = ceil(nbs * block / span)), and with more
// than one split `workspace` holds B * Hkv * n_split * R * (Dh + 2) f32
// (acc, then m, then l). R >= 64 runs the tensor-core route: n_split = 1,
// span >= nbs * block, no workspace.
extern "C" int rpa_f32_partials(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const void* table, const void* bound, void* m,
                                void* l, void* acc, void* workspace, int B,
                                int Sq, int Hkv, int G, int Dh, int block,
                                int nbs, int NB, int quantized, int n_split,
                                int span, void* stream) {
  if (block < 1 || block > MAX_BLOCK || B < 1 || Sq < 1 || Hkv < 1 ||
      G < 1 || nbs < 1 || NB < 1 || n_split < 1 || span < 1 ||
      static_cast<int64_t>(B) * Hkv > 2147483647)
    return static_cast<int>(cudaErrorInvalidValue);
  const int R = G * Sq;
  const int64_t positions = static_cast<int64_t>(nbs) * block;
  if (R < 64) {
    if (span % TK != 0 || n_split != (positions + span - 1) / span ||
        n_split > 65535 || (n_split > 1 && workspace == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (n_split != 1 || span < positions ||
             (R + TC_BQ - 1) / TC_BQ > 65535) {
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

// The dynamic shared memory of the tensor-core route's instance for a
// head dim and pool (bytes; -1 for one it does not have), for reports.
extern "C" int rpa_f32_tc_smem_bytes(int Dh, int quantized) {
  switch (Dh) {
    case 16:
      return quantized ? TcGeom<16, int8_t>::SMEM : TcGeom<16, float>::SMEM;
    case 64:
      return quantized ? TcGeom<64, int8_t>::SMEM : TcGeom<64, float>::SMEM;
    case 128:
      return quantized ? TcGeom<128, int8_t>::SMEM
                       : TcGeom<128, float>::SMEM;
    default:
      return -1;
  }
}
