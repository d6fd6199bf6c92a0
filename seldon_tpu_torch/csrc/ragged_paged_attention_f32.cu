// Ragged paged-attention partials for f32 queries on Hopper's CUDA cores
// (sm_90a).
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
// All of the math runs in f32 FMA on the CUDA cores: no TF32 and no bf16
// tensor-core products. TF32 keeps ~10 mantissa bits, far from what the
// JAX package computes in f32 and from the 1e-5 this route is held to.
//
// What bounds it on this card: at decode row counts (R = G * Sq < 64; the
// serving decode wave has R = 4) bytes, ~2 operations per byte of f32 K/V
// read; at prefill row counts (R = 512) operations, 4 * R * Dh per K/V
// position at the CUDA cores' 67 TFLOP/s. One design serves both, the
// split-KV decode route of ragged_paged_attention.cu with f32 operands:
//  * the grid is (B * Hkv, n_split, tiles of TR query rows), TR in 4, 16,
//    32 by R. Below 64 rows the walk is cut into splits of span = 128
//    positions (n_split from the table's width, never from `bound`) and
//    rpa_f32_merge_kernel, launched right after by the same entry-point
//    call, folds the live splits of each row:
//      m = max m_i, l = sum l_i e^(m_i - m), acc = sum acc_i e^(m_i - m),
//    rows with no live split exactly (NEG_INF, 0, 0). From 64 rows up the
//    row tiles alone fill the card (R = 512 at 32 slots x 8 heads: 4096
//    CTAs) and one split walks the whole slot, so no workspace is needed;
//  * a CTA reads its rows' bounds first and exits at once when its range
//    starts past all of them;
//  * steps of 32 positions gathered through the table by cp.async 16-byte
//    copies in a 3-stage ring (steps j + 1 and j + 2 in flight while step j
//    is computed, one CTA barrier per step); K rows padded by 16 bytes so a
//    warp's 16-byte reads of 32 rows hit all banks. 120 KB of shared memory
//    at Dh 128, f32 pool, TR 32 (one CTA per SM), 100 KB at TR 4 (two);
//  * 4 warps, each owning TR / 4 query rows: lane c holds the score of
//    column c (its dot a chain of Dh FMAs in order of d), the row's max and
//    sum are warp shuffles, p goes through a per-warp buffer in shared
//    memory, and in the value product each lane owns Dh / 32 head-dim
//    columns (Dh 16: 8 lanes per row, four column groups folded by
//    shuffles at the end). int8 codes become f32 by a byte permute and
//    one add; their bf16 scales are loaded one step ahead.
// Making it fast (e.g. 3xTF32 splits on wgmma at prefill row counts) is
// later work. Times: PERF.md (chip_smoke.py, NVIDIA H100 80GB HBM3).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_mma.cuh"

namespace {

using namespace hopper;

constexpr float NEG_INF = -1e30f;  // the JAX package's mask fill
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_BLOCK = 64;  // the largest pool block the wrapper takes

constexpr int NT = 128;  // threads per CTA: 4 warps
constexpr int TK = 32;   // pool positions per step
constexpr int NS = 3;    // cp.async ring stages

// Four int8 codes (one 32-bit word, lowest byte first) as exact f32
// without the int-to-float unit: code b + 128 goes into the low mantissa
// bits of 2^23 and the bias is subtracted.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* out) {
  const uint32_t u = w ^ 0x80808080u;  // b + 128, as unsigned bytes
#pragma unroll
  for (int t = 0; t < 4; ++t)
    out[t] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | t)) -
             8388736.f;
}

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

template <int DH>
cudaError_t launch_dh(const Args& a, int quantized) {
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
// (acc, then m, then l). R >= 64: n_split = 1, no workspace.
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
  } else if (n_split != 1 || span < positions || (R + 31) / 32 > 65535) {
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
