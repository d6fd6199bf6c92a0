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
// s_t = (q . k_t) / sqrt(Dh) [* k_scale_t]. int8 pools keep their 1-byte
// codes; the bf16 scales multiply the f32 scores and the probabilities, as
// the TPU kernel applies them. A row with bound = 0 comes out exactly
// (NEG_INF, 0, 0); dead lanes have p re-zeroed, never exp(0).
// The table entries of live columns must be pool block ids in [0, NB)
// (the engine writes only allocator ids and the trash block 0). They are
// not range-checked here: an id out of range is a fault, as it is for the
// plain version's indexing, never a silent read of another block.
//
// What bounds it on this card: the bytes of live K/V it must read from
// device memory (each live block is 2 * block * Dh * elem bytes per KV
// head); its operations, ~4 * rows * live positions * Dh, sit far below
// the bf16 rate at the decode shape. The design against that bound:
//  * one CTA per (slot * kv-head, tile of TR query rows) walks the live
//    block columns itself, from 0 to ceil(max bound over its rows /
//    block), so dead tail columns cost neither bytes nor operations; the
//    table is read in-kernel (no scalar prefetch on this card);
//  * each step stages TK = 64 pool positions (several whole blocks) in
//    shared memory: every thread issues all of its 16-byte loads of K and
//    V before it converts any, so a CTA has 64 positions of K and V in
//    flight per barrier rather than one load per thread; all of the
//    tile's rows reuse them;
//  * scores are register-tiled (each thread an RT x CT patch of the
//    tile), the online-softmax fold of a row is spread over NT / TR
//    threads with warp shuffles, m and l live in shared memory and acc in
//    registers (each thread owns one head-dim column for all TR rows);
//  * decode (Sq = 1) folds the G query heads of one KV head into one tile
//    (R = G rows), so K/V are read once per (slot, kv-head).
// Prefill tiles (R = G * Sq rows, f32 acc of 256 KB for R = 512) are cut
// into TR = 32 rows; each tile re-reads its slot's live blocks, mostly
// from L2. f32 FMA on the CUDA cores; no tensor cores, no cp.async
// pipelining, no split-KV for decode yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;           // threads per CTA
constexpr int TK = 64;            // pool positions staged per step
constexpr float NEG_INF = -1e30f; // the JAX package's mask fill
constexpr int PAD = 4;            // f32 row padding in shared memory

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

// Stage the step's K and V rows (positions c < P: whole blocks j0, j0 + 1,
// ... of the slot's table row) as f32 rows of stride DH + PAD. Every
// thread first issues all of its 16-byte loads, K and V, and only then
// converts and stores them, so a step's loads are in flight together.
// Blocks past the live count are staged as zeros: their lanes are masked,
// and zeros keep 0 * v finite. Rows c >= P are left as they are (masked).
// int8 pools also stage the step's bf16 scales, loaded in the same batch.
template <int DH, typename KV, bool QUANT>
__device__ __forceinline__ void stage_step(
    const KV* __restrict__ k_pool, const KV* __restrict__ v_pool,
    const __nv_bfloat16* __restrict__ k_scale,
    const __nv_bfloat16* __restrict__ v_scale,
    const int32_t* __restrict__ trow, float* __restrict__ k_s,
    float* __restrict__ v_s, float* __restrict__ ks_s,
    float* __restrict__ vs_s, int j0, int P, int n_live, int block, int h,
    int Hkv) {
  static_assert(TK <= NT, "one scale per thread");
  constexpr int VEC = 16 / sizeof(KV);  // elements per 16-byte load
  static_assert(DH % VEC == 0 && VEC % 4 == 0, "whole vectors per row");
  constexpr int RV = DH / VEC;          // vectors per row
  constexpr int PER = (TK * RV + NT - 1) / NT;
  uint4 kr[PER], vr[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = threadIdx.x + u * NT, c = i / RV;
    const int j = j0 + c / block;
    kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
    if (c < P && j < n_live) {
      const int bid = trow[j];
      const int64_t at =
          ((static_cast<int64_t>(bid) * Hkv + h) * block + c % block) * DH +
          (i % RV) * VEC;
      kr[u] = *reinterpret_cast<const uint4*>(k_pool + at);
      vr[u] = *reinterpret_cast<const uint4*>(v_pool + at);
    }
  }
  __nv_bfloat16 ks = __float2bfloat16(0.f), vs = ks;
  const int sc = threadIdx.x, sj = j0 + sc / block;  // this thread's scale
  if (QUANT && sc < P && sj < n_live) {
    const int bid = trow[sj];
    const int64_t at = (static_cast<int64_t>(bid) * Hkv + h) * block +
                       sc % block;
    ks = k_scale[at];
    vs = v_scale[at];
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = threadIdx.x + u * NT, c = i / RV;
    if (c < P) {
      const int at = c * (DH + PAD) + (i % RV) * VEC;
      const KV* ke = reinterpret_cast<const KV*>(&kr[u]);
      const KV* ve = reinterpret_cast<const KV*>(&vr[u]);
      float4* kd = reinterpret_cast<float4*>(k_s + at);
      float4* vd = reinterpret_cast<float4*>(v_s + at);
#pragma unroll
      for (int w = 0; w < VEC / 4; ++w) {
        kd[w] = make_float4(to_f32(ke[4 * w]), to_f32(ke[4 * w + 1]),
                            to_f32(ke[4 * w + 2]), to_f32(ke[4 * w + 3]));
        vd[w] = make_float4(to_f32(ve[4 * w]), to_f32(ve[4 * w + 1]),
                            to_f32(ve[4 * w + 2]), to_f32(ve[4 * w + 3]));
      }
    }
  }
  if (QUANT && sc < P) {
    ks_s[sc] = __bfloat162float(ks);
    vs_s[sc] = __bfloat162float(vs);
  }
}

template <int DH, int TR, typename KV, bool QUANT>
__global__ void __launch_bounds__(NT) rpa_partials_kernel(
    const __nv_bfloat16* __restrict__ q,        // [B, Sq, Hkv, G, DH]
    const KV* __restrict__ k_pool,              // [NB, Hkv, block, DH]
    const KV* __restrict__ v_pool,              // [NB, Hkv, block, DH]
    const __nv_bfloat16* __restrict__ k_scale,  // [NB, Hkv, block] or null
    const __nv_bfloat16* __restrict__ v_scale,  // [NB, Hkv, block] or null
    const int32_t* __restrict__ table,          // [B, nbs]
    const int32_t* __restrict__ bound,          // [B, Sq]
    float* __restrict__ m_out,                  // [B, Hkv, G, Sq]
    float* __restrict__ l_out,                  // [B, Hkv, G, Sq]
    float* __restrict__ acc_out,                // [B, Hkv, G, Sq, DH]
    int Sq, int Hkv, int G, int block, int nbs, float inv_sqrt_dh) {
  constexpr int CPT = (DH + NT - 1) / NT;  // acc columns per thread
  constexpr int QS = DH + PAD;
  static_assert(TR % 4 == 0, "p is read as float4 over rows");
  constexpr int TRP = TR + 4;  // p_s row stride: float4 rows, banks spread
  // Score tile per thread: RT rows x CT columns of the TR x TK tile.
  constexpr int CT = TR >= 16 ? 4 : 2;
  constexpr int RT = TR * TK / (NT * CT);
  constexpr int CG = TK / CT;              // column groups
  constexpr int RG = TR / RT;              // row groups
  static_assert(RT >= 1 && RG * CG == NT, "score tiling must cover NT");
  constexpr int W = NT / TR;               // fold threads per row
  static_assert(W <= 32 && 32 % W == 0, "fold groups must sit in a warp");

  extern __shared__ float smem[];
  float* q_s = smem;                     // [TR][QS]
  float* k_s = q_s + TR * QS;            // [TK][QS]
  float* v_s = k_s + TK * QS;            // [TK][QS]
  float* p_s = v_s + TK * QS;            // [TK][TRP] scores, then p
  float* ks_s = p_s + TK * TRP;          // [TK]
  float* vs_s = ks_s + TK;               // [TK]
  float* m_s = vs_s + TK;                // [TR]
  float* l_s = m_s + TR;                 // [TR]
  float* a_s = l_s + TR;                 // [TR] rescale of this step
  int* bnd_s = reinterpret_cast<int*>(a_s + TR);  // [TR]
  __shared__ int n_live_s;

  const int bh = blockIdx.x;
  const int b = bh / Hkv;
  const int h = bh % Hkv;
  const int R = G * Sq;
  const int row0 = blockIdx.y * TR;
  const int tid = threadIdx.x;
  const int32_t* trow = table + static_cast<int64_t>(b) * nbs;

  // Query tile (row r = g * Sq + s of this (b, h)) and its bounds; all of
  // a thread's loads are issued before any is stored.
  {
    constexpr int QPER = (TR * DH + NT - 1) / NT;
    float qv[QPER];
#pragma unroll
    for (int u = 0; u < QPER; ++u) {
      const int i = tid + u * NT, r = i / DH, d = i % DH, rr = row0 + r;
      qv[u] = 0.f;
      if (i < TR * DH && rr < R) {
        const int g = rr / Sq, s = rr % Sq;
        qv[u] = __bfloat162float(
            q[((static_cast<int64_t>(b) * Sq + s) * Hkv + h) * G * DH +
              static_cast<int64_t>(g) * DH + d]);
      }
    }
#pragma unroll
    for (int u = 0; u < QPER; ++u) {
      const int i = tid + u * NT;
      if (i < TR * DH) q_s[(i / DH) * QS + i % DH] = qv[u];
    }
  }
  for (int r = tid; r < TR; r += NT) {
    const int rr = row0 + r;
    bnd_s[r] = rr < R ? bound[static_cast<int64_t>(b) * Sq + rr % Sq] : 0;
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    int mx = 0;
    for (int r = 0; r < TR; ++r) mx = max(mx, bnd_s[r]);
    n_live_s = min((mx + block - 1) / block, nbs);
  }
  __syncthreads();
  const int n_live = n_live_s;
  const int cb = block <= TK ? TK / block : 1;  // whole blocks per step
  const int P = cb * block;                     // positions per step

  float acc[CPT][TR];
#pragma unroll
  for (int c = 0; c < CPT; ++c)
#pragma unroll
    for (int r = 0; r < TR; ++r) acc[c][r] = 0.f;

  const int rg = tid / CG, cg = tid % CG;
  const int fr = tid / W, fl = tid % W;  // fold: row, lane within the row

  for (int j0 = 0; j0 < n_live; j0 += cb) {
    stage_step<DH, KV, QUANT>(k_pool, v_pool, k_scale, v_scale, trow, k_s,
                              v_s, ks_s, vs_s, j0, P, n_live, block, h, Hkv);
    __syncthreads();

    // Scores of the tile: thread (rg, cg) owns rows rg + RG * v and
    // columns cg + CG * u. Step column c is pool position j0 * block + c.
    {
      float dot[RT][CT];
#pragma unroll
      for (int v = 0; v < RT; ++v)
#pragma unroll
        for (int u = 0; u < CT; ++u) dot[v][u] = 0.f;
#pragma unroll 4
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        float4 qv[RT], kv[CT];
#pragma unroll
        for (int v = 0; v < RT; ++v)
          qv[v] = reinterpret_cast<const float4*>(q_s + (rg + RG * v) * QS)[d4];
#pragma unroll
        for (int u = 0; u < CT; ++u)
          kv[u] = reinterpret_cast<const float4*>(k_s + (cg + CG * u) * QS)[d4];
#pragma unroll
        for (int v = 0; v < RT; ++v)
#pragma unroll
          for (int u = 0; u < CT; ++u) {
            float a = dot[v][u];
            a = fmaf(qv[v].x, kv[u].x, a);
            a = fmaf(qv[v].y, kv[u].y, a);
            a = fmaf(qv[v].z, kv[u].z, a);
            a = fmaf(qv[v].w, kv[u].w, a);
            dot[v][u] = a;
          }
      }
      const int pos0 = j0 * block;
#pragma unroll
      for (int v = 0; v < RT; ++v)
#pragma unroll
        for (int u = 0; u < CT; ++u) {
          const int r = rg + RG * v, c = cg + CG * u;
          float s = dot[v][u] * inv_sqrt_dh;
          if (QUANT) s *= ks_s[c];
          const bool live = c < P && pos0 + c < bnd_s[r];
          p_s[c * TRP + r] = live ? s : NEG_INF;
        }
    }
    __syncthreads();

    // Online-softmax fold of this step: W threads per row, shuffles.
    {
      const int pos0 = j0 * block;
      const int bnd = bnd_s[fr];
      float mx = NEG_INF;
      for (int c = fl; c < P; c += W) mx = fmaxf(mx, p_s[c * TRP + fr]);
#pragma unroll
      for (int off = W / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[fr];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = fl; c < P; c += W) {
        float* pc = p_s + c * TRP + fr;
        const float p = pos0 + c < bnd ? expf(*pc - m_new) : 0.f;
        *pc = p;
        sum += p;
      }
#pragma unroll
      for (int off = W / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (fl == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[fr] = l_s[fr] * alpha + sum;
        m_s[fr] = m_new;
        a_s[fr] = alpha;
      }
    }
    __syncthreads();

    // acc[r][d] = acc[r][d] * alpha_r + sum_c p[c][r] [* vs_c] * v[c][d];
    // p is read four rows at a time (one broadcast float4 per 4 FMAs).
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int d = tid + cc * NT;
      if (d < DH) {
        float a[TR];
#pragma unroll
        for (int r = 0; r < TR; ++r) a[r] = acc[cc][r] * a_s[r];
        for (int c = 0; c < P; ++c) {
          const float vd = v_s[c * QS + d];
          const float vsc = QUANT ? vs_s[c] : 1.f;
          const float4* pc = reinterpret_cast<const float4*>(p_s + c * TRP);
#pragma unroll
          for (int r4 = 0; r4 < TR / 4; ++r4) {
            const float4 w = pc[r4];
            a[4 * r4] = fmaf(QUANT ? w.x * vsc : w.x, vd, a[4 * r4]);
            a[4 * r4 + 1] = fmaf(QUANT ? w.y * vsc : w.y, vd, a[4 * r4 + 1]);
            a[4 * r4 + 2] = fmaf(QUANT ? w.z * vsc : w.z, vd, a[4 * r4 + 2]);
            a[4 * r4 + 3] = fmaf(QUANT ? w.w * vsc : w.w, vd, a[4 * r4 + 3]);
          }
        }
#pragma unroll
        for (int r = 0; r < TR; ++r) acc[cc][r] = a[r];
      }
    }
    __syncthreads();  // the next step overwrites the staged rows
  }

  const int64_t out_row0 = static_cast<int64_t>(bh) * R + row0;
  for (int r = tid; r < TR; r += NT) {
    if (row0 + r < R) {
      m_out[out_row0 + r] = m_s[r];
      l_out[out_row0 + r] = l_s[r];
    }
  }
#pragma unroll
  for (int cc = 0; cc < CPT; ++cc) {
    const int d = tid + cc * NT;
    if (d < DH) {
#pragma unroll
      for (int r = 0; r < TR; ++r)
        if (row0 + r < R) acc_out[(out_row0 + r) * DH + d] = acc[cc][r];
    }
  }
}

template <int DH, int TR, typename KV, bool QUANT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* table,
                   const void* bound, void* m, void* l, void* acc, int B,
                   int Sq, int Hkv, int G, int block, int nbs,
                   cudaStream_t stream) {
  const int R = G * Sq;
  const size_t floats = static_cast<size_t>(TR) * (DH + PAD) +
                        2 * static_cast<size_t>(TK) * (DH + PAD) +
                        static_cast<size_t>(TK) * (TR + 4) + 2 * TK + 3 * TR;
  const size_t smem = floats * sizeof(float) + TR * sizeof(int);
  auto kern = rpa_partials_kernel<DH, TR, KV, QUANT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(B * Hkv, (R + TR - 1) / TR);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs),
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(bound),
      static_cast<float*>(m), static_cast<float*>(l),
      static_cast<float*>(acc), Sq, Hkv, G, block, nbs,
      1.0f / sqrtf(static_cast<float>(DH)));
  return cudaGetLastError();
}

template <int DH, typename KV, bool QUANT>
cudaError_t launch_rows(const void* q, const void* k, const void* v,
                        const void* ks, const void* vs, const void* table,
                        const void* bound, void* m, void* l, void* acc,
                        int B, int Sq, int Hkv, int G, int block, int nbs,
                        cudaStream_t st) {
  const int R = G * Sq;
  if (R <= 4)
    return launch<DH, 4, KV, QUANT>(q, k, v, ks, vs, table, bound, m, l, acc,
                                    B, Sq, Hkv, G, block, nbs, st);
  if (R <= 16)
    return launch<DH, 16, KV, QUANT>(q, k, v, ks, vs, table, bound, m, l,
                                     acc, B, Sq, Hkv, G, block, nbs, st);
  return launch<DH, 32, KV, QUANT>(q, k, v, ks, vs, table, bound, m, l, acc,
                                   B, Sq, Hkv, G, block, nbs, st);
}

template <int DH>
cudaError_t launch_dtype(const void* q, const void* k, const void* v,
                         const void* ks, const void* vs, const void* table,
                         const void* bound, void* m, void* l, void* acc,
                         int B, int Sq, int Hkv, int G, int block, int nbs,
                         int quantized, cudaStream_t st) {
  if (quantized)
    return launch_rows<DH, int8_t, true>(q, k, v, ks, vs, table, bound, m, l,
                                         acc, B, Sq, Hkv, G, block, nbs, st);
  return launch_rows<DH, __nv_bfloat16, false>(q, k, v, ks, vs, table, bound,
                                               m, l, acc, B, Sq, Hkv, G,
                                               block, nbs, st);
}

}  // namespace

// C entry point, loaded with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 = launched); cudaErrorInvalidValue for a head dim
// or block size the kernel was not built for.
extern "C" int rpa_partials(const void* q, const void* k, const void* v,
                            const void* k_scale, const void* v_scale,
                            const void* table, const void* bound, void* m,
                            void* l, void* acc, int B, int Sq, int Hkv, int G,
                            int Dh, int block, int nbs, int NB, int quantized,
                            void* stream) {
  if (block < 1 || block > TK || B < 1 || Sq < 1 || Hkv < 1 || G < 1 ||
      nbs < 1 || NB < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 16:
      return launch_dtype<16>(q, k, v, k_scale, v_scale, table, bound, m, l,
                              acc, B, Sq, Hkv, G, block, nbs, quantized,
                              st);
    case 64:
      return launch_dtype<64>(q, k, v, k_scale, v_scale, table, bound, m, l,
                              acc, B, Sq, Hkv, G, block, nbs, quantized,
                              st);
    case 128:
      return launch_dtype<128>(q, k, v, k_scale, v_scale, table, bound, m, l,
                               acc, B, Sq, Hkv, G, block, nbs, quantized,
                               st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
