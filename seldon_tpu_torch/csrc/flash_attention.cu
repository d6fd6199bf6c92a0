// Flash attention forward pass on Hopper's tensor cores (sm_90a), bf16.
//
// Replaces the TPU kernel seldon_tpu/ops/flash_attention.py::_flash_kernel
// (launched by _flash_pallas) for bf16 inputs; f32 inputs run the CUDA-core
// kernel of flash_attention_f32.cu. Contract, identical to the TPU kernel's:
//   q   [B*H,   Sq,  Dh]   bf16
//   k,v [B*Hkv, Skv, Dh]   bf16; query row b reads KV row b / q_per_kv
//   out [B*H,   Sq,  Dh]   bf16
// For each query row i (global position q_offset + i under `causal`):
//   s_j = (q_i . k_j) * Dh^-0.5      dot accumulated in f32, THEN scaled;
//         s_j = -1e30 where causal and q_offset + i < j
//   online softmax over KV blocks of BK = 128 positions (the Pallas
//   block_k), per block: m' = max(m, max_j s_j); p_j = exp(s_j - m');
//   alpha = exp(m - m'); l = alpha * l + sum_j p_j (p unrounded);
//   acc = alpha * acc + sum_j bf16(p_j) * v_j (RNE; products and sums f32);
//   out = bf16(acc / max(l, 1e-30)), one IEEE division per element.
// Those are the TPU kernel's rounding points, kept by the plain version
// (ops/flash_attention.flash_blockwise). Its scores for bf16 on the card
// are the tensor cores' bf16 product with f32 accumulation, chained over
// the Dh / 16 k-steps in order, as here: the scores, and so every p and its
// bf16 rounding, are the same numbers, and the two differ only in the
// order of the value product's and l's f32 sums. (Against scores summed by
// an f32 FMA chain, p's bf16 rounding flips wherever it sits on a knife's
// edge, and a flipped p of large weight moves a small output by more than
// one bf16 ulp.) Q is not pre-scaled (Dh^-0.5 is not a power of two, so a
// scaled bf16 Q would round differently) and the scale is not folded into
// an exp2 (exp2(s * log2e) rounds differently from exp(s)): expf of the
// scaled score, as the TPU kernel and the plain version compute it.
//
// What bounds it on this card: operations. A causal pass does
// 2 * Dh * S * (S + 1) FLOPs per query row against 2 * 2 * S * Dh bytes of
// K/V per KV row; at S = 4096 that is ~1000 operations per byte, far above
// the card's ~295 bf16 operations per byte. The bound is the bf16
// tensor-core rate, and the design is built around `wgmma`:
//  * one CTA of two consumer warpgroups (256 threads) per (query row of
//    B*H, tile of BQ = 128 query rows, 64 per warpgroup) walks the KV
//    blocks of its row (the TPU grid's sequential axis); tiles with the
//    longest causal walk are scheduled first; a warpgroup skips the blocks
//    wholly above its own diagonal and the whole walk when all its rows lie
//    past Sq;
//  * Q is copied once into shared memory as bf16; K and V go into a ring of
//    two stages, as bf16, by cp.async with zero-fill (rows past Skv or Sq
//    read as zeros, never the next head's rows). Every tile is stored in
//    the swizzled layout that wgmma's shared-memory descriptors read: rows
//    of 128 bytes (64 bf16) in 1024-byte atoms, 16-byte chunk c of row r
//    at chunk c ^ (r % 8); at Dh 128 a row spans two such atoms and the
//    tile is stored as two 64-column halves; at Dh 16 rows are 32 bytes
//    with the 32-byte swizzle. Block j + 1's copies are issued right after
//    the step's one barrier and are in flight while block j is computed;
//  * S = Q K^T: wgmma m64n64k16 for each 64-column half, A (Q) and B (K,
//    K-major) from shared memory, f32 accumulators, Dh / 16 chained steps;
//    then the scale;
//  * the softmax runs in registers in the accumulator layout: a thread
//    holds 2 rows x 32 columns, a row's 128 columns sit in the 4 threads of
//    a quad (max: two shuffles; l: per-thread partial sums, reduced once
//    at the end). Masking is applied only on blocks that straddle the
//    diagonal or the Skv tail; masked scores are -1e30, so p underflows to
//    0 and alpha to 1 exactly where a row sees no column;
//  * O += P V: p rounded to bf16 and repacked in registers as the A
//    operand of wgmma m64n{Dh}k16 (the accumulator's layout is the A
//    fragment's, no shuffle); B is the V tile, MN-major (the transpose bit
//    of the instruction; V is not transposed in memory); O stays in f32
//    registers;
//  * shared memory per CTA: (128 + 4 * 128) * Dh * 2 bytes + 1 KB of
//    alignment slack: 161 KB at Dh 128 (one CTA per SM), 81 KB at Dh 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

using namespace hopper;

constexpr int NWG = 2;             // consumer warpgroups per CTA
constexpr int NT = 128 * NWG;      // threads per CTA
constexpr int BQ = 64 * NWG;       // query rows per CTA, 64 per warpgroup
constexpr int BK = 128;            // KV positions per step: the Pallas block_k
constexpr float NEG_INF = -1e30f;  // the JAX package's mask fill

// Shared-memory geometry of the kernel's tiles of rows of DH bf16 (the
// swizzled layout of hopper_mma.cuh).
template <int DH>
struct Geom : Swizzle<DH> {
  static constexpr int Q_BYTES = BQ * DH * 2;
  static constexpr int KV_BYTES = BK * DH * 2;
  static constexpr int SMEM = Q_BYTES + 4 * KV_BYTES + 1024;
};

// ROWS rows of DH bf16 from `src` (row stride DH) into the swizzled tile at
// shared address `dst`; rows >= nvalid are zero-filled.
template <int DH, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          int nvalid) {
  constexpr int CPR = DH / 8, TOTAL = ROWS * CPR;
  static_assert(TOTAL % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int u = 0; u < TOTAL / NT; ++u) {
    const int i = threadIdx.x + u * NT;
    const int r = i / CPR, c = i % CPR;
    const bool live = r < nvalid;
    cp_async16(dst + tile_offset<DH>(r, c, ROWS),
               live ? src + static_cast<int64_t>(r) * DH + c * 8 : src,
               live ? 16 : 0);
  }
}

// S = Q K^T for one 64-column half: `qW` is the warpgroup's Q rows, `kH`
// the half's 64 K rows; DH / 16 chained wgmma steps.
template <int DH>
__device__ __forceinline__ void qk_half(float (&s)[32], uint32_t qW,
                                        uint32_t kH) {
  wgmma_ss_n64<false>(s, kmajor_desc<DH>(qW, BQ, 0),
                      kmajor_desc<DH>(kH, BK, 0));
#pragma unroll
  for (int kk = 1; kk < DH / 16; ++kk)
    wgmma_ss_n64<true>(s, kmajor_desc<DH>(qW, BQ, kk),
                       kmajor_desc<DH>(kH, BK, kk));
}

template <int DH>
__global__ void __launch_bounds__(NT, 1) flash_fwd_wgmma(
    const __nv_bfloat16* __restrict__ q,  // [BH, Sq, DH]
    const __nv_bfloat16* __restrict__ k,  // [BH / q_per_kv, Skv, DH]
    const __nv_bfloat16* __restrict__ v,  // [BH / q_per_kv, Skv, DH]
    __nv_bfloat16* __restrict__ out,      // [BH, Sq, DH]
    int Sq, int Skv, int q_per_kv, int causal, int q_offset, float scale) {
  using G = Geom<DH>;
  constexpr int NO = DH / 8;   // n-blocks of 8 columns in O
  constexpr int KP = BK / 16;  // k-steps of P V

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + G::Q_BYTES;       // stage s at sK + s * KV_BYTES
  const uint32_t sV = sK + 2 * G::KV_BYTES;  // stage s at sV + s * KV_BYTES

  const int bh = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // long walks first
  const int n_rows = min(BQ, Sq - row0);
  const int64_t kv_base = static_cast<int64_t>(bh / q_per_kv) * Skv * DH;

  // This thread's warpgroup, its rows, and the KV blocks each one walks:
  // the CTA to its last row's diagonal, the warpgroup to its own.
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int wrow0 = row0 + 64 * wg;
  const int wrows = min(64, Sq - wrow0);  // <= 0: no live row
  int last_col = Skv - 1;
  if (causal) last_col = min(last_col, q_offset + row0 + n_rows - 1);
  const int n_steps = last_col / BK + 1;
  int w_steps = 0;
  if (wrows > 0) {
    int wl = Skv - 1;
    if (causal) wl = min(wl, q_offset + wrow0 + wrows - 1);
    w_steps = wl / BK + 1;
  }
  // Accumulator layout: rows ra and ra + 8 of the warpgroup's 64; in each
  // 8-column n-block, columns cq and cq + 1.
  const int ra = 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const int qpos_a = q_offset + wrow0 + ra, qpos_b = qpos_a + 8;

  load_tile<DH, BQ>(sQ, q + (static_cast<int64_t>(bh) * Sq + row0) * DH,
                    n_rows);
  load_tile<DH, BK>(sK, k + kv_base, min(BK, Skv));
  load_tile<DH, BK>(sV, v + kv_base, min(BK, Skv));
  cp_async_commit();

  // S in two 64-column halves: s[h][4 jl + e] is in n-block 8 h + jl.
  float s[2][32];
  float o[DH / 2];
  uint32_t pf[KP][4];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF;  // running max of rows ra, ra + 8
  float l_a = 0.f, l_b = 0.f;          // this thread's share of their sums

  for (int j = 0; j < n_steps; ++j) {
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();  // block j is in; everyone is done with block j - 1
    const int stage = j & 1;
    if (j + 1 < n_steps) {  // block j + 1 into the stage block j - 1 used
      const int c1 = (j + 1) * BK;
      const int64_t off = kv_base + static_cast<int64_t>(c1) * DH;
      load_tile<DH, BK>(sK + (stage ^ 1) * G::KV_BYTES, k + off,
                        min(BK, Skv - c1));
      load_tile<DH, BK>(sV + (stage ^ 1) * G::KV_BYTES, v + off,
                        min(BK, Skv - c1));
      cp_async_commit();
    }
    if (j >= w_steps) continue;  // warpgroup-uniform: wholly masked or dead
    // S = Q K^T on the tensor cores; then the scale, and the mask.
    const uint32_t kS = sK + stage * G::KV_BYTES;
    const uint32_t qW = sQ + 64 * wg * G::ROWB;  // this warpgroup's rows
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h) qk_half<DH>(s[h], qW, kS + 64 * h * G::ROWB);
    wgmma_commit();
    wgmma_wait_all();
    // __fmul_rn / __fsub_rn: rounded apart, never contracted into one FMA,
    // as the plain version rounds them.
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        pin(s[h][i]);
        s[h][i] = __fmul_rn(s[h][i], scale);
      }
    const int c0 = j * BK;
    if (c0 + BK > Skv || (causal && c0 + BK - 1 > q_offset + wrow0)) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int jl = 0; jl < 8; ++jl)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c0 + 64 * h + 8 * jl + cq + (e & 1);
            const int qpos = e < 2 ? qpos_a : qpos_b;
            if (col >= Skv || (causal && qpos < col))
              s[h][4 * jl + e] = NEG_INF;
          }
    }

    // Online softmax in registers: the quad's 4 threads hold a row.
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int jl = 0; jl < 8; ++jl) {
        mx_a = fmaxf(mx_a, fmaxf(s[h][4 * jl], s[h][4 * jl + 1]));
        mx_b = fmaxf(mx_b, fmaxf(s[h][4 * jl + 2], s[h][4 * jl + 3]));
      }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float alpha_a = expf(__fsub_rn(m_a, mx_a));
    const float alpha_b = expf(__fsub_rn(m_b, mx_b));
    m_a = mx_a;
    m_b = mx_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int jl = 0; jl < 8; ++jl) {
        float* x = &s[h][4 * jl];
        x[0] = expf(__fsub_rn(x[0], mx_a));  // 0 where masked
        x[1] = expf(__fsub_rn(x[1], mx_a));
        x[2] = expf(__fsub_rn(x[2], mx_b));
        x[3] = expf(__fsub_rn(x[3], mx_b));
        sum_a += x[0] + x[1];
        sum_b += x[2] + x[3];
      }
    l_a = alpha_a * l_a + sum_a;
    l_b = alpha_b * l_b + sum_b;
    // p rounded to bf16 as the A fragments of P V: k-step kk covers the
    // S n-blocks 2kk and 2kk + 1.
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) {
      const float* x = &s[kk / 4][8 * (kk % 4)];
      pf[kk][0] = pack_bf16(x[0], x[1]);
      pf[kk][1] = pack_bf16(x[2], x[3]);
      pf[kk][2] = pack_bf16(x[4], x[5]);
      pf[kk][3] = pack_bf16(x[6], x[7]);
    }
#pragma unroll
    for (int jn = 0; jn < NO; ++jn) {
      o[4 * jn] *= alpha_a;
      o[4 * jn + 1] *= alpha_a;
      o[4 * jn + 2] *= alpha_b;
      o[4 * jn + 3] *= alpha_b;
    }

    // O += bf16(P) V on the tensor cores.
    const uint32_t vS = sV + stage * G::KV_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KP; ++kk)
      wgmma_rs<DH>(o, pf[kk], mnmajor_desc<DH>(vS, BK, kk));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) pin(o[i]);
#pragma unroll
    for (int kk = 0; kk < KP; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) pin(pf[kk][e]);
  }

  // out = acc / max(l, 1e-30): the quad's partial sums first, then one IEEE
  // division per element as in the TPU kernel, rounded to bf16.
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  __nv_bfloat16* o_a =
      out + (static_cast<int64_t>(bh) * Sq + wrow0 + ra) * DH + cq;
  __nv_bfloat16* o_b = o_a + 8 * DH;
#pragma unroll
  for (int jn = 0; jn < NO; ++jn) {
    if (ra < wrows)
      *reinterpret_cast<uint32_t*>(o_a + 8 * jn) =
          pack_bf16(o[4 * jn] / den_a, o[4 * jn + 1] / den_a);
    if (ra + 8 < wrows)
      *reinterpret_cast<uint32_t*>(o_b + 8 * jn) =
          pack_bf16(o[4 * jn + 2] / den_b, o[4 * jn + 3] / den_b);
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int BH, int Sq, int Skv, int q_per_kv, int causal,
                   int q_offset, float scale, cudaStream_t stream) {
  constexpr auto kern = flash_fwd_wgmma<DH>;
  const cudaError_t e = allow_smem<kern>(Geom<DH>::SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid(BH, (Sq + BQ - 1) / BQ);
  kern<<<grid, NT, Geom<DH>::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Sq, Skv, q_per_kv, causal, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 = launched); cudaErrorInvalidValue for a head dim
// the kernel was not built for or shapes it cannot take. `scale` is
// Dh^-0.5 rounded to f32 by the caller, as the TPU kernel's is.
extern "C" int flash_attention_bf16_fwd(const void* q, const void* k,
                                        const void* v, void* out, int BH,
                                        int Sq, int Skv, int Dh, int q_per_kv,
                                        int causal, int q_offset, float scale,
                                        void* stream) {
  if (BH < 1 || Sq < 1 || Skv < 1 || q_per_kv < 1 || BH % q_per_kv != 0 ||
      q_offset < 0 || (Sq + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 16:
      return launch<16>(q, k, v, out, BH, Sq, Skv, q_per_kv, causal,
                        q_offset, scale, st);
    case 64:
      return launch<64>(q, k, v, out, BH, Sq, Skv, q_per_kv, causal,
                        q_offset, scale, st);
    case 128:
      return launch<128>(q, k, v, out, BH, Sq, Skv, q_per_kv, causal,
                         q_offset, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
