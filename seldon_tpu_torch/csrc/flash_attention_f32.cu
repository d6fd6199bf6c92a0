// Flash attention forward pass on Hopper's tensor cores (sm_90a), f32, as
// 3xTF32 wgmma chains.
//
// Replaces the TPU kernel seldon_tpu/ops/flash_attention.py::_flash_kernel
// (launched by _flash_pallas) for f32 inputs; bf16 inputs run the bf16
// kernel of flash_attention.cu. Contract, identical to the TPU kernel's:
//   q   [B*H,   Sq,  Dh]   f32
//   k,v [B*Hkv, Skv, Dh]   f32; query row b reads KV row b / q_per_kv
//   out [B*H,   Sq,  Dh]   f32
// For each query row i (global position q_offset + i under `causal`):
//   s_j = (q_i . k_j) * Dh^-0.5      dot accumulated in f32, THEN scaled;
//         s_j = -1e30 where causal and q_offset + i < j
//   online softmax over KV blocks of BK = 128 positions (the Pallas
//   block_k), per block: m' = max(m, max_j s_j); p_j = exp(s_j - m');
//   alpha = exp(m - m'); l = alpha * l + sum_j p_j;
//   acc = alpha * acc + sum_j p_j * v_j, products and sums in f32;
//   out = acc / max(l, 1e-30).
// Those are the TPU kernel's rounding points; the plain version
// (ops/flash_attention.flash_blockwise) keeps the same ones. KV blocks
// wholly above the causal diagonal of a query tile are skipped, and a
// block's dead columns (past Skv, or above the diagonal for a row) get
// p = 0 exactly: skipping or masking them changes nothing, so the query
// tile size is free and any Sq, Skv run here (the TPU kernel needed both
// to divide by its blocks).
//
// What bounds it on this card: operations. A causal pass does
// 2 * Dh * S * (S + 1) FLOPs per query row against 2 * 4 * S * Dh bytes of
// K/V per KV row. On the CUDA cores (67 TFLOP/s) the kernel this one
// replaced reached 0.36 of that ceiling. Here both products run on the
// tensor cores as 3xTF32 (hopper_tf32.cuh: each f32 operand x as hi =
// rna(x) + lo = rna(x - hi), each product as lo hi + hi lo + hi hi, the
// small terms first; 3 passes at 495 TFLOP/s, an effective 165), which
// keeps f32 accuracy (the lo lo term dropped is ~2^-22 of a product):
//  * one CTA of two consumer warpgroups (256 threads) per (query row of
//    B*H, tile of BQ = 128 query rows, 64 per warpgroup) walks the KV
//    blocks of its row (the TPU grid's sequential axis); tiles with the
//    longest causal walk are scheduled first; a warpgroup skips the blocks
//    and 32-column sub-tiles wholly above its own diagonal or past Skv,
//    and the whole walk when all its rows lie past Sq;
//  * Q is read once, split into hi and lo and stored as two swizzled
//    TF32 tiles (128 KB at Dh 128);
//  * a block of 128 positions is eight sub-tiles of 32: K0..K3, then
//    V0..V3. Each is copied by cp.async (zero-filled past Skv) into a
//    3-stage ring of raw f32 sub-tiles (rows padded by 16 bytes), two
//    sub-tiles ahead, and split into hi and lo in one conversion slot of
//    swizzled TF32 tiles: K K-major with its keys permuted in each group
//    of 8 (tf32::kperm, so that S's accumulator layout is P V's A fragment
//    layout without shuffles), V transposed to V^T (positions
//    contiguous): for .tf32, wgmma takes its shared-memory operands
//    K-major only. Two barriers a sub-tile: the raw sub-tile is in, then
//    the conversion is;
//  * S = Q K^T by wgmma m64n32k8 .tf32 per K sub-tile (A and B from shared
//    memory): for each quarter of Dh (halves at Dh 16) an accumulator of
//    its own takes Q lo K hi, Q hi K lo, Q hi K hi over the quarter's
//    k-steps, the quarters summed in f32 (tf32::sum_quarters); the
//    block's 128 scores stay in registers (64 a thread) until the fourth,
//    then the scale, the mask and the online softmax in the accumulator
//    layout (quad shuffles), and O *= alpha;
//  * O_sub = P V by wgmma m64n{64,Dh}k8 .tf32 per V sub-tile into a fresh
//    accumulator, p split into hi and lo in registers (A) against V^T hi
//    and lo (B): p lo V hi, p hi V lo, p hi V hi; then O += O_sub in f32
//    (at Dh 128 in two 64-column halves, for registers). The tensor
//    cores' f32 accumulation inside a chain is not IEEE round-to-nearest
//    and its error grows with each step added into a large partial sum:
//    with S in one chain over Dh and P V chained into O over the whole
//    walk, the f32 llama3-8b score call read 5.42e-5 against the 1e-4
//    gate; with short chains 6.44e-6 (PERF.md, PR 19);
//  * shared memory at Dh 128: Q hi and lo 128 KB, the conversion slot
//    (hi and lo) 32 KB, the raw ring 3 x 16.5 KB: 210.5 KB with 1 KB of
//    alignment slack, one CTA per SM. Registers at Dh 128: the block's
//    scores (64), O (64), and S's four accumulators (64) while Q K^T
//    runs, O_sub's half (32) and the A fragments (32) while P V does; the
//    descriptors' base addresses pass through tf32::opaque, or ptxas keeps
//    every descriptor of the walk live and spills. ptxas' registers,
//    shared memory and spills are printed by chip_smoke.py's build phase
//    (no spill).
// The tensor cores idle while a sub-tile is split and at its two barriers.
// Splitting the next sub-tile while the current chain runs (two slots, a
// 2-stage raw ring) was tried: with runtime branches between a chain's
// issue and its wait ptxas serialized the chains (C7518) and (c) took
// 0.674 ms against 0.445-0.461; made branch-free, ptxas (CUDA 12.8)
// crashed at Dh 128. A producer warpgroup that splits while the two
// consumers multiply is the next design (PERF.md, PR 19).
// Times: PERF.md (chip_smoke.py, NVIDIA H100 80GB HBM3).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"
#include "hopper_tf32.cuh"

namespace {

using namespace hopper;
using namespace hopper::tf32;

constexpr int NT = 256;            // two consumer warpgroups
constexpr int BQ = 128;            // query rows per CTA, 64 per warpgroup
constexpr int BK = 128;            // KV positions per block: the Pallas block_k
constexpr int SK = 32;             // KV positions per sub-tile
constexpr int NSUB = BK / SK;      // sub-tiles of K (then of V) per block
constexpr int NS = 3;              // raw sub-tiles in the cp.async ring
constexpr float NEG_INF = -1e30f;  // the JAX package's mask fill

template <int DH>
struct Geom {
  static constexpr int Q_TILE = BQ * DH * 4;   // Q hi, or Q lo
  static constexpr int SUB = SK * DH * 4;      // a K or V^T tile
  static constexpr int RAW_ROW = DH * 4 + 16;  // padded: banks spread
  static constexpr int RAW = SK * RAW_ROW;
  static constexpr int SMEM = 2 * Q_TILE + 2 * SUB + NS * RAW + 1024;
};

template <int DH>
__global__ void __launch_bounds__(NT, 1) flash_fwd_tf32(
    const float* __restrict__ q,  // [BH, Sq, DH]
    const float* __restrict__ k,  // [BH / q_per_kv, Skv, DH]
    const float* __restrict__ v,  // [BH / q_per_kv, Skv, DH]
    float* __restrict__ out,      // [BH, Sq, DH]
    int Sq, int Skv, int q_per_kv, int causal, int q_offset, float scale) {
  using G = Geom<DH>;
  constexpr int QRB = DH * 4;  // bytes of a Q or K row (TF32)
  constexpr int VRB = SK * 4;  // bytes of a V^T row
  constexpr int NO = DH / 8;   // n-blocks of 8 columns in O
  constexpr int KQ = DH / 8;   // k-steps of Q K^T
  constexpr int KP = SK / 8;   // k-steps of P V per sub-tile
  constexpr int NQA = KQ < 4 ? KQ : 4;  // S accumulators (see sum_quarters)
  constexpr int KPA = KQ / NQA;          // k-steps in each
  constexpr int PN = DH > 64 ? 64 : DH;  // O columns per P V chain
  constexpr int CPR = DH / 4;  // 16-byte chunks of a row

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  const uint32_t sQh = (raw0 + 1023) & ~1023u;
  const uint32_t sQl = sQh + G::Q_TILE;
  const uint32_t sC = sQl + G::Q_TILE;  // the conversion slot: hi, then lo
  const uint32_t sRaw = sC + 2 * G::SUB;
  const uint8_t* raw_g = smem_raw + (sRaw - raw0);

  const int bh = blockIdx.x, tid = threadIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // long walks first
  const int n_rows = min(BQ, Sq - row0);
  const int64_t kv_base = static_cast<int64_t>(bh / q_per_kv) * Skv * DH;

  // This thread's warpgroup, its rows, and the last column each sees: the
  // CTA to its last row's diagonal, the warpgroup to its own (-1: no row).
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int wrow0 = row0 + 64 * wg;
  const int wrows = min(64, Sq - wrow0);
  int last_col = Skv - 1;
  if (causal) last_col = min(last_col, q_offset + row0 + n_rows - 1);
  const int n_steps = last_col / BK + 1;
  int w_last = -1;
  if (wrows > 0) {
    w_last = Skv - 1;
    if (causal) w_last = min(w_last, q_offset + wrow0 + wrows - 1);
  }
  // Accumulator layout: rows ra and ra + 8 of the warpgroup's 64; in each
  // 8-column n-block j of a sub-tile, the keys 8 j + t4 and 8 j + t4 + 4
  // (kperm); O's columns 8 j + 2 t4 and 8 j + 2 t4 + 1.
  const int ra = 16 * warp + lane / 4, t4 = lane % 4;
  const int qpos_a = q_offset + wrow0 + ra, qpos_b = qpos_a + 8;

  // Raw sub-tile u (block u / 8; K sub-tiles u % 8 < 4, then V) into ring
  // stage u % NS; rows past Skv are zero-filled. One copy group per u,
  // empty for a sub-tile past the CTA's last column.
  auto issue = [&](int u) {
    const int cs = (u / 8) * BK + (u % NSUB) * SK;
    if (u < 8 * n_steps && cs <= last_col) {
      const float* src = ((u % 8) < NSUB ? k : v) + kv_base +
                         static_cast<int64_t>(cs) * DH;
      const int nvalid = min(SK, Skv - cs);
      const uint32_t st = sRaw + (u % NS) * G::RAW;
      constexpr int TOTAL = SK * CPR;
#pragma unroll
      for (int x0 = 0; x0 < TOTAL; x0 += NT) {
        const int x = x0 + tid;
        if (TOTAL % NT == 0 || x < TOTAL) {
          const int c = x / CPR, ch = x % CPR;
          const bool live = c < nvalid;
          cp_async16(st + c * G::RAW_ROW + ch * 16,
                     live ? src + c * DH + ch * 4 : src, live ? 16 : 0);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int u = 0; u < NS - 1; ++u) issue(u);

  // Q rows (zeros past Sq), split into the hi and lo tiles; published by
  // the first sub-tile's barriers.
  const float* qt = q + (static_cast<int64_t>(bh) * Sq + row0) * DH;
  for (int x = tid; x < BQ * CPR; x += NT) {
    const int r = x / CPR, ch = x % CPR;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_rows)
      val = *reinterpret_cast<const float4*>(qt + r * DH + ch * 4);
    float hi[4], lo[4];
    split(val.x, hi[0], lo[0]);
    split(val.y, hi[1], lo[1]);
    split(val.z, hi[2], lo[2]);
    split(val.w, hi[3], lo[3]);
    const uint32_t off = offset<QRB>(r, ch, BQ);
    st_v4(sQh + off, hi[0], hi[1], hi[2], hi[3]);
    st_v4(sQl + off, lo[0], lo[1], lo[2], lo[3]);
  }

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF;  // running max of rows ra, ra + 8
  float l_a = 0.f, l_b = 0.f;          // this thread's share of their sums
  const uint32_t qh = sQh + 64 * wg * Layout<QRB>::ROWB;  // this warpgroup's
  const uint32_t ql = sQl + 64 * wg * Layout<QRB>::ROWB;  // rows

  for (int j = 0; j < n_steps; ++j) {
    const int c0 = j * BK;
    const bool w_block = c0 <= w_last;  // warpgroup-uniform
    float s[NSUB][16];                  // the block's scores, then its p
#pragma unroll
    for (int w = 0; w < 2 * NSUB; ++w) {
      const int u = 8 * j + w, sub = w % NSUB;
      const int cs = c0 + sub * SK;
      if (cs <= last_col) {  // CTA-uniform: the sub-tile was staged
        cp_async_wait<NS - 2>();
        __syncthreads();  // raw u is in; everyone is done with the slot
        const uint8_t* rs_ = raw_g + (u % NS) * G::RAW;
        if (w < NSUB)
          convert<DH, float, NT, G::RAW_ROW, false>(rs_, sC);
        else
          convert<DH, float, NT, G::RAW_ROW, true>(rs_, sC);
        fence_proxy_async();
        __syncthreads();  // the slot is in; raw stage u % NS is free
      }
      issue(u + NS - 1);
      const bool w_sub = cs <= w_last;  // warpgroup-uniform
      const uint32_t c_ = opaque(sC);

      if (w < NSUB) {  // S for this sub-tile: Q lo K hi, Q hi K lo, Q hi K hi
        if (w_sub) {  // in NQA accumulators of KPA k-steps, summed in f32
          const uint32_t qh_ = opaque(qh), ql_ = opaque(ql);
          float sa[NQA][16];
          wgmma_fence();
#pragma unroll
          for (int a = 0; a < NQA; ++a) {
#pragma unroll
            for (int kk = a * KPA; kk < (a + 1) * KPA; ++kk)
              ss_n32(sa[a], kdesc<QRB>(ql_, BQ, kk), kdesc<QRB>(c_, SK, kk),
                     kk - a * KPA);
#pragma unroll
            for (int kk = a * KPA; kk < (a + 1) * KPA; ++kk)
              ss_n32(sa[a], kdesc<QRB>(qh_, BQ, kk),
                     kdesc<QRB>(c_ + G::SUB, SK, kk), 1);
#pragma unroll
            for (int kk = a * KPA; kk < (a + 1) * KPA; ++kk)
              ss_n32(sa[a], kdesc<QRB>(qh_, BQ, kk), kdesc<QRB>(c_, SK, kk),
                     1);
          }
          wgmma_commit();
          wgmma_wait_all();
#pragma unroll
          for (int x = 0; x < 16; ++x) {
#pragma unroll
            for (int a = 0; a < NQA; ++a) pin(sa[a][x]);
            s[sub][x] = sum_quarters<NQA>(sa, x);
          }
        } else {  // wholly masked for this warpgroup
#pragma unroll
          for (int x = 0; x < 16; ++x) s[sub][x] = 0.f;
        }
        if (sub == NSUB - 1 && w_block) {
          // The block's 128 scores: the scale, the mask, the online
          // softmax. __fmul_rn / __fsub_rn: rounded apart, never
          // contracted into one FMA, as the plain version rounds them.
          float mx_a = m_a, mx_b = m_b;
#pragma unroll
          for (int h = 0; h < NSUB; ++h)
#pragma unroll
            for (int jl = 0; jl < 4; ++jl)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                float& x = s[h][4 * jl + e];
                const int col = c0 + h * SK + 8 * jl + t4 + 4 * (e & 1);
                const int qpos = e < 2 ? qpos_a : qpos_b;
                x = (col >= Skv || (causal && qpos < col))
                        ? NEG_INF
                        : __fmul_rn(x, scale);
                if (e < 2) mx_a = fmaxf(mx_a, x);
                else mx_b = fmaxf(mx_b, x);
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
          for (int h = 0; h < NSUB; ++h)
#pragma unroll
            for (int jl = 0; jl < 4; ++jl) {
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
#pragma unroll
          for (int jn = 0; jn < NO; ++jn) {
            o[4 * jn] *= alpha_a;
            o[4 * jn + 1] *= alpha_a;
            o[4 * jn + 2] *= alpha_b;
            o[4 * jn + 3] *= alpha_b;
          }
        }
      } else if (w_sub) {
        // O_sub = p lo V hi + p hi V lo + p hi V hi in a fresh
        // accumulator, then O += O_sub in f32; at Dh 128 in two halves of
        // 64 columns (V^T rows), which keeps O_sub to 32 registers.
        uint32_t fh[KP][4], fl[KP][4];
#pragma unroll
        for (int jl = 0; jl < KP; ++jl)
          frag_split(&s[sub][4 * jl], fh[jl], fl[jl]);
#pragma unroll
        for (int hn = 0; hn < DH / PN; ++hn) {
          const uint32_t vh = c_ + hn * PN * VRB;  // rows hn * PN on
          float os[PN / 2];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KP; ++kk)
            rs<PN>(os, fl[kk], kdesc<VRB>(vh, DH, kk), kk);
#pragma unroll
          for (int kk = 0; kk < KP; ++kk)
            rs<PN>(os, fh[kk], kdesc<VRB>(vh + G::SUB, DH, kk), 1);
#pragma unroll
          for (int kk = 0; kk < KP; ++kk)
            rs<PN>(os, fh[kk], kdesc<VRB>(vh, DH, kk), 1);
          wgmma_commit();
          wgmma_wait_all();
#pragma unroll
          for (int x = 0; x < PN / 2; ++x) {
            pin(os[x]);
            o[hn * (PN / 2) + x] = __fadd_rn(o[hn * (PN / 2) + x], os[x]);
          }
        }
#pragma unroll
        for (int kk = 0; kk < KP; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pin(fh[kk][e]);
            pin(fl[kk][e]);
          }
      }
    }
  }

  // out = acc / max(l, 1e-30): the quad's partial sums first, then one IEEE
  // division per element as in the TPU kernel.
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  float* o_a = out + (static_cast<int64_t>(bh) * Sq + wrow0 + ra) * DH +
               2 * t4;
  float* o_b = o_a + 8 * DH;
#pragma unroll
  for (int jn = 0; jn < NO; ++jn) {
    if (ra < wrows)
      *reinterpret_cast<float2*>(o_a + 8 * jn) =
          make_float2(o[4 * jn] / den_a, o[4 * jn + 1] / den_a);
    if (ra + 8 < wrows)
      *reinterpret_cast<float2*>(o_b + 8 * jn) =
          make_float2(o[4 * jn + 2] / den_b, o[4 * jn + 3] / den_b);
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int BH, int Sq, int Skv, int q_per_kv, int causal,
                   int q_offset, float scale, cudaStream_t stream) {
  constexpr auto kern = flash_fwd_tf32<DH>;
  const cudaError_t e = allow_smem<kern>(Geom<DH>::SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid(BH, (Sq + BQ - 1) / BQ);
  kern<<<grid, NT, Geom<DH>::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Skv,
      q_per_kv, causal, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// C entry point, loaded with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 = launched); cudaErrorInvalidValue for a head dim
// the kernel was not built for or shapes it cannot take. `scale` is
// Dh^-0.5 rounded to f32 by the caller, as the TPU kernel's is.
extern "C" int flash_attention_f32_fwd(const void* q, const void* k,
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

// The dynamic shared memory of the kernel's instance for a head dim
// (bytes; -1 for one it does not have), for reports.
extern "C" int flash_attention_f32_smem_bytes(int Dh) {
  switch (Dh) {
    case 16:
      return Geom<16>::SMEM;
    case 64:
      return Geom<64>::SMEM;
    case 128:
      return Geom<128>::SMEM;
    default:
      return -1;
  }
}
