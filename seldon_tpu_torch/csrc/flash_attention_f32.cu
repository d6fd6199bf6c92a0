// Flash attention forward pass on Hopper's CUDA cores (sm_90a), f32.
//
// Replaces the TPU kernel seldon_tpu/ops/flash_attention.py::_flash_kernel
// (launched by _flash_pallas) for f32 inputs; bf16 inputs run the
// tensor-core kernel of flash_attention.cu. Contract, identical to the TPU
// kernel's:
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
// (ops/flash_attention.flash_blockwise) keeps the same ones, so the two
// differ only by f32 summation order. KV blocks wholly above the causal
// diagonal of a query tile are skipped, and a block's dead columns (past
// Skv, or above the diagonal for a row) get p = 0 exactly: skipping or
// masking them changes nothing, so the query tile size is free and any
// Sq, Skv run here (the TPU kernel needed both to divide by its blocks).
//
// What bounds it on this card: operations, at the f32 rate of the CUDA
// cores (67 TFLOP/s): a causal pass does 2 * Dh * S * (S + 1) FLOPs per
// query row against 2 * 4 * S * Dh bytes of K/V per KV row. TF32 tensor
// cores would be faster but keep ~10 mantissa bits, far from the 1e-4 this
// route is held to, so it stays on f32 FMA. Its design:
//  * one CTA of 256 threads per (query row of B*H, tile of BQ = 64 query
//    rows) walks the KV blocks itself (the TPU grid's sequential axis);
//    the tiles with the longest causal walk are scheduled first;
//  * each step stages one KV block of K, then of V, in shared memory as
//    f32; every thread issues all of its 16-byte loads of a tile before it
//    converts or stores any, and the V loads are in flight while the
//    scores are folded;
//  * scores are register-tiled (each thread a 4 x 8 patch of the 64 x 128
//    tile), the online-softmax fold of a row is spread over 4 threads with
//    warp shuffles, m and l live in shared memory, acc in registers (each
//    thread a 4-row x 4/8-column patch of the 64 x Dh output tile).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads per CTA
constexpr int BQ = 64;             // query rows per CTA
constexpr int BK = 128;            // KV positions per step: the Pallas block_k
constexpr int PAD = 4;             // f32 row padding in shared memory
constexpr float NEG_INF = -1e30f;  // the JAX package's mask fill

// 16 bytes of T as f32.
__device__ __forceinline__ void unpack(const uint4& r, float* f,
                                       const float*) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

// The probabilities in v's dtype before the value product: f32, unrounded.
__device__ __forceinline__ float round_p(float p, const float*) { return p; }

// Four consecutive outputs.
__device__ __forceinline__ void store4(float* dst, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}

// ROWS consecutive rows of DH elements of T, staged in shared memory as f32
// rows of stride DH + PAD. load() issues every 16-byte load of this
// thread; store() converts and stores them. Rows >= nvalid stage as zeros.
template <int DH, int ROWS, typename T>
struct Tile {
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  static constexpr int RV = DH / VEC;         // loads per row
  static constexpr int TOTAL = ROWS * RV;
  static constexpr int PER = (TOTAL + NT - 1) / NT;
  static_assert(DH % VEC == 0 && VEC % 4 == 0, "whole vectors per row");
  uint4 r[PER];

  __device__ __forceinline__ void load(const T* __restrict__ src,
                                       int nvalid) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = threadIdx.x + u * NT;
      r[u] = make_uint4(0u, 0u, 0u, 0u);
      if (i < TOTAL && i / RV < nvalid)
        r[u] = reinterpret_cast<const uint4*>(src)[i];
    }
  }

  __device__ __forceinline__ void store(float* __restrict__ dst) const {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = threadIdx.x + u * NT;
      if (i < TOTAL) {
        float f[VEC];
        unpack(r[u], f, static_cast<const T*>(nullptr));
        float4* d = reinterpret_cast<float4*>(dst + (i / RV) * (DH + PAD) +
                                              (i % RV) * VEC);
#pragma unroll
        for (int w = 0; w < VEC / 4; ++w)
          d[w] = make_float4(f[4 * w], f[4 * w + 1], f[4 * w + 2],
                             f[4 * w + 3]);
      }
    }
  }
};

template <int DH>
constexpr size_t smem_floats() {
  return static_cast<size_t>(BQ) * (DH + PAD)     // q_s
         + static_cast<size_t>(BK) * (DH + PAD)   // kv_s
         + static_cast<size_t>(BK) * (BQ + PAD)   // p_s
         + 3 * BQ;                                // m_s, l_s, a_s
}

template <int DH, typename T>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q,  // [BH, Sq, DH]
    const T* __restrict__ k,  // [BH / q_per_kv, Skv, DH]
    const T* __restrict__ v,  // [BH / q_per_kv, Skv, DH]
    T* __restrict__ out,      // [BH, Sq, DH]
    int Sq, int Skv, int q_per_kv, int causal, int q_offset, float scale) {
  constexpr int QS = DH + PAD;  // row stride of q_s and kv_s
  constexpr int PS = BQ + PAD;  // row stride of p_s ([BK][BQ]: by column)
  // Score tile: thread (rg, cg) owns rows rg + RG * i, columns cg + CG * u.
  constexpr int CT = 8, RT = 4;
  constexpr int CG = BK / CT, RG = BQ / RT;
  static_assert(RG * CG == NT, "score tiling must cover NT");
  // Fold: W threads per row, in one warp.
  constexpr int W = NT / BQ;
  static_assert(W <= 32 && 32 % W == 0, "fold groups must sit in a warp");
  // Value product: thread (ar, ac) owns rows ar * RA + i and the CA / 4
  // float4 column groups (ac + ACG * w) * 4 of the BQ x DH output tile.
  constexpr int CA = DH >= 128 ? 8 : 4;
  constexpr int ACG = DH / CA;
  constexpr int ARG = NT / ACG;
  constexpr int RA = BQ / ARG;
  static_assert(ACG * ARG == NT && RA * ARG == BQ, "acc tiling must cover");
  static_assert(RA == 1 || RA % 4 == 0, "p is read as float4 over rows");

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [BQ][QS]
  float* kv_s = q_s + BQ * QS;                   // [BK][QS] K, then V
  float* p_s = kv_s + BK * QS;                   // [BK][PS] scores, then p
  float* m_s = p_s + BK * PS;                    // [BQ]
  float* l_s = m_s + BQ;                         // [BQ]
  float* a_s = l_s + BQ;                         // [BQ] this step's rescale

  const int bh = blockIdx.x;
  const int row0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // long walks first
  const int n_rows = min(BQ, Sq - row0);
  const int tid = threadIdx.x;
  const int64_t kv_base = static_cast<int64_t>(bh / q_per_kv) * Skv * DH;

  {
    Tile<DH, BQ, T> qt;
    qt.load(q + (static_cast<int64_t>(bh) * Sq + row0) * DH, n_rows);
    qt.store(q_s);
  }
  for (int r = tid; r < BQ; r += NT) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  // Causal: the last KV block this tile sees holds its last row's
  // diagonal; the blocks after it are wholly masked and skipped.
  int last_col = Skv - 1;
  if (causal) last_col = min(last_col, q_offset + row0 + n_rows - 1);
  const int n_steps = last_col / BK + 1;

  float acc[RA][CA];
#pragma unroll
  for (int i = 0; i < RA; ++i)
#pragma unroll
    for (int c = 0; c < CA; ++c) acc[i][c] = 0.f;

  const int rg = tid / CG, cg = tid % CG;
  const int fr = tid / W, fl = tid % W;
  const int ar = tid / ACG, ac = tid % ACG;

  for (int j = 0; j < n_steps; ++j) {
    const int c0 = j * BK;
    const int n_cols = min(BK, Skv - c0);
    const T* kb = k + kv_base + static_cast<int64_t>(c0) * DH;
    const T* vb = v + kv_base + static_cast<int64_t>(c0) * DH;
    __syncthreads();  // the last step's value product is done with kv_s
    {
      Tile<DH, BK, T> kt;
      kt.load(kb, n_cols);
      kt.store(kv_s);
    }
    __syncthreads();

    // Scores s = (q . k) * scale, masked to NEG_INF.
    {
      float dot[RT][CT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int u = 0; u < CT; ++u) dot[i][u] = 0.f;
#pragma unroll 4
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        float4 qv[RT], kv[CT];
#pragma unroll
        for (int i = 0; i < RT; ++i)
          qv[i] = reinterpret_cast<const float4*>(q_s + (rg + RG * i) * QS)[d4];
#pragma unroll
        for (int u = 0; u < CT; ++u)
          kv[u] = reinterpret_cast<const float4*>(kv_s + (cg + CG * u) * QS)[d4];
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int u = 0; u < CT; ++u) {
            float a = dot[i][u];
            a = fmaf(qv[i].x, kv[u].x, a);
            a = fmaf(qv[i].y, kv[u].y, a);
            a = fmaf(qv[i].z, kv[u].z, a);
            a = fmaf(qv[i].w, kv[u].w, a);
            dot[i][u] = a;
          }
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int u = 0; u < CT; ++u) {
          const int r = rg + RG * i, c = cg + CG * u;
          const bool live =
              c < n_cols && (!causal || q_offset + row0 + r >= c0 + c);
          p_s[c * PS + r] = live ? dot[i][u] * scale : NEG_INF;
        }
    }
    __syncthreads();

    // V's loads go out first; the fold runs while they are in flight.
    Tile<DH, BK, T> vt;
    vt.load(vb, n_cols);
    {
      float mx = NEG_INF;
      for (int c = fl; c < BK; c += W) mx = fmaxf(mx, p_s[c * PS + fr]);
#pragma unroll
      for (int off = W / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[fr];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = fl; c < BK; c += W) {
        float* pc = p_s + c * PS + fr;
        const float p = expf(*pc - m_new);  // 0 where masked
        sum += p;
        *pc = round_p(p, static_cast<const T*>(nullptr));
      }
#pragma unroll
      for (int off = W / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (fl == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[fr] = alpha * l_s[fr] + sum;
        m_s[fr] = m_new;
        a_s[fr] = alpha;
      }
    }
    vt.store(kv_s);  // K is no longer read: the scores are in p_s
    __syncthreads();

    // acc = acc * alpha + round(p) . v over the block's live columns (a
    // column past Skv has p = 0 and a zero V row: leaving it out is exact).
    {
#pragma unroll
      for (int i = 0; i < RA; ++i) {
        const float al = a_s[ar * RA + i];
#pragma unroll
        for (int c = 0; c < CA; ++c) acc[i][c] *= al;
      }
      for (int c = 0; c < n_cols; ++c) {
        float pr[RA];
        if constexpr (RA % 4 == 0) {
#pragma unroll
          for (int i4 = 0; i4 < RA / 4; ++i4) {
            const float4 w = reinterpret_cast<const float4*>(
                p_s + c * PS + ar * RA)[i4];
            pr[4 * i4] = w.x;
            pr[4 * i4 + 1] = w.y;
            pr[4 * i4 + 2] = w.z;
            pr[4 * i4 + 3] = w.w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < RA; ++i) pr[i] = p_s[c * PS + ar * RA + i];
        }
#pragma unroll
        for (int w = 0; w < CA / 4; ++w) {
          const float4 vv = reinterpret_cast<const float4*>(
              kv_s + c * QS + (ac + ACG * w) * 4)[0];
#pragma unroll
          for (int i = 0; i < RA; ++i) {
            acc[i][4 * w] = fmaf(pr[i], vv.x, acc[i][4 * w]);
            acc[i][4 * w + 1] = fmaf(pr[i], vv.y, acc[i][4 * w + 1]);
            acc[i][4 * w + 2] = fmaf(pr[i], vv.z, acc[i][4 * w + 2]);
            acc[i][4 * w + 3] = fmaf(pr[i], vv.w, acc[i][4 * w + 3]);
          }
        }
      }
    }
  }

  // out = acc / max(l, 1e-30), one IEEE division per element as in the
  // TPU kernel, rounded to the output dtype.
#pragma unroll
  for (int i = 0; i < RA; ++i) {
    const int r = ar * RA + i;
    if (r < n_rows) {
      const float den = fmaxf(l_s[r], 1e-30f);
      T* o = out + (static_cast<int64_t>(bh) * Sq + row0 + r) * DH;
#pragma unroll
      for (int w = 0; w < CA / 4; ++w)
        store4(o + (ac + ACG * w) * 4, acc[i][4 * w] / den,
               acc[i][4 * w + 1] / den, acc[i][4 * w + 2] / den,
               acc[i][4 * w + 3] / den);
    }
  }
}

template <int DH, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int BH, int Sq, int Skv, int q_per_kv, int causal,
                   int q_offset, float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<DH>() * sizeof(float);
  auto kern = flash_fwd_kernel<DH, T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(BH, (Sq + BQ - 1) / BQ);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, q_per_kv,
      causal, q_offset, scale);
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
      return launch<16, float>(q, k, v, out, BH, Sq, Skv, q_per_kv, causal,
                               q_offset, scale, st);
    case 64:
      return launch<64, float>(q, k, v, out, BH, Sq, Skv, q_per_kv, causal,
                               q_offset, scale, st);
    case 128:
      return launch<128, float>(q, k, v, out, BH, Sq, Skv, q_per_kv, causal,
                                q_offset, scale, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
