// 3xTF32 building blocks for the port's f32 tensor-core kernels
// (ragged_paged_attention_f32.cu's route from 64 rows up,
// flash_attention_f32.cu): the split of an f32 value into two TF32 parts,
// the swizzled shared-memory layout of f32 (TF32) tiles, their wgmma
// descriptors and the m64nNk8 .tf32 wgmma instructions the kernels issue.
// The bf16 layout and instructions of hopper_mma.cuh are not changed.
//
// The split. hi = rna(x), lo = rna(x - hi), where rna rounds to TF32 (10
// explicit mantissa bits) to nearest, ties away from zero
// (cvt.rna.tf32.f32; the low 13 bits of the result are cleared). x - hi is
// exact in f32, and x - hi - lo is within 2^-22 |x| for normal x. A
// product x y becomes lo_x hi_y + hi_x lo_y + hi_x hi_y: each term is
// exact in f32 (11 x 11 significant bits), only lo_x lo_y (~2^-22 x y) is
// dropped. The kernels chain the small terms first into an f32
// accumulator, so they are summed before the large one, and keep each
// chain short (S one accumulator per quarter of the contraction, P V a
// fresh one per step, summed in f32): the tensor cores' accumulation
// inside a chain is not IEEE round-to-nearest. An operand that is exact in
// TF32 (an int8 code) needs no lo: 2 terms. The plain version of the split
// and of both kernels' arithmetic is ops/_tf32.py.
//
// Tile layout. A tile is `rows` K-major rows of RB bytes (RB = 4 * the
// row's f32 count), stored in swizzled halves of ROWB = min(RB, 128)
// bytes: 128 bytes with the 128-byte swizzle (16-byte chunk c of row r at
// chunk c ^ (r % 8)) when RB is a multiple of 128, 64 bytes with the
// 64-byte swizzle (chunk c ^ ((r / 2) % 4)) at RB 64. A k8 step of TF32
// is 32 bytes, as a k16 step of bf16 is. For .tf32, wgmma reads both
// shared-memory operands K-major only (the transpose bits exist only for
// 16-bit types), so an operand whose contraction runs down the rows in
// device memory (V in P V) is staged transposed.
//
// Register fragments (the PTX ISA's m64nNk8 .tf32 layouts, as CUTLASS's
// SM90 GMMA traits give them): in warp w of the warpgroup, lane l (g =
// l / 4, t = l % 4) holds A elements a0 (16 w + g, t), a1 (16 w + g + 8,
// t), a2 (16 w + g, t + 4), a3 (16 w + g + 8, t + 4), and accumulator
// elements d[4 j + e] at row 16 w + g + 8 (e / 2), column 8 j + 2 t +
// (e % 2). The accumulator's columns 2 t, 2 t + 1 are not the A
// fragment's t, t + 4: a kernel that feeds S's layout to P V as A either
// shuffles, or stores the keys of each 8-column group permuted (kperm
// below), so that S column 8 j + 2 t + e holds key 8 j + t + 4 e.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace hopper {
namespace tf32 {

// x rounded to TF32, to nearest with ties away from zero, as an f32.
__device__ __forceinline__ float rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xFFFFE000u);
}

__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = rna(x);
  lo = rna(__fsub_rn(x, hi));
}

// The tile row that holds key `key` of an operand whose accumulator
// columns feed P V's A fragments without shuffles (see above).
__device__ __forceinline__ int kperm(int key) {
  return (key & ~7) + 2 * (key & 3) + ((key >> 2) & 1);
}

template <int RB>
struct Layout {
  static_assert(RB == 64 || RB % 128 == 0, "tf32 row bytes");
  static constexpr int ROWB = RB < 128 ? RB : 128;  // swizzled row bytes
  static constexpr int SWZ = ROWB == 128 ? 3 : 2;   // log2(chunks per 128 B)
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte.
  static constexpr uint64_t LAYOUT = ROWB == 128 ? 1 : 2;
  static constexpr int CPH = ROWB / 16;  // 16-byte chunks per swizzled row
};

// Byte offset of 16-byte chunk c of row r in a tile of `rows` rows. The
// tile starts on a 1024-byte boundary.
template <int RB>
__device__ __forceinline__ uint32_t offset(int r, int c, int rows) {
  using L = Layout<RB>;
  const uint32_t off = (c / L::CPH) * rows * L::ROWB + r * L::ROWB +
                       (c % L::CPH) * 16;
  return off ^ (((off >> 7) & ((1u << L::SWZ) - 1)) << 4);
}

// K-major operand, contraction step kk of 8 TF32 (32 bytes): within a
// swizzled row the step moves the start address by 32 bytes (the hardware
// applies the XOR to the address it forms); the next half is rows * ROWB
// bytes on. 8-row groups are 8 * ROWB apart (SBO); LBO is unused.
template <int RB>
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int rows, int kk) {
  using L = Layout<RB>;
  const uint32_t byte = kk * 32;
  return smem_desc(tile + (byte / L::ROWB) * rows * L::ROWB + byte % L::ROWB,
                   16, 8 * L::ROWB, L::LAYOUT);
}

// x, as a value the compiler cannot hoist out of a loop: descriptors
// built from it are formed next to the wgmma that reads them instead of
// being kept in registers across a whole walk.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(x));
  return x;
}

__device__ __forceinline__ void st_v4(uint32_t addr, float a, float b,
                                      float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}
__device__ __forceinline__ void st_f32(uint32_t addr, float a) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(a) : "memory");
}

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

// Converts a raw sub-tile of TK = 32 pool positions (row `pos` of DH
// values of KV at raw + pos * RAW_ROW) into the conversion slot at
// `slot`: a K sub-tile (V_SIDE false) as K-major rows kperm(pos) of DH
// TF32 values, a V sub-tile transposed to DH rows of TK positions (V^T).
// f32 values are split, hi at `slot` and lo at slot + TK * DH * 4; int8
// codes are exact and have no lo. Lanes walk positions, so a warp's reads
// of the padded raw rows and its V^T stores hit distinct banks. NT
// threads take part.
template <int DH, typename KV, int NT, int RAW_ROW, bool V_SIDE>
__device__ __forceinline__ void convert(const uint8_t* raw, uint32_t slot) {
  constexpr int TK = 32;
  constexpr bool QUANT = sizeof(KV) == 1;
  constexpr int EPC = 16 / static_cast<int>(sizeof(KV));  // values a chunk
  constexpr int CPR = DH / EPC;  // 16-byte chunks of a raw row
  constexpr int TOTAL = TK * CPR;
  constexpr uint32_t LO = TK * DH * 4;
#pragma unroll
  for (int x0 = 0; x0 < TOTAL; x0 += NT) {
    const int x = x0 + static_cast<int>(threadIdx.x);
    if (TOTAL % NT == 0 || x < TOTAL) {
      const int pos = x % TK, ch = x / TK;
      const uint4 w =
          *reinterpret_cast<const uint4*>(raw + pos * RAW_ROW + ch * 16);
      float f[EPC];
      if constexpr (QUANT) {
        i8x4_to_f32(w.x, f);
        i8x4_to_f32(w.y, f + 4);
        i8x4_to_f32(w.z, f + 8);
        i8x4_to_f32(w.w, f + 12);
      } else {
        f[0] = __uint_as_float(w.x);
        f[1] = __uint_as_float(w.y);
        f[2] = __uint_as_float(w.z);
        f[3] = __uint_as_float(w.w);
      }
      if constexpr (!V_SIDE) {  // K: row kperm(pos), K-major
        const int kr = kperm(pos);
        if constexpr (QUANT) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            st_v4(slot + offset<DH * 4>(kr, 4 * ch + e, TK), f[4 * e],
                  f[4 * e + 1], f[4 * e + 2], f[4 * e + 3]);
        } else {
          float hi[4], lo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split(f[e], hi[e], lo[e]);
          const uint32_t off = offset<DH * 4>(kr, ch, TK);
          st_v4(slot + off, hi[0], hi[1], hi[2], hi[3]);
          st_v4(slot + LO + off, lo[0], lo[1], lo[2], lo[3]);
        }
      } else {  // V^T: row d, column pos
        const uint32_t col = (pos % 4) * 4;
#pragma unroll
        for (int e = 0; e < EPC; ++e) {
          const uint32_t off = offset<TK * 4>(ch * EPC + e, pos / 4, DH) + col;
          if constexpr (QUANT) {
            st_f32(slot + off, f[e]);
          } else {
            float hi, lo;
            split(f[e], hi, lo);
            st_f32(slot + off, hi);
            st_f32(slot + LO + off, lo);
          }
        }
      }
    }
  }
}

#define TF32_F8(d, i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// S (64 x 32, f32) = A (64 x 8, smem, K-major) B (8 x 32, smem, K-major),
// or S += A B when `acc` is nonzero.
__device__ __forceinline__ void ss_n32(float (&d)[16], uint64_t da,
                                       uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1;\n}\n"
      : TF32_F8(d, 0), TF32_F8(d, 8)
      : "l"(da), "l"(db), "r"(acc));
}

// O (64 x N, f32) = A (64 x 8, registers) B (8 x N, smem, K-major), or
// O += A B when `acc` is nonzero.
template <int N>
__device__ __forceinline__ void rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                   uint64_t db, int acc);

template <>
__device__ __forceinline__ void rs<128>(float (&d)[64],
                                        const uint32_t (&a)[4], uint64_t db,
                                        int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : TF32_F8(d, 0), TF32_F8(d, 8), TF32_F8(d, 16), TF32_F8(d, 24),
        TF32_F8(d, 32), TF32_F8(d, 40), TF32_F8(d, 48), TF32_F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void rs<64>(float (&d)[32],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : TF32_F8(d, 0), TF32_F8(d, 8), TF32_F8(d, 16), TF32_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

template <>
__device__ __forceinline__ void rs<16>(float (&d)[8],
                                       const uint32_t (&a)[4], uint64_t db,
                                       int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : TF32_F8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

#undef TF32_F8

// Element x of a score tile accumulated in N (1, 2 or 4) partial
// accumulators over disjoint k-ranges, summed pairwise in f32
// (round-to-nearest). The tensor cores' accumulation inside a wgmma chain
// is not IEEE round-to-nearest (its error grows with every step it
// adds into a large partial sum); short chains keep that error at a few
// steps, and the f32 adds round as the plain version's sums do.
template <int N>
__device__ __forceinline__ float sum_quarters(const float (&a)[N][16],
                                              int x) {
  static_assert(N == 1 || N == 2 || N == 4, "accumulators");
  if constexpr (N == 1) return a[0][x];
  else if constexpr (N == 2) return __fadd_rn(a[0][x], a[1][x]);
  else
    return __fadd_rn(__fadd_rn(a[0][x], a[1][x]),
                     __fadd_rn(a[2][x], a[3][x]));
}

// The A fragments of P V for k-step j from an accumulator-layout row pair
// (x = &s[4 j]; keys permuted by kperm): a0 = x[0], a1 = x[2], a2 = x[1],
// a3 = x[3], each split into hi and lo.
__device__ __forceinline__ void frag_split(const float* x, uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float h, l;
    split(x[e == 1 ? 2 : e == 2 ? 1 : e], h, l);
    hi[e] = __float_as_uint(h);
    lo[e] = __float_as_uint(l);
  }
}

}  // namespace tf32
}  // namespace hopper
