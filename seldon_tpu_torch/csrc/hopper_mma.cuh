// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels
// (flash_attention.cu, ragged_paged_attention.cu): cp.async copies, the
// swizzled shared-memory tile layout that wgmma's descriptors read, the
// descriptors themselves and the wgmma instructions the kernels issue.
//
// Tile layout. A tile is `rows` rows of DH bf16. Rows are stored in
// swizzled "halves" of ROWB bytes: 128 bytes (64 bf16) with the 128-byte
// swizzle at DH 64 and 128 (DH 128 is two 64-column halves, the second
// `rows * 128` bytes after the first), 32 bytes with the 32-byte swizzle
// at DH 16. 16-byte chunk c of row r sits at chunk (c % CPH) ^ (r % 8)
// (^ (r % 2) at DH 16) of its row in half c / CPH. The same layout serves
// a K-major operand (the contraction runs along a row: Q, and K for
// Q K^T) and an MN-major one (the contraction runs down the rows: V for
// P V).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

template <int DH>
struct Swizzle {
  static_assert(DH == 16 || DH == 64 || DH == 128, "head dim");
  static constexpr int ROWB = DH >= 64 ? 128 : DH * 2;  // swizzled row bytes
  static constexpr int SWZ = ROWB == 128 ? 3 : 1;       // log2(ROWB / 16)
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 3 = 32-byte.
  static constexpr uint64_t LAYOUT = ROWB == 128 ? 1 : 3;
  static constexpr int CPH = ROWB / 16;  // 16-byte chunks per swizzled row
};

// Byte offset of 16-byte chunk c of row r in a tile of `rows` rows.
template <int DH>
__device__ __forceinline__ uint32_t tile_offset(int r, int c, int rows) {
  using S = Swizzle<DH>;
  const uint32_t off = (c / S::CPH) * rows * S::ROWB + r * S::ROWB +
                       (c % S::CPH) * 16;
  return off ^ (((off >> 7) & ((1u << S::SWZ) - 1)) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }
// cp.async and st.shared write through the generic proxy, wgmma reads
// through the async proxy: each thread fences its own writes before the
// barrier that publishes them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle layout type.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// K-major operand, contraction step kk of 16 bf16 (32 bytes). `tile` is
// the first row's start in the first half; `rows` the tile's row count
// (the half stride). Within a swizzle atom a step moves the start address
// by 32 bytes; the hardware applies the XOR to the address it forms.
// 8-row groups are 8 * ROWB apart (SBO); LBO is unused for swizzled
// K-major operands.
template <int DH>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int rows,
                                                int kk) {
  using S = Swizzle<DH>;
  const uint32_t byte = kk * 32;
  return smem_desc(tile + (byte / S::ROWB) * rows * S::ROWB + byte % S::ROWB,
                   16, 8 * S::ROWB, S::LAYOUT);
}

// MN-major operand (N = DH along the rows), contraction step kk of 16
// rows. 8-row groups are 8 * ROWB apart (SBO); the next 64 columns (the
// second half at DH 128) are rows * ROWB apart (LBO).
template <int DH>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int rows,
                                                 int kk) {
  using S = Swizzle<DH>;
  return smem_desc(tile + kk * 16 * S::ROWB, rows * S::ROWB, 8 * S::ROWB,
                   S::LAYOUT);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pins a register for the compiler: it is neither read early nor reused
// while an asynchronous wgmma may still touch it.
__device__ __forceinline__ void pin(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void pin(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

#define HOPPER_WG_F8(d, i)                                             \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOPPER_WG_W8(d, i)                                             \
  "=f"(d[i]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3]),          \
      "=f"(d[i + 4]), "=f"(d[i + 5]), "=f"(d[i + 6]), "=f"(d[i + 7])
#define HOPPER_WG_SS_N64                                                     \
  "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "       \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "   \
  "%29, %30, %31}, "                                                         \
  "%32, %33, p, 1, 1, 0, 0;\n}\n"

// S (64 x 64, f32) = A (64 x 16, smem) B (16 x 64, smem, K-major), or
// S += A B with ACC. Without ACC the accumulator is written, not read.
template <bool ACC>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  if constexpr (ACC) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" HOPPER_WG_SS_N64
                 : HOPPER_WG_F8(d, 0), HOPPER_WG_F8(d, 8),
                   HOPPER_WG_F8(d, 16), HOPPER_WG_F8(d, 24)
                 : "l"(da), "l"(db), "r"(1));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" HOPPER_WG_SS_N64
                 : HOPPER_WG_W8(d, 0), HOPPER_WG_W8(d, 8),
                   HOPPER_WG_W8(d, 16), HOPPER_WG_W8(d, 24)
                 : "l"(da), "l"(db), "r"(0));
  }
}

// O (64 x N, f32) += A (64 x 16, registers) B (16 x N, smem, MN-major).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HOPPER_WG_F8(d, 0), HOPPER_WG_F8(d, 8), HOPPER_WG_F8(d, 16),
        HOPPER_WG_F8(d, 24), HOPPER_WG_F8(d, 32), HOPPER_WG_F8(d, 40),
        HOPPER_WG_F8(d, 48), HOPPER_WG_F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_WG_F8(d, 0), HOPPER_WG_F8(d, 8), HOPPER_WG_F8(d, 16),
        HOPPER_WG_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : HOPPER_WG_F8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef HOPPER_WG_SS_N64
#undef HOPPER_WG_W8
#undef HOPPER_WG_F8

// Two f32 as bf16 (RNE, as .to(bfloat16) rounds), the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Sets kernel KERN's dynamic shared-memory limit once per process (at the
// first launch of that kernel instance), not on every launch; later calls
// return the result of that one call. A kernel whose size is fixed at
// compile time passes the same `bytes` every time.
template <auto KERN>
cudaError_t allow_smem(int bytes) {
  static const cudaError_t once = cudaFuncSetAttribute(
      KERN, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return once;
}

}  // namespace hopper
