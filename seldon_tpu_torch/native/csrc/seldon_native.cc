// Native host core of seldon_tpu_torch: a copy of the JAX package's
// native/seldon_native.cc, built by seldon_tpu_torch/native into
// build/native/ (never into native/, where the JAX package builds).
//
// The orchestrator delegates its per-request CPU hot spots to this library
// via ctypes:
//   * batch fuse/split — assembling micro-batches from N request payloads
//     and splitting responses back (orchestrator/batcher.py)
//   * f32 <-> bf16 conversion with round-to-nearest-even
//
// Plain C ABI; buffers are caller-owned. Thread-safe (stateless).

#include <cstdint>
#include <cstring>
#include <cstddef>

extern "C" {

// ---------------------------------------------------------------------------
// bf16 <-> f32 (round-to-nearest-even)
// ---------------------------------------------------------------------------

void seldon_f32_to_bf16(const float* src, uint16_t* dst, int64_t n) {
  const uint32_t* bits = reinterpret_cast<const uint32_t*>(src);
  for (int64_t i = 0; i < n; ++i) {
    uint32_t x = bits[i];
    // NaN stays NaN (avoid rounding a NaN payload into inf).
    if ((x & 0x7fffffffu) > 0x7f800000u) {
      dst[i] = static_cast<uint16_t>((x >> 16) | 0x0040);
      continue;
    }
    uint32_t lsb = (x >> 16) & 1u;
    uint32_t rounded = x + 0x7fffu + lsb;
    dst[i] = static_cast<uint16_t>(rounded >> 16);
  }
}

void seldon_bf16_to_f32(const uint16_t* src, float* dst, int64_t n) {
  uint32_t* bits = reinterpret_cast<uint32_t*>(dst);
  for (int64_t i = 0; i < n; ++i) {
    bits[i] = static_cast<uint32_t>(src[i]) << 16;
  }
}

// ---------------------------------------------------------------------------
// Batch fuse / split (byte-level; dtype-agnostic)
// ---------------------------------------------------------------------------

// Concatenate n buffers into dst. sizes[i] = byte length of srcs[i].
// Returns total bytes written.
int64_t seldon_batch_fuse(const uint8_t** srcs, const int64_t* sizes,
                          int32_t n, uint8_t* dst) {
  int64_t off = 0;
  for (int32_t i = 0; i < n; ++i) {
    std::memcpy(dst + off, srcs[i], static_cast<size_t>(sizes[i]));
    off += sizes[i];
  }
  return off;
}

// Split src into n buffers (inverse of fuse). Returns bytes consumed.
int64_t seldon_batch_split(const uint8_t* src, const int64_t* sizes,
                           int32_t n, uint8_t** dsts) {
  int64_t off = 0;
  for (int32_t i = 0; i < n; ++i) {
    std::memcpy(dsts[i], src + off, static_cast<size_t>(sizes[i]));
    off += sizes[i];
  }
  return off;
}

// ---------------------------------------------------------------------------
// Version / health probe for the ctypes loader
// ---------------------------------------------------------------------------

int32_t seldon_native_abi_version() { return 1; }

}  // extern "C"
