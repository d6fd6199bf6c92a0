// Zstandard frame decoder (RFC 8878), without dictionaries, and CRC-32C.
//
// Host code for reading orbax checkpoints: zarr chunks and OCDBT nodes are
// zstd frames. Everything RFC 8878 defines is decoded except dictionaries:
// the frame header (single segment, window descriptor, frame content size,
// content checksum), skippable frames, raw / RLE / compressed blocks, the
// literals section (raw, RLE, Huffman with one or four streams, treeless),
// the sequences section (predefined, RLE, FSE-compressed and repeat modes),
// the three repeat offsets and the XXH64 content checksum, verified when the
// frame carries it. A frame naming a dictionary is refused.
//
// C interface (ctypes, seldon_tpu_torch/servers/zstd.py):
//   seldon_zstd_decompress(src, n, dst, cap) -> bytes written, or -1 with
//     the reason in seldon_zstd_last_error(); -2 when cap is too small.
//   seldon_zstd_content_size(src, n) -> the sum of every frame's content
//     size, -1 when a frame does not carry it, -2 on a malformed header.
//   seldon_crc32c(data, n, crc) -> CRC-32C (Castagnoli) continued from crc.

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>

namespace {

thread_local std::string g_error;

struct ZstdError : std::runtime_error {
  using std::runtime_error::runtime_error;
};
struct OutputFull {};

[[noreturn]] void fail(const std::string& what) { throw ZstdError(what); }

inline uint64_t load_le(const uint8_t* p, int n) {
  uint64_t v = 0;
  for (int i = 0; i < n; ++i) v |= uint64_t(p[i]) << (8 * i);
  return v;
}

inline int highest_bit(uint32_t v) { return 31 - __builtin_clz(v); }

// ---------------------------------------------------------------- XXH64 ---

constexpr uint64_t P1 = 11400714785074694791ULL;
constexpr uint64_t P2 = 14029467366897019727ULL;
constexpr uint64_t P3 = 1609587929392839161ULL;
constexpr uint64_t P4 = 9650029242287828579ULL;
constexpr uint64_t P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xx_round(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xx_merge(uint64_t acc, uint64_t v) {
  return (acc ^ xx_round(0, v)) * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xx_round(v1, load_le(p, 8));
      v2 = xx_round(v2, load_le(p + 8, 8));
      v3 = xx_round(v3, load_le(p + 16, 8));
      v4 = xx_round(v4, load_le(p + 24, 8));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xx_merge(h, v1);
    h = xx_merge(h, v2);
    h = xx_merge(h, v3);
    h = xx_merge(h, v4);
  } else {
    h = P5;
  }
  h += uint64_t(n);
  while (p + 8 <= end) {
    h ^= xx_round(0, load_le(p, 8));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= load_le(p, 4) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P5;
    h = rotl(h, 11) * P1;
    ++p;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// --------------------------------------------------------------- CRC-32C ---

struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (int s = 1; s < 8; ++s)
      for (uint32_t i = 0; i < 256; ++i)
        t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

uint32_t crc32c(const uint8_t* p, size_t n, uint32_t crc) {
  static const Crc32cTable tab;
  const auto& t = tab.t;
  crc = ~crc;
  while (n >= 8) {
    uint64_t v = load_le(p, 8) ^ crc;
    crc = t[7][v & 0xFF] ^ t[6][(v >> 8) & 0xFF] ^ t[5][(v >> 16) & 0xFF] ^
          t[4][(v >> 24) & 0xFF] ^ t[3][(v >> 32) & 0xFF] ^
          t[2][(v >> 40) & 0xFF] ^ t[1][(v >> 48) & 0xFF] ^ t[0][v >> 56];
    p += 8;
    n -= 8;
  }
  while (n--) crc = (crc >> 8) ^ t[0][(crc ^ *p++) & 0xFF];
  return ~crc;
}

// ------------------------------------------------------------ bit streams ---

// Forward little-endian bit reader (FSE table descriptions).
struct FwdBits {
  const uint8_t* p;
  size_t n;
  size_t bit = 0;
  uint32_t read(int k) {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i, ++bit) {
      if ((bit >> 3) >= n) fail("FSE table description runs past its section");
      v |= uint32_t((p[bit >> 3] >> (bit & 7)) & 1) << i;
    }
    return v;
  }
  size_t bytes_used() const { return (bit + 7) >> 3; }
};

// Backward bit reader: the stream's last byte holds a marker bit above the
// first bit to read; bits are consumed from the end towards the start. Bits
// below the start read as zero (the FSE streams' overflow rule).
struct BackBits {
  const uint8_t* p;
  size_t n;
  int64_t pos;  // bits left above the start

  BackBits(const uint8_t* data, size_t len) : p(data), n(len) {
    if (len == 0) fail("empty bitstream");
    uint8_t last = data[len - 1];
    if (last == 0) fail("bitstream's last byte has no end marker");
    pos = int64_t(len - 1) * 8 + highest_bit(last);
  }
  // The k (<= 56) bits below pos, without consuming them.
  inline uint64_t peek(int k) const {
    if (k == 0) return 0;
    int64_t lo = pos - k;
    if (lo < 0) {
      int have = int(pos);
      if (have <= 0) return 0;
      return (window(0) & ((uint64_t(1) << have) - 1)) << (-lo);
    }
    return (window(lo) >> (lo & 7)) & ((uint64_t(1) << k) - 1);
  }
  inline uint64_t window(int64_t bitpos) const {
    size_t byte = size_t(bitpos >> 3);
    if (byte + 8 <= n) {
      uint64_t v;
      std::memcpy(&v, p + byte, 8);
      return v;  // little-endian host (x86-64, aarch64)
    }
    return load_le(p + byte, int(n - byte));
  }
  inline uint64_t read(int k) {
    uint64_t v = peek(k);
    pos -= k;
    return v;
  }
};

// -------------------------------------------------------------------- FSE ---

struct FseTable {
  int log = -1;  // -1: no table yet (a repeat mode has nothing to repeat)
  uint8_t sym[512];
  uint8_t bits[512];
  uint16_t base[512];
};

void fse_build(FseTable& t, const int16_t* norm, int nsym, int log) {
  const int size = 1 << log;
  uint16_t next[256];
  int high = size - 1;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      t.sym[high--] = uint8_t(s);
      next[s] = 1;
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3;
  const int mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] <= 0) continue;
    next[s] = uint16_t(norm[s]);
    for (int i = 0; i < norm[s]; ++i) {
      t.sym[pos] = uint8_t(s);
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  }
  if (pos != 0) fail("FSE table's probabilities do not spread");
  for (int i = 0; i < size; ++i) {
    uint16_t d = next[t.sym[i]]++;
    int nb = log - highest_bit(d);
    t.bits[i] = uint8_t(nb);
    t.base[i] = uint16_t((d << nb) - size);
  }
  t.log = log;
}

void fse_rle(FseTable& t, uint8_t symbol) {
  t.sym[0] = symbol;
  t.bits[0] = 0;
  t.base[0] = 0;
  t.log = 0;
}

// Reads a table description at p (at most n bytes); returns bytes used.
size_t fse_read(FseTable& t, const uint8_t* p, size_t n, int max_log,
                int max_sym) {
  FwdBits in{p, n};
  int log = 5 + int(in.read(4));
  if (log > max_log) fail("FSE accuracy log above its maximum");
  int32_t remaining = 1 << log;
  int16_t norm[256];
  int s = 0;
  while (remaining > 0) {
    if (s > max_sym) fail("FSE table description has too many symbols");
    int nb = highest_bit(uint32_t(remaining + 1)) + 1;
    uint32_t val = in.read(nb);
    uint32_t lower = (1u << (nb - 1)) - 1;
    uint32_t threshold = (1u << nb) - 1 - uint32_t(remaining + 1);
    if ((val & lower) < threshold) {
      in.bit -= 1;
      val &= lower;
    } else if (val > lower) {
      val -= threshold;
    }
    int proba = int(val) - 1;
    remaining -= proba < 0 ? -proba : proba;
    norm[s++] = int16_t(proba);
    if (proba == 0) {
      for (;;) {
        int rep = int(in.read(2));
        for (int i = 0; i < rep; ++i) {
          if (s > max_sym) fail("FSE zero run past the last symbol");
          norm[s++] = 0;
        }
        if (rep != 3) break;
      }
    }
  }
  if (remaining != 0) fail("FSE probabilities do not sum to the table size");
  fse_build(t, norm, s, log);
  return in.bytes_used();
}

// ---------------------------------------------------------------- Huffman ---

struct HufTable {
  int max_bits = 0;  // 0: no table yet
  uint8_t sym[1 << 11];
  uint8_t bits[1 << 11];
  uint16_t entry[1 << 11];  // sym | bits << 8: one load per symbol
};

void huf_build(HufTable& t, const uint8_t* weights, int nsym) {
  uint32_t total = 0;
  for (int i = 0; i < nsym; ++i) {
    if (weights[i] > 11) fail("Huffman weight above 11");
    if (weights[i]) total += 1u << (weights[i] - 1);
  }
  if (total == 0) fail("Huffman weights are all zero");
  int max_bits = highest_bit(total) + 1;
  if (max_bits > 11) fail("Huffman code longer than 11 bits");
  uint32_t rest = (1u << max_bits) - total;
  if (rest & (rest - 1)) fail("Huffman weights leave no power of two");
  uint8_t w[256];
  std::memcpy(w, weights, size_t(nsym));
  if (nsym >= 256) fail("Huffman table of more than 256 symbols");
  w[nsym] = uint8_t(highest_bit(rest) + 1);
  int count = nsym + 1;
  uint8_t nbits[256];
  uint32_t rank_count[13] = {0};
  for (int i = 0; i < count; ++i) {
    nbits[i] = w[i] ? uint8_t(max_bits + 1 - w[i]) : 0;
    rank_count[nbits[i]]++;
  }
  uint32_t start[13];
  start[max_bits] = 0;
  for (int b = max_bits; b >= 1; --b) {
    start[b - 1] = start[b] + rank_count[b] * (1u << (max_bits - b));
    for (uint32_t i = start[b]; i < start[b - 1]; ++i) t.bits[i] = uint8_t(b);
  }
  if (start[0] != (1u << max_bits)) fail("Huffman table does not fill");
  for (int i = 0; i < count; ++i) {
    if (!nbits[i]) continue;
    uint32_t len = 1u << (max_bits - nbits[i]);
    std::memset(t.sym + start[nbits[i]], i, len);
    start[nbits[i]] += len;
  }
  for (uint32_t i = 0; i < (1u << max_bits); ++i)
    t.entry[i] = uint16_t(t.sym[i] | (t.bits[i] << 8));
  t.max_bits = max_bits;
}

// Reads a Huffman tree description; returns bytes used.
size_t huf_read(HufTable& t, const uint8_t* p, size_t n) {
  if (n < 1) fail("Huffman tree description is empty");
  uint8_t weights[256];
  int nsym = 0;
  size_t used;
  uint8_t head = p[0];
  if (head >= 128) {
    nsym = head - 127;
    used = 1 + size_t((nsym + 1) / 2);
    if (used > n) fail("Huffman weights run past the literals section");
    for (int i = 0; i < nsym; ++i) {
      uint8_t b = p[1 + i / 2];
      weights[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
  } else {
    size_t csize = head;
    used = 1 + csize;
    if (used > n) fail("Huffman weights run past the literals section");
    FseTable ft;
    size_t hdr = fse_read(ft, p + 1, csize, 6, 255);
    if (hdr >= csize) fail("Huffman weights' FSE stream is empty");
    BackBits in(p + 1 + hdr, csize - hdr);
    uint32_t s1 = uint32_t(in.read(ft.log));
    uint32_t s2 = uint32_t(in.read(ft.log));
    for (;;) {
      if (nsym >= 255) fail("too many Huffman weights");
      weights[nsym++] = ft.sym[s1];
      s1 = ft.base[s1] + uint32_t(in.read(ft.bits[s1]));
      if (in.pos < 0) {
        weights[nsym++] = ft.sym[s2];
        break;
      }
      if (nsym >= 255) fail("too many Huffman weights");
      weights[nsym++] = ft.sym[s2];
      s2 = ft.base[s2] + uint32_t(in.read(ft.bits[s2]));
      if (in.pos < 0) {
        weights[nsym++] = ft.sym[s1];
        break;
      }
    }
  }
  huf_build(t, weights, nsym);
  return used;
}

// One Huffman stream being decoded: its bits, where its symbols go and
// how many are left.
struct HufStream {
  BackBits in;
  uint8_t* out;
  size_t left;
};

// Decodes 56 / MB symbols of `s` from one 56-bit window (needs that many
// left and 56 bits left): one unaligned load, one table load per symbol.
template <int MB>
inline void huf_window(const HufTable& t, HufStream& s) {
  constexpr int per = 56 / MB;
  constexpr uint64_t mask = (uint64_t(1) << MB) - 1;
  int64_t lo = s.in.pos - 56;
  uint64_t v;
  std::memcpy(&v, s.in.p + (lo >> 3), 8);  // lo >> 3 <= n - 8 here
  v >>= (lo & 7);
  int used = 0;
  for (int k = 0; k < per; ++k) {
    uint16_t e = t.entry[(v >> (56 - used - MB)) & mask];
    s.out[k] = uint8_t(e);
    used += e >> 8;
  }
  s.out += per;
  s.in.pos -= used;
  s.left -= per;
}

// Decodes K streams of a table of MB-bit codes: interleaved window by
// window while every stream has a window's worth left (their dependency
// chains overlap), then each to its end bit by bit. Each stream must end
// exactly at its first bit.
template <int K, int MB>
void huf_streams_mb(const HufTable& t, HufStream* s) {
  constexpr size_t per = 56 / MB;
  for (;;) {
    bool room = true;
    for (int j = 0; j < K; ++j)
      room &= s[j].left >= per && s[j].in.pos >= 56;
    if (!room) break;
    for (int j = 0; j < K; ++j) huf_window<MB>(t, s[j]);
  }
  for (int j = 0; j < K; ++j) {
    HufStream& x = s[j];
    while (x.left >= per && x.in.pos >= 56) huf_window<MB>(t, x);
    for (; x.left; --x.left) {
      uint16_t e = t.entry[x.in.peek(MB)];
      *x.out++ = uint8_t(e);
      x.in.pos -= e >> 8;
    }
    if (x.in.pos != 0) fail("Huffman stream not consumed exactly");
  }
}

template <int K>
void huf_streams(const HufTable& t, HufStream* s) {
  switch (t.max_bits) {
    case 1: return huf_streams_mb<K, 1>(t, s);
    case 2: return huf_streams_mb<K, 2>(t, s);
    case 3: return huf_streams_mb<K, 3>(t, s);
    case 4: return huf_streams_mb<K, 4>(t, s);
    case 5: return huf_streams_mb<K, 5>(t, s);
    case 6: return huf_streams_mb<K, 6>(t, s);
    case 7: return huf_streams_mb<K, 7>(t, s);
    case 8: return huf_streams_mb<K, 8>(t, s);
    case 9: return huf_streams_mb<K, 9>(t, s);
    case 10: return huf_streams_mb<K, 10>(t, s);
    default: return huf_streams_mb<K, 11>(t, s);
  }
}

// ---------------------------------------------------------------- frames ---

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,
                              9,  10, 11,  12,  13,  14,   15,   16,   18,
                              20, 22, 24,  28,  32,  40,   48,   64,   128,
                              256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
                              65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2,  2,  3,  3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,   15,   16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26,  27,  28,   29,   30,
    31, 32, 33, 34, 35, 37, 39, 41, 43, 47,  51,  59,   67,   83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2,  3,  3,  4,  4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2,  2,  2,
                                2, 1, 1, 1, 2, 2, 2, 2, 2, 2,  2,  2,
                                2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1,  1,  1,  1,  1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

constexpr size_t kBlockMax = 128 * 1024;

struct Frame {
  uint8_t* out;        // the whole output buffer
  size_t cap;
  size_t frame_start;  // where this frame's output begins
  size_t at;           // write position
  HufTable huf;
  FseTable ll, of, ml;
  uint64_t rep[3] = {1, 4, 8};
  uint8_t lit[kBlockMax];

  void need(size_t k) const {
    if (at + k > cap) throw OutputFull();
  }
};

// Literals section at p; returns bytes used, the literals in f.lit.
size_t read_literals(Frame& f, const uint8_t* p, size_t n, size_t* nlit) {
  if (n < 1) fail("block has no literals section");
  int type = p[0] & 3;
  int sf = (p[0] >> 2) & 3;
  if (type < 2) {  // raw or RLE
    size_t hdr, size;
    if ((sf & 1) == 0) {
      hdr = 1;
      size = p[0] >> 3;
    } else if (sf == 1) {
      hdr = 2;
      if (n < 2) fail("literals header truncated");
      size = (p[0] >> 4) + (size_t(p[1]) << 4);
    } else {
      hdr = 3;
      if (n < 3) fail("literals header truncated");
      size = (p[0] >> 4) + (size_t(p[1]) << 4) + (size_t(p[2]) << 12);
    }
    if (size > kBlockMax) fail("literals larger than a block");
    if (type == 0) {
      if (hdr + size > n) fail("raw literals run past the block");
      std::memcpy(f.lit, p + hdr, size);
      *nlit = size;
      return hdr + size;
    }
    if (hdr + 1 > n) fail("RLE literals run past the block");
    std::memset(f.lit, p[hdr], size);
    *nlit = size;
    return hdr + 1;
  }
  // Huffman-compressed (2) or treeless (3).
  size_t hdr, regen, csize;
  int streams = sf == 0 ? 1 : 4;
  if (sf < 2) {
    hdr = 3;
    if (n < 3) fail("literals header truncated");
    uint64_t h = load_le(p, 3);
    regen = (h >> 4) & 0x3FF;
    csize = (h >> 14) & 0x3FF;
  } else if (sf == 2) {
    hdr = 4;
    if (n < 4) fail("literals header truncated");
    uint64_t h = load_le(p, 4);
    regen = (h >> 4) & 0x3FFF;
    csize = (h >> 18) & 0x3FFF;
  } else {
    hdr = 5;
    if (n < 5) fail("literals header truncated");
    uint64_t h = load_le(p, 5);
    regen = (h >> 4) & 0x3FFFF;
    csize = (h >> 22) & 0x3FFFF;
  }
  if (regen > kBlockMax) fail("literals larger than a block");
  if (hdr + csize > n) fail("compressed literals run past the block");
  const uint8_t* q = p + hdr;
  size_t qn = csize;
  if (type == 2) {
    size_t used = huf_read(f.huf, q, qn);
    q += used;
    qn -= used;
  } else if (f.huf.max_bits == 0) {
    fail("treeless literals with no earlier Huffman table");
  }
  if (streams == 1) {
    HufStream one{BackBits(q, qn), f.lit, regen};
    huf_streams<1>(f.huf, &one);
  } else {
    if (qn < 6) fail("four-stream literals lack their jump table");
    size_t s1 = load_le(q, 2), s2 = load_le(q + 2, 2), s3 = load_le(q + 4, 2);
    if (6 + s1 + s2 + s3 > qn) fail("jump table points past the literals");
    size_t s4 = qn - 6 - s1 - s2 - s3;
    size_t each = (regen + 3) / 4;
    if (3 * each > regen) fail("four-stream literals too short");
    const uint8_t* b = q + 6;
    HufStream four[4] = {
        {BackBits(b, s1), f.lit, each},
        {BackBits(b + s1, s2), f.lit + each, each},
        {BackBits(b + s1 + s2, s3), f.lit + 2 * each, each},
        {BackBits(b + s1 + s2 + s3, s4), f.lit + 3 * each, regen - 3 * each}};
    huf_streams<4>(f.huf, four);
  }
  *nlit = regen;
  return hdr + csize;
}

size_t read_table(FseTable& t, int mode, const uint8_t* p, size_t n,
                  const int16_t* deflt, int ndef, int deflog, int max_log,
                  int max_sym, const char* name) {
  switch (mode) {
    case 0:
      fse_build(t, deflt, ndef, deflog);
      return 0;
    case 1:
      if (n < 1) fail(std::string(name) + " RLE table truncated");
      if (p[0] > max_sym) fail(std::string(name) + " RLE symbol out of range");
      fse_rle(t, p[0]);
      return 1;
    case 2:
      return fse_read(t, p, n, max_log, max_sym);
    default:
      if (t.log < 0)
        fail(std::string(name) + " repeat mode with no earlier table");
      return 0;
  }
}

void copy_match(Frame& f, size_t offset, size_t len) {
  if (offset == 0 || offset > f.at - f.frame_start)
    fail("match offset reaches before the frame's output");
  f.need(len);
  uint8_t* dst = f.out + f.at;
  const uint8_t* src = dst - offset;
  if (offset >= len) {
    std::memcpy(dst, src, len);
  } else {
    for (size_t i = 0; i < len; ++i) dst[i] = src[i];
  }
  f.at += len;
}

void compressed_block(Frame& f, const uint8_t* p, size_t n) {
  size_t block_start = f.at;
  size_t nlit;
  size_t used = read_literals(f, p, n, &nlit);
  p += used;
  n -= used;
  if (n < 1) fail("block has no sequences section");
  size_t nseq;
  if (p[0] < 128) {
    nseq = p[0];
    used = 1;
  } else if (p[0] < 255) {
    if (n < 2) fail("sequence count truncated");
    nseq = (size_t(p[0] - 128) << 8) + p[1];
    used = 2;
  } else {
    if (n < 3) fail("sequence count truncated");
    nseq = p[1] + (size_t(p[2]) << 8) + 0x7F00;
    used = 3;
  }
  p += used;
  n -= used;
  size_t lit_at = 0;
  if (nseq > 0) {
    if (n < 1) fail("sequences section lacks its modes");
    uint8_t modes = p[0];
    if (modes & 3) fail("reserved bits set in the sequence modes");
    p += 1;
    n -= 1;
    used = read_table(f.ll, modes >> 6, p, n, kLLDefault, 36, 6, 9, 35,
                      "literal length");
    p += used;
    n -= used;
    used = read_table(f.of, (modes >> 4) & 3, p, n, kOFDefault, 29, 5, 8, 31,
                      "offset");
    p += used;
    n -= used;
    used = read_table(f.ml, (modes >> 2) & 3, p, n, kMLDefault, 53, 6, 9, 52,
                      "match length");
    p += used;
    n -= used;
    BackBits in(p, n);
    uint32_t sll = uint32_t(in.read(f.ll.log));
    uint32_t sof = uint32_t(in.read(f.of.log));
    uint32_t sml = uint32_t(in.read(f.ml.log));
    for (size_t i = 0; i < nseq; ++i) {
      uint8_t ofc = f.of.sym[sof], llc = f.ll.sym[sll], mlc = f.ml.sym[sml];
      if (llc > 35 || mlc > 52 || ofc > 31) fail("sequence code out of range");
      uint64_t ofv = (uint64_t(1) << ofc) + in.read(ofc);
      uint64_t ml = kMLBase[mlc] + in.read(kMLBits[mlc]);
      uint64_t ll = kLLBase[llc] + in.read(kLLBits[llc]);
      if (i + 1 < nseq) {
        sll = f.ll.base[sll] + uint32_t(in.read(f.ll.bits[sll]));
        sml = f.ml.base[sml] + uint32_t(in.read(f.ml.bits[sml]));
        sof = f.of.base[sof] + uint32_t(in.read(f.of.bits[sof]));
      }
      uint64_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        f.rep[2] = f.rep[1];
        f.rep[1] = f.rep[0];
        f.rep[0] = offset;
      } else {
        uint64_t idx = ofv - 1 + (ll == 0 ? 1 : 0);
        if (idx == 0) {
          offset = f.rep[0];
        } else {
          offset = idx < 3 ? f.rep[idx] : f.rep[0] - 1;
          if (idx > 1) f.rep[2] = f.rep[1];
          f.rep[1] = f.rep[0];
          f.rep[0] = offset;
        }
      }
      if (ll > nlit - lit_at) fail("sequence takes more literals than exist");
      f.need(ll);
      std::memcpy(f.out + f.at, f.lit + lit_at, ll);
      f.at += ll;
      lit_at += ll;
      copy_match(f, offset, ml);
    }
    if (in.pos != 0) fail("sequences bitstream not consumed exactly");
  } else if (n != 0) {
    fail("bytes after an empty sequences section");
  }
  size_t rest = nlit - lit_at;
  f.need(rest);
  std::memcpy(f.out + f.at, f.lit + lit_at, rest);
  f.at += rest;
  if (f.at - block_start > kBlockMax) fail("block decodes to more than 128 KB");
}

struct Header {
  size_t size;            // header bytes after the magic number
  uint64_t content_size;  // UINT64_MAX when absent
  bool checksum;
};

Header frame_header(const uint8_t* p, size_t n) {
  if (n < 1) fail("frame header truncated");
  uint8_t fhd = p[0];
  int fcs_flag = fhd >> 6;
  bool single = (fhd >> 5) & 1;
  if (fhd & 8) fail("reserved bit set in the frame header");
  int did_flag = fhd & 3;
  size_t at = 1;
  if (!single) {
    if (n < 2) fail("frame header truncated");
    uint8_t wd = p[1];
    if ((wd >> 3) > 31 - 10) fail("window larger than the format allows");
    at += 1;
  }
  static const int did_len[4] = {0, 1, 2, 4};
  size_t dl = did_len[did_flag];
  if (at + dl > n) fail("frame header truncated");
  if (dl && load_le(p + at, int(dl)) != 0)
    fail("frame names a dictionary; dictionaries are not supported");
  at += dl;
  static const int fcs_len[4] = {0, 2, 4, 8};
  size_t fl = fcs_flag == 0 ? (single ? 1 : 0) : fcs_len[fcs_flag];
  if (at + fl > n) fail("frame header truncated");
  uint64_t fcs = UINT64_MAX;
  if (fl) {
    fcs = load_le(p + at, int(fl));
    if (fl == 2) fcs += 256;
  }
  at += fl;
  return Header{at, fcs, bool((fhd >> 2) & 1)};
}

constexpr uint32_t kMagic = 0xFD2FB528u;

bool skippable(uint32_t magic) { return (magic & 0xFFFFFFF0u) == 0x184D2A50u; }

// Decodes one frame at p; returns its input bytes.
size_t decode_frame(Frame& f, const uint8_t* p, size_t n) {
  Header h = frame_header(p + 4, n - 4);
  size_t at = 4 + h.size;
  f.frame_start = f.at;
  f.huf.max_bits = 0;
  f.ll.log = f.of.log = f.ml.log = -1;
  f.rep[0] = 1;
  f.rep[1] = 4;
  f.rep[2] = 8;
  for (;;) {
    if (at + 3 > n) fail("block header truncated");
    uint32_t bh = uint32_t(load_le(p + at, 3));
    at += 3;
    bool last = bh & 1;
    int type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (type == 3) fail("reserved block type");
    if (type == 1) {
      if (at + 1 > n) fail("RLE block truncated");
      if (size > kBlockMax) fail("block larger than 128 KB");
      f.need(size);
      std::memset(f.out + f.at, p[at], size);
      f.at += size;
      at += 1;
    } else {
      if (size > kBlockMax) fail("block larger than 128 KB");
      if (at + size > n) fail("block runs past the end of the input");
      if (type == 0) {
        f.need(size);
        std::memcpy(f.out + f.at, p + at, size);
        f.at += size;
      } else {
        compressed_block(f, p + at, size);
      }
      at += size;
    }
    if (last) break;
  }
  size_t produced = f.at - f.frame_start;
  if (h.content_size != UINT64_MAX && produced != h.content_size)
    fail("frame decodes to another size than its header states");
  if (h.checksum) {
    if (at + 4 > n) fail("content checksum truncated");
    uint32_t want = uint32_t(load_le(p + at, 4));
    uint32_t got = uint32_t(xxh64(f.out + f.frame_start, produced));
    if (want != got) fail("content checksum mismatch");
    at += 4;
  }
  return at;
}

int64_t decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  static thread_local Frame* frame = nullptr;
  if (!frame) frame = new Frame();  // ~400 KB of tables: not on the stack
  Frame& f = *frame;
  f.out = dst;
  f.cap = cap;
  f.at = 0;
  size_t at = 0;
  if (n == 0) fail("no zstd frame in an empty input");
  while (at < n) {
    if (n - at < 4) fail("truncated frame magic number");
    uint32_t magic = uint32_t(load_le(src + at, 4));
    if (skippable(magic)) {
      if (n - at < 8) fail("skippable frame truncated");
      uint64_t len = load_le(src + at + 4, 4);
      if (len > n - at - 8) fail("skippable frame runs past the input");
      at += 8 + len;
      continue;
    }
    if (magic != kMagic) fail("not a zstd frame (bad magic number)");
    at += decode_frame(f, src + at, n - at);
  }
  return int64_t(f.at);
}

}  // namespace

extern "C" {

int32_t seldon_zstd_abi_version() { return 1; }

const char* seldon_zstd_last_error() { return g_error.c_str(); }

int64_t seldon_zstd_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                               int64_t cap) {
  try {
    return decompress(src, size_t(n), dst, size_t(cap));
  } catch (const OutputFull&) {
    g_error = "output buffer too small";
    return -2;
  } catch (const std::exception& e) {
    g_error = e.what();
    return -1;
  }
}

int64_t seldon_zstd_content_size(const uint8_t* src, int64_t n) {
  try {
    size_t at = 0, len = size_t(n);
    uint64_t total = 0;
    while (at < len) {
      if (len - at < 4) fail("truncated frame magic number");
      uint32_t magic = uint32_t(load_le(src + at, 4));
      if (skippable(magic)) {
        if (len - at < 8) fail("skippable frame truncated");
        at += 8 + load_le(src + at + 4, 4);
        continue;
      }
      if (magic != kMagic) fail("not a zstd frame (bad magic number)");
      Header h = frame_header(src + at + 4, len - at - 4);
      if (h.content_size == UINT64_MAX) return -1;
      total += h.content_size;
      // Walk the blocks to the next frame.
      at += 4 + h.size;
      for (;;) {
        if (at + 3 > len) fail("block header truncated");
        uint32_t bh = uint32_t(load_le(src + at, 3));
        at += 3 + (((bh >> 1) & 3) == 1 ? 1 : (bh >> 3));
        if (bh & 1) break;
      }
      if (h.checksum) at += 4;
    }
    return int64_t(total);
  } catch (const std::exception& e) {
    g_error = e.what();
    return -2;
  }
}

uint32_t seldon_crc32c(const uint8_t* p, int64_t n, uint32_t crc) {
  return crc32c(p, size_t(n), crc);
}

uint64_t seldon_xxh64(const uint8_t* p, int64_t n) { return xxh64(p, size_t(n)); }

}  // extern "C"
