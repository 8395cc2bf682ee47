// lzcodecs — native LZ4-block and Snappy codecs (Ceph vendors
// liblz4/libsnappy as submodules and wraps them via CompressionPlugin,
// src/compressor/{lz4,snappy}/; neither library is a dependency here,
// so the block formats are implemented from their public specs:
//   LZ4 block:  https://github.com/lz4/lz4/blob/dev/doc/lz4_Block_format.md
//   Snappy:     https://github.com/google/snappy/blob/main/format_description.txt
// Compressors use greedy hash-chain matching (format-conformant; any
// spec decoder reads the output). Exposed through ctypes like the rest
// of this library. Copied from the reference's
// ceph_tpu/ops/native/lzcodecs.cc: both packages write the same bytes.

#include <cstdint>
#include <cstring>

namespace {

inline uint32_t hash32(uint32_t v) { return (v * 2654435761u) >> 20; }
constexpr int HASH_SIZE = 1 << 12;

inline uint32_t load32(const uint8_t *p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

}  // namespace

extern "C" {

// ---------------- LZ4 block format ----------------

// worst case: incompressible data + token overhead
int64_t lz4_max_compressed(int64_t n) { return n + n / 255 + 16; }

// returns compressed size, or -1 if dst too small
int64_t lz4_compress(const uint8_t *src, int64_t n, uint8_t *dst,
                     int64_t cap) {
  if (n == 0) return 0;
  int32_t table[HASH_SIZE];
  for (int i = 0; i < HASH_SIZE; i++) table[i] = -1;
  const int64_t MFLIMIT = 12;  // spec: last match must start 12B short
  int64_t ip = 0, anchor = 0, op = 0;

  auto emit = [&](int64_t lit_len, const uint8_t *lit, int64_t m_len,
                  int64_t m_off) -> bool {
    int64_t need = 1 + lit_len + lit_len / 255 + 1 + 2 + m_len / 255 + 1;
    if (op + need > cap) return false;
    uint8_t *tok = dst + op++;
    // literal length
    if (lit_len >= 15) {
      *tok = 15 << 4;
      int64_t rem = lit_len - 15;
      while (rem >= 255) { dst[op++] = 255; rem -= 255; }
      dst[op++] = (uint8_t)rem;
    } else {
      *tok = (uint8_t)(lit_len << 4);
    }
    std::memcpy(dst + op, lit, lit_len);
    op += lit_len;
    if (m_len == 0) return true;  // final literals-only sequence
    dst[op++] = (uint8_t)(m_off & 0xff);
    dst[op++] = (uint8_t)(m_off >> 8);
    int64_t ml = m_len - 4;       // spec: stored minus minmatch
    if (ml >= 15) {
      *tok |= 15;
      ml -= 15;
      while (ml >= 255) { dst[op++] = 255; ml -= 255; }
      dst[op++] = (uint8_t)ml;
    } else {
      *tok |= (uint8_t)ml;
    }
    return true;
  };

  while (ip + MFLIMIT < n) {
    uint32_t h = hash32(load32(src + ip)) & (HASH_SIZE - 1);
    int64_t cand = table[h];
    table[h] = (int32_t)ip;
    if (cand >= 0 && ip - cand <= 0xffff &&
        load32(src + cand) == load32(src + ip)) {
      int64_t m_len = 4;
      while (ip + m_len + 5 < n && src[cand + m_len] == src[ip + m_len])
        m_len++;
      if (!emit(ip - anchor, src + anchor, m_len, ip - cand)) return -1;
      ip += m_len;
      anchor = ip;
    } else {
      ip++;
    }
  }
  if (!emit(n - anchor, src + anchor, 0, 0)) return -1;
  return op;
}

// returns decompressed size, or -1 on corrupt input / overflow
int64_t lz4_decompress(const uint8_t *src, int64_t n, uint8_t *dst,
                       int64_t cap) {
  int64_t ip = 0, op = 0;
  while (ip < n) {
    uint8_t token = src[ip++];
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (ip >= n) return -1;
        b = src[ip++];
        lit += b;
      } while (b == 255);
    }
    if (ip + lit > n || op + lit > cap) return -1;
    std::memcpy(dst + op, src + ip, lit);
    ip += lit;
    op += lit;
    if (ip >= n) break;          // last sequence has no match
    if (ip + 2 > n) return -1;
    int64_t off = src[ip] | (src[ip + 1] << 8);
    ip += 2;
    if (off == 0 || off > op) return -1;
    int64_t ml = (token & 15);
    if (ml == 15) {
      uint8_t b;
      do {
        if (ip >= n) return -1;
        b = src[ip++];
        ml += b;
      } while (b == 255);
    }
    ml += 4;
    if (op + ml > cap) return -1;
    for (int64_t i = 0; i < ml; i++) {  // overlap-safe byte copy
      dst[op] = dst[op - off];
      op++;
    }
  }
  return op;
}

// ---------------- Snappy format ----------------

int64_t snappy_max_compressed(int64_t n) { return 32 + n + n / 6; }

static int64_t put_varint(uint8_t *dst, uint64_t v) {
  int64_t i = 0;
  while (v >= 0x80) {
    dst[i++] = (uint8_t)(v | 0x80);
    v >>= 7;
  }
  dst[i++] = (uint8_t)v;
  return i;
}

int64_t snappy_compress(const uint8_t *src, int64_t n, uint8_t *dst,
                        int64_t cap) {
  int64_t op = put_varint(dst, (uint64_t)n);
  int32_t table[HASH_SIZE];
  for (int i = 0; i < HASH_SIZE; i++) table[i] = -1;
  int64_t ip = 0, anchor = 0;

  auto emit_literal = [&](int64_t len, const uint8_t *lit) -> bool {
    while (len > 0) {                 // chunk: 2-byte length max
      int64_t piece = len > 65536 ? 65536 : len;
      if (op + piece + 8 > cap) return false;
      int64_t l = piece - 1;
      if (l < 60) {
        dst[op++] = (uint8_t)(l << 2);
      } else if (l < 256) {
        dst[op++] = (uint8_t)(60 << 2);
        dst[op++] = (uint8_t)l;
      } else {
        dst[op++] = (uint8_t)(61 << 2);
        dst[op++] = (uint8_t)(l & 0xff);
        dst[op++] = (uint8_t)(l >> 8);
      }
      std::memcpy(dst + op, lit, piece);
      op += piece;
      lit += piece;
      len -= piece;
    }
    return true;
  };
  auto emit_copy = [&](int64_t off, int64_t len) -> bool {
    while (len > 0) {
      if (op + 5 > cap) return false;
      if (len >= 4 && len < 12 && off < 2048) {
        dst[op++] = (uint8_t)(1 | ((len - 4) << 2) | ((off >> 8) << 5));
        dst[op++] = (uint8_t)(off & 0xff);
        len = 0;
      } else {
        int64_t l = len > 64 ? 64 : len;
        if (l < 4) return false;     // spec min copy is 4
        dst[op++] = (uint8_t)(2 | ((l - 1) << 2));
        dst[op++] = (uint8_t)(off & 0xff);
        dst[op++] = (uint8_t)(off >> 8);
        len -= l;
        if (len > 0 && len < 4) {    // avoid a tail shorter than 4
          len += l - 60;             // rebalance: emit 60, leave l-60+len
          op -= 3;
          dst[op++] = (uint8_t)(2 | ((60 - 1) << 2));
          dst[op++] = (uint8_t)(off & 0xff);
          dst[op++] = (uint8_t)(off >> 8);
        }
      }
    }
    return true;
  };

  while (ip + 8 < n) {
    uint32_t h = hash32(load32(src + ip)) & (HASH_SIZE - 1);
    int64_t cand = table[h];
    table[h] = (int32_t)ip;
    if (cand >= 0 && ip - cand <= 0xffff &&
        load32(src + cand) == load32(src + ip)) {
      int64_t m_len = 4;
      while (ip + m_len < n && src[cand + m_len] == src[ip + m_len])
        m_len++;
      if (!emit_literal(ip - anchor, src + anchor)) return -1;
      if (!emit_copy(ip - cand, m_len)) return -1;
      ip += m_len;
      anchor = ip;
    } else {
      ip++;
    }
  }
  if (!emit_literal(n - anchor, src + anchor)) return -1;
  return op;
}

int64_t snappy_uncompressed_length(const uint8_t *src, int64_t n) {
  uint64_t v = 0;
  int shift = 0;
  for (int64_t i = 0; i < n && i < 10; i++) {
    v |= (uint64_t)(src[i] & 0x7f) << shift;
    if (!(src[i] & 0x80)) return (int64_t)v;
    shift += 7;
  }
  return -1;
}

int64_t snappy_decompress(const uint8_t *src, int64_t n, uint8_t *dst,
                          int64_t cap) {
  uint64_t want = 0;
  int shift = 0;
  int64_t ip = 0;
  while (ip < n) {
    if (shift > 63) return -1;  // >10-byte varint: corrupt (a shift
                                // past 63 would be UB)
    uint8_t b = src[ip++];
    want |= (uint64_t)(b & 0x7f) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
  }
  int64_t op = 0;
  while (ip < n) {
    uint8_t tag = src[ip++];
    int64_t len, off;
    switch (tag & 3) {
      case 0: {                      // literal
        len = (tag >> 2) + 1;
        if (len > 60) {
          int extra = (int)len - 60;
          if (ip + extra > n) return -1;
          len = 0;
          for (int i = 0; i < extra; i++) len |= (int64_t)src[ip++] << (8 * i);
          len += 1;
        }
        if (ip + len > n || op + len > cap) return -1;
        std::memcpy(dst + op, src + ip, len);
        ip += len;
        op += len;
        continue;
      }
      case 1:                        // copy, 1-byte offset
        if (ip >= n) return -1;
        len = ((tag >> 2) & 7) + 4;
        off = ((tag >> 5) << 8) | src[ip++];
        break;
      case 2:                        // copy, 2-byte offset
        if (ip + 2 > n) return -1;
        len = (tag >> 2) + 1;
        off = src[ip] | (src[ip + 1] << 8);
        ip += 2;
        break;
      default:                       // copy, 4-byte offset
        if (ip + 4 > n) return -1;
        len = (tag >> 2) + 1;
        off = (int64_t)load32(src + ip);
        ip += 4;
        break;
    }
    if (off == 0 || off > op || op + len > cap) return -1;
    for (int64_t i = 0; i < len; i++) {
      dst[op] = dst[op - off];
      op++;
    }
  }
  return op == (int64_t)want ? op : -1;
}

}  // extern "C"
