// Host checksum kernels of the port's native library: crc32c (Castagnoli)
// and xxhash32 / xxhash64.
//
// Copied from the reference's ceph_tpu/ops/native/gf256.cc, checksum part
// only: the host GF(2^8) matvec there is left out (the port's host GF runs
// in numpy and torch). The role of src/common/Checksummer.h and
// crc32c_intel_fast_asm.s: the blockstore's blob checksums, the kv WAL's
// record crcs, the messenger's frame crcs and the OSD's shard hinfo crcs.
// crc32c uses the SSE4.2 crc32 instruction (8 bytes a step), a slice-by-8
// table otherwise; the values equal the reference's on every input.
//
// Build: ceph_tpu_torch/ops/native_loader.py (lazy, on first use).

#include <cstdint>
#include <cstring>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// crc32c (Castagnoli) — the BlueStore/messenger checksum
// (role of src/common/crc32c_intel_fast_asm.s + sctp_crc32.c)
// ---------------------------------------------------------------------------

static uint32_t CRC_TBL[8][256];
static int crc_inited = 0;

static void crc32c_init_tbl(void) {
  if (crc_inited) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int j = 0; j < 8; j++) c = (c >> 1) ^ (0x82f63b78u & (~(c & 1) + 1));
    CRC_TBL[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = CRC_TBL[0][i];
    for (int t = 1; t < 8; t++) {
      c = (c >> 8) ^ CRC_TBL[0][c & 0xff];
      CRC_TBL[t][i] = c;
    }
  }
  crc_inited = 1;
}

uint32_t ceph_crc32c(uint32_t crc, const uint8_t *buf, uint64_t len) {
  crc32c_init_tbl();
  crc = ~crc;
  uint64_t i = 0;
#if defined(__SSE4_2__)
  for (; i + 8 <= len; i += 8) {
    uint64_t v;
    std::memcpy(&v, buf + i, 8);
    crc = (uint32_t)_mm_crc32_u64(crc, v);
  }
  for (; i < len; i++) crc = _mm_crc32_u8(crc, buf[i]);
#else
  for (; i + 8 <= len; i += 8) {
    crc ^= (uint32_t)(buf[i] | (buf[i + 1] << 8) | (buf[i + 2] << 16) |
                      ((uint32_t)buf[i + 3] << 24));
    uint32_t hi = (uint32_t)(buf[i + 4] | (buf[i + 5] << 8) |
                             (buf[i + 6] << 16) | ((uint32_t)buf[i + 7] << 24));
    uint32_t c = CRC_TBL[7][crc & 0xff] ^ CRC_TBL[6][(crc >> 8) & 0xff] ^
                 CRC_TBL[5][(crc >> 16) & 0xff] ^ CRC_TBL[4][crc >> 24] ^
                 CRC_TBL[3][hi & 0xff] ^ CRC_TBL[2][(hi >> 8) & 0xff] ^
                 CRC_TBL[1][(hi >> 16) & 0xff] ^ CRC_TBL[0][hi >> 24];
    crc = c;
  }
  for (; i < len; i++) crc = (crc >> 8) ^ CRC_TBL[0][(crc ^ buf[i]) & 0xff];
#endif
  return ~crc;
}

// ---------------------------------------------------------------------------
// xxhash64 (role of the xxHash submodule used by Checksummer.h)
// ---------------------------------------------------------------------------

static const uint64_t P1 = 0x9E3779B185EBCA87ULL;
static const uint64_t P2 = 0xC2B2AE3D27D4EB4FULL;
static const uint64_t P3 = 0x165667B19E3779F9ULL;
static const uint64_t P4 = 0x85EBCA77C2B2AE63ULL;
static const uint64_t P5 = 0x27D4EB2F165667C5ULL;

static inline uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}
static inline uint64_t rd64(const uint8_t *p) {
  uint64_t v; std::memcpy(&v, p, 8); return v;
}
static inline uint32_t rd32(const uint8_t *p) {
  uint32_t v; std::memcpy(&v, p, 4); return v;
}
static inline uint64_t round1(uint64_t acc, uint64_t input) {
  acc += input * P2; acc = rotl64(acc, 31); acc *= P1; return acc;
}
static inline uint64_t merge(uint64_t acc, uint64_t val) {
  val = round1(0, val); acc ^= val; acc = acc * P1 + P4; return acc;
}

uint64_t ceph_xxhash64(uint64_t seed, const uint8_t *p, uint64_t len) {
  const uint8_t *end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t *limit = end - 32;
    do {
      v1 = round1(v1, rd64(p)); p += 8;
      v2 = round1(v2, rd64(p)); p += 8;
      v3 = round1(v3, rd64(p)); p += 8;
      v4 = round1(v4, rd64(p)); p += 8;
    } while (p <= limit);
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = merge(h, v1); h = merge(h, v2); h = merge(h, v3); h = merge(h, v4);
  } else {
    h = seed + P5;
  }
  h += len;
  while (p + 8 <= end) {
    h ^= round1(0, rd64(p));
    h = rotl64(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= (uint64_t)rd32(p) * P1;
    h = rotl64(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= (*p) * P5;
    h = rotl64(h, 11) * P1;
    p++;
  }
  h ^= h >> 33; h *= P2; h ^= h >> 29; h *= P3; h ^= h >> 32;
  return h;
}

uint32_t ceph_xxhash32(uint32_t seed, const uint8_t *p, uint64_t len) {
  const uint32_t Q1 = 0x9E3779B1u, Q2 = 0x85EBCA77u, Q3 = 0xC2B2AE3Du,
                 Q4 = 0x27D4EB2Fu, Q5 = 0x165667B1u;
  const uint8_t *end = p + len;
  uint32_t h;
  auto rotl32 = [](uint32_t x, int r) { return (x << r) | (x >> (32 - r)); };
  if (len >= 16) {
    uint32_t v1 = seed + Q1 + Q2, v2 = seed + Q2, v3 = seed, v4 = seed - Q1;
    const uint8_t *limit = end - 16;
    do {
      v1 = rotl32(v1 + rd32(p) * Q2, 13) * Q1; p += 4;
      v2 = rotl32(v2 + rd32(p) * Q2, 13) * Q1; p += 4;
      v3 = rotl32(v3 + rd32(p) * Q2, 13) * Q1; p += 4;
      v4 = rotl32(v4 + rd32(p) * Q2, 13) * Q1; p += 4;
    } while (p <= limit);
    h = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
  } else {
    h = seed + Q5;
  }
  h += (uint32_t)len;
  while (p + 4 <= end) { h = rotl32(h + rd32(p) * Q3, 17) * Q4; p += 4; }
  while (p < end) { h = rotl32(h + (*p) * Q5, 11) * Q1; p++; }
  h ^= h >> 15; h *= Q2; h ^= h >> 13; h *= Q3; h ^= h >> 16;
  return h;
}

}  // extern "C"
