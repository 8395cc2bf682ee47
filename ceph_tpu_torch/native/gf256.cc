// Host GF(2^8) kernels of the port's native library: the erasure-code
// matvec (the ec_encode_data role of ISA-L), region XOR and region
// multiply-add.
//
// Copied from the reference's ceph_tpu/ops/native/gf256.cc, GF part only
// (the checksum part is native/checksum.cc). The host twin of an EC pool
// (osd/ec_backend.py HOST_BACKEND), ec_util's host flush and Clay's inner
// codecs encode and decode through it, as the reference's do through its
// "native" backend.
//
// GF(2^8) poly 0x11d (gf-complete w=8 / ISA-L field). The hot loop uses the
// same split-nibble table technique ISA-L implements in asm: y = T_lo[x&15]
// ^ T_hi[x>>4] with 16-entry tables in SIMD registers via PSHUFB (AVX2),
// scalar table fallback otherwise. The values equal the reference's on
// every input.
//
// Build: ceph_tpu_torch/ops/native_loader.py (lazy, on first use), which
// calls gf256_init() once when it loads the library.

#include <cstdint>
#include <cstring>

#if defined(__x86_64__)
#include <immintrin.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Tables
// ---------------------------------------------------------------------------

static uint8_t MUL[256][256];
static uint8_t NIB_LO[256][16];  // NIB_LO[c][n] = c * n        (low nibble)
static uint8_t NIB_HI[256][16];  // NIB_HI[c][n] = c * (n << 4) (high nibble)
static int inited = 0;

static uint8_t gf_mul_slow(uint8_t a, uint8_t b) {
  uint16_t r = 0;
  uint16_t aa = a;
  while (b) {
    if (b & 1) r ^= aa;
    aa <<= 1;
    if (aa & 0x100) aa ^= 0x11d;
    b >>= 1;
  }
  return (uint8_t)r;
}

void gf256_init(void) {
  if (inited) return;
  for (int a = 0; a < 256; a++)
    for (int b = 0; b < 256; b++)
      MUL[a][b] = gf_mul_slow((uint8_t)a, (uint8_t)b);
  for (int c = 0; c < 256; c++) {
    for (int n = 0; n < 16; n++) {
      NIB_LO[c][n] = MUL[c][n];
      NIB_HI[c][n] = MUL[c][n << 4];
    }
  }
  inited = 1;
}

// ---------------------------------------------------------------------------
// Region ops
// ---------------------------------------------------------------------------

void gf256_region_xor(uint8_t *dst, const uint8_t *src, uint64_t len) {
  uint64_t i = 0;
#if defined(__AVX2__)
  for (; i + 32 <= len; i += 32) {
    __m256i d = _mm256_loadu_si256((const __m256i *)(dst + i));
    __m256i s = _mm256_loadu_si256((const __m256i *)(src + i));
    _mm256_storeu_si256((__m256i *)(dst + i), _mm256_xor_si256(d, s));
  }
#endif
  for (; i < len; i++) dst[i] ^= src[i];
}

// dst ^= c * src  (the gf_vect_mad of ISA-L)
void gf256_region_mul_add(uint8_t *dst, const uint8_t *src, uint8_t c,
                          uint64_t len) {
  if (c == 0) return;
  if (c == 1) { gf256_region_xor(dst, src, len); return; }
  uint64_t i = 0;
#if defined(__AVX2__)
  __m128i lo128 = _mm_loadu_si128((const __m128i *)NIB_LO[c]);
  __m128i hi128 = _mm_loadu_si128((const __m128i *)NIB_HI[c]);
  __m256i lo = _mm256_broadcastsi128_si256(lo128);
  __m256i hi = _mm256_broadcastsi128_si256(hi128);
  __m256i maskf = _mm256_set1_epi8(0x0f);
  for (; i + 32 <= len; i += 32) {
    __m256i s = _mm256_loadu_si256((const __m256i *)(src + i));
    __m256i sl = _mm256_and_si256(s, maskf);
    __m256i sh = _mm256_and_si256(_mm256_srli_epi64(s, 4), maskf);
    __m256i r = _mm256_xor_si256(_mm256_shuffle_epi8(lo, sl),
                                 _mm256_shuffle_epi8(hi, sh));
    __m256i d = _mm256_loadu_si256((const __m256i *)(dst + i));
    _mm256_storeu_si256((__m256i *)(dst + i), _mm256_xor_si256(d, r));
  }
#endif
  const uint8_t *t = MUL[c];
  for (; i < len; i++) dst[i] ^= t[src[i]];
}

// out[m][len] = mat[m][k] (x) data[k][len]; rows are contiguous slabs.
// This is the ec_encode_data role (ISA-L) — the CPU hot kernel.
void gf256_matvec(const uint8_t *mat, int m, int k, const uint8_t *data,
                  uint8_t *out, uint64_t len) {
  for (int i = 0; i < m; i++) {
    uint8_t *dst = out + (uint64_t)i * len;
    std::memset(dst, 0, len);
    for (int j = 0; j < k; j++)
      gf256_region_mul_add(dst, data + (uint64_t)j * len, mat[i * k + j], len);
  }
}

}  // extern "C"
