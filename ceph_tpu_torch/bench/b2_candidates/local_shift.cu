// Candidate for kernel B2 (A/B only, bench/b2_ab.py): scheme "local byte
// tables plus a shift", with csrc/crc32c_rows.cu's C interface.
//
// A warp per row, lane l reading bytes 16l .. 16l+15 as one uint4, as in
// the committed kernel. The lane first takes the crc of its 16 bytes as if
// they ended the row: c = XOR_j T_j[byte j], T_j[v] = L(v at column 496+j),
// 16 byte tables shared by all lanes (16 KiB; the 32 lanes look up random
// words of them, so these loads conflict). Then it moves c to its own
// place, 16 (31 - l) zero bytes further on: a 4-byte state c followed by n
// zero bytes has the crc of c's own 4 bytes followed by n zero bytes, so
// for lane l < 31 the shift is the XOR over c's bytes k of
// U_{l,k}[byte k] = L(byte at column 16 (l + 1) + k), four tables a lane
// laid out lane-major (128 KiB, conflict-free); lane 31 needs none. Both
// are built by each block from the basis. 20 lookups a lane and row; the
// rest (reduction, loads, grid) is the committed kernel's.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef B2_ROWS
#define B2_ROWS 8
#endif
#ifndef B2_DEPTH
#define B2_DEPTH 4
#endif
#ifndef B2_THREADS
#define B2_THREADS 1024
#endif

namespace {

constexpr int kRowBytes = 512;
constexpr int kRows = B2_ROWS;
constexpr int kDepth = B2_DEPTH < B2_ROWS ? B2_DEPTH : B2_ROWS;
constexpr int kThreads = B2_THREADS;
constexpr int kLocalBytes = 16 * 256 * 4;        // T_j, [j][v]
constexpr int kShiftBytes = 4 * 256 * 32 * 4;    // U, [k][v][lane]
constexpr int kTableBytes = kLocalBytes + kShiftBytes;

__host__ __device__ constexpr int log2i(int v) {
  return v <= 1 ? 0 : 1 + log2i(v >> 1);
}

// 16 entries (hi << 4 | lo) of the byte table of column `col`, in words
// dst[v * stride].
__device__ __forceinline__ void fill16(uint32_t* dst, int stride, int col,
                                       int hi, const uint32_t* basis) {
  const uint32_t* bp = basis + col * 8;
  uint32_t base = 0;
  for (int b = 0; b < 4; ++b)
    if (hi >> b & 1) base ^= __ldg(bp + 4 + b);
  uint32_t lo[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) lo[b] = __ldg(bp + b);
  uint32_t acc = base;
  dst[(hi << 4) * stride] = acc;
#pragma unroll
  for (int v = 1; v < 16; ++v) {
    acc ^= lo[(v & 1) ? 0 : (v & 2) ? 1 : (v & 4) ? 2 : 3];
    dst[((hi << 4) | (v ^ (v >> 1))) * stride] = acc;
  }
}

__device__ void build_tables(uint32_t* tbl, const uint32_t* basis) {
  for (int t = threadIdx.x; t < 256 + 4 * 32 * 16; t += blockDim.x) {
    if (t < 256) {                       // T_j: column 496 + j
      const int j = t >> 4, hi = t & 15;
      fill16(tbl + j * 256, 1, 496 + j, hi, basis);
      continue;
    }
    const int u = t - 256, lane = u & 31, k = (u >> 5) & 3, hi = u >> 7;
    uint32_t* dst = tbl + 16 * 256 + k * 256 * 32 + lane;
    if (lane < 31) {
      fill16(dst, 32, 16 * (lane + 1) + k, hi, basis);
    } else {                             // identity: no bytes follow
      for (int lo = 0; lo < 16; ++lo)
        dst[((hi << 4) | lo) * 32] = static_cast<uint32_t>((hi << 4) | lo) << (8 * k);
    }
  }
}

__device__ __forceinline__ uint32_t lds(const char* tb, uint32_t byte) {
  return *reinterpret_cast<const uint32_t*>(tb + byte);
}

__device__ __forceinline__ uint32_t lane_part(const uint4& v, const char* tb,
                                              uint32_t bank) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t c0 = 0, c1 = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uint32_t x = w[j >> 2];
    const int sh = 8 * (j & 3);
    const uint32_t idx = (sh ? x >> (sh - 2) : x << 2) & 0x3FCu;
    const uint32_t t = lds(tb + j * 1024, idx);
    if (j & 1) c1 ^= t; else c0 ^= t;
  }
  const uint32_t c = c0 ^ c1;
  const char* ub = tb + kLocalBytes;
  uint32_t r = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t idx = ((k ? c >> (8 * k - 7) : c << 7) & 0x7F80u) | bank;
    r ^= lds(ub + k * 32768, idx);
  }
  return r;
}

__device__ __forceinline__ uint32_t reduce_rows(uint32_t (&a)[kRows], int lane) {
#pragma unroll
  for (int n = kRows, o = 16; n > 1; n >>= 1, o >>= 1) {
    const bool up = lane & o;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const uint32_t send = up ? a[i] : a[i + n / 2];
      const uint32_t keep = up ? a[i + n / 2] : a[i];
      a[i] = keep ^ __shfl_xor_sync(0xFFFFFFFFu, send, o);
    }
  }
#pragma unroll
  for (int o = 16 >> log2i(kRows); o >= 1; o >>= 1)
    a[0] ^= __shfl_xor_sync(0xFFFFFFFFu, a[0], o);
  return a[0];
}

__device__ __forceinline__ uint4 load_row(const uint4* __restrict__ xp,
                                          long long r, long long rows,
                                          int lane) {
  if (r < rows) return __ldcs(xp + r * (kRowBytes / 16) + lane);
  return make_uint4(0u, 0u, 0u, 0u);
}

__global__ void __launch_bounds__(kThreads, 1)
crc32c_rows_kernel(const uint4* __restrict__ xp,
                   const uint32_t* __restrict__ basis,
                   long long* __restrict__ out, long long rows) {
  extern __shared__ __align__(16) uint32_t tbl[];
  const int lane = threadIdx.x & 31;
  const long long nw = static_cast<long long>(gridDim.x) * (kThreads / 32);
  const long long batches = (rows + kRows - 1) / kRows;
  long long b = static_cast<long long>(blockIdx.x) * (kThreads / 32) +
                (threadIdx.x >> 5);
  uint4 buf[kDepth];
#pragma unroll
  for (int d = 0; d < kDepth; ++d) buf[d] = load_row(xp, b * kRows + d, rows, lane);
  build_tables(tbl, basis);
  __syncthreads();
  const char* tb = reinterpret_cast<const char*>(tbl);
  const uint32_t bank = static_cast<uint32_t>(lane) * 4;
  for (; b < batches; b += nw) {
    uint32_t acc[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const uint4 v = buf[j % kDepth];
      const long long next = j + kDepth < kRows
                                 ? b * kRows + j + kDepth
                                 : (b + nw) * kRows + (j + kDepth - kRows);
      buf[j % kDepth] = load_row(xp, next, rows, lane);
      acc[j] = lane_part(v, tb, bank);
    }
    const uint32_t c = reduce_rows(acc, lane);
    const long long r = b * kRows + (lane >> (5 - log2i(kRows)));
    if ((lane & (32 / kRows - 1)) == 0 && r < rows)
      out[r] = static_cast<long long>(c);
  }
}

}  // namespace

extern "C" {

int crc32c_rows_launch(const void* x, const void* basis, void* out,
                       long long rows, void* stream) {
  if (rows <= 0) return 0;
  if (reinterpret_cast<uintptr_t>(x) % 16) return cudaErrorMisalignedAddress;
  static int sms_of[64];   // per device, 0 until its first launch
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!sms_of[dev]) {
    err = cudaFuncSetAttribute(crc32c_rows_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kTableBytes);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms_of[dev],
                                   cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const int sms = sms_of[dev];
  const long long warps = (rows + kRows - 1) / kRows;
  long long blocks = (warps + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > sms) blocks = sms;
  crc32c_rows_kernel<<<static_cast<int>(blocks), kThreads, kTableBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const uint32_t*>(basis),
      static_cast<long long*>(out), rows);
  return cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
