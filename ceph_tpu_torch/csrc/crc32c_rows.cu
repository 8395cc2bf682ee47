// Kernel B2: crc32c linear part of every 512-byte row, on Hopper.
//
//   out[r] = L(x[r]) = crc32c(x[r], 0) ^ crc32c(0^512, 0)      x [rows, 512]
//
// Replaces ceph_tpu/ops/crc32c_device.py::_pallas_rows_fn (inner `kernel`),
// which computes the same 32 bits as bits[rows, 4096] @ B[4096, 32] mod 2 on
// the MXU. L is linear in the row's 4096 bits: L(x) is the XOR, over the
// bits i that are set, of basis[i] = L(bit i alone) (B's row i packed into
// a word; bit 8c + b is bit b of byte c). So no byte depends on another,
// and this kernel looks up fields of bits instead of running the crc
// register along the row:
//
// - A warp per row. Lane l reads bytes 16l .. 16l+15 as one uint4: a warp's
//   load is one 512-byte row, coalesced. Each lane cuts its 128 bits into
//   fields of kW bits (the last one narrower) and XORs one table word per
//   field: the field's value v selects the word L(v at that field).
// - Tables in shared memory, built by each block from the basis at start:
//   slot (field, v) holds the 32 lanes' words side by side, so lane l reads
//   only bank l (no conflict). A field's index is one shift (or funnel
//   shift, where it crosses a word) and one LOP3 that masks it into bits
//   7.. and ORs in the lane's bank: kW = 6 gives 22 lookups a lane and row,
//   168.5 KiB of tables, one block an SM.
// - kRows rows reduced together: a warp XORs its 32 lane parts of kRows
//   rows by halving exchanges (__shfl_xor_sync), kRows - 1 + 5 - log2(kRows)
//   shuffles for kRows rows in place of 5 a row, and kRows of the lanes
//   store the rows' int64 words, in one transaction.
// - Persistent blocks, one an SM, each warp walks its batches of kRows
//   rows with kDepth rows loaded ahead (streaming loads). The table
//   build's basis words are loaded first and its first rows next, so that
//   the build overlaps the rows in flight.
//
// Bound: device memory (rows * 512 bytes read once, 8 bytes written per
// row). The lookups cost 22 LDS and ~55 integer instructions a lane and
// row, under the memory time on an H100: there, at the fused flush's
// 360,448 rows, the loop without tables and lookups takes ~93% of the
// kernel's time (B2_SKIP). The macros below are the A/B knobs of
// bench/b2_ab.py.
//
// Plain C interface, built with nvcc and loaded with ctypes (ops/cuda_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef B2_FIELD_BITS
#define B2_FIELD_BITS 6   // bits a table lookup covers (4, 5 or 6)
#endif
#ifndef B2_ROWS
#define B2_ROWS 8         // rows a warp reduces together (1, 2, 4, 8, 16, 32)
#endif
#ifndef B2_DEPTH
#define B2_DEPTH 4        // rows a warp has loaded ahead (divides B2_ROWS)
#endif
#ifndef B2_THREADS
#define B2_THREADS 512    // threads a block
#endif
#ifndef B2_SKIP
#define B2_SKIP 0         // A/B time split only, output wrong: 1 skips the
#endif                    // table build, 2 the lookups

namespace {

constexpr int kRowBytes = 512;
constexpr int kLaneBits = 128;
constexpr int kW = B2_FIELD_BITS;
constexpr int kRows = B2_ROWS;
constexpr int kDepth = B2_DEPTH < B2_ROWS ? B2_DEPTH : B2_ROWS;
constexpr int kThreads = B2_THREADS;
constexpr int kFields = (kLaneBits + kW - 1) / kW;

static_assert(kW >= 1 && kW <= 6, "tables of 7-bit fields exceed shared memory");
static_assert(kRows >= 1 && kRows <= 32 && (kRows & (kRows - 1)) == 0,
              "kRows is a power of two up to 32");
static_assert(kRows % kDepth == 0, "kDepth divides kRows");
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");

__host__ __device__ constexpr int field_width(int f) {
  return kLaneBits - f * kW < kW ? kLaneBits - f * kW : kW;
}

// first table slot (128 bytes: the 32 lanes' words of one field value)
__host__ __device__ constexpr int field_slot(int f) {
  return f * (1 << kW) - (f == kFields ? (1 << kW) - (1 << field_width(f - 1))
                                       : 0);
}

constexpr int kSlots = field_slot(kFields);
constexpr int kTableBytes = kSlots * 128;

__host__ __device__ constexpr int log2i(int v) {
  return v <= 1 ? 0 : 1 + log2i(v >> 1);
}

__host__ __device__ constexpr int ctz(int v) {
  return (v & 1) ? 0 : 1 + ctz(v >> 1);
}

// Table items (field, lane) a thread builds: one per thread and round.
constexpr int kItems = (kFields * 32 + kThreads - 1) / kThreads;

// The basis words of this thread's items: bit f * kW + j of lane l's slice.
__device__ __forceinline__ void load_item_basis(
    uint32_t (&bw)[kItems][kW], const uint32_t* __restrict__ basis) {
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int t = threadIdx.x + it * kThreads, f = t >> 5, lane = t & 31;
#pragma unroll
    for (int j = 0; j < kW; ++j)
      bw[it][j] = t < kFields * 32 && j < field_width(f)
                      ? __ldg(basis + lane * kLaneBits + f * kW + j)
                      : 0u;
  }
}

// Slots of one field for one lane, in Gray-code order: one XOR an entry.
template <int WD>
__device__ __forceinline__ void fill_field(uint32_t* tbl, int slot0, int lane,
                                           const uint32_t (&b)[kW]) {
  uint32_t acc = 0;
  tbl[slot0 * 32 + lane] = 0;
#pragma unroll
  for (int v = 1; v < (1 << WD); ++v) {
    acc ^= b[ctz(v)];
    tbl[(slot0 + (v ^ (v >> 1))) * 32 + lane] = acc;
  }
}

__device__ __forceinline__ void build_tables(uint32_t* tbl,
                                             const uint32_t (&bw)[kItems][kW]) {
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int t = threadIdx.x + it * kThreads, f = t >> 5, lane = t & 31;
    if (t >= kFields * 32) break;
    if (field_width(f) == kW)
      fill_field<kW>(tbl, field_slot(f), lane, bw[it]);
    else
      fill_field<field_width(kFields - 1)>(tbl, field_slot(f), lane, bw[it]);
  }
}

// One lane's part of a row's L: the XOR of its fields' table words.
__device__ __forceinline__ uint32_t lane_part(const uint4& v, const char* tbl,
                                              uint32_t bank) {
  if (B2_SKIP & 2) return v.x ^ v.y ^ v.z ^ v.w;
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t acc0 = 0, acc1 = 0;
#pragma unroll
  for (int f = 0; f < kFields; ++f) {
    const int s = f * kW, q = s >> 5, off = s & 31, wd = field_width(f);
    uint32_t u;
    if (off + wd <= 32)
      u = off >= 7 ? w[q] >> (off - 7) : w[q] << (7 - off);
    else
      u = __funnelshift_r(w[q], w[q + 1], off - 7);
    const uint32_t idx = (u & (((1u << wd) - 1) << 7)) | bank;
    const uint32_t t =
        *reinterpret_cast<const uint32_t*>(tbl + field_slot(f) * 128 + idx);
    if (f & 1) acc1 ^= t; else acc0 ^= t;
  }
  return acc0 ^ acc1;
}

// XOR of a[j] over the warp's 32 lanes, for each of the kRows rows j:
// halving exchanges leave lane l with row l >> (5 - log2(kRows)).
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
  // the table build's basis words first, then the first rows, so that the
  // build starts early and overlaps the rows in flight
  uint32_t bw[kItems][kW];
  load_item_basis(bw, basis);
  uint4 buf[kDepth];
#pragma unroll
  for (int d = 0; d < kDepth; ++d) buf[d] = load_row(xp, b * kRows + d, rows, lane);
  if (!(B2_SKIP & 1)) build_tables(tbl, bw);
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

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// x must be 16-byte aligned, [rows, 512] contiguous; basis [4096] uint32
// (bit i of a row -> its L); out [rows] int64, each in [0, 2^32). One
// block a streaming multiprocessor, fewer for few rows.
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
