// Candidate for kernel B2 (A/B only, bench/b2_ab.py): the TPU kernel's own
// formulation, bits[rows, 4096] @ B[4096, 32] mod 2, on the tensor cores'
// 1-bit product, with csrc/crc32c_rows.cu's C interface.
//
// mma.sync m16n8k256 .b1 .and.popc takes 16 rows of 256 bits as its A
// operand straight from the row's bytes (bit 8c + b of a row is bit b of
// byte c, which is B's row order) and counts popc(a & b) into int32; the
// count's low bit is the GF(2) dot product. A warp takes 16 rows: 16
// k-steps x 4 n-tiles of 8 output bits, 64 products. Thread (g, t) of the
// warp (g = lane / 4, t = lane % 4) reads rows g and g + 8, 16 bytes at
// 64 q + 16 t for q = 0..7 (a group of 4 threads reads 64 contiguous
// bytes of a row per load); word j = 4 q + e of those goes to k-step j / 2,
// register a0 / a1 (j even) or a2 / a3 (j odd). Each block lays B out in
// shared memory in fragment order for that permutation ([step][n-tile]
// [lane] uint2, 16 KiB) by ballots over the basis. The parities of a row
// are ORed over the 4 threads of its group, and one thread stores it.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef B2_THREADS
#define B2_THREADS 512
#endif

namespace {

constexpr int kRowBytes = 512;
constexpr int kThreads = B2_THREADS;
constexpr int kTile = 16;                       // rows of one mma
constexpr int kFragBytes = 16 * 4 * 32 * 8;     // [step][n-tile][lane] uint2
constexpr int kTableBytes = kFragBytes + 4096 * 4;

// row bit of (k-step s, chunk c = t + 4 h of the mma's 256, bit i)
__device__ __forceinline__ int row_bit(int s, int c, int i) {
  const int t = c & 3, j = 2 * s + (c >> 2);
  return 32 * (16 * (j >> 2) + 4 * t + (j & 3)) + i;
}

__device__ void build_frags(uint2* frag, uint32_t* bs,
                            const uint32_t* __restrict__ basis) {
  for (int i = threadIdx.x; i < 4096; i += blockDim.x) bs[i] = __ldg(basis + i);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nt = lane >> 3, g = lane & 7;     // the (n-tile, column) lane keeps
  for (int sc = warp; sc < 16 * 8; sc += kThreads / 32) {
    const int s = sc >> 3, c = sc & 7;
    const uint32_t v = bs[row_bit(s, c, lane)];
    uint32_t mine = 0;
#pragma unroll
    for (int q = 0; q < 32; ++q) {
      const uint32_t word = __ballot_sync(0xFFFFFFFFu, (v >> q) & 1u);
      if (q == lane) mine = word;             // output bit q = 8 nt + g
    }
    uint32_t* dst = reinterpret_cast<uint32_t*>(
        frag + (s * 4 + nt) * 32 + g * 4 + (c & 3));
    dst[c >> 2] = mine;
  }
}

__device__ __forceinline__ void mma(int (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b.x), "r"(b.y));
}

__global__ void __launch_bounds__(kThreads, 1)
crc32c_rows_kernel(const uint4* __restrict__ xp,
                   const uint32_t* __restrict__ basis,
                   long long* __restrict__ out, long long rows) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint2* frag = reinterpret_cast<uint2*>(smem);
  build_frags(frag, smem + kFragBytes / 4, basis);
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long nw = static_cast<long long>(gridDim.x) * (kThreads / 32);
  const long long tiles = (rows + kTile - 1) / kTile;
  for (long long tile = static_cast<long long>(blockIdx.x) * (kThreads / 32) +
                        (threadIdx.x >> 5);
       tile < tiles; tile += nw) {
    const long long r0 = tile * kTile + g, r1 = r0 + 8;
    uint32_t w0[32], w1[32];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      uint4 u0 = make_uint4(0u, 0u, 0u, 0u), u1 = u0;
      if (r0 < rows) u0 = __ldcs(xp + r0 * (kRowBytes / 16) + 4 * q + t);
      if (r1 < rows) u1 = __ldcs(xp + r1 * (kRowBytes / 16) + 4 * q + t);
      w0[4 * q] = u0.x; w0[4 * q + 1] = u0.y; w0[4 * q + 2] = u0.z; w0[4 * q + 3] = u0.w;
      w1[4 * q] = u1.x; w1[4 * q + 1] = u1.y; w1[4 * q + 2] = u1.z; w1[4 * q + 3] = u1.w;
    }
    int d[4][4] = {};
#pragma unroll
    for (int s = 0; s < 16; ++s) {
#pragma unroll
      for (int n = 0; n < 4; ++n)
        mma(d[n], w0[2 * s], w1[2 * s], w0[2 * s + 1], w1[2 * s + 1],
            frag[(s * 4 + n) * 32 + lane]);
    }
    uint32_t p0 = 0, p1 = 0;    // parities of rows g and g + 8
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int sh = 8 * n + 2 * t;
      p0 |= (static_cast<uint32_t>(d[n][0]) & 1u) << sh |
            (static_cast<uint32_t>(d[n][1]) & 1u) << (sh + 1);
      p1 |= (static_cast<uint32_t>(d[n][2]) & 1u) << sh |
            (static_cast<uint32_t>(d[n][3]) & 1u) << (sh + 1);
    }
    p0 |= __shfl_xor_sync(0xFFFFFFFFu, p0, 1);
    p1 |= __shfl_xor_sync(0xFFFFFFFFu, p1, 1);
    p0 |= __shfl_xor_sync(0xFFFFFFFFu, p0, 2);
    p1 |= __shfl_xor_sync(0xFFFFFFFFu, p1, 2);
    if (t == 0 && r0 < rows) out[r0] = static_cast<long long>(p0);
    if (t == 1 && r1 < rows) out[r1] = static_cast<long long>(p1);
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
  const long long tiles = (rows + kTile - 1) / kTile;
  long long blocks = (tiles + kThreads / 32 - 1) / (kThreads / 32);
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
