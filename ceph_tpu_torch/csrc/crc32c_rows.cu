// Kernel B2: crc32c linear part of every 512-byte row, on Hopper.
//
//   out[r] = L(x[r]) = crc32c(x[r], 0) ^ crc32c(0^512, 0)      x [rows, 512]
//
// Replaces ceph_tpu/ops/crc32c_device.py::_pallas_rows_fn (inner `kernel`),
// which computes the same 32 bits as bits[rows, 4096] @ B[4096, 32] mod 2 on
// the MXU. L is the crc register run from state 0 with no final inversion:
// crc32c's affine part cancels between the two terms. So one thread per row
// runs the byte-at-a-time Castagnoli table recurrence (table built in shared
// memory per block), reading its row 16 bytes at a time. The stage-2
// combine of rows through the P matrix and the seed correction stay torch
// code around this kernel (ops/crc32c_torch.py), as they are plain XLA
// around the Pallas kernel in the reference.
//
// Bound: device memory (rows * 512 bytes read once, 4 bytes written per
// row). The 512-step dependent table chain per thread is latency the
// other resident warps hide; a later kernel can split rows across a warp.
//
// Plain C interface, built with nvcc and loaded with ctypes (ops/cuda_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowBytes = 512;
constexpr uint32_t kPoly = 0x82F63B78u;

__device__ __forceinline__ uint32_t step4(const uint32_t* tbl, uint32_t c,
                                          uint32_t w) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
    c = tbl[(c ^ (w >> (8 * s))) & 0xFFu] ^ (c >> 8);
  return c;
}

__global__ void __launch_bounds__(kThreads)
crc32c_rows_kernel(const uint8_t* __restrict__ x, uint32_t* __restrict__ out,
                   long long rows) {
  __shared__ uint32_t tbl[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    uint32_t c = static_cast<uint32_t>(i);
    for (int b = 0; b < 8; ++b) c = (c >> 1) ^ (kPoly & (0u - (c & 1u)));
    tbl[i] = c;
  }
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       r < rows; r += stride) {
    const uint4* p = reinterpret_cast<const uint4*>(x + r * kRowBytes);
    uint32_t c = 0;
#pragma unroll 4
    for (int q = 0; q < kRowBytes / 16; ++q) {
      const uint4 v = p[q];
      c = step4(tbl, c, v.x);
      c = step4(tbl, c, v.y);
      c = step4(tbl, c, v.z);
      c = step4(tbl, c, v.w);
    }
    out[r] = c;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// x must be 16-byte aligned, [rows, 512] contiguous; out [rows] uint32.
int crc32c_rows_launch(const void* x, void* out, long long rows, void* stream) {
  if (rows <= 0) return 0;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (rows + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * 16;
  if (blocks > cap) blocks = cap;
  crc32c_rows_kernel<<<static_cast<int>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint32_t*>(out), rows);
  return cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
