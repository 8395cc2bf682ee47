// Kernel B1: GF(2^8) matrix-stripe product on Hopper.
//
//   out[i, n] = XOR_j gfmul(mat[i, j], data[j, n])     mat [m, k], data [k, N]
//
// Replaces ceph_tpu/ops/gf_pallas.py::_gf_matvec_kernel (launched by
// _matvec_padded_impl / matvec_device). The TPU kernel lowers the product to
// a bit-sliced MXU matmul because the TPU has no byte shuffle; a GPU thread
// can index a table, so this kernel uses ISA-L's split-nibble tables
// instead: gfmul(c, x) = lo_c[x & 15] ^ hi_c[x >> 4], 32 bytes per
// coefficient, built on the host (ops/gf_cuda.py) and staged in shared memory
// per block. No pow2 padding, no block-diagonal folding: any N.
//
// Bound: device memory. Each data byte is read once and each parity byte is
// written once ((k + m) * N bytes); the table lookups hit shared memory.
// Each thread owns 16 lanes (one uint4 per data row, neighbouring threads
// on neighbouring addresses) and accumulates up to kRowBlock output rows per
// pass over the k data rows; matrices with more rows take further passes,
// which re-read the data from L2. Rows whose length or base is not a
// multiple of 16 bytes take the byte-wise variant of the same loop.
//
// Plain C interface, built with nvcc and loaded with ctypes (ops/cuda_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowBlock = 4;

template <bool kVec>
__device__ __forceinline__ void load16(const uint8_t* p, long long rem,
                                       uint32_t d[4]) {
  if (kVec) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  } else {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      uint32_t x = 0;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int b = 4 * w + s;
        if (b < rem) x |= static_cast<uint32_t>(p[b]) << (8 * s);
      }
      d[w] = x;
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store16(uint8_t* p, long long rem,
                                        const uint32_t a[4]) {
  if (kVec) {
    *reinterpret_cast<uint4*>(p) = make_uint4(a[0], a[1], a[2], a[3]);
  } else {
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (b < rem) p[b] = static_cast<uint8_t>(a[b / 4] >> (8 * (b % 4)));
  }
}

// tables: [m, k, 32] bytes, entry (i, j) = lo table (16) then hi table (16)
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gf_matvec_kernel(const uint8_t* __restrict__ tables,
                 const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
                 int m, int k, long long n) {
  extern __shared__ __align__(16) uint8_t tab[];
  const int tab_vecs = m * k * 2;  // 32 bytes = two uint4 per coefficient
  for (int t = threadIdx.x; t < tab_vecs; t += blockDim.x)
    reinterpret_cast<uint4*>(tab)[t] = reinterpret_cast<const uint4*>(tables)[t];
  __syncthreads();

  const long long ngroups = (n + 15) / 16;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       g < ngroups; g += stride) {
    const long long col = g * 16;
    const long long rem = n - col;
    for (int i0 = 0; i0 < m; i0 += kRowBlock) {
      uint32_t acc[kRowBlock][4];
#pragma unroll
      for (int r = 0; r < kRowBlock; ++r)
        acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0;
      for (int j = 0; j < k; ++j) {
        uint32_t d[4];
        load16<kVec>(data + j * n + col, rem, d);
#pragma unroll
        for (int r = 0; r < kRowBlock; ++r) {
          if (i0 + r < m) {
            const uint8_t* t = tab + ((i0 + r) * k + j) * 32;
#pragma unroll
            for (int w = 0; w < 4; ++w) {
              const uint32_t x = d[w];
              uint32_t v = 0;
#pragma unroll
              for (int s = 0; s < 4; ++s) {
                const uint32_t b = (x >> (8 * s)) & 0xFFu;
                v |= static_cast<uint32_t>(t[b & 15u] ^ t[16u + (b >> 4)])
                     << (8 * s);
              }
              acc[r][w] ^= v;
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRowBlock; ++r)
        if (i0 + r < m) store16<kVec>(out + (i0 + r) * n + col, rem, acc[r]);
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      count = 132;
  }
  return count;
}

template <bool kVec>
cudaError_t launch(const uint8_t* tables, const uint8_t* data, uint8_t* out,
                   int m, int k, long long n, cudaStream_t stream) {
  const int smem = m * k * 32;
  cudaError_t err = cudaFuncSetAttribute(
      gf_matvec_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long ngroups = (n + 15) / 16;
  long long blocks = (ngroups + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count()) * 8;
  if (blocks > cap) blocks = cap;
  gf_matvec_kernel<kVec><<<static_cast<int>(blocks), kThreads, smem, stream>>>(
      tables, data, out, m, k, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// vec != 0 requires n % 16 == 0 and 16-byte aligned data/out.
int gf_matvec_launch(const void* tables, const void* data, void* out, int m,
                     int k, long long n, int vec, void* stream) {
  if (n <= 0) return 0;
  const auto* t = static_cast<const uint8_t*>(tables);
  const auto* d = static_cast<const uint8_t*>(data);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(t, d, o, m, k, n, s)
             : launch<false>(t, d, o, m, k, n, s);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
