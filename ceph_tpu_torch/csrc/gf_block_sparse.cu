// Kernel B5: block-sparse GF(2^8) matrix-stripe product on Hopper.
//
//   out[row_order[g*tm + r], n] = XOR over the occupied column blocks b of
//       group g, columns c < tk:  gfmul(coef[b][r][c], data[blk_col[b]*tk + c, n])
//
// Replaces ceph_tpu/ops/gf_block_sparse.py::_sparse_kernel (launched by
// _build_runner). The TPU kernel gathers a group's occupied 8-row column
// blocks, bit-expands them and runs one [128, 8G] bit-matmul on the MXU;
// here a thread indexes tables instead. The host plan (ops/gf_block_sparse.py,
// same row groups and block ids as the reference) is flattened by
// ops/gf_block_sparse_cuda.py into per-block coefficients and ISA-L
// split-nibble tables (32 bytes per coefficient).
//
// Design. One CUDA block per (row group, lane tile of 256 threads x 16
// lanes). The group's tables are streamed through shared memory one column
// block at a time (tm*tk*32 = 4 KiB for [16, 8]), so a group of any width
// fits: the whole group's tables (up to 320 KiB for a [16, 640] group) never
// have to sit in shared memory at once. Each thread keeps tm output rows x 16
// lanes of accumulators in registers, skips zero coefficients (the test is
// uniform across the block, so it does not diverge), and at the end writes
// each row straight to its un-permuted position (the reference un-permutes
// outside its kernel). Padding rows of the last group (out_row < 0) are not
// written; every real row belongs to exactly one group and is written once,
// zeros included.
//
// Bound: device memory, in principle: each referenced data row is read once
// per group that references it (from L2 after the first), and each output
// row is written once. This simple version does 2 shared-memory lookups per
// nonzero coefficient per data byte, which, at the Clay matrices' few
// hundred nonzeros per output row group, makes it bound by shared-memory
// lookups and instruction issue instead.
//
// Plain C interface, built with nvcc and loaded with ctypes (ops/cuda_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTM = 16;

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

// smem: tm*tk*32 bytes of tables, then tm*tk coefficients
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gf_block_sparse_kernel(const int* __restrict__ grp_off,
                       const int* __restrict__ blk_col,
                       const uint8_t* __restrict__ tabs,
                       const uint8_t* __restrict__ coefs,
                       const int* __restrict__ out_row,
                       const uint8_t* __restrict__ data,
                       uint8_t* __restrict__ out, int tm, int tk, int k,
                       long long n) {
  extern __shared__ __align__(16) uint8_t sm[];
  const int tsz = tm * tk * 32;
  uint8_t* stab = sm;
  uint8_t* scoef = sm + tsz;
  const int g = blockIdx.y;
  const long long col =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * 16;
  const bool active = col < n;
  const long long rem = n - col;

  uint32_t acc[kMaxTM][4];
#pragma unroll
  for (int r = 0; r < kMaxTM; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0;

  const int b_end = grp_off[g + 1];
  for (int b = grp_off[g]; b < b_end; ++b) {
    __syncthreads();  // the previous block's tables are no longer read
    const uint4* src = reinterpret_cast<const uint4*>(
        tabs + static_cast<size_t>(b) * tsz);
    for (int t = threadIdx.x; t < tsz / 16; t += blockDim.x)
      reinterpret_cast<uint4*>(stab)[t] = src[t];
    for (int t = threadIdx.x; t < tm * tk; t += blockDim.x)
      scoef[t] = coefs[static_cast<size_t>(b) * tm * tk + t];
    __syncthreads();
    if (!active) continue;
    const int c0 = blk_col[b] * tk;
    for (int c = 0; c < tk && c0 + c < k; ++c) {
      uint32_t d[4];
      load16<kVec>(data + static_cast<long long>(c0 + c) * n + col, rem, d);
#pragma unroll
      for (int r = 0; r < kMaxTM; ++r) {
        if (r < tm && scoef[r * tk + c] != 0) {
          const uint8_t* t = stab + (r * tk + c) * 32;
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const uint32_t x = d[w];
            uint32_t v = 0;
#pragma unroll
            for (int s = 0; s < 4; ++s) {
              const uint32_t bt = (x >> (8 * s)) & 0xFFu;
              v |= static_cast<uint32_t>(t[bt & 15u] ^ t[16u + (bt >> 4)])
                   << (8 * s);
            }
            acc[r][w] ^= v;
          }
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < kMaxTM; ++r) {
    if (r < tm) {
      const int orow = out_row[g * tm + r];
      if (orow >= 0) store16<kVec>(out + static_cast<long long>(orow) * n + col,
                                   rem, acc[r]);
    }
  }
}

template <bool kVec>
cudaError_t launch(const int* grp_off, const int* blk_col, const uint8_t* tabs,
                   const uint8_t* coefs, const int* out_row,
                   const uint8_t* data, uint8_t* out, int groups, int tm,
                   int tk, int k, long long n, cudaStream_t stream) {
  const int smem = tm * tk * 33;
  cudaError_t err = cudaFuncSetAttribute(
      gf_block_sparse_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const long long ngroups16 = (n + 15) / 16;
  const long long tiles = (ngroups16 + kThreads - 1) / kThreads;
  if (tiles > 0x7FFFFFFFLL || groups > 65535) return cudaErrorInvalidValue;
  dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(groups));
  gf_block_sparse_kernel<kVec><<<grid, kThreads, smem, stream>>>(
      grp_off, blk_col, tabs, coefs, out_row, data, out, tm, tk, k, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// vec != 0 requires n % 16 == 0 and 16-byte aligned data/out.
int gf_block_sparse_launch(const void* grp_off, const void* blk_col,
                           const void* tabs, const void* coefs,
                           const void* out_row, const void* data, void* out,
                           int groups, int tm, int tk, int k, long long n,
                           int vec, void* stream) {
  if (n <= 0 || groups <= 0) return 0;
  if (tm < 1 || tm > kMaxTM || tk < 1) return cudaErrorInvalidValue;
  const auto* go = static_cast<const int*>(grp_off);
  const auto* bc = static_cast<const int*>(blk_col);
  const auto* t = static_cast<const uint8_t*>(tabs);
  const auto* c = static_cast<const uint8_t*>(coefs);
  const auto* orow = static_cast<const int*>(out_row);
  const auto* d = static_cast<const uint8_t*>(data);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(go, bc, t, c, orow, d, o, groups, tm, tk, k, n, s)
             : launch<false>(go, bc, t, c, orow, d, o, groups, tm, tk, k, n, s);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
