// Kernel B6: the XOR-strip transform (jerasure bit-matrix schedule) on Hopper.
//
//   out[r, w] = XOR_{j in schedule[r]} in[j, w]     in [S, W], out [R, W] int32
//
// Replaces ceph_tpu/ops/gf_xor_pallas.py::_xor_kernel (launched by
// _xor_encode_padded through StripCodecKernel.encode_strips). A chunk of C
// bytes is 8 strips of C/8 bytes; an m x k GF(2^8) matrix expands to an
// 8m x 8k GF(2) bit-matrix, and each output strip is the XOR of the input
// strips its row selects. Encode and decode are this kernel with different
// matrices. The schedule arrives as a CSR table (row_off [R + 1], idx
// [nnz]), built on the host once per matrix (ops/gf_xor_cuda.py).
//
// Bound: device memory. Each input word is read once and each output word
// written once ((S + R) * W * 4 bytes); the XORs are popcount - R per word
// position, well under the bytes at the card's int32 rate. The design keeps
// the re-reads (a strip feeds ~R/2 outputs) off device memory: a block
// stages one tile of T words of every input strip in shared memory (S * T *
// 4 bytes, at most kSmemBudget; T is the largest power of two up to 128
// that fits, so T divides W, which is a multiple of 128), with coalesced
// 16-byte loads, kBatch in flight per thread. Then each thread owns
// one 16-byte column of the tile and XORs every output row of its row group
// from shared memory, writing 16 bytes per row. With T = 128 (k <= 16) a
// warp writes 512 contiguous bytes of one output row.
//
// Plain C interface, built with nvcc and loaded with ctypes (ops/cuda_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;
constexpr int kMaxTile = 128;               // words per strip and tile
constexpr int kSmemBudget = 64 * 1024;      // bytes of staged input per block

__device__ __forceinline__ void xor4(uint4& a, const uint4& b) {
  a.x ^= b.x; a.y ^= b.y; a.z ^= b.z; a.w ^= b.w;
}

// One block per tile of T = 4 << vshift words; grid-stride over tiles.
__global__ void __launch_bounds__(kThreads)
gf_xor_kernel(const int* __restrict__ row_off, const int* __restrict__ idx,
              const uint4* __restrict__ in, uint4* __restrict__ out, int S,
              int R, long long W4, int vshift) {
  extern __shared__ uint4 tile[];            // [S][V] uint4, V = T / 4
  const int V = 1 << vshift;
  const int total = S * V;
  const int v = threadIdx.x & (V - 1);
  const int g = threadIdx.x >> vshift;
  const int groups = kThreads >> vshift;
  const long long tiles = W4 >> vshift;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long t0 = t << vshift;        // first uint4 column of the tile
    for (int base = threadIdx.x; base < total; base += kThreads * kBatch) {
      uint4 r[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kThreads;
        if (i < total) {
          const long long strip = i >> vshift;
          r[u] = in[strip * W4 + t0 + (i & (V - 1))];
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kThreads;
        if (i < total) tile[i] = r[u];
      }
    }
    __syncthreads();
    for (int row = g; row < R; row += groups) {
      const int e0 = __ldg(row_off + row);
      const int e1 = __ldg(row_off + row + 1);
      uint4 acc = tile[(__ldg(idx + e0) << vshift) + v];
      for (int e = e0 + 1; e < e1; ++e)
        xor4(acc, tile[(__ldg(idx + e) << vshift) + v]);
      out[static_cast<long long>(row) * W4 + t0 + v] = acc;
    }
    __syncthreads();
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

}  // namespace

extern "C" {

// Words per strip and tile for S input strips (0 if even 4 do not fit).
int gf_xor_tile_words(int S) {
  int T = kMaxTile;
  while (T > 4 && static_cast<long long>(S) * T * 4 > kSmemBudget) T /= 2;
  return static_cast<long long>(S) * T * 4 > kSmemBudget ? 0 : T;
}

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// in: S strips of W int32 words, out: R strips of W words, W % 128 == 0,
// both 16-byte aligned; row_off [R + 1] and idx [nnz] int32 on the device,
// every row non-empty, every idx < S.
int gf_xor_launch(const void* row_off, const void* idx, const void* in,
                  void* out, int S, int R, long long W, void* stream) {
  if (W <= 0 || R <= 0) return 0;
  const int T = gf_xor_tile_words(S);
  if (T == 0 || W % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
  int vshift = 0;
  while ((4 << vshift) < T) ++vshift;
  const int smem = S * T * 4;
  cudaError_t err = cudaFuncSetAttribute(
      gf_xor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = W / T;
  long long blocks = tiles;
  const long long cap = static_cast<long long>(sm_count()) * 64;
  if (blocks > cap) blocks = cap;
  gf_xor_kernel<<<static_cast<int>(blocks), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_off), static_cast<const int*>(idx),
      static_cast<const uint4*>(in), static_cast<uint4*>(out), S, R, W / 4,
      vshift);
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
