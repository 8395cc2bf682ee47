// Kernel B4: Clay multi-level layered decode on Hopper, for one padded
// erasure signature.
//
// State, per lane: C and U, one byte per (node n, plane z), row r = n*ssc + z
// of qt*ssc rows. C starts as the input's surviving nodes (erased rows
// zero), U as zero. Then, for each score level:
//
//   phase 1:  U[r] = a1[r] * C[r] ^ a2[r] * C[pair[r]]          r in u_rows(level)
//   MDS:      U[er[j]*ssc + z] = XOR_c dmat[j, c] * U[intact[c]*ssc + z]
//                                                              z in planes(level)
//   phase 2:  C[r] = b1[r] * C[p2[r]] ^ b2[r] * U[r] ^ b3[r] * U[p2[r]]
//                                                              r in c_rows(level)
//
// and the output is C of the erased nodes: out[j*ssc + z] = C[er[j]*ssc + z].
// Over GF(2^8); the tables come from build_decode_tables
// (ceph_tpu_torch/models/clay_device.py, transform_kernel_arrays), which
// asserts that phase 2 never reads a C row it writes in the same level, so
// each phase can update its array in place.
//
// Replaces ceph_tpu/models/clay_device.py::build_transform_kernel (inner
// `kernel`). The TPU kernel keeps the state z-major with each plane padded
// to 8 rows, applies per-level masks to every row, and routes rows with 0/1
// bf16 matmuls; it also transposes and pads the node-major input outside the
// kernel. Here the input is read node-major directly, rows are gathered by
// index, each level walks only its own CSR row lists, and four packed bytes
// are multiplied by a row's constant with shift-and-xor.
//
// Design. The state is 2 * qt*ssc bytes per lane (1.5 KiB at k=8,m=4,d=11),
// too much for a wide lane tile, so a block takes a NARROW tile of tw words
// (4 lanes each; tw chosen by ops/clay_cuda.py so both arrays fit ~100 KiB
// of shared memory: tw = 16 at k=8,m=4,d=11) and keeps its whole state in
// shared memory; the 256 threads split into 256/tw row groups that stride
// over each phase's rows, with a barrier between phases. Nothing but the
// input and the output touches device memory.
//
// Bound: device memory in principle (surviving input rows in, e*ssc rows
// out). This simple version is bound by integer issue (shift-and-xor GF
// multiplies, two row groups per warp at tw = 16) and by the barriers of
// each level's three phases.
//
// Plain C interface, built with nvcc and loaded with ctypes (ops/cuda_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowBlock = 8;

__device__ __forceinline__ uint32_t xtime4(uint32_t x) {
  return ((x & 0x7f7f7f7fu) << 1) ^ (((x >> 7) & 0x01010101u) * 0x1du);
}

__device__ __forceinline__ uint32_t gmul(uint32_t c, uint32_t x) {
  uint32_t y = 0;
  while (c) {
    if (c & 1u) y ^= x;
    x = xtime4(x);
    c >>= 1;
  }
  return y;
}

template <bool kVec>
__device__ __forceinline__ uint32_t load4(const uint8_t* p, long long rem) {
  if (kVec) return *reinterpret_cast<const uint32_t*>(p);
  uint32_t x = 0;
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if (s < rem) x |= static_cast<uint32_t>(p[s]) << (8 * s);
  return x;
}

template <bool kVec>
__device__ __forceinline__ void store4(uint8_t* p, long long rem, uint32_t x) {
  if (kVec) {
    *reinterpret_cast<uint32_t*>(p) = x;
  } else {
#pragma unroll
    for (int s = 0; s < 4; ++s)
      if (s < rem) p[s] = static_cast<uint8_t>(x >> (8 * s));
  }
}

struct Tabs {
  const uint8_t* a1;
  const uint8_t* a2;
  const int* pair;
  const uint8_t* b1;
  const uint8_t* b2;
  const uint8_t* b3;
  const int* p2;
  const int* u_off;
  const int* u_rows;
  const int* p_off;
  const int* planes;
  const int* c_off;
  const int* c_rows;
  const int* intact;  // [kk] node ids
  const int* er;      // [e] node ids
  const uint8_t* dmat;  // [e, kk]
  const uint8_t* load;  // [qt] 1 = read the node from the input
};

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
clay_transform_kernel(Tabs t, const uint8_t* __restrict__ in,
                      uint8_t* __restrict__ out, int qt, int ssc, int kk,
                      int e, int n_levels, long long L, int tw) {
  extern __shared__ uint32_t sm[];
  const int rows = qt * ssc;
  uint32_t* cz = sm;                 // [rows][tw]
  uint32_t* u = sm + rows * tw;      // [rows][tw]
  const int w = threadIdx.x % tw;
  const int g = threadIdx.x / tw;
  const int groups = blockDim.x / tw;
  const long long lane = (static_cast<long long>(blockIdx.x) * tw + w) * 4;
  const long long rem = L - lane;
  const bool active = rem > 0;

  for (int r = g; r < rows; r += groups) {
    const int n = r / ssc;
    cz[r * tw + w] = (active && t.load[n]) ? load4<kVec>(in + r * L + lane, rem) : 0u;
    u[r * tw + w] = 0u;
  }
  __syncthreads();

  for (int li = 0; li < n_levels; ++li) {
    // phase 1: U of this level's slots from C
    for (int i = t.u_off[li] + g; i < t.u_off[li + 1]; i += groups) {
      const int r = t.u_rows[i];
      uint32_t v = gmul(t.a1[r], cz[r * tw + w]);
      const uint32_t c2 = t.a2[r];
      if (c2) v ^= gmul(c2, cz[t.pair[r] * tw + w]);
      u[r * tw + w] = v;
    }
    __syncthreads();
    // plane-wise MDS decode of the erased nodes' U
    for (int i = t.p_off[li] + g; i < t.p_off[li + 1]; i += groups) {
      const int z = t.planes[i];
      for (int j0 = 0; j0 < e; j0 += kRowBlock) {
        uint32_t acc[kRowBlock];
#pragma unroll
        for (int jj = 0; jj < kRowBlock; ++jj) acc[jj] = 0;
        for (int c = 0; c < kk; ++c) {
          const uint32_t v = u[(t.intact[c] * ssc + z) * tw + w];
#pragma unroll
          for (int jj = 0; jj < kRowBlock; ++jj)
            if (j0 + jj < e) acc[jj] ^= gmul(t.dmat[(j0 + jj) * kk + c], v);
        }
#pragma unroll
        for (int jj = 0; jj < kRowBlock; ++jj)
          if (j0 + jj < e) u[(t.er[j0 + jj] * ssc + z) * tw + w] = acc[jj];
      }
    }
    __syncthreads();
    // phase 2: C of this level's erased slots
    for (int i = t.c_off[li] + g; i < t.c_off[li + 1]; i += groups) {
      const int r = t.c_rows[i];
      const int p = t.p2[r];
      uint32_t v = gmul(t.b2[r], u[r * tw + w]);
      const uint32_t c1 = t.b1[r];
      if (c1) v ^= gmul(c1, cz[p * tw + w]);
      const uint32_t c3 = t.b3[r];
      if (c3) v ^= gmul(c3, u[p * tw + w]);
      cz[r * tw + w] = v;
    }
    __syncthreads();
  }

  if (!active) return;
  const int out_rows = e * ssc;
  for (int r = g; r < out_rows; r += groups) {
    const int j = r / ssc, z = r % ssc;
    store4<kVec>(out + r * L + lane, rem, cz[(t.er[j] * ssc + z) * tw + w]);
  }
}

template <bool kVec>
cudaError_t launch(const Tabs& t, const uint8_t* in, uint8_t* out, int qt,
                   int ssc, int kk, int e, int n_levels, long long L, int tw,
                   cudaStream_t stream) {
  const int smem = 2 * qt * ssc * tw * 4;
  cudaError_t err = cudaFuncSetAttribute(
      clay_transform_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const long long words = (L + 3) / 4;
  const long long blocks = (words + tw - 1) / tw;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  clay_transform_kernel<kVec><<<static_cast<unsigned>(blocks), kThreads, smem,
                                stream>>>(t, in, out, qt, ssc, kk, e, n_levels,
                                          L, tw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// vec != 0 requires L % 4 == 0 and 4-byte aligned in/out. tw is the lane
// tile in 4-byte words: a power of two <= 32 that divides 256.
int clay_transform_launch(const void* a1, const void* a2, const void* pair,
                          const void* b1, const void* b2, const void* b3,
                          const void* p2, const void* u_off,
                          const void* u_rows, const void* p_off,
                          const void* planes, const void* c_off,
                          const void* c_rows, const void* intact,
                          const void* er, const void* dmat, const void* load,
                          const void* in, void* out, int qt, int ssc, int kk,
                          int e, int n_levels, long long L, int vec, int tw,
                          void* stream) {
  if (L <= 0) return 0;
  if (tw < 1 || tw > 32 || (kThreads % tw) != 0) return cudaErrorInvalidValue;
  Tabs t;
  t.a1 = static_cast<const uint8_t*>(a1);
  t.a2 = static_cast<const uint8_t*>(a2);
  t.pair = static_cast<const int*>(pair);
  t.b1 = static_cast<const uint8_t*>(b1);
  t.b2 = static_cast<const uint8_t*>(b2);
  t.b3 = static_cast<const uint8_t*>(b3);
  t.p2 = static_cast<const int*>(p2);
  t.u_off = static_cast<const int*>(u_off);
  t.u_rows = static_cast<const int*>(u_rows);
  t.p_off = static_cast<const int*>(p_off);
  t.planes = static_cast<const int*>(planes);
  t.c_off = static_cast<const int*>(c_off);
  t.c_rows = static_cast<const int*>(c_rows);
  t.intact = static_cast<const int*>(intact);
  t.er = static_cast<const int*>(er);
  t.dmat = static_cast<const uint8_t*>(dmat);
  t.load = static_cast<const uint8_t*>(load);
  const auto* i = static_cast<const uint8_t*>(in);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(t, i, o, qt, ssc, kk, e, n_levels, L, tw, s)
             : launch<false>(t, i, o, qt, ssc, kk, e, n_levels, L, tw, s);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
