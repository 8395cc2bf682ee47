// Kernel B3: Clay structured encode on Hopper.
//
//   u_d[f]   = a1[f] * C[ps_row[f]] ^ a2[f] * C[pa_row[f]]          f = j*ssc + z, j < kk
//   u_p[i,z] = XOR_j dmat[i, j] * u_d[j*ssc + z]                     (plane-wise MDS)
//   out[r]   = b1[r] * C[pc_row[r]] ^ b2[r] * u_p[r] ^ b3[r] * u_p[pu[r]]   r = i*ssc + z
//
// over GF(2^8), every row a sub-chunk of L lanes; C is the input [k*ssc, L]
// (data chunk i, plane z at row i*ssc + z) and a row index of -1 is a zero
// row (a virtual node). The tables come from build_encode_fast
// (ceph_tpu_torch/models/clay_device.py, encode_kernel_arrays).
//
// Replaces ceph_tpu/models/clay_device.py::build_encode_kernel (inner
// `kernel`). On the TPU the (node, plane) row gathers are 0/1 bf16 routing
// matmuls on the MXU and the per-row coefficients are bit-plane select
// chains; here a thread gathers rows by index and multiplies four packed
// bytes by a row's constant with shift-and-xor (the constant is the same for
// every thread of a warp, so the loop does not diverge). No pow2 padding:
// any L; rows whose length is not a multiple of 4 bytes take a byte-wise
// variant of the same loop.
//
// Design. One block per tile of 32 words (128 lanes), 8 warps. Stage 3 reads
// u_p ACROSS planes (pu), so a lane's whole u_p (m*ssc bytes, 256 B at
// k=8,m=4,d=11) must exist before any recouple: stages 1-2 (warp w takes
// planes w, w+8, ...) write u_p for the tile into shared memory
// (m*ssc*128 B = 32 KiB at k=8,m=4,d=11), one barrier, then stage 3 (warp w
// takes parity rows w, w+8, ...) reads it. u_d is only needed within its
// plane and stays in registers: its MDS product is accumulated in up to 8
// registers per pass over the plane's kk rows (more parity rows take further
// passes).
//
// Bound: device memory in principle (k*ssc*L bytes in, m*ssc*L out). This
// simple version spends ~6 integer instructions per set bit of each
// coefficient per 4 bytes, (2*kk + m*kk + 3*m) coefficient multiplies per
// plane and lane, so it is bound by integer issue; input rows read twice
// (self and partner) come from L1/L2.
//
// Plain C interface, built with nvcc and loaded with ctypes (ops/cuda_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileWords = 32;
constexpr int kRowBlock = 8;

// four packed GF(2^8) bytes times x, polynomial 0x11d
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

// c * C[row] at this thread's 4 lanes; no load when the product is zero
template <bool kVec>
__device__ __forceinline__ uint32_t gmul_row(uint32_t c, int row,
                                             const uint8_t* in, long long L,
                                             long long lane, long long rem) {
  if (c == 0 || row < 0 || rem <= 0) return 0;
  return gmul(c, load4<kVec>(in + row * L + lane, rem));
}

struct Tabs {
  const int* ps_row;
  const int* pa_row;
  const uint8_t* a1;
  const uint8_t* a2;
  const uint8_t* dmat;  // [m, kk]
  const int* pc_row;
  const int* pu;
  const uint8_t* b1;
  const uint8_t* b2;
  const uint8_t* b3;
};

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
clay_encode_kernel(Tabs t, const uint8_t* __restrict__ in,
                   uint8_t* __restrict__ out, int kk, int m, int ssc,
                   long long L) {
  extern __shared__ uint32_t up[];  // [m*ssc][kTileWords]
  const int lane_w = threadIdx.x % kTileWords;
  const int warp = threadIdx.x / kTileWords;
  const int nwarps = blockDim.x / kTileWords;
  const long long lane =
      (static_cast<long long>(blockIdx.x) * kTileWords + lane_w) * 4;
  const long long rem = L - lane;

  // stages 1-2: per plane, u_d in registers, u_p into shared memory
  for (int z = warp; z < ssc; z += nwarps) {
    for (int i0 = 0; i0 < m; i0 += kRowBlock) {
      uint32_t acc[kRowBlock];
#pragma unroll
      for (int ii = 0; ii < kRowBlock; ++ii) acc[ii] = 0;
      for (int j = 0; j < kk; ++j) {
        const int f = j * ssc + z;
        const uint32_t ud =
            gmul_row<kVec>(t.a1[f], t.ps_row[f], in, L, lane, rem) ^
            gmul_row<kVec>(t.a2[f], t.pa_row[f], in, L, lane, rem);
#pragma unroll
        for (int ii = 0; ii < kRowBlock; ++ii)
          if (i0 + ii < m) acc[ii] ^= gmul(t.dmat[(i0 + ii) * kk + j], ud);
      }
#pragma unroll
      for (int ii = 0; ii < kRowBlock; ++ii)
        if (i0 + ii < m) up[((i0 + ii) * ssc + z) * kTileWords + lane_w] = acc[ii];
    }
  }
  __syncthreads();

  // stage 3: recouple every parity row
  if (rem <= 0) return;
  const int rows = m * ssc;
  for (int r = warp; r < rows; r += nwarps) {
    uint32_t v = gmul_row<kVec>(t.b1[r], t.pc_row[r], in, L, lane, rem);
    v ^= gmul(t.b2[r], up[r * kTileWords + lane_w]);
    const uint32_t c3 = t.b3[r];
    if (c3) v ^= gmul(c3, up[t.pu[r] * kTileWords + lane_w]);
    store4<kVec>(out + r * L + lane, rem, v);
  }
}

template <bool kVec>
cudaError_t launch(const Tabs& t, const uint8_t* in, uint8_t* out, int kk,
                   int m, int ssc, long long L, cudaStream_t stream) {
  const int smem = m * ssc * kTileWords * 4;
  cudaError_t err = cudaFuncSetAttribute(
      clay_encode_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const long long words = (L + 3) / 4;
  const long long blocks = (words + kTileWords - 1) / kTileWords;
  if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
  clay_encode_kernel<kVec><<<static_cast<unsigned>(blocks), kThreads, smem,
                             stream>>>(t, in, out, kk, m, ssc, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// vec != 0 requires L % 4 == 0 and 4-byte aligned in/out.
int clay_encode_launch(const void* ps_row, const void* pa_row, const void* a1,
                       const void* a2, const void* dmat, const void* pc_row,
                       const void* pu, const void* b1, const void* b2,
                       const void* b3, const void* in, void* out, int kk,
                       int m, int ssc, long long L, int vec, void* stream) {
  if (L <= 0) return 0;
  Tabs t;
  t.ps_row = static_cast<const int*>(ps_row);
  t.pa_row = static_cast<const int*>(pa_row);
  t.a1 = static_cast<const uint8_t*>(a1);
  t.a2 = static_cast<const uint8_t*>(a2);
  t.dmat = static_cast<const uint8_t*>(dmat);
  t.pc_row = static_cast<const int*>(pc_row);
  t.pu = static_cast<const int*>(pu);
  t.b1 = static_cast<const uint8_t*>(b1);
  t.b2 = static_cast<const uint8_t*>(b2);
  t.b3 = static_cast<const uint8_t*>(b3);
  const auto* i = static_cast<const uint8_t*>(in);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(t, i, o, kk, m, ssc, L, s)
             : launch<false>(t, i, o, kk, m, ssc, L, s);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
