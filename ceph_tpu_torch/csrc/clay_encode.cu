// Kernel B3: Clay structured encode on Hopper, bit-sliced.
//
//   u_d[f]   = a1[f] * C[ps_row[f]] ^ a2[f] * C[pa_row[f]]          f = j*ssc + z, j < kk
//   u_p[i,z] = XOR_j dmat[i, j] * u_d[j*ssc + z]                     (plane-wise MDS)
//   out[r]   = b1[r] * C[pc_row[r]] ^ b2[r] * u_p[r] ^ b3[r] * u_p[pu[r]]   r = i*ssc + z
//
// over GF(2^8) (polynomial 0x11d), every row a sub-chunk of L lanes; C is
// the input [k*ssc, L] (data chunk i, plane z at row i*ssc + z) and a row
// index of -1 is a zero row (a virtual node). The tables come from
// build_encode_fast (ceph_tpu_torch/models/clay_device.py,
// encode_kernel_arrays); ops/clay_cuda.py picks the launch form.
//
// Replaces ceph_tpu/models/clay_device.py::build_encode_kernel (inner
// `kernel`, pallas_call at :786). On the TPU the (node, plane) row gathers
// are 0/1 bf16 routing matmuls on the MXU and the per-row coefficients are
// bit-plane select chains. Here every multiply is bit-sliced, with no
// tables: a thread owns 32 consecutive lanes as 8 bit-plane words (a
// 12-swap byte<->plane transpose, its own inverse: plane i holds bit i of
// lane 4q+s at bit 8s+q), multiplying by x modulo 0x11d is
// p' = [p7, p0, p1^p7, p2^p7, p3^p7, p4, p5, p6] (3 XORs, the rest
// register renaming), and a constant c is applied as
// acc ^= (x^b * v) & -(bit b of c) for b up to the table's highest set bit
// (one LOP3 per word and bit). That form is branch-free: the a and b
// coefficients differ between the planes that share a warp, so a test per
// set bit would diverge. A table whose terms are single bits (a2 and b3
// are x at the repo's profiles) costs a one-step chain and 16 LOP3s. The
// MDS coefficients dmat[i, j] are the same for every thread of a
// full-form block (j is its loop counter), so there each bit is a uniform
// branch around 8 XORs: 116 of dmat's 256 bits are set at
// k=8,m=4,d=11, and that form took 0.1627 ms of device time against the
// masked form's 0.1886 (python -m ceph_tpu_torch.bench.b3_ab, NVIDIA H100
// 80GB HBM3, 700.00 W).
//
// Stage 3 reads u_p ACROSS planes (pu), so a lane's whole u_p (m*ssc rows)
// must exist before any recouple. The block keeps u_p of its lane tile in
// shared memory in bit-plane form, laid out [word 0..7][m*ssc rows][G lane
// groups] so that neighbouring threads touch neighbouring banks; stage 3
// reads it with no transpose and transposes once, before the store.
//
// Two launch forms, picked on the host from L and the SM count
// (ops/clay_cuda.py, launch_plan):
// - full (kSplit = false): a tile of G (<= 8) groups of 32 lanes per block
//   of 256 threads. Stages 1-2 are spread over (plane, lane group): each
//   thread walks the kk MDS terms of one plane and keeps the m parity rows'
//   products in registers (4 rows a pass); u_p = m*ssc*32*G bytes of shared
//   memory (64 KiB at k=8,m=4,d=11, G=8).
// - short (kSplit = true), when the full grid would leave SMs idle (the
//   64-lane per-stripe calls of ec_util): G = 2 and up to 1,024 threads.
//   Stages 1-2 are spread over (plane, lane group, MDS term j), each thread
//   XORing its term's products into u_p with shared-memory atomics; stage 3
//   is spread over (parity row, lane group).
//
// Bound on this card (NVIDIA H100 SXM). Bytes: k*ssc*L in, m*ssc*L out:
// 0.060 ms at k=8,m=4,d=11, L = 262,144 (12 * 64 * L bytes at 3.35 TB/s).
// Issue, per 32 lanes of all 64 planes at that profile: stages 1-2 walk 512
// u_d rows, each with up to 2 loads and transposes (~60 ops each), its a1
// and a2 multiplies (~25 ops each) and the MDS products (7 chain steps,
// 8 XORs per set bit of dmat's column, 32 uniform bit tests): ~330 ops,
// ~170k in all; stage 3, 256 rows of 2 multiplies, a transpose and a
// store: ~30k. At 16.75e12 two-input int32 ops/s (64 lanes per SM and
// clock) that is ~0.10 ms for 8,192 lane groups: the kernel is bound by
// integer issue, not bytes. The floor of 8 XORs per set coefficient bit
// alone is 0.037 ms.
//
// ptxas (sm_90a): full form 72 registers (16-byte path) / 78 (byte path),
// short form 64 / 64, 0 spill bytes, so up to 3 full-form blocks (64 KiB
// of u_p each) share an SM.
//
// Measured (chip_smoke.py phase 8, NVIDIA H100 80GB HBM3, 700.00 W;
// through the entry point / the wrapper / the profiler's device time):
// full size 0.1760 / 0.1743 / 0.1638 ms, 64 lanes 0.0490 / 0.0508 /
// 0.0089 ms. The byte-wise design it replaces (a shift-and-xor loop per
// coefficient bit and 4 bytes, one block per 128 lanes) took 0.7168 and
// 0.1174 ms through the entry point on that kind of card.
//
// Lanes past L load as zero and are never stored. The 16-byte path needs
// L % 16 == 0 and 16-byte aligned in/out; any other input takes the byte
// path.
//
// Plain C interface, built with nvcc and loaded with ctypes (ops/cuda_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kLanes = 32;          // lanes (bytes) per thread: one 32-bit plane
constexpr int kRows = 4;            // parity rows per pass of stages 1-2
constexpr int kFullThreads = 256;   // threads of a full-form block
constexpr int kShortThreads = 1024; // most threads of a short-form block
constexpr int kMaxDmat = 1024;      // m * kk bytes carried in the parameters
constexpr int kMaxDevices = 64;

struct Params {
  const int* ps_row;
  const int* pa_row;
  const uint8_t* a1;
  const uint8_t* a2;
  const int* pc_row;
  const int* pu;
  const uint8_t* b1;
  const uint8_t* b2;
  const uint8_t* b3;
  long long L;
  int kk, m, ssc, G;
  // highest set bit over each table (-1: all zero)
  int nb_a1, nb_a2, nb_d, nb_b1, nb_b2, nb_b3;
  uint8_t dmat[kMaxDmat];  // [m, kk], the same for every thread
};

template <int S, uint32_t M>
__device__ __forceinline__ void swap_bits(uint32_t& a, uint32_t& b) {
  const uint32_t t = ((a >> S) ^ b) & M;
  b ^= t;
  a ^= t << S;
}

// 8x8 bit transpose within each byte position of w[0..7]: bit j of byte s
// of w[q] <-> bit q of byte s of w[j]. Its own inverse.
__device__ __forceinline__ void transpose8(uint32_t w[8]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) swap_bits<4, 0x0F0F0F0Fu>(w[q], w[q + 4]);
  swap_bits<2, 0x33333333u>(w[0], w[2]);
  swap_bits<2, 0x33333333u>(w[1], w[3]);
  swap_bits<2, 0x33333333u>(w[4], w[6]);
  swap_bits<2, 0x33333333u>(w[5], w[7]);
#pragma unroll
  for (int q = 0; q < 8; q += 2) swap_bits<1, 0x55555555u>(w[q], w[q + 1]);
}

// p <- x * p, p in bit-plane form, modulo x^8 + x^4 + x^3 + x^2 + 1
__device__ __forceinline__ void xtime8(uint32_t p[8]) {
  const uint32_t h = p[7];
  p[7] = p[6];
  p[6] = p[5];
  p[5] = p[4];
  p[4] = p[3] ^ h;
  p[3] = p[2] ^ h;
  p[2] = p[1] ^ h;
  p[1] = p[0];
  p[0] = h;
}

// acc ^= c * x for bits 0..nb of c; x is consumed (left as x^nb * x)
__device__ __forceinline__ void mul_acc(uint32_t acc[8], uint32_t x[8],
                                        uint32_t c, int nb) {
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    if (b > nb) break;
    if (b) xtime8(x);
    const uint32_t mask = 0u - ((c >> b) & 1u);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] ^= x[i] & mask;
  }
}

// 32 bytes at p into w[0..7]; byte 4q+s lands in bits 8s..8s+7 of w[q].
// rem = valid bytes from p (> 0); bytes past it read as zero.
template <bool kVec>
__device__ __forceinline__ void load32(const uint8_t* __restrict__ p,
                                       long long rem, uint32_t w[8]) {
  if (kVec) {  // rem is a multiple of 16
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 b = rem > 16 ? __ldg(reinterpret_cast<const uint4*>(p) + 1)
                             : make_uint4(0, 0, 0, 0);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      uint32_t x = 0;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int i = 4 * q + s;
        if (i < rem) x |= static_cast<uint32_t>(__ldg(p + i)) << (8 * s);
      }
      w[q] = x;
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store32(uint8_t* __restrict__ p, long long rem,
                                        const uint32_t w[8]) {
  if (kVec) {
    reinterpret_cast<uint4*>(p)[0] = make_uint4(w[0], w[1], w[2], w[3]);
    if (rem > 16)
      reinterpret_cast<uint4*>(p)[1] = make_uint4(w[4], w[5], w[6], w[7]);
  } else {
#pragma unroll
    for (int i = 0; i < kLanes; ++i)
      if (i < rem) p[i] = static_cast<uint8_t>(w[i / 4] >> (8 * (i % 4)));
  }
}

// acc ^= c * C[row] at this thread's 32 lanes; nothing for a zero term
template <bool kVec>
__device__ __forceinline__ void row_term(uint32_t acc[8], uint32_t c, int nb,
                                         int row,
                                         const uint8_t* __restrict__ in,
                                         long long L, long long lane0,
                                         long long rem) {
  if (c == 0 || row < 0) return;
  uint32_t x[8];
  load32<kVec>(in + static_cast<long long>(row) * L + lane0, rem, x);
  transpose8(x);
  mul_acc(acc, x, c, nb);
}

template <bool kVec, bool kSplit>
__global__ void __launch_bounds__(kSplit ? kShortThreads : kFullThreads,
                                  kSplit ? 1 : 2)
clay_encode_kernel(const __grid_constant__ Params p,
                   const uint8_t* __restrict__ in, uint8_t* __restrict__ out) {
  extern __shared__ uint32_t up[];  // [8][m*ssc][G], bit-plane words
  const int G = p.G, R = p.m * p.ssc, ssc = p.ssc, kk = p.kk;
  const long long L = p.L;
  const long long tile0 = static_cast<long long>(blockIdx.x) * G * kLanes;

  if (kSplit) {
    for (int i = threadIdx.x; i < 8 * R * G; i += blockDim.x) up[i] = 0;
    __syncthreads();
  }

  // stages 1-2: items (plane, lane group), and in the short form also the
  // MDS term j (slowest, so a warp's atomics hit distinct words)
  const int pg = ssc * G;
  const int items = kSplit ? pg * kk : pg;
  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int j0 = kSplit ? it / pg : 0;
    const int zg = kSplit ? it - j0 * pg : it;
    const int z = zg / G, g = zg - z * G;
    const long long lane0 = tile0 + g * kLanes;
    const long long rem = L - lane0;
    if (rem <= 0) continue;
    const int j_end = kSplit ? j0 + 1 : kk;
    for (int i0 = 0; i0 < p.m; i0 += kRows) {
      uint32_t acc[kRows][8];
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii)
#pragma unroll
        for (int w = 0; w < 8; ++w) acc[ii][w] = 0;
      for (int j = j0; j < j_end; ++j) {
        const int f = j * ssc + z;
        uint32_t ud[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        row_term<kVec>(ud, __ldg(p.a1 + f), p.nb_a1, __ldg(p.ps_row + f), in,
                       L, lane0, rem);
        row_term<kVec>(ud, __ldg(p.a2 + f), p.nb_a2, __ldg(p.pa_row + f), in,
                       L, lane0, rem);
        // acc[ii] ^= dmat[i0 + ii, j] * ud along the chain x^b * ud
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          if (b > p.nb_d) break;
          if (b) xtime8(ud);
#pragma unroll
          for (int ii = 0; ii < kRows; ++ii) {
            const int i = i0 + ii;
            const uint32_t c = i < p.m ? p.dmat[i * kk + j] : 0u;
            if (!kSplit) {  // j is uniform: a uniform branch per bit
              if ((c >> b) & 1u) {
#pragma unroll
                for (int w = 0; w < 8; ++w) acc[ii][w] ^= ud[w];
              }
            } else {
              const uint32_t mask = 0u - ((c >> b) & 1u);
#pragma unroll
              for (int w = 0; w < 8; ++w) acc[ii][w] ^= ud[w] & mask;
            }
          }
        }
      }
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii) {
        const int i = i0 + ii;
        if (i >= p.m) break;
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          uint32_t* dst = up + (static_cast<long long>(w) * R + i * ssc + z) * G + g;
          if (kSplit)
            atomicXor(dst, acc[ii][w]);
          else
            *dst = acc[ii][w];
        }
      }
    }
  }
  __syncthreads();

  // stage 3: recouple every parity row of every lane group
  for (int it = threadIdx.x; it < R * G; it += blockDim.x) {
    const int r = it / G, g = it - r * G;
    const long long lane0 = tile0 + g * kLanes;
    const long long rem = L - lane0;
    if (rem <= 0) continue;
    uint32_t v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    uint32_t x[8];
    row_term<kVec>(v, __ldg(p.b1 + r), p.nb_b1, __ldg(p.pc_row + r), in, L,
                   lane0, rem);
#pragma unroll
    for (int w = 0; w < 8; ++w) x[w] = up[(w * R + r) * G + g];
    mul_acc(v, x, __ldg(p.b2 + r), p.nb_b2);
    const uint32_t c3 = __ldg(p.b3 + r);
    if (c3) {
      const int r3 = __ldg(p.pu + r);
#pragma unroll
      for (int w = 0; w < 8; ++w) x[w] = up[(w * R + r3) * G + g];
      mul_acc(v, x, c3, p.nb_b3);
    }
    transpose8(v);
    store32<kVec>(out + static_cast<long long>(r) * L + lane0, rem, v);
  }
}

// Raise a kernel's dynamic shared-memory limit to smem on device dev, once
// per (kernel, device) and size reached.
template <bool kVec, bool kSplit>
cudaError_t allow_smem(int dev, int smem) {
  static std::atomic<int> allowed[kMaxDevices];  // 0 = default (48 KiB)
  if (smem <= 48 * 1024 || smem <= allowed[dev].load(std::memory_order_relaxed))
    return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      clay_encode_kernel<kVec, kSplit>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) allowed[dev].store(smem, std::memory_order_relaxed);
  return err;
}

template <bool kVec, bool kSplit>
cudaError_t launch(const Params& p, const uint8_t* in, uint8_t* out,
                   int threads, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  const long long smem = 32LL * p.m * p.ssc * p.G;
  const long long blocks = (p.L + kLanes * p.G - 1) / (kLanes * p.G);
  if (smem > 0x7FFFFFFFLL || blocks > 0x7FFFFFFFLL)
    return cudaErrorInvalidValue;
  err = allow_smem<kVec, kSplit>(dev, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  clay_encode_kernel<kVec, kSplit>
      <<<static_cast<unsigned>(blocks), threads, static_cast<size_t>(smem),
         stream>>>(p, in, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// dmat is a HOST pointer to m*kk bytes (copied into the kernel's
// parameters); every other table is on the device. nb[6]: the highest set
// bit of a1, a2, dmat, b1, b2, b3 (-1 where all zero). split picks the
// short form, G the lane groups of 32 per block, threads the block size.
// vec != 0 requires L % 16 == 0 and 16-byte aligned in/out.
int clay_encode_launch(const void* ps_row, const void* pa_row, const void* a1,
                       const void* a2, const void* pc_row, const void* pu,
                       const void* b1, const void* b2, const void* b3,
                       const void* dmat, const void* in, void* out, int kk,
                       int m, int ssc, const int* nb, long long L, int vec,
                       int split, int G, int threads, void* stream) {
  if (L <= 0) return 0;
  if (kk <= 0 || m <= 0 || ssc <= 0 || G <= 0 || m * kk > kMaxDmat ||
      threads <= 0 || threads % 32 ||
      threads > (split ? kShortThreads : kFullThreads))
    return cudaErrorInvalidValue;
  Params p;
  p.ps_row = static_cast<const int*>(ps_row);
  p.pa_row = static_cast<const int*>(pa_row);
  p.a1 = static_cast<const uint8_t*>(a1);
  p.a2 = static_cast<const uint8_t*>(a2);
  p.pc_row = static_cast<const int*>(pc_row);
  p.pu = static_cast<const int*>(pu);
  p.b1 = static_cast<const uint8_t*>(b1);
  p.b2 = static_cast<const uint8_t*>(b2);
  p.b3 = static_cast<const uint8_t*>(b3);
  p.L = L;
  p.kk = kk;
  p.m = m;
  p.ssc = ssc;
  p.G = G;
  p.nb_a1 = nb[0];
  p.nb_a2 = nb[1];
  p.nb_d = nb[2];
  p.nb_b1 = nb[3];
  p.nb_b2 = nb[4];
  p.nb_b3 = nb[5];
  const auto* d = static_cast<const uint8_t*>(dmat);
  for (int i = 0; i < kMaxDmat; ++i) p.dmat[i] = i < m * kk ? d[i] : 0;
  const auto* i = static_cast<const uint8_t*>(in);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (split)
    return vec ? launch<true, true>(p, i, o, threads, s)
               : launch<false, true>(p, i, o, threads, s);
  return vec ? launch<true, false>(p, i, o, threads, s)
             : launch<false, false>(p, i, o, threads, s);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
