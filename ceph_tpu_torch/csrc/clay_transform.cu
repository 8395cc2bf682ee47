// Kernel B4: Clay multi-level layered decode on Hopper, bit-sliced, for one
// padded erasure signature.
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
// Over GF(2^8) (polynomial 0x11d). The tables come from build_decode_tables
// (ceph_tpu_torch/models/clay_device.py, transform_kernel_arrays), which
// asserts that phase 2 never reads a C row it writes in the same level, so
// each phase updates its array in place; ops/clay_cuda.py (transform_items)
// packs each level's phase-1 and phase-2 rows as items (row, partner,
// coefficients), ordered by coefficients.
//
// Replaces ceph_tpu/models/clay_device.py::build_transform_kernel (inner
// `kernel`, pallas_call at :1125). The TPU kernel keeps the state z-major
// with each plane padded to 8 rows, applies per-level masks to every row,
// routes rows with 0/1 bf16 matmuls and multiplies by bit-plane select
// chains. Here every multiply is bit-sliced, with no tables, as in kernel B3
// (csrc/clay_encode.cu): a thread owns 32 consecutive lanes of one row as 8
// bit-plane words (a 12-swap byte<->plane transpose, its own inverse: plane
// i holds bit i of lane 4q+s at bit 8s+q), and multiplying by x modulo 0x11d
// is p' = [p7, p0, p1^p7, p2^p7, p3^p7, p4, p5, p6] (3 XORs, the rest
// register renaming). A constant c is applied along that chain. The MDS
// coefficients dmat[j, c] are kernel parameters and the MDS items are laid
// out so that a warp works on one erased row j, so each bit of c is a
// uniform branch around 8 XORs. The phase-1 and phase-2 coefficients differ
// between rows, so there c is masked, acc ^= (x^b * v) & -(bit b of c), one
// LOP3 a word, branch-free, for b up to the highest set bit over the warp's
// coefficients (a warp reduction); the items' order by coefficients keeps
// that short (a copy where a warp's rows all have c = 1).
//
// State. Each level reads C and U across nodes and planes, so a lane's whole
// state must stay on chip through all levels: a block keeps C and U of its
// tile of G lane groups (32 lanes each) in shared memory in bit-plane form,
// 2 * qt*ssc * 32 * G bytes (48 KiB per lane group at k=8,m=4,d=11), each
// (row, group) as two 16-byte halves, swapped where bit 2 of row*G + group is
// set, so that 8 consecutive rows read or written as 16-byte words take 8
// different bank groups. The load reads up to kAhead rows a thread before
// it transposes any, and transposes each surviving input row once (erased
// rows and U start as zero); the phases read and write plane words only.
// Phase 2 computes each erased row once (transform_items checks it), so it
// stores the row, transposed back, as soon as it has it, and the stores
// overlap the later levels. Nothing but the input, the items and the output
// touches device memory. Each level is three phases with a barrier after
// each, each phase with its own partition: phase 1 over (item, lane group),
// MDS over (erased row j, plane, lane group) with each j's items padded to
// whole warps (its column loop unrolled where kk = 8), phase 2 over (item,
// lane group). G, the block size and the grid come from ops/clay_cuda.py
// (transform_plan); the launcher only checks that the plan covers L.
//
// Bound on this card (NVIDIA H100 SXM), at the main path's shape
// (k=8,m=4,d=11, erased [0, 1, 8, 9], L = 262,144). Bytes: 8*64*L in,
// 4*64*L out, 0.060 ms at 3.35 TB/s. Operations: 13,824 set coefficient
// bits a lane, 8 XORs each per 32 lanes, 0.054 ms at 16.75e12 int32 ops/s;
// the chains, loads, transposes and item overhead take several times that.
// The kernel is bound by integer instruction throughput (LOP3 is 58% of its
// SASS), the input reads only partly hidden behind the other block of an
// SM: 0.267-0.269 ms of device time on an NVIDIA H100 80GB HBM3 at 700.00 W
// (chip_smoke.py phase 8, bench/b4_ab.py; the byte-wise design it replaced,
// one block per 64 lanes with a shift-and-xor loop per coefficient, took
// 1.456-1.474 ms in the same runs); 60 / 51 registers (byte / 16-byte
// path, G = 2), no spills.
//
// Lanes past L load as zero and are never stored. The 16-byte path needs
// L % 16 == 0 and 16-byte aligned in/out; any other input takes the byte
// path.
//
// Plain C interface, built with nvcc and loaded with ctypes (ops/cuda_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

// A/B only (python -m ceph_tpu_torch.bench.b4_ab SRC@NAME=VALUE; the
// output is wrong): skip phase 1 (1), MDS (2), phase 2 (4), the input
// reads (8), the output writes (16)
#ifndef B4_SKIP
#define B4_SKIP 0
#endif

namespace {

constexpr int kLanes = 32;         // lanes (bytes) per thread: one 32-bit plane
constexpr int kMaxThreads = 512;   // most threads of a block
constexpr int kAhead = 3;          // rows a thread reads before transposing
constexpr int kMaxDmat = 1024;     // e * kk bytes carried in the parameters
constexpr int kMaxNodes = 128;     // qt (so kk, e) carried in the parameters
constexpr int kMaxDevices = 64;

struct Params {
  const int4* u_items;  // phase 1: (r, pair[r], a1[r] | a2[r] << 8, 0)
  const int* u_off;     // [n_levels + 1] into u_items
  const int* p_off;     // [n_levels + 1] into planes
  const int* planes;
  const int4* c_items;  // phase 2: (r, p2[r], b1 | b2 << 8 | b3 << 16,
                        //          output row)
  const int* c_off;     // [n_levels + 1] into c_items
  long long L;
  int qt, ssc, kk, e, n_levels;
  int intact[kMaxNodes];   // [kk] node ids
  int er[kMaxNodes];       // [e] node ids
  uint32_t load[kMaxNodes / 32];  // bit n: read node n from the input
  uint8_t dmat[kMaxDmat];  // [e, kk], the same for every thread
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

// acc ^= c * x, c the same in every lane of the warp: a uniform branch per
// bit up to c's highest; x is consumed
__device__ __forceinline__ void mul_uniform(uint32_t acc[8], uint32_t x[8],
                                            uint32_t c) {
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    if ((c >> b) == 0) break;
    if (b) xtime8(x);
    if ((c >> b) & 1u) {
#pragma unroll
      for (int w = 0; w < 8; ++w) acc[w] ^= x[w];
    }
  }
}

// acc ^= c * x, c per lane: masked up to the highest set bit over the
// warp's c (every lane of the warp must call it); x is consumed
__device__ __forceinline__ void mul_masked(uint32_t acc[8], uint32_t x[8],
                                           uint32_t c) {
  const uint32_t any = __reduce_or_sync(0xffffffffu, c);
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    if ((any >> b) == 0) break;
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

// The 8 plane words of row r, lane group g, of a state array (two 16-byte
// halves per (row, group), swapped where bit 2 of r*G + g is set)
__device__ __forceinline__ void get8i(const uint4* s, int i, uint32_t x[8]) {
  const int h = (i >> 2) & 1;
  const uint4 a = s[2 * i + h], b = s[2 * i + (h ^ 1)];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

template <int G>
__device__ __forceinline__ void get8(const uint4* s, int r, int g,
                                     uint32_t x[8]) {
  get8i(s, r * G + g, x);
}

template <int G>
__device__ __forceinline__ void put8(uint4* s, int r, int g,
                                     const uint32_t x[8]) {
  const int i = r * G + g, h = (i >> 2) & 1;
  s[2 * i + h] = make_uint4(x[0], x[1], x[2], x[3]);
  s[2 * i + (h ^ 1)] = make_uint4(x[4], x[5], x[6], x[7]);
}


// acc ^= XOR_c dmat[j, c] * U[intact[c]*ssc + z] at lane group g, each
// column's row read one column ahead of its chain; KK > 0: kk, known at
// compile time (the loop unrolled)
template <int G, int KK>
__device__ __forceinline__ void mds_item(const Params& p, const uint4* us,
                                         int j, int z, int g, uint32_t acc[8]) {
  const int kk = KK > 0 ? KK : p.kk, ssc = p.ssc;
  uint32_t x[8], y[8];
  get8<G>(us, p.intact[0] * ssc + z, g, y);
#pragma unroll(KK > 0 ? KK : 1)
  for (int c = 0; c < kk; ++c) {
#pragma unroll
    for (int w = 0; w < 8; ++w) x[w] = y[w];
    if (c + 1 < kk) get8<G>(us, p.intact[c + 1] * ssc + z, g, y);
    mul_uniform(acc, x, p.dmat[j * kk + c]);
  }
}

template <bool kVec, int G>
__global__ void __launch_bounds__(kMaxThreads)
clay_transform_kernel(const __grid_constant__ Params p,
                      const uint8_t* __restrict__ in,
                      uint8_t* __restrict__ out) {
  extern __shared__ uint4 sm[];
  const int ssc = p.ssc, kk = p.kk, R = p.qt * ssc;
  uint4* cs = sm;               // C: [R][G] x two 16-byte halves
  uint4* us = sm + 2 * R * G;   // U: the same
  const long long L = p.L;
  const long long tile0 = static_cast<long long>(blockIdx.x) * G * kLanes;
  const int T = blockDim.x, lane = threadIdx.x & 31;
  const uint32_t zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};

  // load: C of the surviving nodes, transposed once; erased C and U zero
  for (int base = threadIdx.x; base < R * G; base += kAhead * T) {
    uint32_t x[kAhead][8];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
#pragma unroll
      for (int w = 0; w < 8; ++w) x[a][w] = 0;
      const int it = base + a * T;
      const int r = it / G, g = it % G;
      const long long lane0 = tile0 + g * kLanes;
      const long long rem = L - lane0;
      const int n = r / ssc;
      if (it < R * G && rem > 0 && (p.load[n >> 5] >> (n & 31) & 1u) &&
          !(B4_SKIP & 8))
        load32<kVec>(in + static_cast<long long>(r) * L + lane0, rem, x[a]);
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const int it = base + a * T;
      if (it >= R * G) break;
      transpose8(x[a]);
      put8<G>(cs, it / G, it % G, x[a]);
      put8<G>(us, it / G, it % G, zero);
    }
  }
  __syncthreads();

  for (int li = 0; li < p.n_levels; ++li) {
    // phase 1: U of this level's rows from C. The loops of phases 1 and 2
    // run whole warps (lanes past the item count idle in the body).
    const int u0 = __ldg(p.u_off + li) * G;
    const int nu = __ldg(p.u_off + li + 1) * G - u0;
    for (int base = threadIdx.x - lane; base < (B4_SKIP & 1 ? 0 : nu);
         base += T) {
      const int it = base + lane;
      const int4 t = it < nu ? __ldg(p.u_items + (u0 + it) / G)
                              : make_int4(0, 0, 0, 0);
      const int g = it % G;
      const uint32_t k1 = t.z & 0xff, k2 = (t.z >> 8) & 0xff;
      uint32_t v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      uint32_t x[8];
      get8<G>(cs, t.x, g, x);
      mul_masked(v, x, k1);
      if (__any_sync(0xffffffffu, k2 != 0)) {
        get8<G>(cs, t.y, g, x);
        mul_masked(v, x, k2);
      }
      if (it < nu) put8<G>(us, t.x, g, v);
    }
    __syncthreads();

    // MDS: U of the erased nodes at this level's planes, items (j, plane,
    // lane group) with each j's items padded to whole warps, so that j (from
    // lane 0) and dmat[j, c] are uniform in a warp
    const int p0 = __ldg(p.p_off + li);
    const int np = (__ldg(p.p_off + li + 1) - p0) * G;
    const int seg = (np + 31) & ~31;
    for (int it = threadIdx.x; it < (B4_SKIP & 2 ? 0 : p.e * seg); it += T) {
      const int j = __shfl_sync(0xffffffffu, it / seg, 0);
      const int pg = it - j * seg;
      if (pg >= np) continue;
      const int z = __ldg(p.planes + p0 + pg / G), g = pg % G;
      uint32_t acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      if (kk == 8)  // 8 surviving nodes, as at k=8,m=4,d=11: unrolled
        mds_item<G, 8>(p, us, j, z, g, acc);
      else
        mds_item<G, 0>(p, us, j, z, g, acc);
      put8<G>(us, p.er[j] * ssc + z, g, acc);
    }
    __syncthreads();

    // phase 2: C of this level's rows. Where b1 = 0 the lane reads its own
    // row instead of C[p2[r]] (times zero), never a row another lane writes
    // in this phase.
    const int c0 = __ldg(p.c_off + li) * G;
    const int nc = __ldg(p.c_off + li + 1) * G - c0;
    for (int base = threadIdx.x - lane; base < (B4_SKIP & 4 ? 0 : nc);
         base += T) {
      const int it = base + lane;
      const int4 t = it < nc ? __ldg(p.c_items + (c0 + it) / G)
                              : make_int4(0, 0, 0, 0);
      const int g = it % G;
      const uint32_t k1 = t.z & 0xff, k2 = (t.z >> 8) & 0xff,
                     k3 = (t.z >> 16) & 0xff;
      uint32_t v[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      uint32_t x[8];
      if (__any_sync(0xffffffffu, k1 != 0)) {
        get8<G>(cs, k1 ? t.y : t.x, g, x);
        mul_masked(v, x, k1);
      }
      if (__any_sync(0xffffffffu, k2 != 0)) {
        get8<G>(us, t.x, g, x);
        mul_masked(v, x, k2);
      }
      if (__any_sync(0xffffffffu, k3 != 0)) {
        get8<G>(us, t.y, g, x);
        mul_masked(v, x, k3);
      }
      // the row is final: keep it for the later levels, and store it
      // (output row t.w), transposed back
      const long long lane0 = tile0 + g * kLanes;
      if (it < nc) put8<G>(cs, t.x, g, v);
      if (it < nc && lane0 < L && !(B4_SKIP & 16)) {
        transpose8(v);
        store32<kVec>(out + static_cast<long long>(t.w) * L + lane0,
                      L - lane0, v);
      }
    }
    __syncthreads();
  }
}

// Raise the kernel's dynamic shared-memory limit to smem on device dev, once
// per (kernel, device) and size reached.
template <bool kVec, int G>
cudaError_t allow_smem(int dev, int smem) {
  static std::atomic<int> allowed[kMaxDevices];  // 0 = default (48 KiB)
  if (smem <= 48 * 1024 || smem <= allowed[dev].load(std::memory_order_relaxed))
    return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      clay_transform_kernel<kVec, G>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) allowed[dev].store(smem, std::memory_order_relaxed);
  return err;
}

template <bool kVec, int G>
cudaError_t launch(const Params& p, const uint8_t* in, uint8_t* out,
                   int blocks, int threads, int smem, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  err = allow_smem<kVec, G>(dev, smem);
  if (err != cudaSuccess) return err;
  clay_transform_kernel<kVec, G>
      <<<static_cast<unsigned>(blocks), threads, static_cast<size_t>(smem),
         stream>>>(p, in, out);
  return cudaGetLastError();
}

template <bool kVec>
cudaError_t launch_g(const Params& p, const uint8_t* in, uint8_t* out, int G,
                     int blocks, int threads, int smem, cudaStream_t stream) {
  switch (G) {
    case 1: return launch<kVec, 1>(p, in, out, blocks, threads, smem, stream);
    case 2: return launch<kVec, 2>(p, in, out, blocks, threads, smem, stream);
    case 4: return launch<kVec, 4>(p, in, out, blocks, threads, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// u_items, c_items ([n, 4] int32), u_off, p_off, c_off and planes are on
// the device; intact (kk ints), er (e ints), dmat (e*kk bytes) and load (qt
// bytes, 1 = read the node from the input) are HOST pointers, copied into
// the kernel's parameters. G (lane groups of 32
// per block: 1, 2 or 4), blocks, threads and smem are the plan of
// ops/clay_cuda.py (transform_plan); the launcher only checks that it
// covers L and holds the state, and refuses it otherwise. vec != 0 requires
// L % 16 == 0 and 16-byte aligned in/out.
int clay_transform_launch(const void* u_items, const void* u_off,
                          const void* p_off, const void* planes,
                          const void* c_items, const void* c_off,
                          const int* intact, const int* er,
                          const uint8_t* dmat, const uint8_t* load,
                          const void* in, void* out,
                          int qt, int ssc, int kk, int e, int n_levels,
                          long long L, int vec, int G, int blocks,
                          int threads, int smem, void* stream) {
  if (L <= 0) return 0;
  if (qt <= 0 || ssc <= 0 || kk <= 0 || e <= 0 || n_levels < 0 || G <= 0 ||
      e * kk > kMaxDmat || qt > kMaxNodes || threads <= 0 ||
      threads % 32 || threads > kMaxThreads || blocks <= 0 ||
      static_cast<long long>(blocks) * G * kLanes < L ||
      static_cast<long long>(smem) != 64LL * qt * ssc * G)
    return cudaErrorInvalidValue;
  Params p;
  p.u_items = static_cast<const int4*>(u_items);
  p.u_off = static_cast<const int*>(u_off);
  p.p_off = static_cast<const int*>(p_off);
  p.planes = static_cast<const int*>(planes);
  p.c_items = static_cast<const int4*>(c_items);
  p.c_off = static_cast<const int*>(c_off);
  p.L = L;
  p.qt = qt;
  p.ssc = ssc;
  p.kk = kk;
  p.e = e;
  p.n_levels = n_levels;
  for (int i = 0; i < kMaxNodes; ++i) {
    p.intact[i] = i < kk ? intact[i] : 0;
    p.er[i] = i < e ? er[i] : 0;
  }
  for (int i = 0; i < kMaxNodes / 32; ++i) p.load[i] = 0;
  for (int n = 0; n < qt; ++n)
    if (load[n]) p.load[n >> 5] |= 1u << (n & 31);
  for (int i = 0; i < kMaxDmat; ++i) p.dmat[i] = i < e * kk ? dmat[i] : 0;
  const auto* i = static_cast<const uint8_t*>(in);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return vec ? launch_g<true>(p, i, o, G, blocks, threads, smem, s)
             : launch_g<false>(p, i, o, G, blocks, threads, smem, s);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
