// Kernel B1: GF(2^8) matrix-stripe product on Hopper, bit-sliced.
//
//   out[i, n] = XOR_j mat[i, j] * data[j, n]     mat [m, k], data [k, N]
//
// over GF(2^8) with polynomial 0x11d, any N, any matrix up to 32 x 128.
//
// Replaces ceph_tpu/ops/gf_pallas.py::_gf_matvec_kernel (pallas_call in
// _matvec_padded_impl, :108). The TPU kernel unpacks the data into bit
// planes in VMEM, multiplies them by the [8m, 8k] GF(2) bit matrix on the
// MXU, takes & 1 and packs back; device memory sees only the data in and
// the parity out. This kernel keeps the bit-matrix view and the single
// pass over the data, and does the GF(2) product with XORs:
// - a thread owns 32 lanes (bytes) of every row: two 16-byte pieces, at
//   16t and 512 + 16t of its warp's 1 KiB span, so that every load and
//   store of a warp covers 512 contiguous bytes. A 12-swap byte<->plane
//   transpose (its own inverse) turns the 32 bytes of a data row into 8
//   bit-plane words: plane b holds bit b of lane 4q+s at bit 8s+q;
// - along the multiply-by-x chain cur = x^s * d_j (3 XORs a step modulo
//   0x11d), cur is XORed into acc[i] for every output row i whose
//   coefficient mat[i, j] has bit s set. That is B[8i+s, 8j], column 0 of
//   the 8x8 block of the bit matrix; the chain produces the other columns.
//   The per-(j, s) masks of output rows (bit i of mask[j][s] = bit s of
//   mat[i, j]) and each column's chain length are kernel parameters
//   (__grid_constant__, 4.2 KiB at 32 x 128), the same for every thread,
//   so each test is a warp-uniform branch around 8 XORs. A zero column
//   is never loaded;
// - acc[R][8] stays in registers, R = 2 (m <= 2: the decodes of 1 and 2
//   lost chunks), 4 (m <= 4: the RS k=8, m=3 encode) or 16 rows a pass; a
//   matrix with more than 16 rows takes two passes, as blocks of their own
//   placed next to the other pass of their tile so that the re-read of
//   the data hits L2. Two rows are loaded ahead of their transposes, and
//   the 2- and 4-row templates on the 16-byte path are held to 64
//   registers, 4 blocks of 256 an SM: 64 KiB of loads in flight per SM.
//   Each finished row is transposed once, then stored.
//
// Bound on this card (NVIDIA H100 SXM, 3.35 TB/s, 16.75e12 two-input
// int32 ops/s: 64 lanes per SM and clock). Bytes: (k + m) * N, 0.0551 ms
// for the ISA k=8, m=3 encode of 128 MiB. Issue, per 32 lanes: k row
// transposes (~60 ops each), a chain step (3) per coefficient bit below
// each column's top bit, 8 XORs per set coefficient bit, m output
// transposes. ISA k=8, m=3 (36 set bits): ~480 + ~150 + 288 + 180 = ~1.1k
// vector int32 ops, 0.035 ms for 16 Mi lanes; the uniform tests and
// branches issue on the uniform datapath and the branch unit. Decode e=1
// (a row of ones, 8 bits): ~0.6k, 0.019 ms; e=2 (69 bits): ~1.4k, 0.044
// ms. So the kernel is bound by bytes, with issue below it.
//
// ptxas (sm_90a), registers per template, 16-byte path / byte path:
// 2 rows 52 / 124, 4 rows 63 / 128, 16 rows 165 / 194; 0 spill bytes but
// for the 4-row 16-byte path's 8 (held to 71 registers and 3 blocks an SM
// it does not spill, and encodes 2.5% slower).
//
// Measured (python -m ceph_tpu_torch.bench.b1_ab, NVIDIA H100 80GB HBM3,
// 700.00 W; torch.profiler's device time of the kernel on [8, 16 Mi],
// 128 MiB): ISA encode 0.0665-0.0670 ms, decode e=1 0.0512-0.0514, e=2
// 0.0617-0.0618, 81-88% of the card's memory rate. The split-nibble
// design this replaces (ISA-L's shared-memory tables, 16 lanes a thread,
// bound by LDS and integer issue), timed in turns with it, took
// 0.1678-0.1691 / 0.0675-0.0698 / 0.1168-0.1223. A form with 4 rows
// loaded ahead at 2 blocks an SM took 0.0665-0.0726 / 0.0515-0.0557 /
// 0.0724-0.0730. Streaming cache hints (ld/st .cs) time faster on
// repeated calls over the same 151 MB only because evict-first keeps
// part of it in L2 across calls; a real stripe batch is read once.
//
// Lanes past N load as zero and are never stored. The 16-byte path needs
// N % 16 == 0 and 16-byte aligned data and out; any other input takes the
// byte path, the same loop with byte loads and stores.
//
// Plain C interface, built with nvcc and loaded with ctypes (ops/cuda_build.py).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxM = 32;
constexpr int kMaxK = 128;
constexpr int kThreads = 256;
constexpr int kHalf = 512;                 // second piece of a thread's lanes
constexpr long long kWarpSpan = 2 * kHalf; // lanes of one warp

struct Params {
  const uint8_t* data;
  uint8_t* out;
  long long n;
  int m, k, passes;
  uint32_t mask[kMaxK][8];  // bit i of mask[j][s]: bit s of mat[i, j]
  uint8_t steps[kMaxK];     // chain steps of column j: its top bit + 1
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

// This thread's 32 lanes of a row into w[0..7]: bytes base..base+15 into
// w[0..3], base+512.. into w[4..7], byte 4q+s of a piece at bits 8s..8s+7
// of its word q. base < n; lanes at or past n read as zero.
template <bool kVec>
__device__ __forceinline__ void load32(const uint8_t* __restrict__ row,
                                       long long base, long long n,
                                       uint32_t w[8]) {
  if (kVec) {  // n % 16 == 0: a piece is wholly in or wholly out
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(row + base));
    const uint4 b =
        base + kHalf < n
            ? __ldg(reinterpret_cast<const uint4*>(row + base + kHalf))
            : make_uint4(0, 0, 0, 0);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const long long c0 = base + (q / 4) * kHalf + 4 * (q % 4);
      uint32_t x = 0;
#pragma unroll
      for (int s = 0; s < 4; ++s)
        if (c0 + s < n) x |= static_cast<uint32_t>(__ldg(row + c0 + s)) << (8 * s);
      w[q] = x;
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store32(uint8_t* __restrict__ row,
                                        long long base, long long n,
                                        const uint32_t w[8]) {
  if (kVec) {
    *reinterpret_cast<uint4*>(row + base) = make_uint4(w[0], w[1], w[2], w[3]);
    if (base + kHalf < n)
      *reinterpret_cast<uint4*>(row + base + kHalf) =
          make_uint4(w[4], w[5], w[6], w[7]);
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const long long c0 = base + (q / 4) * kHalf + 4 * (q % 4);
#pragma unroll
      for (int s = 0; s < 4; ++s)
        if (c0 + s < n) row[c0 + s] = static_cast<uint8_t>(w[q] >> (8 * s));
    }
  }
}

// Block b runs pass b % passes (output rows R*pass..) of lane tile
// b / passes; thread t of the tile owns lanes base..base+15 and
// base+512..base+527 of its warp's 1 KiB span.
// Each template is compiled for this many blocks of 256 an SM: 4 (64
// registers) on the 16-byte path of the 2- and 4-row blocks, 2 (128) on
// their byte path, whose byte loads would spill at 64, 1 for the 16-row
// block (128 accumulator registers).
template <int R, bool kVec>
__global__ void __launch_bounds__(kThreads, R > 4 ? 1 : (kVec ? 4 : 2))
gf_matvec_kernel(const __grid_constant__ Params p) {
  const int pass = static_cast<int>(blockIdx.x % p.passes);
  const long long tile = blockIdx.x / p.passes;
  const long long warp = (tile * blockDim.x + threadIdx.x) >> 5;
  const long long base = warp * kWarpSpan + (threadIdx.x & 31) * 16;
  const long long n = p.n;
  if (base >= n) return;
  const int row0 = pass * R;

  uint32_t acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int w = 0; w < 8; ++w) acc[r][w] = 0;

  // rows loaded ahead of their transposes: with 4 blocks an SM, 64 KiB
  // in flight per SM
  constexpr int kPre = 2;
  for (int j0 = 0; j0 < p.k; j0 += kPre) {
    uint32_t x[kPre][8];
#pragma unroll
    for (int u = 0; u < kPre; ++u) {
      const int j = j0 + u;
      if (j < p.k && p.steps[j])
        load32<kVec>(p.data + j * n, base, n, x[u]);
    }
#pragma unroll
    for (int u = 0; u < kPre; ++u) {
      const int j = j0 + u;
      if (j >= p.k) break;
      const int steps = p.steps[j];
      if (steps == 0) continue;
      transpose8(x[u]);
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        if (s >= steps) break;
        if (s) xtime8(x[u]);
        const uint32_t rows = p.mask[j][s] >> row0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if ((rows >> r) & 1u) {
#pragma unroll
            for (int w = 0; w < 8; ++w) acc[r][w] ^= x[u][w];
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (row0 + r >= p.m) break;
    transpose8(acc[r]);
    store32<kVec>(p.out + (row0 + r) * n, base, n, acc[r]);
  }
}

template <int R, bool kVec>
cudaError_t launch(const Params& p, long long blocks, cudaStream_t stream) {
  gf_matvec_kernel<R, kVec>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// coef is a HOST pointer to the parameter block of ops/gf_cuda.py's
// coef_block: mask [k][8] uint32 (bit i of mask[j][s] = bit s of
// mat[i, j]), then steps [k] uint8; it is copied into the kernel's
// parameters. rows (2, 4 or 16), passes and blocks are gf_cuda.py's
// launch_plan, taken as they are: a plan whose passes do not cover m rows
// exactly, or whose tiles of 256 threads x 32 lanes do not cover n, is
// refused. vec != 0 requires n % 16 == 0 and 16-byte aligned data/out.
int gf_matvec_launch(const void* data, void* out, long long n, int m, int k,
                     const void* coef, int rows, int passes, long long blocks,
                     int vec, void* stream) {
  if (n <= 0) return 0;
  if (m <= 0 || m > kMaxM || k < 0 || k > kMaxK ||
      (rows != 2 && rows != 4 && rows != 16) || passes <= 0 ||
      passes * rows < m || (passes - 1) * rows >= m || blocks <= 0 ||
      blocks > 0x7FFFFFFFLL || blocks % passes ||
      blocks / passes * kThreads * 32 < n)
    return cudaErrorInvalidValue;
  Params p;
  memset(&p, 0, sizeof(p));
  p.data = static_cast<const uint8_t*>(data);
  p.out = static_cast<uint8_t*>(out);
  p.n = n;
  p.m = m;
  p.k = k;
  p.passes = passes;
  const auto* c = static_cast<const uint8_t*>(coef);
  memcpy(p.mask, c, static_cast<size_t>(k) * sizeof(p.mask[0]));
  memcpy(p.steps, c + static_cast<size_t>(k) * sizeof(p.mask[0]),
         static_cast<size_t>(k));
  auto s = static_cast<cudaStream_t>(stream);
  if (rows == 2)
    return vec ? launch<2, true>(p, blocks, s) : launch<2, false>(p, blocks, s);
  if (rows == 4)
    return vec ? launch<4, true>(p, blocks, s) : launch<4, false>(p, blocks, s);
  return vec ? launch<16, true>(p, blocks, s) : launch<16, false>(p, blocks, s);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
