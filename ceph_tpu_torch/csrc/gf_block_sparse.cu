// Kernel B5: block-sparse GF(2^8) matrix-stripe product on Hopper, bit-sliced.
//
//   out[out_row[g*16 + r], n] = XOR over the live columns c of group g:
//       gfmul(coef[c][r], data[col_row[c], n])
//
// Replaces ceph_tpu/ops/gf_block_sparse.py::_sparse_kernel (launched by
// _build_runner). The TPU kernel gathers a group's occupied 8-row column
// blocks, bit-expands them and runs one [128, 8G] bit-matmul on the MXU.
// Here the same product runs as XORs of bit planes, with no tables. The
// host plan (ops/gf_block_sparse.py, the reference's row groups and block
// ids) is flattened by ops/gf_block_sparse_cuda.py into each group's live
// columns (a data row with at least one nonzero coefficient in the group's
// rows) and, per live column, the 16 coefficients of the group's rows.
//
// Bound on this card (NVIDIA H100 SXM). Bytes: each used data row read once
// and each output row written once; for the k=8,m=4,d=11 decode-2 matrix
// ([128, 640], 512 used input rows) at N = 262,144 that is 0.050 ms at
// 3.35 TB/s. ALU: per 32 lanes, 8 XORs of 32-bit words per set coefficient
// bit (26,032 set bits) plus a transpose (12 masked swaps) and a 7-step
// multiply-by-x chain (21 XORs) per live (group, column) pair (1,120): about
// 0.11 ms of two-input int32 operations at 16.75e12 ops/s (64 int32 lanes
// per SM and clock). The split-nibble design this replaces did 2
// shared-memory table lookups and ~5 integer ops per nonzero coefficient per
// byte: 1.10 ms on NVIDIA H100 80GB HBM3 at 700 W.
//
// Design.
// - A thread owns 32 consecutive lanes (bytes) of N. Per live column it
//   loads 32 data bytes (two 16-byte loads; a warp reads 1 KiB contiguous)
//   into 8 words and transposes them into 8 bit planes: plane i holds bit i
//   of lane 4q+s at bit position 8s+q. The transpose is its own inverse, so
//   the same routine maps the accumulators back to bytes before the store.
// - Multiplying by x modulo 0x11D is p' = [p7, p0, p1^p7, p2^p7, p3^p7, p4,
//   p5, p6]: 3 XORs, the rest register renaming. Per column the chain
//   x^b * data, b = 0..7, is formed once (29 distinct registers); each row
//   with a nonzero coefficient XORs in the multiples of its set bits.
// - The coefficients are the same for every thread of the block, so every
//   test is warp-uniform and never diverges. Rows are tested four at a
//   time (one 32-bit word of coefficients), then one by one, then bit by
//   bit: a column touches ~6 of 16 rows, and skipping a row or a bit by a
//   uniform branch is cheaper than issuing its XORs predicated. The
//   branches, not the XORs, bound the kernel: at 183-188 registers an SM
//   holds 8 warps, too few to hide the stalls between short XOR runs
//   (decode-2: 0.41 ms of device time on NVIDIA H100 80GB HBM3 at 700 W).
// - The column loop's bounds must be visibly uniform: with a per-thread
//   bound every coefficient test became a divergent branch with its own
//   reconvergence barrier, 12% slower at full size (same card).
// - r, b and the plane index are compile-time after unrolling: acc[16][8]
//   stays in registers (128 of them). The next live column's data and
//   coefficients are loaded before the current column is processed.
// - One block per (row group, lane tile); the row group is the
//   fastest-varying block index, so all groups of a lane tile run together
//   and share its data rows in L2 instead of each fetching them from device
//   memory. Where the whole-tile grid would leave SMs idle (short N, such as
//   the 64-lane calls of a per-stripe caller), the block's 4 warps take
//   every 4th live column each over one 1,024-lane tile instead, and XOR
//   their accumulators together through shared memory.
// - Lanes past N load as zero and are never stored. The 16-byte path needs
//   n % 16 == 0 and 16-byte aligned data and out; any other input takes the
//   byte path. Padding rows (out_row < 0) are not written; every real row
//   belongs to exactly one group and is written once, zeros included.
//
// Plain C interface, built with nvcc and loaded with ctypes (ops/cuda_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kLanes = 32;     // lanes (bytes) per thread: one 32-bit plane
constexpr int kRows = 16;      // rows per group: 16 coefficient bytes
constexpr int kSlices = 4;     // column slices of the short-N form (warps)

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

__device__ __forceinline__ void xor8(uint32_t a[8], const uint32_t p[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] ^= p[i];
}

// acc[r] ^= coef[r] * p for the 16 coefficient bytes in cf (row r in byte
// r % 4 of word r / 4), p in bit-plane form
__device__ __forceinline__ void mul_add(uint32_t acc[kRows][8], const uint4 cf,
                                        const uint32_t p[8]) {
  uint32_t mb[8][8];  // mb[b] = x^b * p, modulo x^8 + x^4 + x^3 + x^2 + 1
#pragma unroll
  for (int i = 0; i < 8; ++i) mb[0][i] = p[i];
#pragma unroll
  for (int b = 1; b < 8; ++b) {
    const uint32_t h = mb[b - 1][7];
    mb[b][0] = h;
    mb[b][1] = mb[b - 1][0];
    mb[b][2] = mb[b - 1][1] ^ h;
    mb[b][3] = mb[b - 1][2] ^ h;
    mb[b][4] = mb[b - 1][3] ^ h;
    mb[b][5] = mb[b - 1][4];
    mb[b][6] = mb[b - 1][5];
    mb[b][7] = mb[b - 1][6];
  }
  const uint32_t cw[4] = {cf.x, cf.y, cf.z, cf.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (cw[q]) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t c = (cw[q] >> (8 * j)) & 0xFFu;
        if (c) {
#pragma unroll
          for (int b = 0; b < 8; ++b)
            if (c & (1u << b)) xor8(acc[4 * q + j], mb[b]);
        }
      }
    }
  }
}

// grid: groups * lane tiles blocks, the group fastest-varying. The block's
// kS slices of kThreads / kS threads split the group's live columns (slice s
// takes columns c_beg + s, c_beg + s + kS, ...) over the tile's
// kThreads / kS * 32 lanes. With more than one slice, the slices'
// accumulators are XORed together through shared memory and slice s stores
// rows s * kRows / kS onwards.
template <bool kVec, int kS>
__global__ void __launch_bounds__(kThreads)
gf_block_sparse_kernel(const int* __restrict__ grp_off,
                       const int* __restrict__ col_row,
                       const uint4* __restrict__ col_coef,
                       const int* __restrict__ out_row,
                       const uint8_t* __restrict__ data,
                       uint8_t* __restrict__ out, int groups, long long n) {
  constexpr int kWords = kThreads / kS;  // threads per slice
  const int g = static_cast<int>(blockIdx.x % groups);
  const long long tile = blockIdx.x / groups;
  // one slice: the loop bounds stay block-uniform (see the header), and a
  // thread past N leaves at once, as this form has no barrier
  const int t = kS == 1 ? threadIdx.x : threadIdx.x % kWords;
  const int s = kS == 1 ? 0 : threadIdx.x / kWords;
  const long long lane0 = (tile * kWords + t) * kLanes;
  const bool active = lane0 < n;
  if (kS == 1 && !active) return;
  const long long rem = n - lane0;

  uint32_t acc[kRows][8];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = 0;

  const int c_end = kS == 1 || active ? grp_off[g + 1] : 0;
  int c = grp_off[g] + s;
  uint32_t nxt[8];
  uint4 ncf = make_uint4(0, 0, 0, 0);
  if (c < c_end) {
    load32<kVec>(data + static_cast<long long>(__ldg(col_row + c)) * n + lane0,
                 rem, nxt);
    ncf = __ldg(col_coef + c);
  }
  for (; c < c_end; c += kS) {
    uint32_t p[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i] = nxt[i];
    const uint4 cf = ncf;
    if (c + kS < c_end) {
      load32<kVec>(
          data + static_cast<long long>(__ldg(col_row + c + kS)) * n + lane0,
          rem, nxt);
      ncf = __ldg(col_coef + c + kS);
    }
    transpose8(p);
    mul_add(acc, cf, p);
  }

  if constexpr (kS == 1) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int orow = __ldg(out_row + g * kRows + r);
      if (orow >= 0) {
        transpose8(acc[r]);
        store32<kVec>(out + static_cast<long long>(orow) * n + lane0, rem,
                      acc[r]);
      }
    }
  } else {
    extern __shared__ uint4 red[];  // [kS][kRows][2][kWords]
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      red[((s * kRows + r) * 2 + 0) * kWords + t] =
          make_uint4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      red[((s * kRows + r) * 2 + 1) * kWords + t] =
          make_uint4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
    __syncthreads();
    if (!active) return;
#pragma unroll
    for (int rr = 0; rr < kRows / kS; ++rr) {
      const int r = s * (kRows / kS) + rr;
      const int orow = __ldg(out_row + g * kRows + r);
      if (orow < 0) continue;
      uint32_t w[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
      for (int q = 0; q < kS; ++q) {
        const uint4 lo = red[((q * kRows + r) * 2 + 0) * kWords + t];
        const uint4 hi = red[((q * kRows + r) * 2 + 1) * kWords + t];
        w[0] ^= lo.x; w[1] ^= lo.y; w[2] ^= lo.z; w[3] ^= lo.w;
        w[4] ^= hi.x; w[5] ^= hi.y; w[6] ^= hi.z; w[7] ^= hi.w;
      }
      transpose8(w);
      store32<kVec>(out + static_cast<long long>(orow) * n + lane0, rem, w);
    }
  }
}

constexpr int kMaxDevices = 64;

// The SM count of device dev, read from the driver once per device.
cudaError_t sm_count(int dev, int* sms) {
  static std::atomic<int> known[kMaxDevices];  // 0 = not read yet
  *sms = known[dev].load(std::memory_order_relaxed);
  if (*sms > 0) return cudaSuccess;
  const cudaError_t err =
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) known[dev].store(*sms, std::memory_order_relaxed);
  return err;
}

// One slice per block unless that grid has fewer blocks than the card has
// SMs; then kSlices slices over 1,024-lane tiles.
template <bool kVec>
cudaError_t launch(const int* grp_off, const int* col_row,
                   const uint4* col_coef, const int* out_row,
                   const uint8_t* data, uint8_t* out, int groups, long long n,
                   cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  err = sm_count(dev, &sms);
  if (err != cudaSuccess) return err;
  const long long whole = (n + kThreads * kLanes - 1) / (kThreads * kLanes);
  if (whole * groups >= sms) {
    if (whole * groups > 0x7FFFFFFFLL) return cudaErrorInvalidValue;
    gf_block_sparse_kernel<kVec, 1>
        <<<static_cast<unsigned>(whole * groups), kThreads, 0, stream>>>(
            grp_off, col_row, col_coef, out_row, data, out, groups, n);
    return cudaGetLastError();
  }
  constexpr int kWords = kThreads / kSlices;
  constexpr int kSmem = kSlices * kRows * 8 * kWords * 4;  // 64 KiB
  // the shared-memory limit above 48 KiB, raised once per device
  static std::atomic<bool> raised[kMaxDevices];
  if (!raised[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(gf_block_sparse_kernel<kVec, kSlices>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return err;
    raised[dev].store(true, std::memory_order_relaxed);
  }
  const long long tiles = (n + kWords * kLanes - 1) / (kWords * kLanes);
  gf_block_sparse_kernel<kVec, kSlices>
      <<<static_cast<unsigned>(tiles * groups), kThreads, kSmem, stream>>>(
          grp_off, col_row, col_coef, out_row, data, out, groups, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns the cudaError_t of the launch (0 = queued).
// col_coef: 16 bytes per live column (16-byte aligned); out_row: 16 entries
// per group. vec != 0 requires n % 16 == 0 and 16-byte aligned data/out.
int gf_block_sparse_launch(const void* grp_off, const void* col_row,
                           const void* col_coef, const void* out_row,
                           const void* data, void* out, int groups,
                           long long n, int vec, void* stream) {
  if (n <= 0 || groups <= 0) return 0;
  const auto* go = static_cast<const int*>(grp_off);
  const auto* cr = static_cast<const int*>(col_row);
  const auto* cc = static_cast<const uint4*>(col_coef);
  const auto* orow = static_cast<const int*>(out_row);
  const auto* d = static_cast<const uint8_t*>(data);
  auto* o = static_cast<uint8_t*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return vec ? launch<true>(go, cr, cc, orow, d, o, groups, n, s)
             : launch<false>(go, cr, cc, orow, d, o, groups, n, s);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
