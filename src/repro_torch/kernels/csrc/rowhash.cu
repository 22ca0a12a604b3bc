// rowhash: 128-bit row signatures from uint32 column lanes, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/rowhash.py::rowhash_pallas
// (body _rowhash_kernel). Same function, bit for bit: four seeded
// murmur-fmix32 chains over the C lanes of each row,
//     h = fmix32(h ^ (x * C1 + salt(j, s)));  h = h * C2 + 1
// finalized with fmix32(h ^ C). The TPU kernel wrote (R, 4) uint32 words
// and the host packed them into two uint64 words; here each thread writes
// the packed words directly (sig_lo = w1 << 32 | w0, sig_hi = w3 << 32 | w2),
// which fuses ops.pack64 into the kernel.
//
// Bound: bytes, closely followed by integer operations. A row reads
// C * 4 bytes and writes 16, and every lane costs ~42 32-bit integer
// operations across the four chains (per chain step two multiplies, three
// shifts, four xors, two adds); at the main path's C = 24 an H100 needs
// about as long to issue the operations as to move the bytes (PERF.md
// has the measured share). Design: one thread per row keeps the four
// chains in registers with no cross-thread traffic; the lane loop reads
// the row in order, and a warp's 32 rows (32 * C * 4 bytes) stay in L1
// across the loop, so device memory sees each lane once.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

constexpr uint32_t kLaneC1 = 0x9E3779B1u;
constexpr uint32_t kLaneC2 = 0x95D0BE4Fu;
constexpr uint32_t kSaltS = 0x7F4A7C15u;

__global__ void rowhash_kernel(const uint32_t* __restrict__ lanes,
                               int64_t rows, int c,
                               uint64_t* __restrict__ sig_lo,
                               uint64_t* __restrict__ sig_hi) {
  int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const uint32_t* row = lanes + r * c;
  uint32_t h0 = 0x2545F491u, h1 = 0x8C2E1B6Du;
  uint32_t h2 = 0x64E6D3A5u, h3 = 0x5851F42Du;
  for (int j = 0; j < c; ++j) {
    uint32_t xm = __ldg(row + j) * kLaneC1;
    uint32_t base = static_cast<uint32_t>(2 * j + 1) * kLaneC1;
    h0 = fmix32(h0 ^ (xm + base)) * kLaneC2 + 1u;
    h1 = fmix32(h1 ^ (xm + base + kSaltS)) * kLaneC2 + 1u;
    h2 = fmix32(h2 ^ (xm + base + 2u * kSaltS)) * kLaneC2 + 1u;
    h3 = fmix32(h3 ^ (xm + base + 3u * kSaltS)) * kLaneC2 + 1u;
  }
  uint32_t cc = static_cast<uint32_t>(c);
  h0 = fmix32(h0 ^ cc);
  h1 = fmix32(h1 ^ cc);
  h2 = fmix32(h2 ^ cc);
  h3 = fmix32(h3 ^ cc);
  sig_lo[r] = (static_cast<uint64_t>(h1) << 32) | h0;
  sig_hi[r] = (static_cast<uint64_t>(h3) << 32) | h2;
}

}  // namespace

// lanes: (rows, c) uint32, row-major; sig_lo / sig_hi: (rows,) uint64.
// Returns cudaGetLastError() after the launch (0 == launched).
extern "C" int rt_rowhash(int device, const void* lanes, int64_t rows,
                          int c, void* sig_lo, void* sig_hi, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kThreads = 256;
  int64_t blocks = (rows + kThreads - 1) / kThreads;
  rowhash_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(lanes), rows, c,
      static_cast<uint64_t*>(sig_lo), static_cast<uint64_t*>(sig_hi));
  return static_cast<int>(cudaGetLastError());
}
