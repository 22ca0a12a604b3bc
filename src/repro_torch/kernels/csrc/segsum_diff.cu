// segsum_diff: the diff-aggregation scan over a key-sorted signed stream,
// for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/segsum_diff.py::
// segsum_pallas (body _segsum_kernel). Per element of a stream sorted by
// 128-bit key (lo, hi) with int32 signs it writes
//   bnd[i]  = 1 where a new run of equal keys starts (row 0 always), and
//   csum[i] = the inclusive cumulative sum of the signs over the WHOLE
//             stream (the TPU kernel emitted block-local sums plus block
//             totals and left the carry to the host).
// An optional second word pair (r_lo, r_hi) ORs its change flags in, so
// the (key, row-signature) grouping of diff_aggregate_rows is one pass.
// The TPU kernel's all-ones row padding and prev_last block seams are
// gone: a thread reads its predecessor directly.
//
// Bound: bytes. Per element it reads 16 or 32 bytes of key words and a
// 4-byte sign and writes 5 bytes, with a handful of compares and adds.
// Design: a two-pass block scan. Pass 1 gives each 1024-thread block one
// tile: boundary flags, a warp-shuffle inclusive scan of the signs, and
// the tile total. A single block then scans the tile totals into
// exclusive offsets, and pass 2 adds each tile's offset. (A decoupled
// look-back scan would save pass 2's re-read of csum; later work.)
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

// Inclusive scan of v across the block; every thread gets its prefix.
__device__ __forceinline__ int32_t block_inclusive_scan(int32_t v) {
  __shared__ int32_t warp_sums[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    int32_t t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    int32_t w = lane < nwarps ? warp_sums[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      int32_t t = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += t;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v += warp_sums[warp - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return v;
}

__global__ void segsum_tiles(const uint64_t* __restrict__ lo,
                             const uint64_t* __restrict__ hi,
                             const uint64_t* __restrict__ r_lo,
                             const uint64_t* __restrict__ r_hi,
                             const int32_t* __restrict__ signs, int64_t n,
                             uint8_t* __restrict__ bnd,
                             int32_t* __restrict__ csum,
                             int32_t* __restrict__ tile_tot) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int32_t v = 0;
  if (i < n) {
    bool b = (i == 0);
    if (!b) {
      b = (lo[i] != lo[i - 1]) || (hi[i] != hi[i - 1]);
      if (r_lo != nullptr) {
        b = b || (r_lo[i] != r_lo[i - 1]) || (r_hi[i] != r_hi[i - 1]);
      }
    }
    bnd[i] = b ? 1 : 0;
    v = signs[i];
  }
  v = block_inclusive_scan(v);
  if (i < n) csum[i] = v;
  if (threadIdx.x == blockDim.x - 1) tile_tot[blockIdx.x] = v;
}

// One block: tile_tot -> exclusive prefix offsets, in place.
__global__ void scan_tile_totals(int32_t* __restrict__ tot, int64_t ntiles) {
  int32_t carry = 0;
  for (int64_t base = 0; base < ntiles; base += blockDim.x) {
    int64_t i = base + threadIdx.x;
    int32_t v = i < ntiles ? tot[i] : 0;
    int32_t inc = block_inclusive_scan(v);
    if (i < ntiles) tot[i] = carry + inc - v;
    // the last thread's inclusive value is the chunk total
    __shared__ int32_t chunk;
    if (threadIdx.x == blockDim.x - 1) chunk = inc;
    __syncthreads();
    carry += chunk;
    __syncthreads();
  }
}

__global__ void add_tile_offsets(int32_t* __restrict__ csum, int64_t n,
                                 const int32_t* __restrict__ off) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n && blockIdx.x > 0) csum[i] += off[blockIdx.x];
}

}  // namespace

// lo/hi: (n,) uint64 sorted keys; r_lo/r_hi: (n,) uint64 or null;
// signs: (n,) int32; bnd: (n,) uint8; csum: (n,) int32;
// scratch: (ceil(n / 1024),) int32. n >= 1.
extern "C" int rt_segsum(int device, const void* lo, const void* hi,
                         const void* r_lo, const void* r_hi,
                         const void* signs, int64_t n, void* bnd, void* csum,
                         void* scratch, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t ntiles = (n + kThreads - 1) / kThreads;
  int32_t* tot = static_cast<int32_t*>(scratch);
  int32_t* cs = static_cast<int32_t*>(csum);
  segsum_tiles<<<static_cast<unsigned>(ntiles), kThreads, 0, s>>>(
      static_cast<const uint64_t*>(lo), static_cast<const uint64_t*>(hi),
      static_cast<const uint64_t*>(r_lo), static_cast<const uint64_t*>(r_hi),
      static_cast<const int32_t*>(signs), n, static_cast<uint8_t*>(bnd), cs,
      tot);
  if (ntiles > 1) {
    scan_tile_totals<<<1, kThreads, 0, s>>>(tot, ntiles);
    add_tile_offsets<<<static_cast<unsigned>(ntiles), kThreads, 0, s>>>(
        cs, n, tot);
  }
  return static_cast<int>(cudaGetLastError());
}
