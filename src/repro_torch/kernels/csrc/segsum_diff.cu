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
// gone: a row's predecessor is read directly.
//
// Bound: bytes. Per row it reads 16 bytes of key words (32 with the row
// pair) and a 4-byte sign and writes a 1-byte flag and a 4-byte sum, 25
// (41) bytes against a few compares and adds: at 6,001,215 rows with the
// pair 246 MB, 0.0734 ms at 3.35 TB/s. So every byte should cross HBM
// once and the launch count should be one.
//
// Design: one launch, one pass, decoupled look-back (Merrill & Garland,
// "Single-pass Parallel Prefix Scan with Decoupled Look-back", the scheme
// of CUB's DeviceScan; no library code here).
//  - The C entry zeroes the scratch (a tile counter, then one status word
//    per tile) with one cudaMemsetAsync and launches once. A CTA takes
//    the next tile id from the counter, not blockIdx, so every tile it
//    waits on belongs to a CTA that is already running.
//  - A tile is kTile = 4,096 rows: kThreads threads x kQuads quads of 4
//    consecutive rows. Quad (k, t) covers rows 4 (k kThreads + t) .. +3,
//    so a warp's accesses are contiguous: two 16-byte loads per key word
//    and quad (one 32-byte sector), one 16-byte load of signs, one 4-byte
//    store of 4 flags, one 16-byte store of 4 sums.
//  - Flags: a row is compared with its predecessor; the quad's first row
//    takes the previous lane's last row by shuffle, lane 0 reads it.
//  - Sums: per quad 4 running sums, per step a warp-shuffle scan of the
//    quad totals, and warp 0 scans the 32 (step, warp) totals. The tile
//    total is published at once as an AGGREGATE status word (flag in the
//    high half, value in the low half of one 64-bit word, so one store
//    publishes both); warp 0 then looks back over 32 predecessors a round,
//    folding AGGREGATEs until the nearest INCLUSIVE, and publishes its
//    own INCLUSIVE. The other warps write their flags meanwhile.
//  - Sums wrap as int32 (uint32 arithmetic), as torch.cumsum in int32.
// Inputs that are not 16-byte aligned (a view that starts mid-sector)
// take the same kernel with scalar loads and stores.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kQuads = 2;                         // quads per thread
constexpr int64_t kTile = kThreads * kQuads * 4;  // rows per tile
static_assert(kQuads * kWarps == 32, "one warp scans the step totals");

constexpr u64 kAggregate = 1ull << 32;            // status word flags;
constexpr u64 kInclusive = 2ull << 32;            // 0 = not yet published

__device__ __forceinline__ u64 load_status(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ uint32_t warp_inclusive(uint32_t v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t t = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// The sum of every tile before `tile` (warp 0, all lanes; tile >= 1):
// lane l reads the status of tile end - 1 - l, waits until it is
// published, and the warp folds the values up to the nearest INCLUSIVE.
__device__ uint32_t look_back(const u64* status, int64_t tile, int lane) {
  uint32_t prefix = 0;
  for (int64_t end = tile;; end -= 32) {
    const int64_t i = end - 1 - lane;
    u64 w = kInclusive;               // before tile 0: an inclusive 0
    if (i >= 0) {
      do {
        w = load_status(status + i);
      } while ((w >> 32) == 0);
    }
    const unsigned inc = __ballot_sync(0xffffffffu, w >= kInclusive);
    const int stop = inc ? __ffs(inc) - 1 : 31;
    uint32_t v = lane <= stop ? static_cast<uint32_t>(w) : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    prefix += v;
    if (inc) return prefix;
  }
}

// Four consecutive words from row r0; rows at or past n read 0.
template <bool kVec>
__device__ __forceinline__ void load_quad(const u64* __restrict__ p,
                                          int64_t r0, int64_t n, u64 w[4]) {
  if (kVec && r0 + 4 <= n) {
    const ulonglong2* v = reinterpret_cast<const ulonglong2*>(p + r0);
    const ulonglong2 a = v[0], b = v[1];
    w[0] = a.x; w[1] = a.y; w[2] = b.x; w[3] = b.y;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = r0 + j < n ? p[r0 + j] : 0ull;
  }
}

// OR into f the change flags of rows r0+1 .. r0+3 of p and of row r0
// against its predecessor (the previous lane's last row; lane 0 reads it).
template <bool kVec>
__device__ __forceinline__ void or_changes(const u64* __restrict__ p,
                                           int64_t r0, int64_t n, int lane,
                                           bool f[4]) {
  u64 w[4];
  load_quad<kVec>(p, r0, n, w);
  u64 prev = __shfl_up_sync(0xffffffffu, w[3], 1);
  if (lane == 0 && r0 > 0 && r0 < n) prev = p[r0 - 1];
  f[0] |= w[0] != prev;
  f[1] |= w[1] != w[0];
  f[2] |= w[2] != w[1];
  f[3] |= w[3] != w[2];
}

template <bool kVec, bool kRows>
__global__ void __launch_bounds__(kThreads, 2)
segsum_scan(const u64* __restrict__ lo, const u64* __restrict__ hi,
            const u64* __restrict__ r_lo, const u64* __restrict__ r_hi,
            const int32_t* __restrict__ signs, int64_t n,
            uint8_t* __restrict__ bnd, int32_t* __restrict__ csum,
            u64* __restrict__ scratch) {
  __shared__ uint32_t s_tile;
  __shared__ uint32_t s_step[32];  // (step, warp) totals, then prefixes
  __shared__ uint32_t s_prefix;    // the sum of every earlier tile
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  u64* status = scratch + 1;
  if (t == 0) s_tile = atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t base = tile * kTile;

  // 1. signs: running sums inside each quad, then a warp scan per step
  uint32_t sum[kQuads][4];
#pragma unroll
  for (int k = 0; k < kQuads; ++k) {
    const int64_t r0 = base + 4 * (k * kThreads + t);
    int32_t s[4];
    if (kVec && r0 + 4 <= n) {
      const int4 v = *reinterpret_cast<const int4*>(signs + r0);
      s[0] = v.x; s[1] = v.y; s[2] = v.z; s[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] = r0 + j < n ? signs[r0 + j] : 0;
    }
    uint32_t run = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) sum[k][j] = run += static_cast<uint32_t>(s[j]);
    const uint32_t incl = warp_inclusive(run, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) sum[k][j] += incl - run;
    if (lane == 31) s_step[k * kWarps + warp] = incl;
  }
  __syncthreads();

  // 2. warp 0: the step totals' scan, the tile's status, the look-back
  if (warp == 0) {
    const uint32_t v = s_step[lane];
    const uint32_t incl = warp_inclusive(v, lane);
    s_step[lane] = incl - v;
    const uint32_t total = __shfl_sync(0xffffffffu, incl, 31);
    uint32_t prefix = 0;
    if (tile > 0) {
      if (lane == 0) store_status(status + tile, kAggregate | total);
      prefix = look_back(status, tile, lane);
    }
    if (lane == 0) {
      store_status(status + tile, kInclusive | (prefix + total));
      s_prefix = prefix;
    }
  }

  // 3. boundary flags, 4 to a store (warp 0 after its look-back)
#pragma unroll
  for (int k = 0; k < kQuads; ++k) {
    const int64_t r0 = base + 4 * (k * kThreads + t);
    bool f[4] = {false, false, false, false};
    or_changes<kVec>(lo, r0, n, lane, f);
    or_changes<kVec>(hi, r0, n, lane, f);
    if (kRows) {
      or_changes<kVec>(r_lo, r0, n, lane, f);
      or_changes<kVec>(r_hi, r0, n, lane, f);
    }
    if (r0 == 0) f[0] = true;
    if (kVec && r0 + 4 <= n) {
      *reinterpret_cast<uint32_t*>(bnd + r0) =
          static_cast<uint32_t>(f[0]) | static_cast<uint32_t>(f[1]) << 8 |
          static_cast<uint32_t>(f[2]) << 16 |
          static_cast<uint32_t>(f[3]) << 24;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (r0 + j < n) bnd[r0 + j] = f[j];
    }
  }
  __syncthreads();

  // 4. sums: the earlier tiles', the earlier steps' and warps', the quad's
  const uint32_t prefix = s_prefix;
#pragma unroll
  for (int k = 0; k < kQuads; ++k) {
    const int64_t r0 = base + 4 * (k * kThreads + t);
    const uint32_t add = prefix + s_step[k * kWarps + warp];
    int32_t c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = static_cast<int32_t>(sum[k][j] + add);
    if (kVec && r0 + 4 <= n) {
      *reinterpret_cast<int4*>(csum + r0) = make_int4(c[0], c[1], c[2], c[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (r0 + j < n) csum[r0 + j] = c[j];
    }
  }
}

bool aligned(const void* p, uintptr_t a) {
  return (reinterpret_cast<uintptr_t>(p) & (a - 1)) == 0;
}

template <bool kVec, bool kRows>
void launch(unsigned tiles, cudaStream_t s, const void* lo, const void* hi,
            const void* r_lo, const void* r_hi, const void* signs, int64_t n,
            void* bnd, void* csum, void* scratch) {
  segsum_scan<kVec, kRows><<<tiles, kThreads, 0, s>>>(
      static_cast<const u64*>(lo), static_cast<const u64*>(hi),
      static_cast<const u64*>(r_lo), static_cast<const u64*>(r_hi),
      static_cast<const int32_t*>(signs), n, static_cast<uint8_t*>(bnd),
      static_cast<int32_t*>(csum), static_cast<u64*>(scratch));
}

}  // namespace

// lo/hi: (n,) uint64 sorted keys; r_lo/r_hi: (n,) uint64 or null;
// signs: (n,) int32; bnd: (n,) uint8; csum: (n,) int32;
// scratch: scratch_words uint64, at least ceil(n / 4096) + 1 (else
// cudaErrorInvalidValue and no launch), zeroed here. n >= 0.
extern "C" int rt_segsum(int device, const void* lo, const void* hi,
                         const void* r_lo, const void* r_hi,
                         const void* signs, int64_t n, void* bnd, void* csum,
                         void* scratch, int64_t scratch_words,
                         void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (scratch_words < tiles + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = cudaMemsetAsync(scratch, 0, (tiles + 1) * sizeof(u64), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool rows = r_lo != nullptr;
  const bool vec = aligned(lo, 16) && aligned(hi, 16) && aligned(signs, 16)
      && aligned(csum, 16) && aligned(bnd, 4)
      && (!rows || (aligned(r_lo, 16) && aligned(r_hi, 16)));
  const unsigned g = static_cast<unsigned>(tiles);
  if (vec && rows) {
    launch<true, true>(g, s, lo, hi, r_lo, r_hi, signs, n, bnd, csum, scratch);
  } else if (vec) {
    launch<true, false>(g, s, lo, hi, r_lo, r_hi, signs, n, bnd, csum,
                        scratch);
  } else if (rows) {
    launch<false, true>(g, s, lo, hi, r_lo, r_hi, signs, n, bnd, csum,
                        scratch);
  } else {
    launch<false, false>(g, s, lo, hi, r_lo, r_hi, signs, n, bnd, csum,
                         scratch);
  }
  return static_cast<int>(cudaGetLastError());
}
