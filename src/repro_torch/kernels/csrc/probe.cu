// probe: fused 128-bit key probe (run start + run length), for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/probe.py::probe_pallas
// (body _probe_kernel). For each query key (lo, hi), ordered with the lo
// word primary (the seal order), it returns the exact lower bound
// `start` (defined for misses too: where the key would insert) and
// `cnt = upper_bound - lower_bound`, the length of the run of rows equal
// to the query. The TPU kernel worked on four uint32 lanes and int32
// outputs; here the words are native uint64 and the outputs int64.
//
// Bound. On the main path a sealed object of up to 262,144 rows (4 MiB of
// key lanes) takes the sorted queries inside its zone: about 4,350 of the
// 100,000 keys of an SF1 change set. The bytes that must move are the
// distinct table rows the descents can touch: sorted queries share the
// upper levels, so level l gives at most min(2^l, q) rows, ~34,200 rows x
// 16 B ~ 0.55 MB at 4,333 queries, plus queries and results at 16 B each:
// ~0.69 MB, ~0.2 us at 3.35 TB/s. What the card waits on is the chain of
// dependent loads, each a trip to L2, and the launch's own ~0.9 us of
// device time sits on top.
//
// Design: one warp takes a tile of 32 consecutive queries, one CTA each,
// so ~4,350 queries make ~136 CTAs over the 132 SMs, and cuts the chain
// of 19 dependent levels a query walked alone to four trips.
//  - A warp vote decides whether the tile is sorted by (lo, hi).
//  - Window. The table's keys are hash signatures, so a lo word's rank is
//    close to where it sits between the first and the last row's. One
//    32-pivot level, pivots 64 rows apart around the rows so predicted
//    for the tile's first and last query, brackets the lower bound of the
//    first and the upper bound of the last (the ballot keeps the range
//    between the last pivot below and the first pivot not below). The
//    window between them holds every lower bound and run of the tile. A
//    table of at most 4,096 rows is its own window.
//  - Sample. Every 8th row's key of the window (at most 512 keys, 8 KB)
//    goes to shared memory with cp.async, one trip; each lane descends it
//    there (fixed depth, no divergence) to its 8-row block.
//  - Block. Each lane reads the 7 rows inside its block and the row after
//    the block's end at once, one trip: the lower bound, and the run
//    length but for runs of equal keys longer than those rows (hashed
//    keys give runs of 0 or 1).
//    A run that goes on past those rows is counted by a forward scan of
//    up to 4 rows, then an upper-bound bisection.
//  - Fallback, a path of the same kernel: a tile that is not sorted, or
//    whose window is wider than 4,096 rows (sparse queries, or lo words
//    far from uniform), runs a per-lane descent: the lower- and the
//    upper-bound descent of fixed depth in one loop.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;        // queries per tile, one warp, one CTA
constexpr int kSample = 512;     // most sample keys a tile holds
constexpr int64_t kStride = 8;   // rows between sample keys
constexpr int64_t kWindow = kSample * kStride;  // widest sampled window
constexpr int64_t kReach = 64;   // rows between pivots of the window level
constexpr int kScan = 4;         // run rows scanned before the bisection
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ bool less128(uint64_t a_lo, uint64_t a_hi,
                                        uint64_t b_lo, uint64_t b_hi) {
  return (a_lo < b_lo) || ((a_lo == b_lo) && (a_hi < b_hi));
}

struct Table {
  const uint64_t* __restrict__ lo;
  const uint64_t* __restrict__ hi;
  int64_t n;
  // row i < key
  __device__ __forceinline__ bool below(int64_t i, uint64_t kl,
                                        uint64_t kh) const {
    return less128(__ldg(lo + i), __ldg(hi + i), kl, kh);
  }
  // row i <= key
  __device__ __forceinline__ bool not_above(int64_t i, uint64_t kl,
                                            uint64_t kh) const {
    return !less128(kl, kh, __ldg(lo + i), __ldg(hi + i));
  }
};

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(dst), "l"(gmem) : "memory");
}

// A load issued where it stands: the compiler may not sink it into the
// branch that uses it, behind the trips taken before that branch.
__device__ __forceinline__ uint64_t ld_now(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.global.nc.u64 %0, [%1];\n" : "=l"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The row a lo word would sit at if the table's lo words were uniform
// between its first and last (they are hash signatures).
__device__ __forceinline__ int64_t guess_row(uint64_t x, uint64_t t0,
                                             uint64_t tn, int64_t n) {
  if (x <= t0 || tn <= t0) return 0;
  if (x >= tn) return n - 1;
  return static_cast<int64_t>(__fdividef(__ull2float_rn(x - t0),
                                         __ull2float_rn(tn - t0)) *
                              static_cast<float>(n - 1));
}

// One level of 32 pivots, lane j at base + j * kReach, over a monotone
// test (true, then false over the rows; a pivot before the table counts
// as true, one past it as false): the ballot of the lanes' tests x gives
// [lo, hi] holding the first row whose test is false.
__device__ __forceinline__ void bracket(int64_t base, int64_t n, bool x,
                                        int64_t& lo, int64_t& hi) {
  const int k = __popc(__ballot_sync(kAll, x));
  lo = k > 0 ? base + (k - 1) * kReach + 1 : 0;
  hi = k < kWarp ? base + k * kReach : n;
  lo = lo < 0 ? 0 : lo;
  hi = hi > n ? n : hi;
}

// Upper bound of (kl, kh) given that row `last` equals it: bisection of
// (last, n], row n standing for +infinity.
__device__ __noinline__ int64_t upper_after(const Table& t, int64_t last,
                                            uint64_t kl, uint64_t kh) {
  int64_t l = last, h = t.n;
  while (h - l > 1) {
    int64_t mid = l + ((h - l) >> 1);
    if (t.not_above(mid, kl, kh)) l = mid; else h = mid;
  }
  return h;
}

// Rows equal to (kl, kh) from row i on (i: the run's start or inside it).
__device__ __noinline__ int64_t run_from(const Table& t, int64_t i,
                                         uint64_t kl, uint64_t kh) {
  const int64_t from = i;
  for (int r = 0; r < kScan; ++r, ++i) {
    if (i >= t.n || __ldg(t.lo + i) != kl || __ldg(t.hi + i) != kh) {
      return i - from;
    }
  }
  return upper_after(t, i - 1, kl, kh) - from;
}

__global__ void __launch_bounds__(kWarp)
probe_kernel(Table t, const uint64_t* __restrict__ q_lo,
             const uint64_t* __restrict__ q_hi, int64_t nq,
             int64_t* __restrict__ start, int64_t* __restrict__ cnt) {
  __shared__ uint64_t s_lo[kSample];
  __shared__ uint64_t s_hi[kSample];
  const int lane = threadIdx.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarp;
  const int64_t i = first + lane;
  const bool active = i < nq;
  const int last_lane = static_cast<int>(
      nq - first < kWarp ? nq - first - 1 : kWarp - 1);
  const uint64_t kl = active ? q_lo[i] : 0, kh = active ? q_hi[i] : 0;
  const uint64_t t0 = ld_now(t.lo), tn = ld_now(t.lo + t.n - 1);

  // sorted by (lo, hi)? each lane against the one before it
  const uint64_t pl = __shfl_up_sync(kAll, kl, 1);
  const uint64_t ph = __shfl_up_sync(kAll, kh, 1);
  const bool sorted =
      __all_sync(kAll, lane == 0 || !active || !less128(kl, kh, pl, ph));
  // window [wa, wb): wa is at or below the lower bound of the tile's first
  // query, wb at or above the upper bound of its last
  int64_t wa = 0, wb = t.n;
  if (sorted && t.n > kWindow) {
    const uint64_t fl = __shfl_sync(kAll, kl, 0);
    const uint64_t fh = __shfl_sync(kAll, kh, 0);
    const uint64_t ll = __shfl_sync(kAll, kl, last_lane);
    const uint64_t lh = __shfl_sync(kAll, kh, last_lane);
    const int64_t ga = guess_row(fl, t0, tn, t.n);
    const int64_t gb = guess_row(ll, t0, tn, t.n);
    if (gb - ga <= kWindow) {        // else too sparse to sample
      // both levels' loads in flight before either ballot
      const int64_t base_a = ga - kWarp / 2 * kReach;
      const int64_t base_b = gb - kWarp / 2 * kReach;
      const int64_t pa = base_a + lane * kReach, pb = base_b + lane * kReach;
      const bool ia = pa >= 0 && pa < t.n, ib = pb >= 0 && pb < t.n;
      const uint64_t al = ia ? __ldg(t.lo + pa) : 0;
      const uint64_t ah = ia ? __ldg(t.hi + pa) : 0;
      const uint64_t bl = ib ? __ldg(t.lo + pb) : 0;
      const uint64_t bh = ib ? __ldg(t.hi + pb) : 0;
      const bool xa = pa < 0 || (ia && less128(al, ah, fl, fh));
      const bool xb = pb < 0 || (ib && !less128(ll, lh, bl, bh));
      int64_t a_hi, b_lo;
      bracket(base_a, t.n, xa, wa, a_hi);
      bracket(base_b, t.n, xb, b_lo, wb);
    }
  }
  int64_t lb, run;
  if (sorted && wb - wa <= kWindow) {
    // offsets inside the window are 32-bit: at most kWindow rows
    const uint64_t* wlo = t.lo + wa;
    const uint64_t* whi = t.hi + wa;
    const int w = static_cast<int>(wb - wa);
    // every 8th row of the window into shared memory
    const int m = (w + kStride - 1) / kStride;
    for (int j = lane; j < m; j += kWarp) {
      cp_async8(s_lo + j, wlo + j * kStride);
      cp_async8(s_hi + j, whi + j * kStride);
    }
    cp_async_wait_all();
    __syncwarp();
    // c = sample keys below the query: a descent of fixed depth
    int c = 0;
    for (int step = 1 << (31 - __clz(m | 1)); step > 0; step >>= 1) {
      const int j = c + step;
      const int at = j <= m ? j - 1 : (m > 0 ? m - 1 : 0);
      const bool lt = less128(s_lo[at], s_hi[at], kl, kh);
      c = j <= m && lt ? j : c;
    }
    const bool h_eq = c < m && s_lo[c] == kl && s_hi[c] == kh;
    // the lower bound lies in (l, h] (window offsets): row l (sample c - 1,
    // or a row before the window) is below the query, row h is not: sample
    // c, or for c == m the window's end, from which on every row is above
    // the tile
    const int h = c < m ? c * kStride : w;
    const int l = c > 0 ? (c - 1) * kStride : h - 1;
    const int rows = h - l - 1;                  // at most kStride - 1
    const uint64_t* blo = wlo + (l + 1);
    const uint64_t* bhi = whi + (l + 1);
    // the rows between, and the row after h, read at once
    uint64_t rl[kStride - 1], rh[kStride - 1];
#pragma unroll
    for (int r = 0; r < kStride - 1; ++r) {
      rl[r] = r < rows ? __ldg(blo + r) : 0;
      rh[r] = r < rows ? __ldg(bhi + r) : 0;
    }
    const bool more = c < m && wa + h + 1 < t.n;
    const uint64_t nl = more ? __ldg(wlo + h + 1) : 0;
    const uint64_t nh = more ? __ldg(whi + h + 1) : 0;
    int under = 0, equal = 0;
#pragma unroll
    for (int r = 0; r < kStride - 1; ++r) {
      under += r < rows && less128(rl[r], rh[r], kl, kh);
      equal += r < rows && rl[r] == kl && rh[r] == kh;
    }
    lb = wa + l + 1 + under;
    run = equal;
    // the run reaches row h: go on if row h (sample c) equals the query
    if (l + 1 + under + equal == h && h_eq) {
      const bool next = more && nl == kl && nh == kh;
      run += next ? 2 + run_from(t, wa + h + 2, kl, kh) : 1;
    }
  } else {
    // unsorted or sparse tile: a lane per query, the lower- and the
    // upper-bound descent of fixed depth in one loop, their loads
    // independent
    int64_t bl = 0, bu = 0, len = t.n;
    while (len > 1) {
      const int64_t half = len >> 1;
      const bool gl = t.below(bl + half, kl, kh);
      const bool gu = t.not_above(bu + half, kl, kh);
      bl = gl ? bl + half : bl;
      bu = gu ? bu + half : bu;
      len -= half;
    }
    lb = bl + t.below(bl, kl, kh);
    run = bu + t.not_above(bu, kl, kh) - lb;
  }
  if (active) {
    start[i] = lb;
    cnt[i] = run;
  }
}

}  // namespace

// t_lo/t_hi: (n,) uint64 sorted by (lo, hi), n >= 1; q_lo/q_hi: (nq,)
// uint64; out: (2, nq) int64, row 0 the start, row 1 the run length.
extern "C" int rt_probe(int device, const void* t_lo, const void* t_hi,
                        int64_t n, const void* q_lo, const void* q_hi,
                        int64_t nq, void* out, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nq <= 0) return 0;
  unsigned blocks = static_cast<unsigned>((nq + kWarp - 1) / kWarp);
  Table t{static_cast<const uint64_t*>(t_lo),
          static_cast<const uint64_t*>(t_hi), n};
  int64_t* o = static_cast<int64_t*>(out);
  probe_kernel<<<blocks, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      t, static_cast<const uint64_t*>(q_lo), static_cast<const uint64_t*>(q_hi),
      nq, o, o + nq);
  return static_cast<int>(cudaGetLastError());
}
