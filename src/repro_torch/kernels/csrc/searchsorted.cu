// searchsorted: lower / upper bound of uint64 queries in a sorted uint64
// table, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/searchsorted.py::
// searchsorted_pallas (body _searchsorted_kernel). The TPU kernel split
// each 64-bit word into (hi32, lo32) lanes, kept the whole table in VMEM
// and served upper_bound as lower_bound(q + 1) with a guard for the
// maximum word. Here the words are native uint64, each query has a side
// (`<` for left, `<=` for right), and the result equals
// numpy.searchsorted(table, q, side).
//
// Bound: memory latency. Each query walks ceil(log2 N) dependent loads
// of 8 bytes at data-dependent addresses; the bytes that must move (the
// queries in, the indices out, the table once) are small next to the
// latency of the chain. The tables on this path are whole tombstone
// target arrays and change sets that no block of shared memory holds, so
// the search runs over global memory and lets L2 keep the top levels of
// the implicit tree, which every query touches. Design: one thread per
// query, a branchless descent of fixed depth for a given N (no
// divergence inside a warp), and queries that arrive sorted make
// neighbouring threads walk neighbouring paths.
//
// On the main path every launch is small (a few µs of device time), so
// the host side is kept lean: the device is set only when it is not the
// current one, and one entry takes a side per query, so that the zone
// windows of one probe (each object's minimum on the left, its maximum on
// the right) are one launch instead of one pair per object.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Queries [0, n_left) take side left and the rest side right: one
// kernel serves both entries (a one-side launch passes n_left = nq or 0).
__global__ void bound_kernel(const uint64_t* __restrict__ tab, int64_t n,
                             const uint64_t* __restrict__ q, int64_t nq,
                             int64_t n_left, int64_t* __restrict__ out) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const uint64_t key = q[i];
  const bool right = i >= n_left;
  int64_t base = 0;
  int64_t len = n;
  while (len > 1) {
    int64_t half = len >> 1;
    uint64_t v = __ldg(tab + base + half);
    bool go = (v < key) || (right && v == key);
    base = go ? base + half : base;
    len -= half;
  }
  uint64_t v = __ldg(tab + base);
  out[i] = base + static_cast<int64_t>((v < key) || (right && v == key));
}

int launch(int device, const void* tab, int64_t n, const void* q, int64_t nq,
           int64_t n_left, void* out, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nq <= 0) return 0;
  constexpr int kThreads = 256;
  unsigned blocks = static_cast<unsigned>((nq + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint64_t* t = static_cast<const uint64_t*>(tab);
  const uint64_t* qq = static_cast<const uint64_t*>(q);
  int64_t* o = static_cast<int64_t*>(out);
  bound_kernel<<<blocks, kThreads, 0, s>>>(t, n, qq, nq, n_left, o);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tab: (n,) uint64 ascending, n >= 1; q: (nq,) uint64; out: (nq,) int64.
// Query i takes side left (first j with tab[j] >= q[i]) for i < n_left
// and side right (first j with tab[j] > q[i]) otherwise.
extern "C" int rt_searchsorted_sides(int device, const void* tab, int64_t n,
                                     const void* q, int64_t nq,
                                     int64_t n_left, void* out,
                                     void* stream) {
  return launch(device, tab, n, q, nq, n_left, out, stream);
}

// One side for every query: side_right = 0 -> left, 1 -> right.
extern "C" int rt_searchsorted(int device, const void* tab, int64_t n,
                               const void* q, int64_t nq, int side_right,
                               void* out, void* stream) {
  return launch(device, tab, n, q, nq, side_right ? 0 : nq, out, stream);
}
