// searchsorted: lower / upper bound of uint64 queries in a sorted uint64
// table, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/searchsorted.py::
// searchsorted_pallas (body _searchsorted_kernel). The TPU kernel split
// each 64-bit word into (hi32, lo32) lanes, kept the whole table in VMEM
// and served upper_bound as lower_bound(q + 1) with a guard for the
// maximum word. Here the words are native uint64, a `side` flag selects
// `<` or `<=`, and the result equals numpy.searchsorted(table, q, side).
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
#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <bool kRight>
__global__ void bound_kernel(const uint64_t* __restrict__ tab, int64_t n,
                             const uint64_t* __restrict__ q, int64_t nq,
                             int64_t* __restrict__ out) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const uint64_t key = q[i];
  int64_t base = 0;
  int64_t len = n;
  while (len > 1) {
    int64_t half = len >> 1;
    uint64_t v = __ldg(tab + base + half);
    bool go = kRight ? (v <= key) : (v < key);
    base = go ? base + half : base;
    len -= half;
  }
  uint64_t v = __ldg(tab + base);
  out[i] = base + static_cast<int64_t>(kRight ? (v <= key) : (v < key));
}

}  // namespace

// tab: (n,) uint64 ascending, n >= 1; q: (nq,) uint64; out: (nq,) int64.
// side_right = 0 -> first i with tab[i] >= q; 1 -> first i with tab[i] > q.
extern "C" int rt_searchsorted(int device, const void* tab, int64_t n,
                               const void* q, int64_t nq, int side_right,
                               void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kThreads = 256;
  unsigned blocks = static_cast<unsigned>((nq + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint64_t* t = static_cast<const uint64_t*>(tab);
  const uint64_t* qq = static_cast<const uint64_t*>(q);
  int64_t* o = static_cast<int64_t*>(out);
  if (side_right) {
    bound_kernel<true><<<blocks, kThreads, 0, s>>>(t, n, qq, nq, o);
  } else {
    bound_kernel<false><<<blocks, kThreads, 0, s>>>(t, n, qq, nq, o);
  }
  return static_cast<int>(cudaGetLastError());
}
