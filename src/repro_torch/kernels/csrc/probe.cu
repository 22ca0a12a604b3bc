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
// Bound: memory latency, as for searchsorted: 2 * ceil(log2 N) dependent
// 16-byte loads per query against a sealed object of up to 262,144 rows
// (4 MiB of key lanes, which L2 holds whole). Design: one thread per
// query; the lower- and upper-bound descents share one loop of fixed
// depth, so their independent loads overlap, and queries that arrive
// sorted (the probe contract) walk neighbouring paths in a warp.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ bool less128(uint64_t a_lo, uint64_t a_hi,
                                        uint64_t b_lo, uint64_t b_hi) {
  return (a_lo < b_lo) || ((a_lo == b_lo) && (a_hi < b_hi));
}

__global__ void probe_kernel(const uint64_t* __restrict__ t_lo,
                             const uint64_t* __restrict__ t_hi, int64_t n,
                             const uint64_t* __restrict__ q_lo,
                             const uint64_t* __restrict__ q_hi, int64_t nq,
                             int64_t* __restrict__ start,
                             int64_t* __restrict__ cnt) {
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  const uint64_t kl = q_lo[i], kh = q_hi[i];
  int64_t bl = 0, bu = 0, len = n;
  while (len > 1) {
    int64_t half = len >> 1;
    int64_t ml = bl + half, mu = bu + half;
    // lower bound walks right while t < q; upper bound while t <= q
    bool gl = less128(__ldg(t_lo + ml), __ldg(t_hi + ml), kl, kh);
    bool gu = !less128(kl, kh, __ldg(t_lo + mu), __ldg(t_hi + mu));
    bl = gl ? ml : bl;
    bu = gu ? mu : bu;
    len -= half;
  }
  int64_t lb = bl + less128(__ldg(t_lo + bl), __ldg(t_hi + bl), kl, kh);
  int64_t ub = bu + !less128(kl, kh, __ldg(t_lo + bu), __ldg(t_hi + bu));
  start[i] = lb;
  cnt[i] = ub - lb;
}

}  // namespace

// t_lo/t_hi: (n,) uint64 sorted by (lo, hi), n >= 1; q_lo/q_hi: (nq,)
// uint64; start/cnt: (nq,) int64.
extern "C" int rt_probe(int device, const void* t_lo, const void* t_hi,
                        int64_t n, const void* q_lo, const void* q_hi,
                        int64_t nq, void* start, void* cnt, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kThreads = 256;
  unsigned blocks = static_cast<unsigned>((nq + kThreads - 1) / kThreads);
  probe_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(t_lo), static_cast<const uint64_t*>(t_hi),
      n, static_cast<const uint64_t*>(q_lo),
      static_cast<const uint64_t*>(q_hi), nq, static_cast<int64_t*>(start),
      static_cast<int64_t*>(cnt));
  return static_cast<int>(cudaGetLastError());
}
