// flash_attention_bwd: the backward of flash attention, bf16, for sm_90a.
//
// No Pallas counterpart: the reference trains through XLA's automatic
// differentiation of repro/models/layers.py::block_causal_attention. This
// is the gradient of the port's forward (csrc/flash_attention.cu) with
// respect to q, k and v, from the forward's output o and its per-row
// natural-log sum of exponentials lse. Same function as the plain
// version (kernels/ref.py::attention_bwd): scores scaled by 1/sqrt(hd) in
// fp32, the forward's mask (keys at or beyond Sk, top-left causal
// qpos >= kpos), P = exp(S - lse), D = rowsum(dO * O), dV = P^T dO,
// dS = P * (dO V^T - D), dQ = dS K * scale, dK = dS^T Q * scale; dK and dV
// of a KV head sum over its H / KV query heads.
//
// Layout: q, o, dO, dq (B, Sq, H, hd); k, v, dk, dv (B, Sk, KV, hd), all
// contiguous bf16; lse and the D scratch (B, H, Sq) fp32.
//
// Bound: five products of 2 * Sq * Sk * hd FLOPs each per head (S and dP
// twice: once in each pass below), 2.5 times the forward's tensor work
// counted as the backward's bound; the tensor cores bound it, not memory.
// Design (FlashAttention-2's split, on mma.sync.m16n8k16 bf16 -> fp32):
//
// - attn_bwd_dot: one thread per query row and head computes D.
// - attn_bwd_dkdv: one CTA of 4 warps per (batch, KV head, 64-key tile);
//   each warp owns 16 keys and keeps their dK and dV in registers. The CTA
//   loops over the group's query heads and, for each, over the 64-row
//   query tiles that reach its keys (causal: from the diagonal tile on;
//   tiles wholly above the diagonal are skipped), staging Q, dO, lse and D
//   of the tile in shared memory. Per tile: S^T = K Q^T, P^T, dV += P^T
//   dO, dP^T = V dO^T, dS^T, dK += dS^T Q. The group sum stays in
//   registers, so dK and dV are each written once.
// - attn_bwd_dq: one CTA of 4 warps per (batch, head, 64-row query tile);
//   Q and dO of a warp's 16 rows stay in registers as A fragments; the
//   CTA walks the key tiles up to the diagonal: S = Q K^T, P, dP = dO V^T,
//   dS, dQ += dS K.
// - No float atomics: every output element has one writer and a fixed
//   order of sums, so two launches on the same inputs give the same bits.
// - P and dS are rounded to bf16 for the products that take them as an
//   operand (as the forward rounds P before P.V); every sum is fp32.
//   K, V, Q and dO fragments come from padded shared-memory rows (pitch
//   hd + 8) or, transposed, through ldmatrix.trans.
//
// Not yet done (later work): wgmma, TMA and a ring of stages.
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;           // rows per query tile and per key tile
constexpr int kThreads = 128;    // 4 warps x 16 rows
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;

template <int HD>
struct Tile {
  static constexpr int kLD = HD + 8;                 // padded row pitch
  static constexpr int kBytes = kT * kLD * 2;        // one staged tile
  // attn_bwd_dkdv: K | V | Q | dO | lse[kT] | D[kT]
  static constexpr int kDkdvSmem = 4 * kBytes + 2 * kT * 4;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two transposed 8x8 b16 matrices: lanes 0-7 address the rows of the
// first, lanes 8-15 those of the second.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1,
                                                  const void* row) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16 rows x 16 columns from column c0) of a row-major bf16
// tile with pitch ld, rows r .. r + 15 where r = the warp's first row.
__device__ __forceinline__ void a_frag(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int ld,
                                       int r, int c0, int g, int tig) {
  const __nv_bfloat16* p = tile + (r + g) * ld + c0 + 2 * tig;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// C (16 rows x kT columns as 8 n-tiles) (+)= A (16 x HD, fragments from a
// row-major shared tile `a_tile` at warp row `ar`) . B^T, B the row-major
// shared tile `b_tile` (kT rows x HD): c[n] += sum_d A[., d] B[8n + ., d].
template <int HD>
__device__ __forceinline__ void mma_abt(float (&c)[kT / 8][4],
                                        const __nv_bfloat16* a_tile, int ar,
                                        const __nv_bfloat16* b_tile, int g,
                                        int tig) {
  constexpr int LD = Tile<HD>::kLD;
#pragma unroll
  for (int t = 0; t < HD / 16; ++t) {
    uint32_t a[4];
    a_frag(a, a_tile, LD, ar, t * 16, g, tig);
#pragma unroll
    for (int n = 0; n < kT / 8; ++n) {
      const __nv_bfloat16* br = b_tile + (n * 8 + g) * LD + t * 16 + tig * 2;
      mma16816(c[n], a, ld32(br), ld32(br + 8));
    }
  }
}

// C (16 rows x HD as HD/8 n-tiles) += P (16 x kT, fp32 accumulators of an
// earlier product, rounded to bf16 A fragments) . B, B the row-major
// shared tile `b_tile` (kT rows x HD), read transposed by ldmatrix.
template <int HD>
__device__ __forceinline__ void mma_pb(float (&c)[HD / 8][4],
                                       const float (&p)[kT / 8][4],
                                       const __nv_bfloat16* b_tile, int lane) {
  constexpr int LD = Tile<HD>::kLD;
#pragma unroll
  for (int t = 0; t < kT / 16; ++t) {
    const uint32_t pa[4] = {pack_bf16(p[2 * t][0], p[2 * t][1]),
                            pack_bf16(p[2 * t][2], p[2 * t][3]),
                            pack_bf16(p[2 * t + 1][0], p[2 * t + 1][1]),
                            pack_bf16(p[2 * t + 1][2], p[2 * t + 1][3])};
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      uint32_t b0, b1;
      ldmatrix_x2_trans(b0, b1, b_tile + (t * 16 + (lane & 15)) * LD + j * 8);
      mma16816(c[j], pa, b0, b1);
    }
  }
}

// Stage kT rows (row0 ..) of one head of a (B, S, heads, HD) tensor into a
// padded shared tile; rows at or past s are zero.
template <int HD>
__device__ __forceinline__ void stage(__nv_bfloat16* tile,
                                      const __nv_bfloat16* base, int64_t pitch,
                                      int row0, int s) {
  constexpr int LD = Tile<HD>::kLD;
  for (int c = threadIdx.x; c < kT * HD / 8; c += kThreads) {
    const int r = c / (HD / 8), col = (c % (HD / 8)) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < s)
      x = *reinterpret_cast<const uint4*>(base + (row0 + r) * pitch + col);
    *reinterpret_cast<uint4*>(&tile[r * LD + col]) = x;
  }
}

// Write a warp's 16 rows (r, r + 8 per thread) of fp32 accumulators times
// `mul` as bf16 into one head of a (B, S, heads, HD) tensor, rows < s.
template <int HD>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, int64_t pitch,
                                           const float (&acc)[HD / 8][4],
                                           float mul, int r, int s, int tig) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r + half * 8;
    if (row < s) {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<uint32_t*>(base + row * pitch + j * 8 + tig * 2) =
            pack_bf16(acc[j][2 * half] * mul, acc[j][2 * half + 1] * mul);
    }
  }
}

// D[b, h, r] = sum_d dO[b, r, h, d] * O[b, r, h, d] in fp32.
template <int HD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dot(const __nv_bfloat16* __restrict__ o,
             const __nv_bfloat16* __restrict__ d_o, float* __restrict__ dsum,
             int64_t rows, int sq, int h) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= rows) return;
  const uint4* x = reinterpret_cast<const uint4*>(o + t * HD);
  const uint4* y = reinterpret_cast<const uint4*>(d_o + t * HD);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const uint4 a = x[i], b = y[i];
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fa = __bfloat1622float2(a2[e]);
      const float2 fb = __bfloat1622float2(b2[e]);
      acc = fmaf(fa.x, fb.x, acc);
      acc = fmaf(fa.y, fb.y, acc);
    }
  }
  // row t of (B, Sq, H) -> (B, H, Sq)
  const int head = static_cast<int>(t % h);
  const int64_t bs = t / h;
  const int r = static_cast<int>(bs % sq);
  const int64_t b = bs / sq;
  dsum[(b * h + head) * sq + r] = acc;
}

// One (batch, KV head, key tile): dK and dV of its 64 keys.
template <int HD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const __nv_bfloat16* __restrict__ d_o,
              const float* __restrict__ lse, const float* __restrict__ dsum,
              __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
              int sq, int sk, int h, int kv, float scale, int causal) {
  using T = Tile<HD>;
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kT * T::kLD;
  __nv_bfloat16* qs = vs + kT * T::kLD;
  __nv_bfloat16* dos = qs + kT * T::kLD;
  float* lse_s = reinterpret_cast<float*>(dos + kT * T::kLD);
  float* d_s = lse_s + kT;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int k0 = blockIdx.x * kT;          // causal: the longest tiles first
  const int kvh = blockIdx.y % kv, b = blockIdx.y / kv;
  const int group = h / kv;
  const float scale_log2 = scale * kLog2e;
  const int kr = 16 * warp;                // the warp's first key in the tile

  const int64_t q_pitch = static_cast<int64_t>(h) * HD;
  const int64_t kv_pitch = static_cast<int64_t>(kv) * HD;
  const int64_t kv_off = (static_cast<int64_t>(b) * sk * kv + kvh) * HD;
  stage<HD>(ks, k + kv_off, kv_pitch, k0, sk);
  stage<HD>(vs, v + kv_off, kv_pitch, k0, sk);

  float dkacc[HD / 8][4], dvacc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkacc[j][e] = dvacc[j][e] = 0.f;

  // Query tiles wholly above the diagonal (every row < k0) see no key here.
  const int qt_first = causal ? k0 / kT : 0;
  const int n_qt = (sq + kT - 1) / kT;
  for (int j = 0; j < group; ++j) {
    const int head = kvh * group + j;
    const int64_t q_off = (static_cast<int64_t>(b) * sq * h + head) * HD;
    const float* lse_h = lse + (static_cast<int64_t>(b) * h + head) * sq;
    const float* d_h = dsum + (static_cast<int64_t>(b) * h + head) * sq;
    for (int qt = qt_first; qt < n_qt; ++qt) {
      const int q0 = qt * kT;
      __syncthreads();   // every warp is done with the previous Q / dO tile
      stage<HD>(qs, q + q_off, q_pitch, q0, sq);
      stage<HD>(dos, d_o + q_off, q_pitch, q0, sq);
      if (threadIdx.x < kT) {
        const int r = q0 + threadIdx.x;
        lse_s[threadIdx.x] = r < sq ? lse_h[r] * kLog2e : 0.f;
        d_s[threadIdx.x] = r < sq ? d_h[r] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T (16 keys x 64 queries), then P^T in place.
      float s[kT / 8][4];
#pragma unroll
      for (int n = 0; n < kT / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      mma_abt<HD>(s, ks, kr, qs, g, tig);
      const bool full = q0 + kT <= sq && k0 + kT <= sk &&
                        (!causal || q0 >= k0 + kT - 1);
#pragma unroll
      for (int n = 0; n < kT / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = n * 8 + tig * 2 + (e & 1);       // query in tile
          const int key = k0 + kr + g + (e >> 1) * 8;
          const int qr = q0 + qi;
          const bool keep =
              full || (qr < sq && key < sk && (!causal || qr >= key));
          s[n][e] = keep ? exp2f(fmaf(s[n][e], scale_log2, -lse_s[qi])) : 0.f;
        }
      }
      // dV += P^T dO
      mma_pb<HD>(dvacc, s, dos, lane);
      // dP^T = V dO^T, then dS^T = P^T * (dP^T - D) in place.
      float dp[kT / 8][4];
#pragma unroll
      for (int n = 0; n < kT / 8; ++n)
        dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
      mma_abt<HD>(dp, vs, kr, dos, g, tig);
#pragma unroll
      for (int n = 0; n < kT / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[n][e] = s[n][e] * (dp[n][e] - d_s[n * 8 + tig * 2 + (e & 1)]);
      // dK += dS^T Q
      mma_pb<HD>(dkacc, dp, qs, lane);
    }
  }
  __nv_bfloat16* dkb = dk + kv_off;
  __nv_bfloat16* dvb = dv + kv_off;
  store_rows<HD>(dkb, kv_pitch, dkacc, scale, k0 + kr + g, sk, tig);
  store_rows<HD>(dvb, kv_pitch, dvacc, 1.f, k0 + kr + g, sk, tig);
}

// One (batch, head, query tile): dQ of its 64 rows.
template <int HD>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq(const __nv_bfloat16* __restrict__ q,
            const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v,
            const __nv_bfloat16* __restrict__ d_o,
            const float* __restrict__ lse, const float* __restrict__ dsum,
            __nv_bfloat16* __restrict__ dq, int sq, int sk, int h, int kv,
            float scale, int causal) {
  using T = Tile<HD>;
  __shared__ __align__(16) __nv_bfloat16 ks[kT * T::kLD];
  __shared__ __align__(16) __nv_bfloat16 vs[kT * T::kLD];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  // Causal tiles further down carry more key tiles: launch those first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kT;
  const int head = blockIdx.y % h, b = blockIdx.y / h;
  const int kvh = head / (h / kv);
  const float scale_log2 = scale * kLog2e;
  const int r_lo = q0 + 16 * warp + g;     // this thread's rows r_lo, r_lo + 8

  const int64_t q_pitch = static_cast<int64_t>(h) * HD;
  const int64_t kv_pitch = static_cast<int64_t>(kv) * HD;
  const int64_t q_off = (static_cast<int64_t>(b) * sq * h + head) * HD;
  const int64_t kv_off = (static_cast<int64_t>(b) * sk * kv + kvh) * HD;
  const float* lse_h = lse + (static_cast<int64_t>(b) * h + head) * sq;
  const float* d_h = dsum + (static_cast<int64_t>(b) * h + head) * sq;

  // Q and dO of the warp's rows as A fragments; rows past Sq read as zero.
  uint32_t qf[HD / 16][4], dof[HD / 16][4];
  float lse_r[2], d_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + half * 8;
    const bool in = r < sq;
    lse_r[half] = in ? lse_h[r] * kLog2e : 0.f;
    d_r[half] = in ? d_h[r] : 0.f;
#pragma unroll
    for (int t = 0; t < HD / 16; ++t) {
      const __nv_bfloat16* qp = q + q_off + r * q_pitch + t * 16 + tig * 2;
      const __nv_bfloat16* dp = d_o + q_off + r * q_pitch + t * 16 + tig * 2;
      qf[t][half] = in ? ld32(qp) : 0u;
      qf[t][half + 2] = in ? ld32(qp + 8) : 0u;
      dof[t][half] = in ? ld32(dp) : 0u;
      dof[t][half + 2] = in ? ld32(dp + 8) : 0u;
    }
  }

  float dqacc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
    dqacc[j][0] = dqacc[j][1] = dqacc[j][2] = dqacc[j][3] = 0.f;

  // Key tiles at or past k_end are masked for every row of this tile.
  const int k_end = causal ? min(sk, q0 + kT) : sk;
  const int n_kt = (k_end + kT - 1) / kT;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kT;
    __syncthreads();   // every warp is done with the previous tile
    stage<HD>(ks, k + kv_off, kv_pitch, k0, sk);
    stage<HD>(vs, v + kv_off, kv_pitch, k0, sk);
    __syncthreads();

    // S = Q K^T and dP = dO V^T (16 rows x 64 keys each).
    float s[kT / 8][4], dp[kT / 8][4];
#pragma unroll
    for (int n = 0; n < kT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int t = 0; t < HD / 16; ++t) {
#pragma unroll
      for (int n = 0; n < kT / 8; ++n) {
        const __nv_bfloat16* kr = &ks[(n * 8 + g) * T::kLD + t * 16 + tig * 2];
        const __nv_bfloat16* vr = &vs[(n * 8 + g) * T::kLD + t * 16 + tig * 2];
        mma16816(s[n], qf[t], ld32(kr), ld32(kr + 8));
        mma16816(dp[n], dof[t], ld32(vr), ld32(vr + 8));
      }
    }
    const bool full = q0 + kT <= sq && k0 + kT <= sk &&
                      (!causal || q0 >= k0 + kT - 1);
    // dS = P * (dP - D), P = exp(S * scale - lse), in place in dp.
#pragma unroll
    for (int n = 0; n < kT / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const int r = r_lo + half * 8;
        const int key = k0 + n * 8 + tig * 2 + (e & 1);
        const bool keep = full || (r < sq && key < sk && (!causal || r >= key));
        const float p =
            keep ? exp2f(fmaf(s[n][e], scale_log2, -lse_r[half])) : 0.f;
        dp[n][e] = p * (dp[n][e] - d_r[half]);
      }
    }
    // dQ += dS K
    mma_pb<HD>(dqacc, dp, ks, lane);
  }
  store_rows<HD>(dq + q_off, q_pitch, dqacc, scale, r_lo, sq, tig);
}

// The dK/dV kernel's dynamic shared memory limit, once per device.
template <int HD>
cudaError_t prepare(int device) {
  static std::atomic<bool> done[kMaxDevices];
  if (done[device].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dkdv<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile<HD>::kDkdvSmem);
  if (err == cudaSuccess) done[device].store(true, std::memory_order_release);
  return err;
}

template <int HD>
int launch(int device, const void* q, const void* k, const void* v,
           const void* o, const void* lse, const void* d_o, void* dq,
           void* dk, void* dv, void* dsum, int b, int sq, int sk, int h,
           int kv, int causal, cudaStream_t stream) {
  cudaError_t err = prepare<HD>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  using bf = __nv_bfloat16;
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD)));
  const int64_t rows = static_cast<int64_t>(b) * sq * h;
  attn_bwd_dot<HD><<<static_cast<unsigned>((rows + kThreads - 1) / kThreads),
                     kThreads, 0, stream>>>(
      static_cast<const bf*>(o), static_cast<const bf*>(d_o),
      static_cast<float*>(dsum), rows, sq, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv((sk + kT - 1) / kT, b * kv);
  attn_bwd_dkdv<HD><<<grid_kv, kThreads, Tile<HD>::kDkdvSmem, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(d_o),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<bf*>(dk), static_cast<bf*>(dv), sq, sk, h, kv, scale,
      causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_q((sq + kT - 1) / kT, b * h);
  attn_bwd_dq<HD><<<grid_q, kThreads, 0, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(d_o),
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<bf*>(dq), sq, sk, h, kv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, o, d_o, dq: (b, sq, h, hd) bf16; k, v, dk, dv: (b, sk, kv, hd) bf16;
// lse, dsum (scratch for D): (b, h, sq) fp32; all contiguous and 16-byte
// aligned; h % kv == 0; sq, sk >= 1; hd in {64, 128} (else
// cudaErrorInvalidValue). Three launches on `stream`: D, dK/dV, dQ.
extern "C" int rt_flash_attention_bwd(int device, const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* lse, const void* d_o,
                                      void* dq, void* dk, void* dv,
                                      void* dsum, int b, int sq, int sk,
                                      int h, int kv, int hd, int causal,
                                      void* stream) {
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch<64>(device, q, k, v, o, lse, d_o, dq, dk, dv, dsum, b, sq,
                      sk, h, kv, causal, s);
  if (hd == 128)
    return launch<128>(device, q, k, v, o, lse, d_o, dq, dk, dv, dsum, b, sq,
                       sk, h, kv, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The kernels' registers per thread (cudaFuncGetAttributes) and shared
// memory per CTA, into out[6]: D pass regs, dK/dV regs, dQ regs, dK/dV
// dynamic smem, dQ static smem, threads per CTA.
extern "C" int rt_flash_attention_bwd_config(int device, int hd, int* out) {
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes a0, a1, a2;
  if (hd == 64) {
    err = cudaFuncGetAttributes(&a0, attn_bwd_dot<64>);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&a1, attn_bwd_dkdv<64>);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&a2, attn_bwd_dq<64>);
  } else if (hd == 128) {
    err = cudaFuncGetAttributes(&a0, attn_bwd_dot<128>);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&a1, attn_bwd_dkdv<128>);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&a2, attn_bwd_dq<128>);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a0.numRegs;
  out[1] = a1.numRegs;
  out[2] = a2.numRegs;
  out[3] = hd == 64 ? Tile<64>::kDkdvSmem : Tile<128>::kDkdvSmem;
  out[4] = static_cast<int>(a2.sharedSizeBytes);
  out[5] = kThreads;
  return 0;
}
