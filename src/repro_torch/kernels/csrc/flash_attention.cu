// flash_attention: online-softmax attention forward, bf16, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (body _flash_kernel) together with the GQA head
// repeat and transposes of its wrapper (repro/kernels/ops.py::attention).
// Same function: scores scaled by 1/sqrt(hd) in fp32; keys at or beyond
// Sk masked; top-left causal mask qpos >= kpos; masked scores are
// NEG = -1e30 (not -inf); running max, denominator and numerator in fp32;
// p rounded to bf16 before P.V; output acc / max(l, 1e-30). Key tiles that
// lie wholly above the diagonal of a query tile are skipped, and rows at
// or beyond Sq are never written.
//
// Layout: q (B, Sq, H, hd), k/v (B, Sk, KV, hd), o like q, all contiguous
// bf16 -- the model's own layout, so no transpose. Query head h reads KV
// head h / (H / KV) in place (the reference repeats K and V per group).
//
// Bound: at the serving shapes (S >= 1024) the work is 4*Sq*Sk*hd FLOPs
// per head against (2*Sq + 2*Sk)*hd*2 bytes, so the tensor cores bound it,
// not memory. Design (FlashAttention-2): one CTA of 4 warps per (64-row
// query tile, head, batch); each warp owns 16 query rows. Q stays in
// registers as mma A fragments for the whole loop; 64-key K and V tiles
// are staged in shared memory; Q.K^T and P.V run on the tensor cores as
// mma.sync.m16n8k16 bf16 -> fp32, and the softmax state lives in the
// accumulator registers, so no score ever reaches device memory. V's B
// fragments come from ldmatrix.trans. Not yet done (later work): wgmma,
// TMA and a double-buffered K/V ring to overlap loads with the products.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;      // query rows per CTA: 4 warps x 16
constexpr int kBN = 64;      // keys per staged tile
constexpr int kThreads = 128;
constexpr float kNeg = -1e30f;

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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int sq, int sk, int h, int kv,
                 float scale, int causal) {
  // Row pitch HD + 8 bf16: the 32-bit fragment reads of 8 rows x 4 lanes
  // and the 16-byte ldmatrix rows fall in distinct banks.
  constexpr int LD = HD + 8;
  __shared__ __align__(16) __nv_bfloat16 ks[kBN * LD];
  __shared__ __align__(16) __nv_bfloat16 vs[kBN * LD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;   // mma fragment row / column pair
  // Causal tiles further down carry more key tiles: launch those first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (h / kv);
  const int r_lo = q0 + warp * 16 + g;       // this thread's rows r_lo, r_lo+8

  const int64_t q_pitch = static_cast<int64_t>(h) * HD;
  const int64_t kv_pitch = static_cast<int64_t>(kv) * HD;
  const __nv_bfloat16* qb = q + (static_cast<int64_t>(b) * sq * h + head) * HD;
  const __nv_bfloat16* kb = k + (static_cast<int64_t>(b) * sk * kv + kvh) * HD;
  const __nv_bfloat16* vb = v + (static_cast<int64_t>(b) * sk * kv + kvh) * HD;

  // Q as A fragments (16 rows x HD per warp), rows past Sq read as zero.
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int t = 0; t < HD / 16; ++t) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r_lo + half * 8;
      const __nv_bfloat16* src = qb + r * q_pitch + t * 16 + tig * 2;
      const bool in = r < sq;
      qf[t][half] = in ? *reinterpret_cast<const uint32_t*>(src) : 0u;
      qf[t][half + 2] = in ? *reinterpret_cast<const uint32_t*>(src + 8) : 0u;
    }
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {kNeg, kNeg};
  float l_run[2] = {0.f, 0.f};   // this thread's share; summed over the quad

  // Key tiles at or past k_end are masked for every row of this tile.
  const int k_end = causal ? min(sk, q0 + kBM) : sk;
  const int n_tiles = (k_end + kBN - 1) / kBN;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBN;
    __syncthreads();   // every warp is done with the previous tile
    for (int c = tid; c < kBN * HD / 8; c += kThreads) {
      const int r = c / (HD / 8), col = (c % (HD / 8)) * 8;
      uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = kk;
      if (k0 + r < sk) {
        kk = *reinterpret_cast<const uint4*>(kb + (k0 + r) * kv_pitch + col);
        vv = *reinterpret_cast<const uint4*>(vb + (k0 + r) * kv_pitch + col);
      }
      *reinterpret_cast<uint4*>(&ks[r * LD + col]) = kk;
      *reinterpret_cast<uint4*>(&vs[r * LD + col]) = vv;
    }
    __syncthreads();

    // S = Q K^T: 16 x 64 per warp, as 8 n-tiles of 16 x 8.
    float s[kBN / 8][4];
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int t = 0; t < HD / 16; ++t) {
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n) {
        const __nv_bfloat16* kr = &ks[(n * 8 + g) * LD + t * 16 + tig * 2];
        mma16816(s[n], qf[t], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // Scale and mask; the new running max of each row.
    float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r_lo + (e >> 1) * 8;
        const int c = k0 + n * 8 + tig * 2 + (e & 1);
        const bool keep = c < sk && (!causal || r >= c);
        const float x = keep ? s[n][e] * scale : kNeg;
        s[n][e] = x;
        m_new[e >> 1] = fmaxf(m_new[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_new[i] = quad_max(m_new[i]);
      alpha[i] = expf(m_run[i] - m_new[i]);
      m_run[i] = m_new[i];
    }
    float row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m_run[e >> 1]);
        s[n][e] = p;
        row_sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + row_sum[i];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }

    // O += P V: the S accumulators of two n-tiles are one A fragment.
#pragma unroll
    for (int t = 0; t < kBN / 16; ++t) {
      const uint32_t pa[4] = {pack_bf16(s[2 * t][0], s[2 * t][1]),
                              pack_bf16(s[2 * t][2], s[2 * t][3]),
                              pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]),
                              pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3])};
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, &vs[(t * 16 + (lane & 15)) * LD + j * 8]);
        mma16816(acc[j], pa, b0, b1);
      }
    }
  }

  __nv_bfloat16* ob = o + (static_cast<int64_t>(b) * sq * h + head) * HD;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + half * 8;
    const float den = fmaxf(quad_sum(l_run[half]), 1e-30f);
    if (r < sq) {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<uint32_t*>(ob + r * q_pitch + j * 8 + tig * 2) =
            pack_bf16(acc[j][2 * half] / den, acc[j][2 * half + 1] / den);
      }
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int sk, int h, int kv, int causal, cudaStream_t stream) {
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD)));
  dim3 grid((sq + kBM - 1) / kBM, h, b);
  flash_fwd_kernel<HD><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), sq,
      sk, h, kv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/o: (b, sq, h, hd) bf16; k/v: (b, sk, kv, hd) bf16; all contiguous and
// 16-byte aligned; h % kv == 0; sq, sk >= 1; hd in {64, 128} (else
// cudaErrorInvalidValue).
extern "C" int rt_flash_attention(int device, const void* q, const void* k,
                                  const void* v, void* o, int b, int sq,
                                  int sk, int h, int kv, int hd, int causal,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64) return launch<64>(q, k, v, o, b, sq, sk, h, kv, causal, s);
  if (hd == 128) return launch<128>(q, k, v, o, b, sq, sk, h, kv, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
