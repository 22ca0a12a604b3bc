// flash_attention: online-softmax attention forward, bf16, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (body _flash_kernel) together with the GQA head
// repeat and transposes of its wrapper (repro/kernels/ops.py::attention).
// Same function: scores scaled by 1/sqrt(hd) in fp32; keys at or beyond
// Sk masked; top-left causal mask qpos >= kpos and, with a sliding window
// W (causal only, as in repro/models/layers.py::block_causal_attention),
// qpos - kpos < W; masked scores are NEG = -1e30 (not -inf); running max,
// denominator and numerator in fp32; p rounded to bf16 before P.V; output
// acc / max(l, 1e-30). Key tiles that lie wholly above the diagonal of a
// query tile, or wholly below the window of its first row, are skipped,
// and rows at or beyond Sq are never written.
//
// Layout: q (B, Sq, H, hd), k/v (B, Sk, KV, hd), o like q, all contiguous
// bf16 -- the model's own layout, so no transpose. Query head h reads KV
// head h / (H / KV) in place (the reference repeats K and V per group).
//
// Bound: at the serving shapes (S >= 512) the work is 4*Sq*Sk*hd FLOPs
// per head against (2*Sq + 2*Sk)*hd*2 bytes, so the tensor cores bound it,
// not memory; the softmax's exp2 on the SFUs (16 a clock per SM) comes
// next. Design (FlashAttention-3 shape, one CTA per query tile and head):
//
// - TMA. q, k and v are 4-D tensor maps (hd, heads, S, B), so a box that
//   runs past S in batch b is zero-filled, never read from batch b + 1.
//   Boxes are 64 columns (128 bytes) wide with SWIZZLE_128B; hd 128 is
//   two such slabs. The CTA loads its Q tile once and streams 128-key K
//   and V tiles through a ring of kStages stages, each guarded by a full
//   (TMA bytes) and an empty (consumer warps) mbarrier. The host encodes
//   the maps on the stack per call (cuTensorMapEncodeTiled, reached
//   through the runtime, so no -lcuda) and sets the shared memory limit
//   once per instantiation.
// - Warp specialisation. Warpgroup 0 is the producer: after setmaxnreg
//   lowers its registers, one thread of its first warp issues every TMA
//   load. Warpgroups 1..NC are consumers (setmaxnreg raises theirs), each
//   owning 64 query rows: NC = 2 (128-row tiles) when that still gives a
//   full wave of CTAs, else NC = 1 (64-row tiles): at 16 heads and B = 1,
//   prompts up to 1024 take 64 rows, 1536 and longer 128.
//   rt_flash_attention_rows forces either; chip_smoke.py times both at
//   the serving prompt lengths, which backs the rule.
// - wgmma for both products. S = Q.K^T is m64n128k16 with Q and K from
//   shared memory (both K-major); O += P.V is m64n{hd}k16 with P from
//   registers -- the fp32 S accumulator repacked to bf16 is already the A
//   fragment -- and V from shared memory, key-major, with B transposed.
//   Each consumer runs its tile's products and softmax in turn; with two
//   consumers one's softmax overlaps the other's products.
// - Masking only where needed: key tiles wholly below the diagonal of the
//   warpgroup's rows, inside Sk and (with a window) wholly inside the
//   window of its last row skip the mask; the diagonal, the window's lower
//   edge and the ragged last tile mask element by element. The scale is
//   folded into exp2: p = exp2(s * scale * log2e - m), m kept in the log2
//   domain, a masked score being NEG * log2e, so a fully masked prefix
//   still gives p = 1 until a real key rescales it, as in the reference.
// - The sliding window (a runtime int, 0 for none). The CTA's tile loop
//   starts at the tile holding key q0 - W + 1, the first key of its first
//   row's window: the kernel's form of the reference's pair skip. Rows
//   further down may still meet tiles wholly below their own window;
//   those scores are all NEG, so p = 1 there until the row's own window
//   begins. Tiles run in ascending key order and every row with a key in
//   its window meets it later in the loop (its diagonal at the latest),
//   where alpha = exp2(NEG * log2e - m) = 0 rescales that prefix away: the
//   reference's order gives the same guarantee. At W >= Sq no tile is
//   skipped and no score of a written row changes mask, so the output is
//   the unwindowed kernel's, bit for bit.
// - LSE for the backward (optional; serving passes null): the epilogue
//   also writes each row's natural-log sum of exponentials, (m + log2 l)
//   * ln 2 with m and l as above, into lse (B, H, Sq) float32: the
//   training forward saves it, so the backward recomputes P in one pass.
//   It is a template flag, so the serving kernel (kLse false) is compiled
//   without the store and its code does not change.
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cuda.h>          // CUtensorMap and the encoder's types (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBN = 128;           // keys per K/V tile
constexpr int kWG = 128;           // threads per warpgroup
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegL2 = -1e30f * kLog2e;   // NEG in the log2 domain
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

template <int HD, int NC>
struct Cfg {
  static constexpr int kBM = 64 * NC;                 // query rows per CTA
  static constexpr int kStages = HD == 64 ? 3 : 2;   // K/V ring depth
  static constexpr int kSlabs = HD / 64;              // 128-byte column slabs
  static constexpr int kThreads = kWG * (NC + 1);
  static constexpr int kQBytes = kBM * HD * 2;
  static constexpr int kKVBytes = kBN * HD * 2;       // one K or V tile
  // Shared memory, 1024-byte aligned for the 128-byte swizzle:
  // Q | K[kStages] | V[kStages] | mbarriers (q, full[], empty[]).
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKVBytes;
  static constexpr int kBarOff = kVOff + kStages * kKVBytes;
  static constexpr int kSmem = kBarOff + 8 * (1 + 2 * kStages) + 1024;
};

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Registers an asynchronous wgmma reads or writes: pin them around it so
// the compiler neither reads an accumulator before the wait nor reuses an
// operand register while the product is in flight.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define D8(i)                                                       \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),   \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define D32 D8(0), D8(8), D8(16), D8(24)
#define D64 D32, D8(32), D8(40), D8(48), D8(56)
#define R32                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define R64                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// S (64 x 128, fp32) (+)= Q (64 x 16, smem) . K^T (16 x 128, smem).
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : D64
      : "l"(da), "l"(db), "r"(accumulate));
}

// O (64 x 64, fp32) += P (64 x 16, registers) . V (16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O (64 x 128, fp32) += P (64 x 16, registers) . V (16 x 128, smem).
__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef D8
#undef D32
#undef D64
#undef R32
#undef R64

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------------------------ kernel

// Online softmax of one 64 x 128 score tile held as a wgmma accumulator:
// s[4j + e] is row r0 + 8 (e >> 1), key k0 + 8j + 2 tig + (e & 1). Turns
// s into p (fp32, unrounded), updates m (log2 domain) and this thread's
// share of l, and gives the factor alpha the output rows must take.
// `win` is the window (INT_MAX for none); masked tiles only read it.
template <bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float scale_log2, int r0, int k0,
                                             int sk, int causal, int win) {
  float mx[2] = {m[0], m[1]};
  if (kMask) {
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int r = r0 + ((i >> 1) & 1) * 8;
      const int c = k0 + (i >> 2) * 8 + (i & 1);
      const bool keep = c < sk && (!causal || (r >= c && r - c < win));
      s[i] = keep ? s[i] * scale_log2 : kNegL2;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
  } else {
    float raw[2] = {s[0], s[2]};
#pragma unroll
    for (int i = 0; i < 64; ++i)
      raw[(i >> 1) & 1] = fmaxf(raw[(i >> 1) & 1], s[i]);
    mx[0] = fmaxf(mx[0], raw[0] * scale_log2);
    mx[1] = fmaxf(mx[1], raw[1] * scale_log2);
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = quad_max(mx[i]);
    alpha[i] = ex2(m[i] - mx[i]);
    m[i] = mx[i];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float mi = m[(i >> 1) & 1];
    s[i] = kMask ? ex2(s[i] - mi) : ex2(fmaf(s[i], scale_log2, -mi));
    sum[(i >> 1) & 1] += s[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
}

// Rescale the output rows by alpha and round p to the bf16 A fragments of
// the tile's P.V (the fp32 accumulator layout of two 8-key column blocks
// is the m64k16 A layout).
template <int HD>
__device__ __forceinline__ void rescale_pack(const float (&s)[64],
                                             float (&acc)[HD / 2],
                                             uint32_t (&p)[32],
                                             const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

template <int HD, int NC, bool kLse>
__global__ void __launch_bounds__(Cfg<HD, NC>::kThreads, 1)
flash_fwd_kernel(__grid_constant__ const CUtensorMap tq,
                 __grid_constant__ const CUtensorMap tk,
                 __grid_constant__ const CUtensorMap tv,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int sq, int sk, int h, int kv, float scale_log2, int causal,
                 int window) {
  using C = Cfg<HD, NC>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base, s_k = base + C::kKOff, s_v = base + C::kVOff;
  const uint32_t bar_q = base + C::kBarOff;
  const uint32_t bar_full = bar_q + 8;                  // [kStages]
  const uint32_t bar_empty = bar_full + 8 * C::kStages;  // [kStages]

  // Causal tiles further down carry more key tiles: launch those first
  // (blocks start in x-major order, so every head's longest tile leads).
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kBM;
  const int head = blockIdx.x % h, b = blockIdx.x / h;
  const int kvh = head / (h / kv);
  // Key tiles at or past k_end are masked for every row of this CTA, and
  // so are those before t0, wholly below the window of its first row.
  const int k_end = causal ? min(sk, q0 + C::kBM) : sk;
  const int n_tiles = (k_end + kBN - 1) / kBN;
  const int win = causal && window > 0 ? window : 0x7fffffff;
  const int t0 = max(0, q0 - win + 1) / kBN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * NC);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWG;
  if (wg == 0) {
    // ---- producer: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, C::kQBytes);
#pragma unroll
      for (int sl = 0; sl < C::kSlabs; ++sl)
        tma_load(s_q + sl * C::kBM * 128, &tq, bar_q, sl * 64, head, q0, b);
      for (int t = t0; t < n_tiles; ++t) {
        const int st = (t - t0) % C::kStages;
        const uint32_t round = (t - t0) / C::kStages;
        mbar_wait(bar_empty + 8 * st, (round & 1) ^ 1);   // round 0 passes
        const uint32_t full = bar_full + 8 * st;
        mbar_expect_tx(full, 2 * C::kKVBytes);
#pragma unroll
        for (int sl = 0; sl < C::kSlabs; ++sl) {
          const uint32_t off = st * C::kKVBytes + sl * kBN * 128;
          tma_load(s_k + off, &tk, full, sl * 64, kvh, t * kBN, b);
          tma_load(s_v + off, &tv, full, sl * 64, kvh, t * kBN, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroup c: query rows q0 + 64c .. q0 + 64c + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = wg - 1;
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % kWG) / 32;
    const int tig = lane & 3;
    const int r0 = q0 + 64 * c + 16 * warp + (lane >> 2);   // rows r0, r0+8
    // Tiles in [lo_plain, n_plain) lie inside Sk, wholly at or below the
    // diagonal of this warpgroup's first row and wholly inside the window
    // of its last row that is written: no mask.
    const int qmin = q0 + 64 * c;
    const int n_plain = (causal ? min(sk, qmin + 1) : sk) / kBN;
    const int lo_key = min(qmin + 63, sq - 1) - win + 1;
    const int lo_plain = lo_key > 0 ? (lo_key + kBN - 1) / kBN : 0;

    float s[64], acc[HD / 2];
    uint32_t p[32];
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegL2, kNegL2};
    float l[2] = {0.f, 0.f};   // this thread's share; summed over the quad

    const uint32_t q_rows = s_q + c * 64 * 128;
    // S = Q K^T over hd in steps of 16 (32 bytes inside a 128-byte slab)
    auto issue_qk = [&](int st) {
      const uint32_t k_tile = s_k + st * C::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_qk(s, sw128_desc(q_rows + (kk / 4) * C::kBM * 128 + col, 16, 1024),
                 sw128_desc(k_tile + (kk / 4) * kBN * 128 + col, 16, 1024),
                 kk > 0);
      }
      wg_commit();
    };
    // O += P V over a tile's keys in steps of 16 (16 rows of V)
    auto issue_pv = [&](int st) {
      const uint32_t v_tile = s_v + st * C::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_pv(acc, &p[4 * kk],
                 sw128_desc(v_tile + kk * 16 * 128, kBN * 128, 1024));
      wg_commit();
    };
    mbar_wait(bar_q, 0);
    // Per tile: S_t = Q K_t^T, its softmax, O += P_t V_t. With two
    // consumers, one's softmax runs beside the other's products.
    float alpha[2];
    for (int t = t0; t < n_tiles; ++t) {
      const int st = (t - t0) % C::kStages;
      mbar_wait(bar_full + 8 * st, ((t - t0) / C::kStages) & 1);
      pin(s);
      wg_fence();
      issue_qk(st);
      wg_wait<0>();
      pin(s);
      if (t >= n_plain || t < lo_plain)
        softmax_tile<true>(s, m, l, alpha, scale_log2, r0, t * kBN + 2 * tig,
                           sk, causal, win);
      else
        softmax_tile<false>(s, m, l, alpha, scale_log2, r0, 0, sk, causal,
                            win);
      rescale_pack<HD>(s, acc, p, alpha);
      pin(acc);
      pin(p);
      wg_fence();
      issue_pv(st);
      wg_wait<0>();
      pin(acc);
      pin(p);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);   // stage free
    }

    __nv_bfloat16* ob = o + (static_cast<int64_t>(b) * sq * h + head) * HD;
    const int64_t pitch = static_cast<int64_t>(h) * HD;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + half * 8;
      const float den = fmaxf(quad_sum(l[half]), 1e-30f);
      if (r < sq) {
#pragma unroll
        for (int j = 0; j < HD / 8; ++j)
          *reinterpret_cast<uint32_t*>(ob + r * pitch + j * 8 + tig * 2) =
              pack_bf16(acc[4 * j + 2 * half] / den,
                        acc[4 * j + 2 * half + 1] / den);
        // m is the quad's common running max (log2 domain); natural log out
        if (kLse && tig == 0)
          lse[(static_cast<int64_t>(b) * h + head) * sq + r] =
              (m[half] + log2f(den)) * kLn2;
      }
    }
  }
}

// ------------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's entry-point query, so
// the library needs no -lcuda. Looked up once.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &res);
#endif
    return err == cudaSuccess && res == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// (hd, heads, S, B) map of a contiguous (B, S, heads, hd) bf16 tensor;
// boxes of 64 columns x `rows` positions of one head and batch.
bool encode(CUtensorMap* map, const void* ptr, int b, int s, int heads, int hd,
            int rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t row = static_cast<cuuint64_t>(heads) * hd * 2;
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(hd) * 2, row,
                                 row * static_cast<cuuint64_t>(s)};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxDevices = 64;

int sm_count(int device) {
  static std::atomic<int> cached[kMaxDevices];
  int n = cached[device].load(std::memory_order_relaxed);
  if (n == 0) {
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
        cudaSuccess)
      return 0;
    cached[device].store(n, std::memory_order_relaxed);
  }
  return n;
}

// Query rows per CTA: 128 (two consumer warpgroups) while that still
// fills every SM once; 64 (one) on smaller grids.
int default_rows(int device, int b, int sq, int h) {
  const int64_t ctas = static_cast<int64_t>(b) * h * ((sq + 127) / 128);
  return ctas >= sm_count(device) ? 128 : 64;
}

// The dynamic shared memory size is set once per instantiation and device.
template <int HD, int NC, bool kLse>
cudaError_t prepare(int device) {
  static std::atomic<bool> done[kMaxDevices];
  if (done[device].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD, NC, kLse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<HD, NC>::kSmem);
  if (err == cudaSuccess) done[device].store(true, std::memory_order_release);
  return err;
}

template <int HD, int NC, bool kLse>
int launch(int device, const void* q, const void* k, const void* v, void* o,
           float* lse, int b, int sq, int sk, int h, int kv, int causal,
           int window, cudaStream_t stream) {
  using C = Cfg<HD, NC>;
  cudaError_t err = prepare<HD, NC, kLse>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, b, sq, h, HD, C::kBM) ||
      !encode(&tk, k, b, sk, kv, HD, kBN) || !encode(&tv, v, b, sk, kv, HD, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = static_cast<float>(
      1.0 / std::sqrt(static_cast<double>(HD)) * 1.4426950408889634);
  const dim3 grid(b * h, (sq + C::kBM - 1) / C::kBM);
  flash_fwd_kernel<HD, NC, kLse><<<grid, C::kThreads, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, sq, sk, h, kv,
      scale_log2, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// The LSE instance when lse is given, else serving's.
template <int HD, int NC>
int pick(int device, const void* q, const void* k, const void* v, void* o,
         float* lse, int b, int sq, int sk, int h, int kv, int causal,
         int window, cudaStream_t stream) {
  return lse != nullptr
             ? launch<HD, NC, true>(device, q, k, v, o, lse, b, sq, sk, h, kv,
                                    causal, window, stream)
             : launch<HD, NC, false>(device, q, k, v, o, lse, b, sq, sk, h,
                                     kv, causal, window, stream);
}

template <int HD, int NC>
int describe(int* out) {
  using C = Cfg<HD, NC>;
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, flash_fwd_kernel<HD, NC, false>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[9] = {C::kBM, kBN, C::kStages, C::kThreads, attr.numRegs,
                       kProducerRegs, kConsumerRegs, C::kSmem,
                       static_cast<int>(attr.sharedSizeBytes)};
  for (int i = 0; i < 9; ++i) out[i] = vals[i];
  return 0;
}

int dispatch(int device, const void* q, const void* k, const void* v,
             void* o, void* lse_out, int b, int sq, int sk, int h, int kv,
             int hd, int causal, int window, int rows, void* stream) {
  if (window < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  if (hd == 64 && rows == 128)
    return pick<64, 2>(device, q, k, v, o, lse, b, sq, sk, h, kv, causal,
                         window, s);
  if (hd == 64 && rows == 64)
    return pick<64, 1>(device, q, k, v, o, lse, b, sq, sk, h, kv, causal,
                         window, s);
  if (hd == 128 && rows == 128)
    return pick<128, 2>(device, q, k, v, o, lse, b, sq, sk, h, kv, causal,
                         window, s);
  if (hd == 128 && rows == 64)
    return pick<128, 1>(device, q, k, v, o, lse, b, sq, sk, h, kv, causal,
                         window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q/o: (b, sq, h, hd) bf16; k/v: (b, sk, kv, hd) bf16; all contiguous and
// 16-byte aligned; h % kv == 0; sq, sk >= 1; hd in {64, 128} (else
// cudaErrorInvalidValue). lse: null, or (b, h, sq) float32 for the rows'
// natural-log sums of exponentials. window: the causal sliding window W
// (query i sees keys i - W + 1 .. i), 0 for none; read only when causal.
extern "C" int rt_flash_attention(int device, const void* q, const void* k,
                                  const void* v, void* o, void* lse, int b,
                                  int sq, int sk, int h, int kv, int hd,
                                  int causal, int window, void* stream) {
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  return dispatch(device, q, k, v, o, lse, b, sq, sk, h, kv, hd, causal,
                  window, default_rows(device, b, sq, h), stream);
}

// rt_flash_attention with `rows` (64 or 128) query rows per CTA in place
// of its own choice, to time that choice.
extern "C" int rt_flash_attention_rows(int device, const void* q,
                                       const void* k, const void* v, void* o,
                                       void* lse, int b, int sq, int sk, int h,
                                       int kv, int hd, int causal, int window,
                                       int rows, void* stream) {
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  return dispatch(device, q, k, v, o, lse, b, sq, sk, h, kv, hd, causal,
                  window, rows, stream);
}

// The configuration rt_flash_attention launches for these sizes, into
// out[9]: query rows per CTA, keys per tile, ring stages, threads per CTA,
// registers per thread at launch (cudaFuncGetAttributes), producer and
// consumer registers after setmaxnreg, dynamic and static shared memory
// bytes per CTA.
extern "C" int rt_flash_attention_config(int device, int b, int sq, int h,
                                         int hd, int* out) {
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool two = default_rows(device, b, sq, h) == 128;
  if (hd == 64) return two ? describe<64, 2>(out) : describe<64, 1>(out);
  if (hd == 128) return two ? describe<128, 2>(out) : describe<128, 1>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}
