// flash_attention_bwd: the backward of flash attention, bf16, for sm_90a.
//
// No Pallas counterpart: the reference trains through XLA's automatic
// differentiation of repro/models/layers.py::block_causal_attention. This
// is the gradient of the port's forward (csrc/flash_attention.cu) with
// respect to q, k and v, from the forward's output o and its per-row
// natural-log sum of exponentials lse. Same function as the plain
// version (kernels/ref.py::attention_bwd): scores scaled by 1/sqrt(hd) in
// fp32, the forward's mask (keys at or beyond Sk, top-left causal
// qpos >= kpos and, with a sliding window W, qpos - kpos < W),
// P = exp(S - lse), D = rowsum(dO * O), dV = P^T dO,
// dS = P * (dO V^T - D), dQ = dS K * scale, dK = dS^T Q * scale; dK and dV
// of a KV head sum over its H / KV query heads.
//
// Layout: q, o, dO, dq (B, Sq, H, hd); k, v, dk, dv (B, Sk, KV, hd), all
// contiguous bf16; lse (B, H, Sq) fp32. Scratch (the wrapper allocates
// it; nothing needs zeroing): rowstats (2, B, H, Sqp) fp32 with Sqp = Sq
// rounded up to 64, dq_acc (B, H, Sqp, hd) fp32, counters
// (B * H * ceil(Sq / 64) + 1) int32.
//
// Bound: five products of 2 * Sq * Sk * hd FLOPs each per head, 2.5 times
// the forward's tensor work; the tensor cores bound it, not memory.
// Design (FlashAttention-3's backward shape), three launches a call:
//
// - attn_bwd_dot: D = rowsum(dO * O) with HD / 8 lanes per row (16-byte
//   loads, a shuffle tree), coalesced over (B, Sq, H); it also writes
//   lse * log2e (+inf past Sq, so P is 0 there without a mask) beside D in
//   rowstats, padded to whole 64-row tiles, and zeroes the counters.
// - attn_bwd_main: one CTA of three warpgroups per (batch, KV head,
//   128-key tile). Warpgroup 0 holds the producer and the dQ writers;
//   setmaxnreg lowers its registers and raises the consumers'. One
//   producer thread issues every TMA load: K and V of the tile once, then
//   Q and dO tiles of 64 rows (4-D tensor maps, 128-byte swizzle,
//   zero-filled past S) and their 64 lse and D values (bulk copies)
//   through a ring of kStages stages, each guarded by a full (TMA bytes)
//   and an empty (consumer warps) mbarrier. The CTA loops over the
//   group's query heads and, for each, over the query tiles from the
//   diagonal on (under a window, up to the last tile whose rows reach a
//   key of the tile); the group sum of dK and dV stays in registers.
//   Warpgroups 1-2 are consumers, each owning 64 keys. Per query tile a
//   consumer runs five wgmma products: S^T = K Q^T and dP^T = V dO^T
//   (A and B from shared memory, K-major, m64n64); P^T = exp2(S^T * scale
//   * log2e - lse * log2e), masked only on diagonal, ragged-key and
//   (with a window) the window's lower-edge tiles;
//   dS^T = P^T * (dP^T - D); dV += P^T dO and dK += dS^T Q (A the bf16
//   repack of the fp32 accumulator in registers, B MN-major); dS^T goes to
//   a swizzled shared tile (double-buffered), and after a barrier of both
//   consumers each computes dQ_part = dS K for its half of hd (A and B
//   from shared memory, both MN-major) over all 128 keys, into an fp32
//   shared buffer laid out as the dq_acc tensor map's 128-byte swizzle
//   (no bank conflicts).
// - dQ with a fixed summation order, no float atomics whose order varies:
//   each (batch, head, 64-row query tile) has a counter. One writer warp
//   per dQ buffer (kDQBufs) adds a part into dq_acc with a TMA reduce
//   when its turn comes -- descending key tile, the order in which parts
//   arrive while CTAs walk query tiles upward from the diagonal -- waits
//   for the reduce to complete and bumps the counter (release / acquire
//   at gpu scope). The first part (the highest key tile that reaches the
//   query tile) is a TMA store, so dq_acc needs no zeroing, and two
//   launches give the same bits.
// - Deadlock freedom: a CTA takes its tile id from a global atomic
//   counter, not from blockIdx, so every id below a running CTA's belongs
//   to a CTA that runs or has finished. Ids run by (batch, KV head), then
//   key tile from last to first, and a tile only ever waits on the higher
//   key tiles of its own (batch, KV head): smaller ids. The cost is tail
//   balance: causal tiles nearer the start carry more query tiles
//   (key tile t of n walks 2 (n - t) of them per head at Sq = Sk), yet
//   each group's longest tile (t = 0) takes the group's last id. At the
//   training shape (B 4, 16 KV heads, 16 key tiles) the 1,024 CTAs hold
//   17,408 tile steps, 132 per SM on average, and the last CTA to start
//   holds 32 of them: at most about a quarter of the mean, paid once.
//   All pairs, every key tile waits on the next one's part of each query
//   tile, so a group's CTAs run staggered by one reduce each.
// - The sliding window (a runtime int, 0 for none; it needs causal, as in
//   the forward). Key tile kt walks query tiles qt_first .. qt_last, the
//   last being the one that holds row k0 + kBN - 2 + W, the last row that
//   sees the tile's last key (so every query tile with a row that sees a
//   key of this tile). dQ's order does not change: the highest key tile
//   that reaches query tile qt is still its diagonal tile, which lies
//   inside every row's window (each row sees itself), so turn 0 is still
//   the one TMA store and dq_acc needs no zeroing; the key tiles that
//   reach qt form one band (qt_first and qt_last both grow with kt), so
//   the key tiles between kt and the diagonal all add a part before kt,
//   and wait_turn counts the same parts. The deadlock argument is
//   unchanged: a tile still waits only on higher key tiles of its own
//   (batch, KV head). At W >= Sq no pair lies outside the window: the
//   same tiles run in the same order down the same masked paths, and the
//   result is the unwindowed kernel's, bit for bit. Query rows that see
//   no key (rows at or past Sk + W - 1, when Sq > Sk) take no part; the
//   wrapper zeroes their dq.
// - attn_bwd_convert: dq = bf16(dq_acc * scale), back to (B, Sq, H, hd).
//
// Every sum is fp32; P and dS are rounded to bf16 where they are a
// product's operand (as the forward rounds P before P.V). A wait that
// outlives kSpinCycles (a broken schedule, not a slow one) traps, so a
// fault fails the launch instead of hanging the card.
//
// What it costs (timed in PERF.md): at hd 128 a consumer holds dK and dV
// (128 fp32 registers) beside S^T and dP^T (64), and ptxas does not give
// the consumer loop of a 384-thread CTA all the registers setmaxnreg
// grants, so that instance spills and serializes its wgmmas (warning
// C7512); hd 64 fits. Both consumers meet at the dS barrier every query
// tile, so their softmaxes run together and the tensor cores idle then.
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cuda.h>          // CUtensorMap and the encoder's types (no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBN = 128;           // keys per CTA tile
constexpr int kBM = 64;            // query rows per tile
constexpr int kWG = 128;           // threads per warpgroup
constexpr int kThreads = 3 * kWG;  // producer + two consumers
constexpr int kDotThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr long long kSpinCycles = 20000000000LL;   // ~10 s at 2 GHz
constexpr int kMaxDevices = 64;

template <int HD>
struct Cfg {
  static constexpr int kStages = 2;                  // Q / dO ring depth
  static constexpr int kSlabs = HD / 64;              // 128-byte column slabs
  static constexpr int kKVBytes = kBN * HD * 2;       // one K or V tile
  static constexpr int kQBytes = kBM * HD * 2;        // one Q or dO tile
  static constexpr int kDSBytes = kBN * kBM * 2;      // one dS^T tile
  static constexpr int kDQBytes = kBM * HD * 4;       // one fp32 dQ part
  // dQ parts in flight, one writer warp each (the budget at hd 128)
  static constexpr int kDQBufs = HD == 64 ? 3 : 2;
  // Shared memory, 1024-byte aligned for the 128-byte swizzle:
  // K | V | Q[kStages] | dO[kStages] | dS[2] | dQ[kDQBufs] | lse[kStages][64] |
  // D[kStages][64] | mbarriers (kv, full[], empty[]) | tile id.
  static constexpr int kVOff = kKVBytes;
  static constexpr int kQOff = 2 * kKVBytes;
  static constexpr int kDOOff = kQOff + kStages * kQBytes;
  static constexpr int kDSOff = kDOOff + kStages * kQBytes;
  static constexpr int kDQOff = kDSOff + 2 * kDSBytes;
  static constexpr int kRowOff = kDQOff + kDQBufs * kDQBytes;
  static constexpr int kBarOff = kRowOff + 2 * kStages * kBM * 4;
  static constexpr int kIdOff = kBarOff + 8 * (1 + 2 * kStages);
  static constexpr int kSmem = kIdOff + 16 + 1024;
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

// Spin until the phase of parity `parity` has completed; trap if it never
// does.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kSpinCycles) __trap();
  }
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

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// to shared memory; completes on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
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

// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Named barriers: both consumers' dS^T in place (256 threads); per dQ
// buffer, the part in it, and the buffer free again (both consumers and
// the dQ writer warp, 288 threads).
constexpr int kBarDS = 1, kBarDQFull = 2, kBarDQEmpty = 5;   // + buffer
constexpr int kDQSync = 2 * kWG + 32;

// Wait at barrier `id` over `n` threads.
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
// Arrive at barrier `id` over `n` threads without waiting.
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// One box of a 2-D tensor map stored from, or added (fp32) from, shared
// memory into global memory; tracked by the thread's bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_add(const CUtensorMap* map, uint32_t src,
                                        int c0, int c1) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.2d.global.shared::cta.add.tile.bulk_group "
      "[%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
// Commit the thread's bulk copies and wait until they have read their
// shared memory; then (bulk_wait) until they are complete.
__device__ __forceinline__ void bulk_commit_wait_read() {
  asm volatile(
      "cp.async.bulk.commit_group;\n"
      "cp.async.bulk.wait_group.read 0;\n" ::
          : "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Order this thread's bulk-copy (async proxy) global accesses with its
// generic ones.
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__device__ __forceinline__ void st_smem(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(x) : "memory");
}
__device__ __forceinline__ void st_smem_f2(uint32_t addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x),
               "f"(y)
               : "memory");
}

// Spin until *p >= target (acquire at gpu scope); trap if it never is.
__device__ __forceinline__ void wait_turn(const int* p, int target) {
  const long long t0 = clock64();
  for (;;) {
    int v;
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
                 : "=r"(v)
                 : "l"(p)
                 : "memory");
    if (v >= target) return;
    if (clock64() - t0 > kSpinCycles) __trap();
  }
}

// *p += 1 after every write this thread has seen (release at gpu scope).
__device__ __forceinline__ void bump(int* p) {
  asm volatile(
      "fence.acq_rel.gpu;\n"
      "red.relaxed.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(1)
      : "memory");
}

#define D8(i)                                                       \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),   \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define D16 D8(0), D8(8)
#define D32 D16, D8(16), D8(24)
#define D64 D32, D8(32), D8(40), D8(48), D8(56)
#define R16                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
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

// S^T or dP^T (64 x 64, fp32) (+)= A (64 x 16, smem) . B^T (16 x 64,
// smem), both K-major.
__device__ __forceinline__ void wgmma_st(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : D32
      : "l"(da), "l"(db), "r"(accumulate));
}

// dV or dK (64 x 64, fp32) += A (64 x 16, registers) . B (16 x 64, smem,
// MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// dV or dK (64 x 128, fp32) += A (64 x 16, registers) . B (16 x 128, smem).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// dQ_part (64 x 32, fp32) (+)= dS (64 x 16, smem, MN-major) . K (16 x 32,
// smem, MN-major).
__device__ __forceinline__ void wgmma_dq(float (&d)[16], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " R16
      ", %16, %17, p, 1, 1, 1, 1;\n}\n"
      : D16
      : "l"(da), "l"(db), "r"(accumulate));
}

// dQ_part (64 x 64, fp32) (+)= dS (64 x 16, smem, MN-major) . K (16 x 64,
// smem, MN-major).
__device__ __forceinline__ void wgmma_dq(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " R32
      ", %32, %33, p, 1, 1, 1, 1;\n}\n"
      : D32
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef D8
#undef D16
#undef D32
#undef D64
#undef R16
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

// ----------------------------------------------------------------- kernels

// rowstats[0][b][h][s] = lse * log2e (+inf for s >= Sq) and
// rowstats[1][b][h][s] = sum_d dO[b, s, h, d] * O[b, s, h, d] (0 for
// s >= Sq), over s < Sqp; counters[0 .. n_counters) = 0.
template <int HD>
__global__ void __launch_bounds__(kDotThreads)
attn_bwd_dot(const __nv_bfloat16* __restrict__ o,
             const __nv_bfloat16* __restrict__ d_o,
             const float* __restrict__ lse, float* __restrict__ rowstats,
             int* __restrict__ counters, int n_counters, int b_all, int sq,
             int sqp, int h) {
  constexpr int L = HD / 8;          // lanes per row, 16 bytes each
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kDotThreads + threadIdx.x;
  if (t < n_counters) counters[t] = 0;
  const int64_t rows = static_cast<int64_t>(b_all) * sqp * h;
  const int64_t r = t / L;           // (b, s, head) over (B, Sqp, H)
  const int part = static_cast<int>(t % L);
  const int head = static_cast<int>(r % h);
  const int64_t bs = r / h;
  const int s = static_cast<int>(bs % sqp);
  const int64_t b = bs / sqp;
  float acc = 0.f;
  if (r < rows && s < sq) {
    const int64_t off = ((b * sq + s) * h + head) * HD + part * 8;
    const uint4 x = *reinterpret_cast<const uint4*>(o + off);
    const uint4 y = *reinterpret_cast<const uint4*>(d_o + off);
    const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 fx = __bfloat1622float2(x2[e]);
      const float2 fy = __bfloat1622float2(y2[e]);
      acc = fmaf(fx.x, fy.x, acc);
      acc = fmaf(fx.y, fy.y, acc);
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < rows && part == 0) {
    const int64_t bh = b * h + head;
    rowstats[bh * sqp + s] = s < sq ? lse[bh * sq + s] * kLog2e : INFINITY;
    rowstats[rows + bh * sqp + s] = acc;
  }
}

// One (batch, KV head, 128-key tile), by tile id: dK and dV of its keys,
// and its parts of dQ, added into dq_acc (B, H, Sqp, hd) in their turn.
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_main(__grid_constant__ const CUtensorMap tq,
              __grid_constant__ const CUtensorMap tk,
              __grid_constant__ const CUtensorMap tv,
              __grid_constant__ const CUtensorMap tdo,
              __grid_constant__ const CUtensorMap tacc,
              const float* __restrict__ rowstats,
              int* __restrict__ counters, __nv_bfloat16* __restrict__ dk,
              __nv_bfloat16* __restrict__ dv, int b_all, int sq, int sk,
              int h, int kv, float scale, int causal, int window) {
  using C = Cfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(sm);
  const uint32_t s_k = base, s_v = base + C::kVOff;
  const uint32_t s_q = base + C::kQOff, s_do = base + C::kDOOff;
  const uint32_t s_ds = base + C::kDSOff, s_dq = base + C::kDQOff;
  const uint32_t s_rows = base + C::kRowOff;
  const uint32_t bar_kv = base + C::kBarOff;
  const uint32_t bar_full = bar_kv + 8;                  // [kStages]
  const uint32_t bar_empty = bar_full + 8 * C::kStages;  // [kStages]
  int* tile_id = reinterpret_cast<int*>(sm + C::kIdOff);

  const int nqt = (sq + kBM - 1) / kBM;
  const int nkt = (sk + kBN - 1) / kBN;
  const int sqp = nqt * kBM;
  if (threadIdx.x == 0) {
    // the last counter hands out tile ids in the order CTAs start
    *tile_id = atomicAdd(counters + static_cast<int64_t>(b_all) * h * nqt, 1);
    mbar_init(bar_kv, 1);
#pragma unroll
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);   // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int id = *tile_id;
  const int kt = nkt - 1 - id % nkt;      // last key tile first
  const int b = id / nkt / kv, kvh = id / nkt % kv;
  const int k0 = kt * kBN;
  const int group = h / kv;
  // causal: query tiles wholly above the diagonal (every row < k0) see no
  // key of this tile; under a window W (INT_MAX for none) neither do those
  // wholly below the window of its last key: row k0 + kBN - 1 + W - 1 is
  // the last that sees one
  const int win = causal && window > 0 ? window : 0x7fffffff;
  const int qt_first = causal ? min(k0 / kBM, nqt) : 0;
  const int qt_last = static_cast<int>(
      min(static_cast<int64_t>(nqt - 1),
          (static_cast<int64_t>(k0) + kBN - 2 + win) / kBM));
  const int n_q = max(0, qt_last - qt_first + 1);   // query tiles per head
  const int n_iter = group * n_q;

  const int wg = threadIdx.x / kWG;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (warp == 0 && lane == 0) {
      // ---- producer: one thread issues every TMA load
      mbar_expect_tx(bar_kv, 2 * C::kKVBytes);
#pragma unroll
      for (int sl = 0; sl < C::kSlabs; ++sl) {
        tma_load(s_k + sl * kBN * 128, &tk, bar_kv, sl * 64, kvh, k0, b);
        tma_load(s_v + sl * kBN * 128, &tv, bar_kv, sl * 64, kvh, k0, b);
      }
      const int64_t plane = static_cast<int64_t>(b_all) * h * sqp;
      for (int i = 0; i < n_iter; ++i) {
        const int st = i % C::kStages;
        mbar_wait(bar_empty + 8 * st, ((i / C::kStages) & 1) ^ 1);
        const int head = kvh * group + i / n_q;
        const int q0 = (qt_first + i % n_q) * kBM;
        const uint32_t full = bar_full + 8 * st;
        mbar_expect_tx(full, 2 * C::kQBytes + 2 * kBM * 4);
#pragma unroll
        for (int sl = 0; sl < C::kSlabs; ++sl) {
          const uint32_t off = st * C::kQBytes + sl * kBM * 128;
          tma_load(s_q + off, &tq, full, sl * 64, head, q0, b);
          tma_load(s_do + off, &tdo, full, sl * 64, head, q0, b);
        }
        const float* row = rowstats + (static_cast<int64_t>(b) * h + head) * sqp + q0;
        bulk_load(s_rows + st * kBM * 4, row, kBM * 4, full);
        bulk_load(s_rows + (C::kStages + st) * kBM * 4, row + plane, kBM * 4,
                  full);
      }
    } else if (warp >= 1 && warp <= C::kDQBufs) {
      // ---- dQ writers, one warp per dQ buffer (iterations i = buf mod
      // kDQBufs): each adds its parts into dq_acc when their turn comes
      // (descending key tile: `turn` higher key tiles reach the query tile
      // and add first; the first one stores), then bumps the counter. Under
      // a window the key tiles that reach the query tile are still a band
      // that ends at its diagonal tile, so the turn is the same
      const int buf = warp - 1;
      if (buf < n_iter) named_arrive(kBarDQEmpty + buf, kDQSync);
      for (int i = buf; i < n_iter; i += C::kDQBufs) {
        const int head = kvh * group + i / n_q;
        const int qt = qt_first + i % n_q;
        const int kt_max =
            causal ? min(nkt - 1, (qt * kBM + kBM - 1) / kBN) : nkt - 1;
        const int turn = kt_max - kt;
        int* cnt = counters + (static_cast<int64_t>(b) * h + head) * nqt + qt;
        if (lane == 0 && turn > 0) {
          wait_turn(cnt, turn);
          fence_async_global();
        }
        named_sync(kBarDQFull + buf, kDQSync);   // part i is in buffer buf
        if (lane == 0) {
          const int row = (b * h + head) * sqp + qt * kBM;   // of dq_acc
#pragma unroll
          for (int sl = 0; sl < HD / 32; ++sl) {
            const uint32_t src = s_dq + buf * C::kDQBytes + sl * kBM * 128;
            if (turn == 0)
              tma_store(&tacc, src, sl * 32, row);
            else
              tma_add(&tacc, src, sl * 32, row);
          }
          bulk_commit_wait_read();
        }
        __syncwarp();
        if (i + C::kDQBufs < n_iter) named_arrive(kBarDQEmpty + buf, kDQSync);
        if (lane == 0) {
          bulk_wait();
          fence_async_global();
          bump(cnt);
        }
        __syncwarp();
      }
    }
  } else {
    // ---- consumer warpgroup c: keys k0 + 64c .. k0 + 64c + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = wg - 1;
    const int tid = threadIdx.x % kWG;
    const int lane = tid % 32, warp = tid / 32;
    const int g = lane >> 2, tig = lane & 3;
    const int kc0 = k0 + 64 * c;            // this consumer's first key
    const int krow = 64 * c + 16 * warp + g;   // its rows krow, krow + 8
    const float scale_log2 = scale * kLog2e;
    const float* lse_s = reinterpret_cast<const float*>(sm + C::kRowOff);
    const float* d_s = lse_s + C::kStages * kBM;

    float dkacc[HD / 2], dvacc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dkacc[i] = dvacc[i] = 0.f;

    const uint32_t k_rows = s_k + c * 64 * 128, v_rows = s_v + c * 64 * 128;
    mbar_wait(bar_kv, 0);
    for (int i = 0; i < n_iter; ++i) {
      const int st = i % C::kStages;
      const int q0 = (qt_first + i % n_q) * kBM;
      const uint32_t q_t = s_q + st * C::kQBytes, do_t = s_do + st * C::kQBytes;
      mbar_wait(bar_full + 8 * st, (i / C::kStages) & 1);

      // S^T = K Q^T and dP^T = V dO^T over hd in steps of 16
      auto issue_st = [&](float (&acc)[32], uint32_t a_rows, uint32_t b_t) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const uint32_t col = (kk % 4) * 32;
          wgmma_st(acc,
                   sw128_desc(a_rows + (kk / 4) * kBN * 128 + col, 16, 1024),
                   sw128_desc(b_t + (kk / 4) * kBM * 128 + col, 16, 1024),
                   kk > 0);
        }
      };
      // dV += P^T dO or dK += dS^T Q over the tile's queries in steps of
      // 16 (16 rows of dO or Q)
      auto issue_kv = [&](float (&acc)[HD / 2], const uint32_t(&a)[16],
                          uint32_t b_t) {
#pragma unroll
        for (int kk = 0; kk < kBM / 16; ++kk)
          wgmma_rs(acc, &a[4 * kk],
                   sw128_desc(b_t + kk * 16 * 128, kBM * 128, 1024));
      };
      float s[32], dp[32];
      pin(s);
      pin(dp);
      wg_fence();
      issue_st(s, k_rows, q_t);
      issue_st(dp, v_rows, do_t);
      wg_commit();
      wg_wait<0>();
      pin(s);
      pin(dp);

      // P^T = exp2(S^T * scale * log2e - lse * log2e), masked, and dS^T =
      // P^T * (dP^T - D), in place: s[4j + e] is key krow + 8 (e >> 1),
      // query q0 + 8j + 2 tig + (e & 1)
      // and the window's lower edge: the tile's last row below Sq lies W
      // or more past this consumer's first key
      const bool masked = (causal && q0 < kc0 + 63) || kc0 + 64 > sk ||
                          min(q0 + kBM, sq) - 1 - kc0 >= win;
      const float* lse_t = lse_s + st * kBM;
      const float* d_t = d_s + st * kBM;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + 8 * j + 2 * tig);
        const float2 dd = *reinterpret_cast<const float2*>(d_t + 8 * j + 2 * tig);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 4 * j + e;
          float p = ex2(fmaf(s[x], scale_log2, -((e & 1) ? l2.y : l2.x)));
          if (masked) {
            const int key = k0 + krow + 8 * (e >> 1);
            const int qr = q0 + 8 * j + 2 * tig + (e & 1);
            if (key >= sk || (causal && qr < key) || qr - key >= win)
              p = 0.f;
          }
          s[x] = p;
          dp[x] = p * (dp[x] - ((e & 1) ? dd.y : dd.x));
        }
      }
      uint32_t pa[16], da[16];
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        pa[t] = pack_bf16(s[2 * t], s[2 * t + 1]);
        da[t] = pack_bf16(dp[2 * t], dp[2 * t + 1]);
      }
      // dS^T as bf16 into the swizzled [key][query] tile: key row R holds
      // 64 queries in 128 bytes, 16-byte chunk j at j ^ (R & 7)
      const uint32_t ds_t = s_ds + (i & 1) * C::kDSBytes;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = krow + 8 * hh;
        const uint32_t row = ds_t + r * 128 + tig * 4;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          st_smem(row + ((j ^ (r & 7)) << 4), da[2 * j + hh]);
      }
      fence_async_smem();

      pin(dvacc);
      pin(dkacc);
      pin(pa);
      pin(da);
      wg_fence();
      issue_kv(dvacc, pa, do_t);
      issue_kv(dkacc, da, q_t);
      wg_commit();

      // dQ_part = dS K over the tile's 128 keys, for this consumer's half
      // of hd; both consumers' dS^T rows must be in place
      named_sync(kBarDS, 2 * kWG);
      float dq[HD / 4];
      pin(dq);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        const uint32_t kb = HD == 64 ? s_k + kk * 16 * 128 + c * 64
                                     : s_k + c * kBN * 128 + kk * 16 * 128;
        wgmma_dq(dq, sw128_desc(ds_t + kk * 16 * 128, C::kDSBytes, 1024),
                 sw128_desc(kb, kBN * 128, 1024), kk > 0);
      }
      wg_commit();
      wg_wait<1>();                 // dV and dK: the stage is free
      pin(dvacc);
      pin(dkacc);
      pin(pa);
      pin(da);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);
      wg_wait<0>();
      pin(dq);

      // the part, this consumer's half of the columns, into the fp32
      // buffer for the dQ writer: slabs of 32 columns x 64 rows, each row
      // 128 bytes with 16-byte chunk j at j ^ (row & 7) (the tensor map's
      // 128-byte swizzle, so the stores meet no bank conflict)
      const int buf = i % C::kDQBufs;
      named_sync(kBarDQEmpty + buf, kDQSync);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 16 * warp + g + 8 * hh;
#pragma unroll
        for (int j = 0; j < HD / 16; ++j) {
          const int col = c * (HD / 2) + 8 * j + 2 * tig;
          const uint32_t at = s_dq + buf * C::kDQBytes + (col / 32) * kBM * 128 +
                              r * 128 + ((((col % 32) / 4) ^ (r & 7)) << 4) +
                              (col % 4) * 4;
          st_smem_f2(at, dq[4 * j + 2 * hh], dq[4 * j + 2 * hh + 1]);
        }
      }
      fence_async_smem();
      named_arrive(kBarDQFull + buf, kDQSync);
    }

    // dK (times scale) and dV of this consumer's keys below Sk
    const int64_t kv_pitch = static_cast<int64_t>(kv) * HD;
    const int64_t kv_off = (static_cast<int64_t>(b) * sk * kv + kvh) * HD;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = k0 + krow + 8 * hh;
      if (key < sk) {
        __nv_bfloat16* dkr = dk + kv_off + key * kv_pitch + 2 * tig;
        __nv_bfloat16* dvr = dv + kv_off + key * kv_pitch + 2 * tig;
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          *reinterpret_cast<uint32_t*>(dkr + 8 * j) =
              pack_bf16(dkacc[4 * j + 2 * hh] * scale,
                        dkacc[4 * j + 2 * hh + 1] * scale);
          *reinterpret_cast<uint32_t*>(dvr + 8 * j) =
              pack_bf16(dvacc[4 * j + 2 * hh], dvacc[4 * j + 2 * hh + 1]);
        }
      }
    }
  }
}

// dq (B, Sq, H, hd) = bf16(dq_acc (B, H, Sqp, hd) * scale), four values
// a thread.
template <int HD>
__global__ void __launch_bounds__(kDotThreads)
attn_bwd_convert(const float* __restrict__ acc, uint2* __restrict__ dq,
                 int64_t n4, int sq, int sqp, int h, float scale) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kDotThreads + threadIdx.x;
  if (i >= n4) return;
  const int64_t row = i / (HD / 4);          // (b, s, head) of dq
  const int head = static_cast<int>(row % h);
  const int64_t bs = row / h;
  const int64_t b = bs / sq, s = bs % sq;
  const float4 x = *reinterpret_cast<const float4*>(
      acc + ((b * h + head) * sqp + s) * HD + (i % (HD / 4)) * 4);
  dq[i] = make_uint2(pack_bf16(x.x * scale, x.y * scale),
                     pack_bf16(x.z * scale, x.w * scale));
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

// (hd, rows) map of a contiguous (rows, hd) fp32 tensor; boxes of 32
// columns x 64 rows, 128-byte swizzle.
bool encode_acc(CUtensorMap* map, void* ptr, int64_t rows, int hd) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(hd) * 4};
  const cuuint32_t box[2] = {32, static_cast<cuuint32_t>(kBM)};
  const cuuint32_t unit[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, ptr, dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The main kernel's dynamic shared memory limit, once per device.
template <int HD>
cudaError_t prepare(int device) {
  static std::atomic<bool> done[kMaxDevices];
  if (done[device].load(std::memory_order_acquire)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_main<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg<HD>::kSmem);
  if (err == cudaSuccess) done[device].store(true, std::memory_order_release);
  return err;
}

template <int HD>
int launch(int device, const void* q, const void* k, const void* v,
           const void* o, const void* lse, const void* d_o, void* dq,
           void* dk, void* dv, void* rowstats, void* dq_acc, void* counters,
           int b, int sq, int sk, int h, int kv, int causal, int window,
           cudaStream_t stream) {
  using bf = __nv_bfloat16;
  cudaError_t err = prepare<HD>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nqt = (sq + kBM - 1) / kBM, nkt = (sk + kBN - 1) / kBN;
  const int sqp = nqt * kBM;
  CUtensorMap tq, tk, tv, tdo, tacc;
  if (!encode_acc(&tacc, dq_acc, static_cast<int64_t>(b) * h * sqp, HD))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!encode(&tq, q, b, sq, h, HD, kBM) || !encode(&tdo, d_o, b, sq, h, HD, kBM) ||
      !encode(&tk, k, b, sk, kv, HD, kBN) || !encode(&tv, v, b, sk, kv, HD, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(HD)));
  const int n_counters = b * h * nqt + 1;
  const int64_t dot_threads = static_cast<int64_t>(b) * sqp * h * (HD / 8);
  attn_bwd_dot<HD><<<static_cast<unsigned>((dot_threads + kDotThreads - 1) /
                                           kDotThreads),
                     kDotThreads, 0, stream>>>(
      static_cast<const bf*>(o), static_cast<const bf*>(d_o),
      static_cast<const float*>(lse), static_cast<float*>(rowstats),
      static_cast<int*>(counters), n_counters, b, sq, sqp, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_bwd_main<HD><<<b * kv * nkt, kThreads, Cfg<HD>::kSmem, stream>>>(
      tq, tk, tv, tdo, tacc, static_cast<const float*>(rowstats),
      static_cast<int*>(counters),
      static_cast<bf*>(dk), static_cast<bf*>(dv), b, sq, sk, h, kv, scale,
      causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n4 = static_cast<int64_t>(b) * sq * h * HD / 4;
  attn_bwd_convert<HD><<<static_cast<unsigned>((n4 + kDotThreads - 1) /
                                               kDotThreads),
                         kDotThreads, 0, stream>>>(
      static_cast<const float*>(dq_acc), static_cast<uint2*>(dq), n4, sq, sqp,
      h, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int describe(int* out) {
  using C = Cfg<HD>;
  cudaFuncAttributes main_a, dot_a, conv_a;
  cudaError_t err = cudaFuncGetAttributes(&main_a, attn_bwd_main<HD>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&dot_a, attn_bwd_dot<HD>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&conv_a, attn_bwd_convert<HD>);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vals[10] = {kBN, kBM, C::kStages, kThreads, main_a.numRegs,
                        kProducerRegs, kConsumerRegs, C::kSmem, dot_a.numRegs,
                        conv_a.numRegs};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
  return 0;
}

}  // namespace

// q, o, d_o, dq: (b, sq, h, hd) bf16; k, v, dk, dv: (b, sk, kv, hd) bf16;
// lse: (b, h, sq) fp32; scratch: rowstats (2, b, h, sqp) fp32 with sqp =
// 64 * ceil(sq / 64), dq_acc (b, h, sqp, hd) fp32, counters (b * h *
// ceil(sq / 64) + 1) int32, none of it zeroed; all contiguous and 16-byte
// aligned; h % kv == 0; sq, sk >= 1; hd in {64, 128}; window >= 0, the
// causal sliding window W (0 for none; ignored without causal) (else
// cudaErrorInvalidValue). Three launches on `stream`: D (which zeroes the
// counters), the main kernel, the dq conversion. Under a window, the dq
// rows that see no key (at or past sk + W - 1) are left undefined.
extern "C" int rt_flash_attention_bwd(int device, const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* lse, const void* d_o,
                                      void* dq, void* dk, void* dv,
                                      void* rowstats, void* dq_acc,
                                      void* counters, int b, int sq, int sk,
                                      int h, int kv, int hd, int causal,
                                      int window, void* stream) {
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (window < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    return launch<64>(device, q, k, v, o, lse, d_o, dq, dk, dv, rowstats,
                      dq_acc, counters, b, sq, sk, h, kv, causal, window, s);
  if (hd == 128)
    return launch<128>(device, q, k, v, o, lse, d_o, dq, dk, dv, rowstats,
                       dq_acc, counters, b, sq, sk, h, kv, causal, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch configuration for head dim hd, into out[10]: keys per CTA
// tile, query rows per tile, ring stages, threads per CTA of the main
// kernel, its registers per thread at launch (cudaFuncGetAttributes),
// producer and consumer registers after setmaxnreg, its dynamic shared
// memory bytes, and the D pass's and the conversion's registers.
extern "C" int rt_flash_attention_bwd_config(int device, int hd, int* out) {
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (hd == 64) return describe<64>(out);
  if (hd == 128) return describe<128>(out);
  return static_cast<int>(cudaErrorInvalidValue);
}
