// Flash-attention forward for Hopper (sm_90a), bf16 in and out, f32
// softmax and accumulation.
//
// Replaces the Pallas TPU kernel ``_attn_kernel`` / ``flash_attention_bhsd``
// (src/repro/kernels/flash_attention/kernel.py).  Same function: an online
// softmax over K tiles in order with f32 m / l / acc, scores (q.k) * scale
// with an optional tanh softcap, masks kp < kv_len, causal kp <= qp and
// window kp > qp - window, whole K tiles skipped by the same three block
// predicates, GQA head h -> h * Hkv / H, output width Dv = v's head dim, and
// the lane fault applied to acc / max(l, 1e-30) at finalize.  Masked scores
// take the reference's finite -1e30, so a row whose first admitted tile is
// fully masked is wiped by corr = exp(m_prev - m_new) = 0 as it is there.
//
// What bounds it on an H100: 2 * Sq * Skv * (D + Dv) * H operations
// (halved when causal) over a few MB, so the tensor cores in principle
// (21.5 GFLOP at qwen1.5-4b P = 2048: 0.022 ms at 989 TFLOP/s); in practice
// the K/V stream of each block (the ring's round trip) and, at the short
// prompts of serving, the fixed cost of a launch.  The design:
//
//   * Warp specialization.  An item is 64 * NWG query rows of one (b, h);
//     a block has NWG = 1 or 2 consumer warpgroups of 64 rows each, then
//     one producer warp whose elected thread issues TMA loads: each item's
//     Q tile into one of two buffers, then its K/V tiles into a ring of
//     ``stages`` stages of BK = 64 keys, with completion on ``mbarrier``s
//     (full: the bytes landed; empty: every consumer warp is done).  Every
//     tile is made of 64-column, 128B-swizzled boxes, so a row of 128 head
//     dims is two boxes.
//   * A persistent grid: one block per SM slot, dealt the items (heaviest
//     causal tiles first, every other round backwards), so that a block's
//     start-up is paid once and the next item's loads run under this one's
//     last products and its store.
//   * S = Q K^T with ``wgmma.mma_async`` m64n64k16, both operands from
//     shared memory and K-major (D contiguous): no transpose bit.  The first
//     k16 step has scale-d = 0 and the accumulator is held by register
//     fences; no wgmma sits under a branch that depends on the thread, so
//     ptxas serializes none of them (C7515, C7520).
//   * The softmax in registers.  Thread t of a warpgroup holds rows
//     lane / 4 and lane / 4 + 8 of its warp's 16; a row's max and partial sum
//     combine over the 4 lanes of a quad with two ``__shfl_xor_sync`` steps
//     (l stays a per-lane partial until finalize).  The scale * log2(e) is
//     folded into one FFMA in front of each ``ex2``.  Masks run only on the
//     tiles that need them: the causal diagonal, the kv_len edge and the
//     window edge; O is rescaled only where a row max moved.
//   * O += P V with the RS form of ``wgmma`` (A from registers): the f32 S
//     fragment's layout is the A fragment's, so P is packed to bf16 pairs in
//     place (P was rounded to bf16 before its product in PR 11's kernel
//     too).  V (keys, Dv) is row-major, so as B it is MN-major: the
//     transpose bit, 1024 bytes between 8-key groups and one box between
//     64-column blocks, so two boxes form one n128 operand at Dv = 128.  O
//     stays in f32 registers for the whole K loop and is rescaled there.
//     The P V product of tile j-1 runs on the tensor cores while the
//     softmax of tile j runs on the CUDA cores.
//   * Strided operands.  The tensor maps are 4-D, (D, S, H, B) with the
//     caller's element strides (d contiguous, the others multiples of 16
//     bytes), so the model's (B, S, H, D) tensors are read in place; TMA
//     zero-fills rows past S and columns past D.  The output is written
//     through its strides, straight into the model's (B, S, H, Dv).
//   * Determinism: no atomics, K tiles in order, one instruction sequence
//     for every call of a shape: the same inputs give the same bits, and a
//     strided view gives the bits of its contiguous copy.
//
// Head dims 129-256 (gemma2-2b's 256): KD = VB = 3 or 4 boxes, one
// consumer warpgroup a block (NWG = 1) and one block a SM.  A 64 x 256 f32
// O is 128 registers a consumer thread, and with S and P at BK = 64 (32 +
// 16) and the addresses the thread needs about 200: the launch bounds ask
// for one block a SM, so ptxas may give a thread up to 255 (5 warps a SM
// leave registers to spare, so the producer warp need not hand any over
// with ``setmaxnreg``).  P V is two m64n128k16 halves per 16 keys (at VB
// = 3 an m64n128k16 and an m64n64k16), each over its own 64-column boxes
// of the V stage.  Shared memory at KD = VB = 4: two 32 KB Q tiles and
// 64 KB a K/V stage, so two stages (197,696 B); at KD = VB = 3, three.
// Other pairs above 2 (D and Dv in different box counts) are not compiled.
//
// Requirements checked by the C entry: D, Dv <= 256, and (KD, VB) one of
// the compiled pairs, at NWG = 1 above 128; 16-byte aligned
// pointers; strides that TMA takes (the wrapper pads a row whose stride is
// not a multiple of 16 bytes).  Any Sq, Skv: ragged edges are zero-filled
// by TMA and masked on store.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "lane_fault.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int COLS = 64;         // head dims per box: 128 bytes, one swizzle row
constexpr int QROWS = 64;        // query rows per consumer warpgroup
constexpr int BK = 64;           // keys a K/V stage
constexpr int WG = 128;          // threads per warpgroup
constexpr int DMAX = 256;
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;  // a Hopper block's dynamic shared memory
constexpr int MAX_DEVICES = 64;  // devices with per-device setup remembered
constexpr float NEG_INF = -1e30f;   // finite, as in the reference kernel
constexpr float LOG2E = 1.4426950408889634f;
constexpr int ERR_ARGS = -1;
constexpr int ERR_ENCODE = -2;

// Dynamic shared memory of a block: two Q tiles (NWG * KD boxes of 64 rows
// each: the next item's loads while this one's run), ``stages`` K/V stages
// (KD + VB boxes of BK rows), two mbarriers a Q tile and two a stage, 1024
// bytes to align the swizzled boxes.  Mirrored by ``ring_bytes`` in
// kernels/flash_attention/kernel.py.
__host__ __device__ constexpr int smem_bytes(int nwg, int kd, int vb,
                                             int stages) {
  return 2 * nwg * kd * QROWS * 128 + stages * (kd + vb) * BK * 128 +
         8 * (4 + 2 * stages) + 1024;
}

struct AttnArgs {
  bf16* o;                  // (B, Sq, H, dvo)
  long long osb, osh, oss;  // its element strides of b, h, s
  int H, Hkv, Sq, Skv, kv_len;
  int dvo;                  // output columns stored (v's width, even)
  int lanes;                // real output width: the lane fault's columns
  float qk_scale;           // scale * log2(e) (no softcap)
  float cap_in, cap_out;    // softcap: tanh(s * cap_in) * cap_out
  int softcap, causal, window, stages, B;
  // which of (s, h, b) is dimension 1, 2, 3 of each tensor map
  unsigned char selq[3], selk[3], selv[3];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Spins until the barrier's phase of parity ``parity`` completes.  A phase
// that never completes is a bug: trap (a launch failure) rather than hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t n = 0;; ++n) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (n == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ int pick(unsigned char sel, int s, int h, int b) {
  return sel == 0 ? s : (sel == 1 ? h : b);
}

// One box (64 columns from ``col``, rows from ``s``, one h, one b) of a 4-D
// bf16 tensor map into shared memory, completing ``bar``'s transaction count.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         const unsigned char* sel, int col,
                                         int s, int h, int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(col),
         "r"(pick(sel[0], s, h, b)), "r"(pick(sel[1], s, h, b)),
         "r"(pick(sel[2], s, h, b)), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor, 128B swizzle: start address, leading and
// stride byte offsets, each in 16-byte units.  K-major (Q, K): rows of 128
// bytes, 8-row atoms 1024 apart (SBO); the leading offset is unused.
// MN-major (V): 64 columns of N per 128-byte row, one row per key; 8-row
// atoms 1024 apart (SBO), 64-column blocks ``lbo`` apart.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lbo >> 4) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keeps the compiler from touching registers a wgmma reads or writes
// across the fence / wait that bounds it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

#define ACC8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// S(64 x 64, f32) = Q(64 x 16, K-major) K^T(16 x 64, K-major) + (scale_d ?
// S : 0), both from shared memory (imm-trans-b = 0).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

#define ACC8O(i)                                                         \
  "+f"(d[OFF + i]), "+f"(d[OFF + i + 1]), "+f"(d[OFF + i + 2]),          \
      "+f"(d[OFF + i + 3]), "+f"(d[OFF + i + 4]), "+f"(d[OFF + i + 5]),  \
      "+f"(d[OFF + i + 6]), "+f"(d[OFF + i + 7])

// O[OFF, OFF + 32) (64 x 64, f32) = P(64 x 16, bf16 pairs in registers)
// V(16 x 64, MN-major) + (scale_d ? O : 0): the RS form (imm-trans-b = 1).
template <int OFF, int N>
__device__ __forceinline__ void wgmma_rs64(float (&d)[N], const uint32_t* a,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC8O(0), ACC8O(8), ACC8O(16), ACC8O(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// O[OFF, OFF + 64) (64 x 128) as above: two 64-column boxes of V, LBO apart.
template <int OFF, int N>
__device__ __forceinline__ void wgmma_rs128(float (&d)[N], const uint32_t* a,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : ACC8O(0), ACC8O(8), ACC8O(16), ACC8O(24), ACC8O(32), ACC8O(40),
        ACC8O(48), ACC8O(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#undef ACC8O

// O (64 x 64 VB, f32) += P V over VB 64-column boxes of V, 128 columns a
// product and a last m64n64 for an odd box: register i of O is column
// 8 (i / 4) + 2 t + i % 2 throughout, as one m64n(64 VB) product lays it
// out.  ``db`` addresses box 0; box c starts c boxes of BK rows later.
template <int NO>
__device__ __forceinline__ void wgmma_pv(float (&d)[NO], const uint32_t* a,
                                         uint64_t db, int scale_d) {
  constexpr uint64_t BOX16 = (BK * 128) >> 4;  // one box, 16-byte units
  static_assert(NO % 32 == 0 && NO <= 128, "1 to 4 boxes of V");
  if constexpr (NO >= 64) wgmma_rs128<0>(d, a, db, scale_d);
  if constexpr (NO >= 128) wgmma_rs128<64>(d, a, db + 2 * BOX16, scale_d);
  if constexpr (NO % 64) wgmma_rs64<NO - 32>(d, a, db + (NO / 32 - 1) * BOX16,
                                             scale_d);
}

#undef ACC8

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The reference kernel's block predicate for ``rows`` query rows from q0 and
// the BK keys from k0.
__device__ __forceinline__ bool tile_runs(const AttnArgs& a, int k0, int q0,
                                          int rows) {
  bool run = k0 < a.kv_len;
  if (a.causal) run = run && k0 <= q0 + rows - 1;
  if (a.window > 0) run = run && k0 + BK - 1 > q0 - a.window;
  return run;
}

// 2^x on the SFU (ex2.approx, subnormal results flushed to 0).
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One tile of the online softmax on a thread's fragment: register i of S is
// row row0 + 8 * ((i / 2) % 2), key k0 + 8 * (i / 4) + 2 * t + i % 2 (t =
// lane % 4).  Masked scores become NEG_INF (only when MASK); m is kept in
// the log2 domain, scores are scaled into it by the FFMA in front of each
// exp2 (under a softcap they are capped and scaled first).  Then S holds
// p = exp2(s * c - m_new); m, the per-lane partial l and corr =
// exp2(m_prev - m_new) are per row.  Returns whether any row of the warp
// has a new max (else corr is 1 and O needs no rescale).
template <bool MASK, int NS>
__device__ __forceinline__ bool softmax_tile(float (&S)[NS], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             const AttnArgs& a, int row0,
                                             int k0, int t) {
  float c = a.qk_scale;
  if (a.softcap) {
#pragma unroll
    for (int i = 0; i < NS; ++i) S[i] = tanhf(S[i] * a.cap_in) * a.cap_out;
    c = 1.0f;
  }
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    if (MASK) {
      const int qp = row0 + 8 * ((i / 2) % 2);
      const int kp = k0 + 8 * (i / 4) + 2 * t + (i % 2);
      bool ok = kp < a.kv_len;
      if (a.causal) ok = ok && kp <= qp;
      if (a.window > 0) ok = ok && kp > qp - a.window;
      S[i] = ok ? S[i] : NEG_INF;
    }
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], S[i]);
  }
  bool moved = false;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * c);
    corr[r] = exp2_sfu(m[r] - m_new);
    moved = moved || m_new != m[r];
    m[r] = m_new;
  }
  // The exponent is clamped at 0: where a row is fully masked so far, m
  // is NEG_INF * c rounded, and the FFMA's exact residual could be a huge
  // positive number (p = inf); clamped, p <= 1 and corr = 0 wipes it.
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const float p = exp2_sfu(fminf(fmaf(S[i], c, -m[(i / 2) % 2]), 0.0f));
    S[i] = p;
    sum[(i / 2) % 2] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
  return __any_sync(0xffffffffu, moved);
}

// A work item is (h, query tile, b): 64 * NWG query rows of one head.
// Items are numbered h fastest, then the query tiles last to first (under
// a causal mask the tiles with the most K tiles come first), then b.
struct Item {
  int h, q0, b;
};

__device__ __forceinline__ Item item_of(int w, int qtiles, int bq, int H) {
  const int r = w / H;
  return {w % H, (qtiles - 1 - r % qtiles) * bq, r / qtiles};
}

// The block's n-th item: the grid is persistent (one block per SM slot),
// and deals the items in rows of gridDim.x, every other row backwards, so
// that each block gets a heavy item with a light one.  -1: none left.
__device__ __forceinline__ int nth_item(int n, int items) {
  const int w = n * gridDim.x +
                ((n & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  return w < items ? w : -1;
}

// grid: persistent blocks; block NWG consumer warpgroups then one producer
// warp.  KD, VB: 64-column boxes of a Q / K row and of a V row (1 or 2,
// or KD = VB = 3 or 4 at NWG = 1: one block a SM, so up to 255 registers
// a thread).
//
// The producer loads each item's Q tile into one of two buffers (as soon as
// the consumers have released it) and its K/V tiles into the ring, which
// runs on from item to item.  A consumer warpgroup pipelines its tiles as
// FlashAttention-3 does: for tile j it issues S_j = Q K_j^T, then O +=
// P_{j-1} V_{j-1}, waits for S_j only, and runs the softmax of tile j on
// the CUDA cores while the tensor cores run the P V product; then it waits
// for that product, releases tile j-1's stage, rescales O and packs P_j.
// The last tile's P V follows the loop; the store of an item's output runs
// while the next item's loads are in flight.
template <int NWG, int KD, int VB, bool FAULT>
__global__ void __launch_bounds__(NWG * WG + 32,
                                  NWG == 1 && KD <= 2 ? 2 : 1)
flash_attn_fwd(const __grid_constant__ CUtensorMap tmQ,
               const __grid_constant__ CUtensorMap tmK,
               const __grid_constant__ CUtensorMap tmV, const AttnArgs a,
               const LaneFaultArgs f) {
  constexpr int BQ = QROWS * NWG;        // query rows an item
  constexpr int QBOX = QROWS * 128;      // 64 rows x 64 bf16
  constexpr int KVBOX = BK * 128;        // BK rows x 64 bf16
  constexpr int Q_BYTES = NWG * KD * QBOX;
  constexpr int STAGE_BYTES = (KD + VB) * KVBOX;
  constexpr int NS = BK / 2;             // S registers a thread
  constexpr int NO = VB * 32;            // O registers a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int stages = a.stages;
  unsigned char* ring_p = smem + 2 * Q_BYTES;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(ring_p + stages * STAGE_BYTES);
  uint64_t* qempty = qfull + 2;
  uint64_t* full = qempty + 2;
  uint64_t* empty = full + stages;

  const int qtiles = (a.Sq + BQ - 1) / BQ;
  const int items = a.H * qtiles * a.B;
  const int nk = (a.Skv + BK - 1) / BK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&qfull[i], 1);
      mbar_init(&qempty[i], NWG * 4);  // one arrival per consumer warp
    }
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NWG * 4) {  // producer: one thread keeps the ring full
    if (lane == 0) {
      int st = 0;
      uint32_t ph = 0;
      for (int n = 0, w; (w = nth_item(n, items)) >= 0; ++n) {
        const Item it = item_of(w, qtiles, BQ, a.H);
        const int kvh = it.h * a.Hkv / a.H;
        const int qb = n & 1;
        mbar_wait(&qempty[qb], ((n >> 1) & 1) ^ 1);
        mbar_expect_tx(&qfull[qb], Q_BYTES);
        for (int w2 = 0; w2 < NWG; ++w2)
          for (int c = 0; c < KD; ++c)
            tma_load(smem + qb * Q_BYTES + (w2 * KD + c) * QBOX, &tmQ,
                     a.selq, c * COLS, it.q0 + w2 * QROWS, it.h, it.b,
                     &qfull[qb]);
        for (int kt = 0; kt < nk; ++kt) {
          if (!tile_runs(a, kt * BK, it.q0, BQ)) continue;
          mbar_wait(&empty[st], ph ^ 1);
          unsigned char* sk = ring_p + st * STAGE_BYTES;
          mbar_expect_tx(&full[st], STAGE_BYTES);
          for (int c = 0; c < KD; ++c)
            tma_load(sk + c * KVBOX, &tmK, a.selk, c * COLS, kt * BK, kvh,
                     it.b, &full[st]);
          for (int c = 0; c < VB; ++c)
            tma_load(sk + (KD + c) * KVBOX, &tmV, a.selv, c * COLS, kt * BK,
                     kvh, it.b, &full[st]);
          if (++st == stages) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows [q0 + 64 wg, q0 + 64 wg + 64)
  // of each item.  No wgmma sits under a branch that depends on the thread
  // (ptxas would serialize every product, C7520): a warpgroup also runs the
  // item's tiles that are fully masked for its own rows, which changes no
  // bit (such a tile adds p = 0 once a row has a real score, and the sums
  // it adds before one are wiped by corr = 0), and the first P V product
  // runs on P = 0.
  const int wg = warp / 4;
  const int t = lane % 4;
  const uint32_t ring = smem_u32(ring_p);
  int st = 0;
  uint32_t ph = 0;
  for (int n = 0, w; (w = nth_item(n, items)) >= 0; ++n) {
    const Item it = item_of(w, qtiles, BQ, a.H);
    const int qb = n & 1;
    const int qw0 = it.q0 + wg * QROWS;
    const int row0 = qw0 + (warp % 4) * 16 + lane / 4;  // and row0 + 8
    const uint32_t qaddr = smem_u32(smem + qb * Q_BYTES + wg * KD * QBOX);
    float O[NO];
    uint32_t P[NS / 2];  // the last tile's P, its P V product not issued yet
#pragma unroll
    for (int j = 0; j < NS / 2; ++j) P[j] = 0u;
    float m[2] = {NEG_INF, NEG_INF};
    float l[2] = {0.0f, 0.0f};
    int done = 0;        // tiles run
    int pst = 0;         // the stage that holds the last tile's V
    mbar_wait(&qfull[qb], (n >> 1) & 1);
    for (int kt = 0; kt < nk; ++kt) {
      const int k0 = kt * BK;
      if (!tile_runs(a, k0, it.q0, BQ)) continue;
      mbar_wait(&full[st], ph);
      const uint32_t kaddr = ring + st * STAGE_BYTES;
      // the first P V product reads this tile's V (P = 0, so O = 0)
      const uint32_t vaddr =
          ring + (done > 0 ? pst : st) * STAGE_BYTES + KD * KVBOX;
      float S[NS];
      fence_regs(S);
      fence_regs(O);
      fence_regs(P);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KD * 4; ++kk) {
        // +32 bytes along the swizzled row; a second box past 64 columns
        const uint64_t da =
            make_desc(qaddr + (kk / 4) * QBOX, 16, 1024) + 2 * (kk % 4);
        const uint64_t db =
            make_desc(kaddr + (kk / 4) * KVBOX, 16, 1024) + 2 * (kk % 4);
        wgmma_ss(S, da, db, kk > 0 ? 1 : 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        // +16 keys: 16 rows of 128 bytes; the first product overwrites O
        wgmma_pv(O, P + 4 * kk, make_desc(vaddr, KVBOX, 1024) + 128 * kk,
                 (done > 0 || kk > 0) ? 1 : 0);
      wgmma_commit();
      wgmma_wait<1>();  // S only: the P V product runs on
      fence_regs(S);

      float corr[2];
      const bool edge =
          k0 + BK > a.kv_len || (a.causal && k0 + BK - 1 > qw0) ||
          (a.window > 0 && k0 <= qw0 + QROWS - 1 - a.window);
      const bool moved =
          edge ? softmax_tile<true>(S, m, l, corr, a, row0, k0, t)
               : softmax_tile<false>(S, m, l, corr, a, row0, k0, t);
      wgmma_wait<0>();
      fence_regs(O);
      fence_regs(P);
      if (done > 0 && lane == 0) mbar_arrive(&empty[pst]);
      if (moved) {  // whole warps: corr is 1 where no row max moved
#pragma unroll
        for (int i = 0; i < NO; ++i) O[i] *= corr[(i / 2) % 2];
      }
      // the S fragment is P's A fragment: 16 keys are registers 8kk..8kk+7
#pragma unroll
      for (int j = 0; j < NS / 2; ++j)
        P[j] = pack_bf16(S[2 * j], S[2 * j + 1]);
      pst = st;
      ++done;
      if (++st == stages) {
        st = 0;
        ph ^= 1;
      }
    }
    if (lane == 0) mbar_arrive(&qempty[qb]);  // every Q K^T is done
    {  // the last tile's P V product, then its stage goes back
      const uint32_t vaddr = ring + pst * STAGE_BYTES + KD * KVBOX;
      fence_regs(O);
      fence_regs(P);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_pv(O, P + 4 * kk, make_desc(vaddr, KVBOX, 1024) + 128 * kk,
                 (done > 0 || kk > 0) ? 1 : 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(O);
      fence_regs(P);
    }
    if (done > 0 && lane == 0) mbar_arrive(&empty[pst]);
    if (done == 0) {  // no admitted tile: acc = 0, as the reference's
#pragma unroll
      for (int i = 0; i < NO; ++i) O[i] = 0.0f;
    }

    // finalize: acc / max(l, 1e-30), lane fault in f32, bf16 pairs
    float lt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lt[r] = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
      lt[r] = lt[r] + __shfl_xor_sync(0xffffffffu, lt[r], 2);
      lt[r] = fmaxf(lt[r], 1e-30f);
    }
    bf16* og = a.o + it.b * a.osb + it.h * a.osh;
#pragma unroll
    for (int i = 0; i < NO; i += 2) {
      const int row = row0 + 8 * ((i / 2) % 2);
      const int col = 8 * (i / 4) + 2 * t;
      if (row >= a.Sq || col >= a.dvo) continue;
      float v0 = O[i] / lt[(i / 2) % 2];
      float v1 = O[i + 1] / lt[(i / 2) % 2];
      if (FAULT) {
        if (col < a.lanes) v0 = apply_lane_fault<FAULT>(v0, col, f);
        if (col + 1 < a.lanes) v1 = apply_lane_fault<FAULT>(v1, col + 1, f);
      }
      *reinterpret_cast<__nv_bfloat162*>(og + row * a.oss + col) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver entry point: reached through the
// runtime, so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, H, S, cols) bf16 view with element strides sb, sh, ss (d
// contiguous) as a 4-D tensor map of 64-column boxes of ``rows`` rows,
// 128B-swizzled; reads past the edges are zeros.  The three outer
// dimensions go in order of stride (a dimension of extent 1 last, its
// stride past every other's span): the box is one deep in h and b, so the
// order does not change its layout in shared memory.  ``sel`` records which
// of (s, h, b) each map dimension is.
bool make_map(CUtensorMap* map, unsigned char* sel, const void* ptr,
              int cols, int S, int H, int B, long long ss, long long sh,
              long long sb, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  struct Dim {
    long long stride;
    long long n;
    unsigned box;
    unsigned char id;
  } d[3] = {{ss, S, static_cast<unsigned>(rows), 0}, {sh, H, 1u, 1},
            {sb, B, 1u, 2}};
  long long span = cols;
  for (const Dim& x : d)
    if (x.n > 1 && x.stride * x.n > span) span = x.stride * x.n;
  span = (span + 7) / 8 * 8;
  for (Dim& x : d)
    if (x.n == 1) x.stride = span;
  for (int i = 1; i < 3; ++i)  // insertion sort by stride, stable
    for (int j = i; j > 0 && d[j].stride < d[j - 1].stride; --j) {
      const Dim tmp = d[j];
      d[j] = d[j - 1];
      d[j - 1] = tmp;
    }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols), 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {COLS, 0, 0, 0};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    if (d[i].stride <= 0 || d[i].stride % 8) return false;
    dims[i + 1] = static_cast<cuuint64_t>(d[i].n);
    strides[i] = static_cast<cuuint64_t>(d[i].stride) * 2;
    box[i + 1] = d[i].box;
    sel[i] = d[i].id;
  }
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NWG, int KD, int VB, bool FAULT>
int launch(const CUtensorMap& q, const CUtensorMap& k, const CUtensorMap& v,
           const AttnArgs& a, const LaneFaultArgs& f, int grid,
           cudaStream_t s) {
  auto* kernel = flash_attn_fwd<NWG, KD, VB, FAULT>;
  // the shared-memory cap, once per kernel and device (an attribute of
  // the function in each device's context)
  static bool ready[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES || !ready[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < MAX_DEVICES) ready[dev] = true;
  }
  kernel<<<grid, NWG * WG + 32, smem_bytes(NWG, KD, VB, a.stages), s>>>(
      q, k, v, a, f);
  return static_cast<int>(cudaGetLastError());
}

template <int NWG, bool FAULT>
int dispatch(int kd, int vb, const CUtensorMap& q, const CUtensorMap& k,
             const CUtensorMap& v, const AttnArgs& a, const LaneFaultArgs& f,
             int grid, cudaStream_t s) {
  switch (kd * 4 + vb) {
    case 5: return launch<NWG, 1, 1, FAULT>(q, k, v, a, f, grid, s);
    case 6: return launch<NWG, 1, 2, FAULT>(q, k, v, a, f, grid, s);
    case 9: return launch<NWG, 2, 1, FAULT>(q, k, v, a, f, grid, s);
    case 10: return launch<NWG, 2, 2, FAULT>(q, k, v, a, f, grid, s);
  }
  if constexpr (NWG == 1) {  // head dims 129-256: one warpgroup a block
    switch (kd * 4 + vb) {
      case 15: return launch<1, 3, 3, FAULT>(q, k, v, a, f, grid, s);
      case 20: return launch<1, 4, 4, FAULT>(q, k, v, a, f, grid, s);
    }
  }
  return ERR_ARGS;
}

}  // namespace

// One call's arguments, packed field for field by ``_HEAD`` and ``_TAIL``
// in kernels/flash_attention/kernel.py (one ctypes argument costs a
// fraction of forty).  q (B, H, Sq, D), k (B, Hkv, Skv, D), v (B, Hkv, Skv,
// Dv), all bf16, as element strides of (b, h, s) with d contiguous; o a
// contiguous (B, Sq, H, dvo) bf16 tensor, dvo = Dv rounded up to even;
// ``nwg`` consumer warpgroups a block, ``stages`` K/V stages and ``grid``
// persistent blocks (the Python plan's); ``lanes`` the real output width
// for the lane fault; ``size`` is sizeof(Params), to catch a layout
// mismatch.
struct Params {
  unsigned long long q, k, v, o, fault_mask, stream;
  long long qs[3], ks[3], vs[3];
  int B, H, Hkv, Sq, Skv, D, Dv, lanes, kv_len;
  int causal, window, nwg, stages, grid, fault_kind, size;
  float scale, softcap, fault_value, fault_gain;
};
static_assert(sizeof(Params) == 200, "Params must match kernel.py's _PARAMS");

extern "C" int flash_attention_fwd(const Params* p) {
  const int kd = (p->D + COLS - 1) / COLS;
  const int vb = (p->Dv + COLS - 1) / COLS;
  if (p->size != static_cast<int>(sizeof(Params)) || p->grid < 1 ||
      (p->nwg != 1 && p->nwg != 2) ||
      p->B < 1 || p->H < 1 ||
      p->Hkv < 1 || p->H % p->Hkv || p->Sq < 1 || p->Skv < 1 || p->D < 1 ||
      p->D > DMAX || p->Dv < 1 || p->Dv > DMAX || p->kv_len < 1 ||
      p->kv_len > p->Skv || p->stages < 2 || p->stages > MAX_STAGES ||
      smem_bytes(p->nwg, kd, vb, p->stages) > SMEM_LIMIT ||
      ((kd > 2 || vb > 2) && (p->nwg != 1 || kd != vb)) || (p->o & 3))
    return ERR_ARGS;
  AttnArgs a;
  CUtensorMap mq, mk, mv;
  const void* q = reinterpret_cast<const void*>(p->q);
  const void* k = reinterpret_cast<const void*>(p->k);
  const void* v = reinterpret_cast<const void*>(p->v);
  if (!make_map(&mq, a.selq, q, p->D, p->Sq, p->H, p->B, p->qs[2], p->qs[1],
                p->qs[0], QROWS) ||
      !make_map(&mk, a.selk, k, p->D, p->Skv, p->Hkv, p->B, p->ks[2],
                p->ks[1], p->ks[0], BK) ||
      !make_map(&mv, a.selv, v, p->Dv, p->Skv, p->Hkv, p->B, p->vs[2],
                p->vs[1], p->vs[0], BK))
    return ERR_ENCODE;
  a.o = reinterpret_cast<bf16*>(p->o);
  const int dvo = p->Dv + p->Dv % 2;  // output rows of whole bf16 pairs
  a.oss = static_cast<long long>(p->H) * dvo;
  a.osh = dvo;
  a.osb = a.oss * p->Sq;
  a.H = p->H;
  a.Hkv = p->Hkv;
  a.Sq = p->Sq;
  a.Skv = p->Skv;
  a.kv_len = p->kv_len;
  a.dvo = dvo;
  a.lanes = p->lanes;
  a.qk_scale = p->scale * LOG2E;
  a.softcap = p->softcap > 0.0f;
  a.cap_in = p->softcap > 0.0f ? p->scale / p->softcap : 0.0f;
  a.cap_out = p->softcap * LOG2E;
  a.causal = p->causal;
  a.window = p->window;
  a.stages = p->stages;
  a.B = p->B;
  LaneFaultArgs f;
  f.kind = p->fault_kind;
  f.mask = reinterpret_cast<const uint32_t*>(p->fault_mask);
  f.value = p->fault_value;
  f.gain = p->fault_gain;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(p->stream);
  const bool fault = p->fault_kind >= 0;
  if (p->nwg == 1)
    return fault ? dispatch<1, true>(kd, vb, mq, mk, mv, a, f, p->grid, s)
                 : dispatch<1, false>(kd, vb, mq, mk, mv, a, f, p->grid, s);
  return fault ? dispatch<2, true>(kd, vb, mq, mk, mv, a, f, p->grid, s)
               : dispatch<2, false>(kd, vb, mq, mk, mv, a, f, p->grid, s);
}

// Dynamic shared memory of a block, so the Python plan can be held against
// the compiled layout.
extern "C" int flash_attention_smem_bytes(int nwg, int kd, int vb,
                                          int stages) {
  return smem_bytes(nwg, kd, vb, stages);
}

extern "C" const char* flash_attention_error_string(int e) {
  if (e == ERR_ARGS) return "flash_attention: arguments the kernel does not take";
  if (e == ERR_ENCODE)
    return "flash_attention: cuTensorMapEncodeTiled failed (strides?)";
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
