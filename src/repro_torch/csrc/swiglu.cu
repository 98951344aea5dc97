// Gated MLP for Hopper (sm_90a): y = (act(x@w1) * (x@w3)) @ w2, bf16 in and
// out, f32 accumulation, act = silu h*sigmoid(h) or tanh-gelu.
//
// Replaces the Pallas TPU kernel ``_swiglu_kernel`` / ``swiglu_pallas``
// (src/repro/kernels/swiglu/kernel.py).  The TPU kernel fuses both products
// so that the (M, F) hidden never leaves VMEM, which holds megabytes.  A
// Hopper block has 227 KB of shared memory, and fusing there costs more than
// it saves: the hidden, rounded to bf16 (as the fused kernel would round it
// before its second product), is 1.8 MB at qwen1.5-4b M=128 and 6.3 MB at
// zamba2-1.2b M=384, so it is written once and read once through the 50 MB
// L2.  Two GEMMs, one CUDA kernel template:
//
//   phase A (EPI_GATE):  G = act(x @ w1) * (x @ w3), bf16 (M, F) scratch.
//     One block owns a (64 * NWG) x 64 tile of G.  It walks D in 64-wide
//     K tiles; each stage holds one x tile and the matching 64 x 64 tiles
//     of w1 and w3 side by side, so one m64n128k16 wgmma per 16 of K
//     computes h1 and h3 together, and the gate runs on the accumulator
//     registers before the bf16 store.
//   phase B (EPI_PARTIAL / EPI_OUT):  y = G @ w2.  One block owns a
//     (64 * NWG) x (64 * NSUB) tile of y (one m64n64k16 wgmma per 64
//     columns) and a slice of F (``splits`` slices, fixed by D, F and Do,
//     never by M).  With one slice it applies the lane fault to the f32
//     sum and stores bf16; with more, each slice stores an f32 partial and
//     ``swiglu_split_sum`` adds them in slice order (no float atomics: the
//     same inputs give the same bits), then the fault, then bf16.
//
// Both phases: one producer warpgroup (one thread) fills a ring of stages
// in shared memory with TMA (``cp.async.bulk.tensor`` into 128B-swizzled
// 64 x 64 boxes, completion on ``mbarrier``s); NWG = 1, 2 or 3 consumer
// warpgroups each own 64 rows and issue ``wgmma.mma_async`` straight from
// the ring (x and G K-major, w1, w3 and w2 row-major, i.e. MN-major through
// the transpose bit), keeping one stage of MMAs in flight while the next
// stage's wait runs.  Rows past M are zero-filled by TMA and masked on
// store.  Every output row depends on its own input row only, and the
// instructions and the K order (16 at a time, in order within a slice)
// are the same at every M: NWG and NSUB change which rows and columns share
// a block, never a row's arithmetic, so its bits do not depend on how many
// rows share the call.

// What bounds it on an H100: at decode (M = 1-16) the weights, 3 * D * F
// bf16 (106 MB at qwen1.5-4b), must stream from HBM once; the tensor cores
// idle on a 64-row tile, so what matters is bytes in flight on every SM
// (phase A: F / 64 blocks of 8 stages; phase B: Do / 64 tiles times the
// slices, 12 stages).  At prefill (M in the hundreds) 6 M D F
// operations bound it (38.6 GFLOP at zamba2-1.2b M=384); blocks walk M
// fastest, so the row tiles of one weight column run together and share
// its tiles through L2, and the weights cross HBM about once.  There the
// L2-to-SM traffic per operation sets the pace, so prefill takes taller
// blocks (NWG = 2 or 3) and, in phase B, 128 columns a block (NSUB = 2).
//
// Requirements checked by the wrapper: D, F and Do multiples of 64 (the
// wrapper zero-pads), row-contiguous bf16 tensors, 16-byte aligned.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "lane_fault.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int BK = 64;        // K per stage: 128 bytes of bf16, one swizzle row
constexpr int BN = 64;        // output columns per block (of G, or of y)
constexpr int WG = 128;       // threads per warpgroup
constexpr int BOX = 64 * BK * 2;  // one 64 x 64 bf16 box: 8 KB
constexpr int ERR_ARGS = -1;
constexpr int ERR_ENCODE = -2;

enum { EPI_GATE = 0, EPI_PARTIAL = 1, EPI_OUT = 2 };

// Ring geometry.  A stage holds the A box (64 * NWG rows of x or G) and NB
// B boxes (w1 and w3 in phase A; NSUB 64-column boxes of w2 in phase B):
// as many stages as fit in 200 KB, at most 12.  One block a SM.
// Mirrored by ``ring_bytes`` in kernels/swiglu/kernel.py.
template <int NWG, int NB>
struct Ring {
  static constexpr int A_BYTES = NWG * BOX;
  static constexpr int STAGE_BYTES = A_BYTES + NB * BOX;
  static constexpr int FIT = 200 * 1024 / STAGE_BYTES;
  static constexpr int STAGES = FIT < 12 ? FIT : 12;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;
  static_assert(STAGES >= 2, "ring too shallow");
  static_assert(SMEM <= 232448, "ring exceeds a block's shared memory");
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

// One 64 x 64 box at (column c0, row c1) of a 2-D bf16 tensor map into
// shared memory, completing ``bar``'s transaction count.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor, 128B swizzle: start address, leading and
// stride byte offsets, each in 16-byte units.  K-major (x, G): rows of 128
// bytes, 8-row atoms 1024 apart (SBO); the leading offset is unused.
// MN-major (w1, w3, w2): 64 columns of N per 128-byte row, one row per K;
// 8-row atoms 1024 apart (SBO), 64-column blocks ``lbo`` apart.
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
// Keeps the compiler from reading an accumulator before the wait above.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D(64 x 64, f32) = A(64 x 16, K-major) * B(16 x 64, MN-major) + (scale_d ?
// D : 0), both from shared memory through 128B-swizzle descriptors
// (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D(64 x 128, f32) = A(64 x 16, K-major) * B(16 x 128, MN-major) + (scale_d
// ? D : 0), as above.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ float gate(float h, int act) {
  if (act == 0) return h * (1.0f / (1.0f + expf(-h)));  // silu: h * logistic(h)
  return 0.5f * h *
         (1.0f + tanhf(0.7978845608028654f * (h + 0.044715f * h * h * h)));
}

struct Epilogue {
  void* out;        // G or y (bf16), or the f32 partials (splits, M, ld)
  int M;            // real rows
  int ld;           // row stride of ``out`` in elements
  int nk;           // K tiles of 64 in all
  int k_per_split;  // K tiles per slice (phase B; nk in phase A)
  int act;          // 0 silu, 1 gelu
  int lanes;        // real output width: lanes past it are padding
  LaneFaultArgs f;
};

// Two columns of y, the lane fault on each, one bf16 pair store.
template <bool FAULT>
__device__ __forceinline__ void store_y(const Epilogue& e, size_t at, int col,
                                        float v0, float v1) {
  if (FAULT) {
    if (col < e.lanes) v0 = apply_lane_fault<FAULT>(v0, col, e.f);
    if (col + 1 < e.lanes) v1 = apply_lane_fault<FAULT>(v1, col + 1, e.f);
  }
  *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(e.out) + at) =
      __floats2bfloat162_rn(v0, v1);
}

// Visits the (row, column) pairs that thread t of a consumer warpgroup
// holds: register i of the fragment is row 16 * warp + lane / 4 +
// 8 * ((i / 2) % 2), column 8 * (i / 4) + 2 * (lane % 4) + i % 2 of the
// warpgroup's 64-row tile; f(sub-tile, register, row, column).
template <int NSUB, typename Fn>
__device__ __forceinline__ void for_fragment(int r0, int c0, Fn f) {
#pragma unroll
  for (int s = 0; s < NSUB; ++s)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f(s, 4 * j + 2 * h, r0 + 8 * h, c0 + s * BN + 8 * j);
}

// grid (row tiles, column tiles, slices); block (NWG + 1) warpgroups.
// Phase A: one n128 tile (w1 | w3) a block; phase B: NSUB n64 tiles.
template <int NWG, int EPI, int NSUB, bool FAULT>
__global__ void __launch_bounds__((NWG + 1) * WG, 1)
swiglu_gemm(const __grid_constant__ CUtensorMap tmA,
            const __grid_constant__ CUtensorMap tmB,
            const __grid_constant__ CUtensorMap tmB3, const Epilogue e) {
  constexpr bool GATE = EPI == EPI_GATE;
  static_assert(!GATE || NSUB == 1, "phase A has one n128 tile a block");
  using R = Ring<NWG, GATE ? 2 : NSUB>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + R::STAGES * R::STAGE_BYTES);
  uint64_t* empty = full + R::STAGES;

  const int m0 = blockIdx.x * 64 * NWG;
  const int n0 = blockIdx.y * BN * NSUB;
  const int kbeg = blockIdx.z * e.k_per_split;
  const int kend = min(e.nk, kbeg + e.k_per_split);
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer: one thread keeps the ring full
    if (threadIdx.x == 0) {
      for (int kt = kbeg, it = 0; kt < kend; ++kt, ++it) {
        const int st = it % R::STAGES;
        mbar_wait(&empty[st], ((it / R::STAGES) & 1) ^ 1);
        unsigned char* sa = smem + st * R::STAGE_BYTES;
        unsigned char* sb = sa + R::A_BYTES;
        mbar_expect_tx(&full[st], R::STAGE_BYTES);
        tma_load(sa, &tmA, kt * BK, m0, &full[st]);
        if constexpr (GATE) {
          tma_load(sb, &tmB, n0, kt * BK, &full[st]);
          tma_load(sb + BOX, &tmB3, n0, kt * BK, &full[st]);
        } else {
#pragma unroll
          for (int q = 0; q < NSUB; ++q)
            tma_load(sb + q * BOX, &tmB, n0 + q * BN, kt * BK, &full[st]);
        }
      }
    }
    return;
  }

  // consumers: warpgroup c owns rows [m0 + 64c, m0 + 64c + 64)
  const int c = wg - 1;
  const int t = threadIdx.x % WG;
  constexpr int NACC = GATE ? 64 : 32;
  float acc[NSUB][NACC];
  const uint32_t base = smem_u32(smem);
  int it = 0;
  for (int kt = kbeg; kt < kend; ++kt, ++it) {
    const int st = it % R::STAGES;
    mbar_wait(&full[st], (it / R::STAGES) & 1);
    const uint32_t sa = base + st * R::STAGE_BYTES + c * BOX;
    const uint32_t sb = base + st * R::STAGE_BYTES + R::A_BYTES;
    const uint64_t da = make_desc(sa, 16, 1024);
#pragma unroll
    for (int s = 0; s < NSUB; ++s) fence_acc(acc[s]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A: +32 bytes along its swizzled row; B: +16 rows of 128 bytes.
      // The slice's first product overwrites the accumulator.
      const int scale_d = (it > 0 || kk > 0) ? 1 : 0;
#pragma unroll
      for (int s = 0; s < NSUB; ++s) {
        const uint64_t db = make_desc(sb + s * BOX, BOX, 1024) + 128 * kk;
        if constexpr (GATE)
          wgmma_n128(acc[s], da + 2 * kk, db, scale_d);
        else
          wgmma_n64(acc[s], da + 2 * kk, db, scale_d);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's MMAs are done: release it
#pragma unroll
    for (int s = 0; s < NSUB; ++s) fence_acc(acc[s]);
    if (it > 0 && t % 32 == 0) mbar_arrive(&empty[(it - 1) % R::STAGES]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int s = 0; s < NSUB; ++s) fence_acc(acc[s]);

  const int lane = t % 32;
  const int r0 = m0 + c * 64 + (t / 32) * 16 + lane / 4;
  const int c0 = n0 + (lane % 4) * 2;
  if constexpr (EPI == EPI_GATE) {
    // columns 64.. of the n128 tile are h3 for the same F columns
    for_fragment<1>(r0, c0, [&](int, int i, int r, int col) {
      if (r >= e.M) return;
      *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(e.out) +
                                         static_cast<size_t>(r) * e.ld + col) =
          __floats2bfloat162_rn(gate(acc[0][i], e.act) * acc[0][32 + i],
                                gate(acc[0][i + 1], e.act) * acc[0][33 + i]);
    });
  } else if constexpr (EPI == EPI_OUT) {
    for_fragment<NSUB>(r0, c0, [&](int s, int i, int r, int col) {
      if (r < e.M)
        store_y<FAULT>(e, static_cast<size_t>(r) * e.ld + col, col,
                       acc[s][i], acc[s][i + 1]);
    });
  } else {
    float* ws = static_cast<float*>(e.out) +
                static_cast<size_t>(blockIdx.z) * e.M * e.ld;
    for_fragment<NSUB>(r0, c0, [&](int s, int i, int r, int col) {
      if (r < e.M)
        *reinterpret_cast<float2*>(ws + static_cast<size_t>(r) * e.ld + col) =
            make_float2(acc[s][i], acc[s][i + 1]);
    });
  }
}

// y = the sum of the slices' f32 partials in slice order, then the lane
// fault, then bf16; two columns a thread.
template <bool FAULT>
__global__ void swiglu_split_sum(const float* __restrict__ ws, Epilogue e,
                                 int splits) {
  const size_t total = static_cast<size_t>(e.M) * e.ld;
  const size_t i =
      (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 2;
  if (i >= total) return;
  float2 v = *reinterpret_cast<const float2*>(ws + i);
  for (int k = 1; k < splits; ++k) {
    const float2 p = *reinterpret_cast<const float2*>(ws + k * total + i);
    v.x += p.x;
    v.y += p.y;
  }
  store_y<FAULT>(e, i, static_cast<int>(i % e.ld), v.x, v.y);
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

// A row-major bf16 (rows, cols) tensor seen as 64-column boxes of
// ``box_rows`` rows, 128B-swizzled; reads past the edge are zeros.
bool make_map(CUtensorMap* map, const void* ptr, int rows, int cols,
              int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NWG, int EPI, int NSUB, bool FAULT>
int launch_gemm(dim3 grid, const CUtensorMap& a, const CUtensorMap& b,
                const CUtensorMap& b3, const Epilogue& e, cudaStream_t s) {
  constexpr int SMEM = Ring<NWG, EPI == EPI_GATE ? 2 : NSUB>::SMEM;
  auto* kernel = swiglu_gemm<NWG, EPI, NSUB, FAULT>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, (NWG + 1) * WG, SMEM, s>>>(a, b, b3, e);
  return static_cast<int>(cudaGetLastError());
}

template <int NWG, int NSUB>
int run_b(const CUtensorMap& mg, const CUtensorMap& m2, Epilogue e, void* ws,
          int splits, unsigned mt, cudaStream_t s) {
  const dim3 grid(mt, e.ld / (BN * NSUB), splits);
  const bool fault = e.f.kind >= 0;
  if (splits == 1)
    return fault
               ? launch_gemm<NWG, EPI_OUT, NSUB, true>(grid, mg, m2, m2, e, s)
               : launch_gemm<NWG, EPI_OUT, NSUB, false>(grid, mg, m2, m2, e, s);
  void* out = e.out;
  e.out = ws;
  const int rc =
      launch_gemm<NWG, EPI_PARTIAL, NSUB, false>(grid, mg, m2, m2, e, s);
  if (rc != 0) return rc;
  e.out = out;
  const size_t pairs = static_cast<size_t>(e.M) * e.ld / 2;
  const unsigned blocks = static_cast<unsigned>((pairs + 255) / 256);
  const float* partials = static_cast<const float*>(ws);
  if (fault)
    swiglu_split_sum<true><<<blocks, 256, 0, s>>>(partials, e, splits);
  else
    swiglu_split_sum<false><<<blocks, 256, 0, s>>>(partials, e, splits);
  return static_cast<int>(cudaGetLastError());
}

template <int NWG>
int run(const void* x, const void* w1, const void* w3, const void* w2,
        void* g, void* ws, void* out, int M, int D, int F, int Do, int nsub,
        int splits, int act, const LaneFaultArgs& f, int lanes,
        cudaStream_t s) {
  constexpr int BM = 64 * NWG;
  CUtensorMap mx, m1, m3, mg, m2;
  if (!make_map(&mx, x, M, D, BM) || !make_map(&m1, w1, D, F, BK) ||
      !make_map(&m3, w3, D, F, BK) || !make_map(&mg, g, M, F, BM) ||
      !make_map(&m2, w2, F, Do, BK))
    return ERR_ENCODE;
  const unsigned mt = (M + BM - 1) / BM;
  Epilogue e{g, M, F, D / BK, D / BK, act, lanes, f};
  const int rc = launch_gemm<NWG, EPI_GATE, 1, false>(dim3(mt, F / BN, 1), mx,
                                                      m1, m3, e, s);
  if (rc != 0) return rc;
  e.out = out;
  e.ld = Do;
  e.nk = F / BK;
  e.k_per_split = (e.nk + splits - 1) / splits;
  if (nsub == 1) return run_b<NWG, 1>(mg, m2, e, ws, splits, mt, s);
  if constexpr (NWG > 1) {
    if (nsub == 2) return run_b<NWG, 2>(mg, m2, e, ws, splits, mt, s);
  }
  return ERR_ARGS;
}

}  // namespace

// x (M, D), w1 / w3 (D, F), w2 (F, Do), all bf16, D, F and Do multiples of
// 64; g (M, F) bf16 scratch; ws (splits, M, Do) f32 scratch when
// splits > 1; out (M, Do) bf16.  ``nwg`` consumer warpgroups (64 rows
// each) a block, ``nsub`` 64-column tiles a phase-B block; ``lanes`` is the
// real output width for the lane fault.
extern "C" int swiglu_fwd(const void* x, const void* w1, const void* w3,
                          const void* w2, void* g, void* ws, void* out, int M,
                          int D, int F, int Do, int nwg,
                          int nsub, int splits, int act, int fault_kind,
                          const void* fault_mask, float fault_value,
                          float fault_gain, int lanes, void* stream) {
  const int nkf = F / BK;
  if (M < 1 || D < BK || F < BK || nsub < 1 || Do < BN * nsub || D % BK ||
      F % BK || Do % (BN * nsub) || splits < 1 || splits > nkf ||
      (splits - 1) * ((nkf + splits - 1) / splits) >= nkf ||
      (splits > 1 && ws == nullptr))
    return ERR_ARGS;
  LaneFaultArgs f;
  f.kind = fault_kind;
  f.mask = static_cast<const uint32_t*>(fault_mask);
  f.value = fault_value;
  f.gain = fault_gain;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nwg) {
    case 1:
      return run<1>(x, w1, w3, w2, g, ws, out, M, D, F, Do, nsub, splits,
                    act, f, lanes, s);
    case 2:
      return run<2>(x, w1, w3, w2, g, ws, out, M, D, F, Do, nsub, splits,
                    act, f, lanes, s);
    case 3:
      return run<3>(x, w1, w3, w2, g, ws, out, M, D, F, Do, nsub, splits,
                    act, f, lanes, s);
  }
  return ERR_ARGS;
}

// Dynamic shared memory of a block with ``nwg`` consumer warpgroups: phase
// A (``nsub`` 0) or phase B with ``nsub`` w2 tiles, so the Python plan can
// be held against the compiled ring.
extern "C" int swiglu_smem_bytes(int nwg, int nsub) {
  switch (nwg * 4 + nsub) {
    case 4: return Ring<1, 2>::SMEM;
    case 5: return Ring<1, 1>::SMEM;
    case 8: return Ring<2, 2>::SMEM;
    case 9: return Ring<2, 1>::SMEM;
    case 10: return Ring<2, 2>::SMEM;
    case 12: return Ring<3, 2>::SMEM;
    case 13: return Ring<3, 1>::SMEM;
    case 14: return Ring<3, 2>::SMEM;
  }
  return ERR_ARGS;
}

extern "C" const char* swiglu_error_string(int e) {
  if (e == ERR_ARGS) return "swiglu: arguments the kernel does not take";
  if (e == ERR_ENCODE) return "swiglu: cuTensorMapEncodeTiled failed";
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
