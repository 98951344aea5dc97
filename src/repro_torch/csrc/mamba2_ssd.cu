// Chunked Mamba2 SSD forward for Hopper (sm_90a): three chunk-parallel
// phases in place of one block per (b, h) that walks every chunk.
//
// Replaces the Pallas TPU kernel ``_ssd_kernel`` / ``ssd_chunked_pallas``
// (src/repro/kernels/mamba2_scan/kernel.py).  The TPU kernel walks the chunk
// axis as the minor grid dimension and carries the (N, P) state in VMEM
// between grid steps.  Per chunk of L <= 128 tokens:
//
//   xdt = x * dt,  cum = cumsum(dt * A),  tot = cum[L-1]
//   W[i, j] = (C B^T)[i, j] * exp(cum_i - cum_j)   for i >= j, else 0
//   y       = W xdt + (C state) * exp(cum)          lane fault on P, bf16
//   state'  = exp(tot) * state + B^T (xdt * exp(tot - cum))
//
// Only the state recurrence is sequential, and it is linear: state' =
// d * state + U with the scalar d = exp(tot) and U = B^T (xdt exp(tot -
// cum)), both functions of the chunk alone.  B and C have no head axis
// (ngroups = 1), so C B^T is one L x L product per (b, chunk), shared by
// the H heads.  The call runs in three phases:
//
//   1. chunk state  (mamba2_ssd_chunk_state, one block per (b, h, chunk)):
//      U = B^T (xdt exp(tot - cum)) on the tensor cores, and d; and, spread
//      over the H blocks of a (b, chunk), the shared product: block h
//      computes the rows i = h, h + H, ... of CB = C B^T (j <= i only, f32
//      FMA) into scratch;
//   2. state pass   (mamba2_ssd_state_pass, 8 blocks per (b, h), one state
//      entry quad a thread): S_in[c] = d[c-1] S_in[c-1] + U[c-1] over the
//      chunks (state_pass.cuh), in place over U; the final state when it is
//      asked for;
//   3. chunk scan   (mamba2_ssd_chunk_scan, one block per (b, h, chunk,
//      64-row tile)): W from CB with the lower triangle selected BEFORE the
//      exponent, so every exponent is <= 0 in the scan's domain (dt > 0,
//      A < 0): no inf and no NaN however fast a chunk decays; then
//      y = (W dt) x + exp(cum) (C S_in) on the tensor cores, the lane
//      fault, bf16.
//
// The tensor-core products are mma.sync m16n8k8 with tf32 operands and f32
// accumulators, each warp 16 rows x 32 lanes.  x, B and C are bf16, so
// exact in tf32; the other operand of each product is split into two tf32
// parts (hi + lo, to 2^-22), so each product is two mma and keeps f32's
// accuracy.  One tf32 rounding would cost about 5e-4 relative a product,
// which zamba2-1.2b's 38 random-init layers amplify past the serving
// check's 5% bound on the logits.
//
// At zamba2-1.2b's prefill (B = 1, S = 384, H = 64, L = 128) phase 1 runs
// 192 blocks and phase 3 384, against 64 blocks (one per (b, h)) before.
// The scratch is one f32 (N, P) state a (b, h, chunk) (16 KB, as much as
// the chunk's x in bf16), CB (64 KB a (b, chunk)) and d: 3.3 MB there.
//
// What bounds it on an H100: the call must move ~7.5 MB (x and y in bf16,
// dt, B, C, the f32 state out): 2.2 us at 3.35 TB/s, against 0.8 GFLOP of
// products (0.8 us at the bf16 tensor rate).  C B^T is computed once per
// (b, chunk) instead of once per head.  Each block issues all of its global
// loads before it waits on any (dt first, for the cumsum; phase 3's with
// cp.async, straight to shared memory).  Phase 3 keeps its operands in
// 74,752 bytes (x and C in bf16, rows unpadded and XOR-swizzled), so three
// blocks share an SM and zamba2-1.2b's 384 run in one wave.
//
// Operands: x (B, S, H, P), B and C (B, S, N) are read through their
// strides (the last one 1), as the model passes views of one projection:
// the wrapper makes no copy when P = N = 64 and every row is 16-byte
// aligned.  dt (B, S, H) and A (H,) are contiguous f32; y is written
// contiguous (B, S, H, 64).
//
// Determinism: no atomics; every sum runs in a fixed order, so two calls
// give the same bits.  Nothing here allocates: the wrapper hands in y, the
// state and the scratch (``torch.empty``).
//
// Requirements checked by the wrapper: N = P = 64 (the wrapper zero-pads
// narrower operands: zero B/C columns and zero x lanes add nothing and are
// sliced away), S a multiple of L (the op zero-pads with dt = 0, which
// leaves the real tokens' y and the final state exact).  Chunks shorter
// than 128 run with a zero tail.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "lane_fault.cuh"
#include "state_pass.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int LMAX = 128;      // longest chunk
constexpr int MAX_DEVICES = 64;  // devices with per-device setup remembered
constexpr int N = 64;          // state width (padded by the wrapper)
constexpr int P = 64;          // head channels (padded by the wrapper)
constexpr int TILE = 64;       // rows of y a phase-3 block
constexpr int NT = 256;
constexpr int PASS_NT = 128;
constexpr int PASS_BLOCKS = N * P / 4 / PASS_NT;   // per (b, h): 8
constexpr int LDBT = LMAX + 4; // phase 1's row strides, 4 and 8 mod 32 so
constexpr int LDX = P + 8;     // that a fragment's loads hit 32 banks
constexpr int VEC = LMAX * 8 / NT;   // 16-byte loads a thread of a
                                     // (128, 64) bf16 tile: 4
static_assert(NT == 8 * 32 && TILE == 4 * 16 && N == 4 * 16 && P == 2 * 32,
              "U and y: 8 warps, each 16 rows x 32 lanes");
static_assert(LMAX == 32 * 4, "cumsum: one warp, four tokens a lane");

// Phase 1's operands: U = B^T xw on the tensor cores, with B^T kept
// transposed (B is bf16, so exact in tf32) and xw = xdt exp(tot - cum).
struct StateSmem {
  float bt[N][LDBT];     // B^T
  float xw[LMAX][LDX];
  float dt[LMAX];
  float cum[LMAX];
};

// Phase 3's operands for y = (W dt) x + exp(cum) (C S_in): the tile's rows
// of W dt, S_in, and x and C as they came (bf16, exact in tf32).  Rows
// are unpadded, 74,752 bytes in all, so three blocks share an SM; the
// columns are XOR-swizzled by row instead, so that a fragment's loads hit
// 32 banks (``wcol`` and friends below).
struct ScanSmem {
  float w[TILE][LMAX];     // C B^T, then W dt in place
  float s[N][P];
  uint16_t x[LMAX][P];
  uint16_t c[TILE][N];
  float dt[LMAX];
  float cum[LMAX];
};

__device__ __forceinline__ int wcol(int i, int j) { return j ^ ((i & 7) << 2); }
__device__ __forceinline__ int scol(int n, int p) { return p ^ ((n & 3) << 3); }
__device__ __forceinline__ int xcol(int l, int p) { return p ^ ((l & 3) << 3); }
__device__ __forceinline__ int ccol(int i, int n) { return n ^ ((i & 7) << 3); }

struct Strides {       // element strides of the strided operands
  long long xb, xs, xh, bb, bs, cb, cs;
};

__device__ __forceinline__ void unpack8(const uint4& v, float* dst) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    dst[2 * k] = f.x;
    dst[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// eight floats to 16-byte aligned shared memory, two 16-byte stores
__device__ __forceinline__ void store8(float* dst, const float* v) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// x = hi + lo, both tf32, to about 2^-22 of x: the split of the 3xTF32
// products, which keep f32's accuracy on the tensor cores
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// 16 bytes global -> shared without registers (cp.async), zero-filled when
// ``valid`` is false
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// a bf16 in shared memory as a tf32 operand (exact)
__device__ __forceinline__ uint32_t bf16_tf32(uint16_t h) {
  return static_cast<uint32_t>(h) << 16;
}

// d += a b on the tensor cores: m16n8k8, tf32 operands, f32 accumulators
__device__ __forceinline__ void mma_tf32(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// dt of warp 0's four slots of chunk c (zero past L): issued before the
// block's other loads, so that the cumsum waits on no second round trip.
__device__ __forceinline__ float4 load_dt(const float* __restrict__ dt,
                                          int b, int c, int S, int H, int h,
                                          int L) {
  float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (threadIdx.x < 32) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int l = threadIdx.x * 4 + k;
      if (l < L) v[k] = dt[((size_t)b * S + (size_t)c * L + l) * H + h];
    }
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

// dt and cum = cumsum(dt * A) of the chunk's 128 slots in shared memory,
// from warp 0's ``load_dt``: four slots a lane, a shuffle scan.  Ends with
// a barrier.
__device__ __forceinline__ void chunk_cumsum(float* sDt, float* sCum,
                                             float4 dtv, float a) {
  const int lane = threadIdx.x;
  if (lane < 32) {
    const float d[4] = {dtv.x, dtv.y, dtv.z, dtv.w};
    float v[4];
    float run = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sDt[lane * 4 + k] = d[k];
      v[k] = d[k] * a;
      run += v[k];
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    float acc = incl - run;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      acc += v[k];
      sCum[lane * 4 + k] = acc;
    }
  }
  __syncthreads();
}

// ---- phase 1: U and d of each chunk; the rows i = h, h + H, ... of C B^T
__global__ void __launch_bounds__(NT, 2)
mamba2_ssd_chunk_state(const bf16* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const bf16* __restrict__ Bm,
                       const bf16* __restrict__ Cm, float* __restrict__ U,
                       float* __restrict__ CB, float* __restrict__ D, int S,
                       int H, int L, Strides st) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StateSmem& sm = *reinterpret_cast<StateSmem*>(smem_raw);
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int tid = threadIdx.x;
  const size_t t0 = (size_t)c * L;

  const float4 dtv = load_dt(dt, b, c, S, H, h, L);
  const float a = A[h];
  // every global load first, then the cumsum.  B: thread (l = e % 128,
  // n0 = 8 (e / 128)), so that the transposed stores hit 32 banks; x:
  // thread (l = e / 8, p0 = 8 (e % 8)), coalesced
  uint4 rb[VEC], rx[VEC];
#pragma unroll
  for (int it = 0; it < VEC; ++it) {
    const int e = tid + it * NT;
    const int lb = e & (LMAX - 1), nb = (e >> 7) * 8;
    const int lx = e >> 3, px = (e & 7) * 8;
    rb[it] = rx[it] = make_uint4(0u, 0u, 0u, 0u);
    if (lb < L)
      rb[it] = *reinterpret_cast<const uint4*>(Bm + b * st.bb +
                                               (t0 + lb) * st.bs + nb);
    if (lx < L)
      rx[it] = *reinterpret_cast<const uint4*>(
          x + b * st.xb + (t0 + lx) * st.xs + h * st.xh + px);
  }
  chunk_cumsum(sm.dt, sm.cum, dtv, a);
  const float tot = sm.cum[LMAX - 1];   // the zero tail adds nothing
#pragma unroll
  for (int it = 0; it < VEC; ++it) {
    const int e = tid + it * NT;
    const int lb = e & (LMAX - 1), nb = (e >> 7) * 8;
    const int lx = e >> 3, px = (e & 7) * 8;
    float vb[8], vx[8];
    unpack8(rb[it], vb);
    unpack8(rx[it], vx);
    const float d = sm.dt[lx], e2 = __expf(tot - sm.cum[lx]);
#pragma unroll
    for (int k = 0; k < 8; ++k) sm.bt[nb + k][lb] = vb[k];
#pragma unroll
    for (int k = 0; k < 8; ++k) vx[k] = (vx[k] * d) * e2;
    store8(&sm.xw[lx][px], vx);
  }
  __syncthreads();

  // this thread's first row of C B^T: i = h + H (tid / 128), column
  // j = tid % 128 <= i; its C row loads while the U product runs
  const int j = tid & (LMAX - 1);
  int i = h + (tid >> 7) * H;
  uint4 crow[N / 8];
  auto load_crow = [&](int row) {
#pragma unroll
    for (int q = 0; q < N / 8; ++q)
      crow[q] = *reinterpret_cast<const uint4*>(Cm + b * st.cb +
                                                (t0 + row) * st.cs + 8 * q);
  };
  if (i < L && j <= i) load_crow(i);

  // U = B^T xw: warp rows (n) r0.., lanes (p) n0..; zero rows past L add
  // nothing
  {
    const int warp = tid >> 5, lane = tid & 31;
    const int r0 = (warp & 3) * 16, n0 = (warp >> 2) * 32;
    const int g = lane >> 2, tg = lane & 3;
    float acc[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[t][q] = 0.0f;
    const int kl = (L + 7) & ~7;
    for (int k0 = 0; k0 < kl; k0 += 8) {
      const uint32_t af[4] = {
          __float_as_uint(sm.bt[r0 + g][k0 + tg]),
          __float_as_uint(sm.bt[r0 + g + 8][k0 + tg]),
          __float_as_uint(sm.bt[r0 + g][k0 + tg + 4]),
          __float_as_uint(sm.bt[r0 + g + 8][k0 + tg + 4])};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        uint32_t bh[2], bl[2];
        split_tf32(sm.xw[k0 + tg][n0 + 8 * t + g], bh[0], bl[0]);
        split_tf32(sm.xw[k0 + tg + 4][n0 + 8 * t + g], bh[1], bl[1]);
        mma_tf32(acc[t], af, bl);   // B^T is exact: two products
        mma_tf32(acc[t], af, bh);
      }
    }
    const size_t item = ((size_t)b * H + h) * nc + c;
    float* u = U + item * N * P;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int p = n0 + 8 * t + 2 * tg;
      *reinterpret_cast<float2*>(u + (r0 + g) * P + p) =
          make_float2(acc[t][0], acc[t][1]);
      *reinterpret_cast<float2*>(u + (r0 + g + 8) * P + p) =
          make_float2(acc[t][2], acc[t][3]);
    }
    if (tid == 0) D[item] = expf(tot);
  }

  // CB rows i = h + 2kH (threads 0-127) and h + (2k+1)H (128-255); C's
  // row is the same for a warp (a broadcast load), the next one loads
  // while this one is summed
  float* cb = CB + ((size_t)b * nc + c) * LMAX * LMAX;
  for (; i < L; i += 2 * H) {
    if (j <= i) {
      float acc = 0.0f;
#pragma unroll
      for (int q = 0; q < N / 8; ++q) {
        float cv[8];
        unpack8(crow[q], cv);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          acc = fmaf(cv[k], sm.bt[8 * q + k][j], acc);
      }
      cb[i * LMAX + j] = acc;
    }
    if (i + 2 * H < L && j <= i + 2 * H) load_crow(i + 2 * H);
  }
}

// ---- phase 2: S_in of every chunk, in place over U; the final state
__global__ void __launch_bounds__(PASS_NT)
mamba2_ssd_state_pass(float* __restrict__ U, const float* __restrict__ D,
                      float* __restrict__ state_out, int nc) {
  const size_t bh = blockIdx.y;
  const int q = blockIdx.x * PASS_NT + threadIdx.x;   // float4 of the state
  float4* u = reinterpret_cast<float4*>(U + bh * nc * N * P) + q;
  const float4 s = pass_states(u, N * P / 4, D + bh * nc, 1, nc);
  if (state_out != nullptr)
    reinterpret_cast<float4*>(state_out + bh * N * P)[q] = s;
}

// ---- phase 3: y of one 64-row tile of a chunk, from the chunk's S_in:
// y = (W dt) x + exp(cum) (C S_in) on the tensor cores (x and C are bf16,
// exact in tf32; W dt and S_in are split in two); each warp 16 rows x 32
// lanes, four m16n8k8 n-tiles a step.
template <bool FAULT>
__global__ void __launch_bounds__(NT, 3)
mamba2_ssd_chunk_scan(const bf16* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const bf16* __restrict__ Cm,
                      const float* __restrict__ Sin,
                      const float* __restrict__ CB, bf16* __restrict__ y,
                      int S, int H, int L, int nc, Strides st,
                      LaneFaultArgs f) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ScanSmem& sm = *reinterpret_cast<ScanSmem*>(smem_raw);
  const int ntiles = (L + TILE - 1) / TILE;
  const int c = blockIdx.x / ntiles, tile = blockIdx.x % ntiles;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t t0 = (size_t)c * L;
  const int i_lo = tile * TILE;
  const int jend = min(L, i_lo + TILE);   // columns of W, rows of x
  const int jend8 = (jend + 7) & ~7;       // the product's depth over them

  // ---- every global load at once, straight to shared memory: S_in, the
  // tile's C rows, x's rows, the tile's rows of C B^T up to its diagonal
  const float4 dtv = load_dt(dt, b, c, S, H, h, L);
  const float a = A[h];
  {
    const float* s_in = Sin + (((size_t)b * H + h) * nc + c) * N * P;
#pragma unroll
    for (int it = 0; it < N * P / 4 / NT; ++it) {
      const int e = tid + it * NT, n = e >> 4, p0 = (e & 15) * 4;
      cp_async16(&sm.s[n][scol(n, p0)], s_in + n * P + p0, true);
    }
#pragma unroll
    for (int it = 0; it < TILE * 8 / NT; ++it) {
      const int e = tid + it * NT, il = e >> 3, n0 = (e & 7) * 8;
      const int i = i_lo + il;
      cp_async16(&sm.c[il][ccol(il, n0)],
                 i < L ? Cm + b * st.cb + (t0 + i) * st.cs + n0 : Cm, i < L);
    }
#pragma unroll
    for (int it = 0; it < VEC; ++it) {
      const int e = tid + it * NT, l = e >> 3, p0 = (e & 7) * 8;
      if (l < jend8)
        cp_async16(&sm.x[l][xcol(l, p0)],
                   l < jend ? x + b * st.xb + (t0 + l) * st.xs + h * st.xh + p0
                            : x,
                   l < jend);
    }
    const float* cb = CB + ((size_t)b * nc + c) * LMAX * LMAX;
#pragma unroll
    for (int it = 0; it < TILE * LMAX / 4 / NT; ++it) {
      const int e = tid + it * NT, il = e >> 5, j0 = (e & 31) * 4;
      const int i = i_lo + il;
      if (j0 < jend8)
        cp_async16(&sm.w[il][wcol(il, j0)],
                   i < L && j0 <= i ? cb + i * LMAX + j0 : cb,
                   i < L && j0 <= i);
    }
  }
  cp_async_wait_all();
  chunk_cumsum(sm.dt, sm.cum, dtv, a);   // its barrier publishes the copies

  // ---- W dt in place, the lower triangle selected before the exponent
  // (every exponent <= 0); C B^T past the diagonal is never read
#pragma unroll
  for (int it = 0; it < TILE * LMAX / 4 / NT; ++it) {
    const int e = tid + it * NT, il = e >> 5, j0 = (e & 31) * 4;
    if (j0 >= jend8) continue;
    const int i = i_lo + il;
    float4* q = reinterpret_cast<float4*>(&sm.w[il][wcol(il, j0)]);
    const float4 cbv = *q;
    const float w[4] = {cbv.x, cbv.y, cbv.z, cbv.w};
    const float ci = sm.cum[i];
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = j0 + k;
      v[k] = j <= i && i < L ? (w[k] * __expf(ci - sm.cum[j])) * sm.dt[j]
                             : 0.0f;
    }
    *q = make_float4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();

  // ---- warp rows r0.., lanes n0..; W is zero past the diagonal, so the
  // W part stops at the warp's last row
  const int r0 = (warp & 3) * 16, n0 = (warp >> 2) * 32;
  const int g = lane >> 2, tg = lane & 3;
  const int ra = r0 + g, rb = r0 + g + 8;
  const int kw = min(jend8, i_lo + r0 + 16);
  float acc[4][4], ast[4][4];   // (W dt) x;  C S_in
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[t][q] = ast[t][q] = 0.0f;
  for (int k0 = 0; k0 < kw; k0 += 8) {
    uint32_t ah[4], al[4];
    split_tf32(sm.w[ra][wcol(ra, k0 + tg)], ah[0], al[0]);
    split_tf32(sm.w[rb][wcol(rb, k0 + tg)], ah[1], al[1]);
    split_tf32(sm.w[ra][wcol(ra, k0 + tg + 4)], ah[2], al[2]);
    split_tf32(sm.w[rb][wcol(rb, k0 + tg + 4)], ah[3], al[3]);
    const int xa = k0 + tg, xb = k0 + tg + 4;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int p = n0 + 8 * t + g;
      const uint32_t bf[2] = {bf16_tf32(sm.x[xa][xcol(xa, p)]),
                              bf16_tf32(sm.x[xb][xcol(xb, p)])};
      mma_tf32(acc[t], al, bf);   // x is exact: two products
      mma_tf32(acc[t], ah, bf);
    }
  }
#pragma unroll
  for (int k0 = 0; k0 < N; k0 += 8) {
    const uint32_t af[4] = {bf16_tf32(sm.c[ra][ccol(ra, k0 + tg)]),
                            bf16_tf32(sm.c[rb][ccol(rb, k0 + tg)]),
                            bf16_tf32(sm.c[ra][ccol(ra, k0 + tg + 4)]),
                            bf16_tf32(sm.c[rb][ccol(rb, k0 + tg + 4)])};
    const int sa = k0 + tg, sb = k0 + tg + 4;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int p = n0 + 8 * t + g;
      uint32_t bh[2], bl[2];
      split_tf32(sm.s[sa][scol(sa, p)], bh[0], bl[0]);
      split_tf32(sm.s[sb][scol(sb, p)], bh[1], bl[1]);
      mma_tf32(ast[t], af, bl);   // C is exact: two products
      mma_tf32(ast[t], af, bh);
    }
  }

  // ---- the lane fault on P, bf16 pairs
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i_lo + r0 + g + 8 * half;
    if (i >= L) continue;
    const float ec = expf(sm.cum[i]);
    __nv_bfloat162* yrow = reinterpret_cast<__nv_bfloat162*>(
        y + (((size_t)b * S + t0 + i) * H + h) * P);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int p = n0 + 8 * t + 2 * tg;
      yrow[p / 2] = __floats2bfloat162_rn(
          apply_lane_fault<FAULT>(acc[t][2 * half] + ast[t][2 * half] * ec,
                                  p, f),
          apply_lane_fault<FAULT>(
              acc[t][2 * half + 1] + ast[t][2 * half + 1] * ec, p + 1, f));
    }
  }
}

int smem_state() { return (int)sizeof(StateSmem); }
int smem_scan() { return (int)sizeof(ScanSmem); }

struct Plan {
  int nc, ntiles;
  long long scratch_floats[3];   // U, CB, d
};

Plan make_plan(int Bt, int S, int H, int L) {
  Plan p;
  p.nc = S / L;
  p.ntiles = (L + TILE - 1) / TILE;
  p.scratch_floats[0] = (long long)Bt * H * p.nc * N * P;
  p.scratch_floats[1] = (long long)Bt * p.nc * LMAX * LMAX;
  p.scratch_floats[2] = (long long)Bt * H * p.nc;
  return p;
}

template <bool FAULT>
cudaError_t launch(const bf16* x, const float* dt, const float* A,
                   const bf16* Bm, const bf16* Cm, bf16* y, float* state_out,
                   float* scratch, int Bt, int S, int H, int L,
                   const Strides& st, const Plan& p, LaneFaultArgs f,
                   cudaStream_t s) {
  // once per instantiation and device (an attribute of the function in
  // each device's context)
  static bool opted_in[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES || !opted_in[dev]) {
    e = cudaFuncSetAttribute(
        mamba2_ssd_chunk_state, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_state());
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(mamba2_ssd_chunk_scan<FAULT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_scan());
    if (e != cudaSuccess) return e;
    if (dev < MAX_DEVICES) opted_in[dev] = true;
  }
  float* U = scratch;
  float* CB = U + p.scratch_floats[0];
  float* D = CB + p.scratch_floats[1];
  mamba2_ssd_chunk_state<<<dim3(p.nc, H, Bt), NT, smem_state(), s>>>(
      x, dt, A, Bm, Cm, U, CB, D, S, H, L, st);
  mamba2_ssd_state_pass<<<dim3(PASS_BLOCKS, Bt * H), PASS_NT, 0, s>>>(
      U, D, state_out, p.nc);
  mamba2_ssd_chunk_scan<FAULT>
      <<<dim3(p.nc * p.ntiles, H, Bt), NT, smem_scan(), s>>>(
          x, dt, A, Cm, U, CB, y, S, H, L, p.nc, st, f);
  return cudaGetLastError();
}

}  // namespace

// The launch plan (``kernel.plan`` computes the same in Python): chunks,
// row tiles a chunk, the blocks of the three phases, the scratch bytes and
// the dynamic shared memory of phases 1 and 3.
extern "C" int mamba2_ssd_plan(int Bt, int S, int H, int L, long long* out) {
  if (Bt < 1 || H < 1 || L < 1 || L > LMAX || S < L || S % L != 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(Bt, S, H, L);
  out[0] = p.nc;
  out[1] = p.ntiles;
  out[2] = (long long)Bt * H * p.nc;
  out[3] = (long long)PASS_BLOCKS * Bt * H;
  out[4] = (long long)Bt * H * p.nc * p.ntiles;
  out[5] = (p.scratch_floats[0] + p.scratch_floats[1] + p.scratch_floats[2]) *
           (long long)sizeof(float);
  out[6] = smem_state();
  out[7] = smem_scan();
  return 0;
}

extern "C" int mamba2_ssd_fwd(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, void* y,
                              void* state_out, void* scratch,
                              long long scratch_bytes, int Bt, int S, int H,
                              int L, long long xb, long long xs, long long xh,
                              long long bb, long long bs, long long cb,
                              long long cs, int fault_kind,
                              const void* fault_mask, float fault_value,
                              float fault_gain, void* stream) {
  long long pl[8];
  const int rc = mamba2_ssd_plan(Bt, S, H, L, pl);
  if (rc != 0) return rc;
  if (scratch_bytes < pl[5]) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(Bt, S, H, L);
  const Strides st = {xb, xs, xh, bb, bs, cb, cs};
  LaneFaultArgs f;
  f.kind = fault_kind;
  f.mask = static_cast<const uint32_t*>(fault_mask);
  f.value = fault_value;
  f.gain = fault_gain;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb_ = static_cast<const bf16*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const bf16* Bb = static_cast<const bf16*>(Bm);
  const bf16* Cb = static_cast<const bf16*>(Cm);
  bf16* yb = static_cast<bf16*>(y);
  float* so = static_cast<float*>(state_out);
  float* sc = static_cast<float*>(scratch);
  const cudaError_t e =
      fault_kind < 0 ? launch<false>(xb_, dtf, Af, Bb, Cb, yb, so, sc, Bt, S,
                                     H, L, st, p, f, s)
                     : launch<true>(xb_, dtf, Af, Bb, Cb, yb, so, sc, Bt, S,
                                    H, L, st, p, f, s);
  return (int)e;
}

extern "C" const char* mamba2_ssd_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
