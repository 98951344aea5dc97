// Chunked RWKV-6 WKV forward for Hopper (sm_90a): three chunk-parallel
// phases in place of one block per (b, h) that walks every chunk.
//
// Replaces the Pallas TPU kernel ``_wkv_kernel`` / ``wkv6_chunked_pallas``
// (src/repro/kernels/rwkv6_scan/kernel.py).  The TPU kernel walks the chunk
// axis as the minor grid dimension and carries the (K, V) state in VMEM
// between grid steps.  Per chunk of L <= 16 tokens it uses the factorization
//
//   la = cumsum(lw),  qexp = r * exp(la - lw),  kexp = k * exp(-la)
//   scores[i, j] = qexp_i . kexp_j  for i > j (selected), else 0
//   bonus_i      = sum_k r_ik u_k k_ik
//   o      = scores v + qexp state + bonus * v     lane fault on V, bf16
//   state' = exp(la_L) * state + (k * exp(la_L - la))^T v
//
// which is kept here as it is.  Only the state recurrence is sequential,
// and it is linear: state' = d * state + U with d = exp(la_L) (a K-vector)
// and U = (k * exp(la_L - la))^T v, both functions of the chunk alone.  So
// the call runs in three phases, each on a grid that fills the card:
//
//   1. chunk state  (rwkv6_wkv_chunk_state, one block per (b, h, group of
//      G chunks)): U and d of the group, walking its G chunks with the
//      state in registers (d multiplies, U adds), from a zero start, in
//      f32 FMA;
//   2. state pass   (rwkv6_wkv_state_pass, 8 blocks per (b, h), one state
//      entry quad a thread): S_in[g] = d[g-1] * S_in[g-1] + U[g-1] over
//      the groups (state_pass.cuh), in place over U; the final state when
//      it is asked for;
//   3. chunk scan   (rwkv6_wkv_chunk_scan, one block per (b, h, group)):
//      from S_in[g], each chunk's o as above, walking the group's chunks
//      with the state in shared memory.  The scores are f32 FMA, one
//      (i, j) a thread, computed for i > j only; o = [scores | qexp]
//      [v ; S] (depth 16 + 64) and, between the chunks of a group, the
//      state update run on the tensor cores (mma.sync m16n8k8, f32
//      accumulators).  Each f32 operand is split into two tf32 parts
//      (hi + lo, to 2^-22; v is bf16, exact in tf32), so a product is two
//      or three mma and keeps f32's accuracy: one tf32 rounding would cost
//      about 5e-4 relative, which random-init models amplify layer by
//      layer.  TF32 keeps f32's 8-bit exponent, so the e^64 factors of
//      qexp and kexp survive where bf16 operands would not.
//
// G is the plan's (``kernel.plan`` mirrors ``make_plan``): 1 while the
// (b, h, chunk) items number under 1024, else the largest power of two that
// keeps 512 or more groups.  512 chunk-scan blocks (51 KB of shared memory
// each) are about one wave at four blocks per SM, and the scratch (one f32
// (K, V) state and one K-vector per group, 16.6 KB) stays under 17 MB,
// inside the 50 MB L2: 8.5 MB at rwkv6-1.6b's prefill (B = 1, S = 512,
// H = 32: G = 2, 512 groups) and at S = 4096 (G = 16).
//
// Range: lw lies in [-4, -1e-4] (the model clamps it), so |la| <= 64 at
// L = 16 and exp(-la) <= e^64, inside f32 (the wrapper refuses L > 16), as
// in the blocked form.  Every factor that crosses a chunk boundary (d, the
// group decays, exp(la_L - la)) is a decay <= 1, so the phases add no range
// limit.  The scores' upper triangle is selected, never computed.
//
// What bounds it on an H100: at rwkv6-1.6b's prefill the call must move
// ~10.5 MB (r, k, v, lw and o in bf16, the f32 state out): 3.1 us at
// 3.35 TB/s, against 0.34 GFLOP of products (0.34 us at the bf16 tensor
// rate).  The scratch adds 4 x 8.5 MB of L2 traffic (phase 1 writes U,
// phase 2 reads it and writes S_in, phase 3 reads S_in).  Each block runs
// G chunks in a handful of barriers, so no block is a long latency chain;
// what is left is the per-chunk work on the CUDA cores (the cumsum, the
// exponents, the scores, phase 1's products) and three launches.
//
// Determinism: no atomics; every sum runs in a fixed order, so two calls
// give the same bits.  Nothing here allocates: the wrapper hands in o, the
// state and the scratch (``torch.empty``).
//
// Requirements checked by the wrapper: K = V = 64 (the wrapper zero-pads
// narrower operands: zero r/k channels with lw = 0 and u = 0, and zero v
// lanes, add nothing and are sliced away), S a multiple of L (the op
// zero-pads, which leaves the real tokens' o and the final state exact),
// contiguous tensors, 16-byte aligned rows.  Chunks shorter than 16 run as
// 16 slots whose tail is zero.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "lane_fault.cuh"
#include "state_pass.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int LMAX = 16;       // longest chunk; every chunk runs 16 slots
constexpr int MAX_DEVICES = 64;  // devices with per-device setup remembered
constexpr int K = 64;          // key channels (padded by the wrapper)
constexpr int V = 64;          // value lanes (padded by the wrapper)
constexpr int NT = 256;        // threads of the chunk phases
constexpr int PASS_NT = 128;   // threads of the state pass, a float4 each
constexpr int PASS_BLOCKS = K * V / 4 / PASS_NT;   // per (b, h): 8
constexpr long long MIN_GROUPS = 512;
static_assert(NT == K * 4 && LMAX == 16, "prologue: 4 slots a thread");
static_assert(NT == 2 * LMAX * (K / 8), "stage: a 16-byte load a thread");
static_assert(NT == 16 * LMAX, "scores: one (i, j) a thread");
static_assert(NT == (K / 4) * (V / 4), "U: a 4x4 quad a thread");
static_assert(NT / 32 * 8 == V && LMAX == 16, "o: 16 rows x 8 lanes a warp");
static_assert(NT / 32 == (K / 16) * (V / 32), "S: 16 rows x 32 lanes a warp");

struct Plan {
  int nc;       // chunks of L tokens
  int group;    // chunks a work item walks (G)
  int ng;       // groups per (b, h)
};

Plan make_plan(int Bt, int S, int H, int L) {
  Plan p;
  p.nc = S / L;
  p.group = 1;
  const long long bh = (long long)Bt * H;
  while (2 * p.group <= p.nc &&
         bh * ((p.nc + 2 * p.group - 1) / (2 * p.group)) >= MIN_GROUPS)
    p.group *= 2;
  p.ng = (p.nc + p.group - 1) / p.group;
  return p;
}

// Phase 1's shared memory: one chunk's operands in f32, rows [L, 16)
// zero.
struct Chunk {
  float k[LMAX][K];
  float w[LMAX][K];    // lw
  float v[LMAX][V];
  float ks[LMAX][K];   // kscale = k * exp(la_L - la)
  float dec[K];        // exp(la_L)
};

// Phase 3's operands, f32 (split into tf32 parts as fragments are
// loaded): o = [scores | qexp] [v ; S], one product of depth 16 + 64 on
// the tensor cores.  Row strides are 4 or 8 mod 32 so that a fragment's
// loads hit 32 banks.
constexpr int LDQ = LMAX + K + 20;   // 100
constexpr int LDVS = V + 8;          // 72
constexpr int LDKE = K + 4;          // 68
constexpr int LDKS = K + 8;          // 72

struct ScanSmem {
  float aq[LMAX][LDQ];       // scores (columns 0-15), qexp (16-79)
  float vs[LMAX + K][LDVS];  // v (rows 0-15), the state (rows 16-79)
  float ke[LMAX][LDKE];      // kexp
  float ks[LMAX][LDKS];      // kscale
  float r[LMAX][K];
  float k[LMAX][K];
  float w[LMAX][K];          // lw
  float dec[K];              // exp(la_L)
  float bonus[LMAX];
  float u[K];
};

__device__ __forceinline__ void load8_bf16(const bf16* src, float* dst) {
  const uint4 q = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
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

// x = hi + lo, both tf32, to about 2^-22 of x: the split of the 3xTF32
// products, which keep f32's accuracy on the tensor cores
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// Rows [0, L) of NTENS (B, S, H, 64) bf16 tensors at token s0 into f32
// tiles of 16 rows (row strides ``ld``), rows [L, 16) zero: one 16-byte
// load (8 values) a thread and pair of tensors, threads 0-127 the first of
// each pair.
template <int NTENS>
__device__ __forceinline__ void stage(const bf16* const (&src)[NTENS],
                                      float* const (&dst)[NTENS],
                                      const int (&ld)[NTENS], size_t row0,
                                      size_t tok_stride, int L) {
  const int second = threadIdx.x >> 7;
  const int l = (threadIdx.x & 127) >> 3, c0 = (threadIdx.x & 7) * 8;
#pragma unroll
  for (int t = 0; t < NTENS; t += 2) {
    if (t + second >= NTENS) break;
    const int u = t + 1 < NTENS ? t + 1 : t;
    const bf16* s = second ? src[u] : src[t];
    float* d = (second ? dst[u] : dst[t]) + l * (second ? ld[u] : ld[t]) +
               c0;
    float vals[8];
    if (l < L) {
      load8_bf16(s + row0 + l * tok_stride + c0, vals);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) vals[i] = 0.0f;
    }
    float4* q = reinterpret_cast<float4*>(d);
    q[0] = make_float4(vals[0], vals[1], vals[2], vals[3]);
    q[1] = make_float4(vals[4], vals[5], vals[6], vals[7]);
  }
}

// The per-(slot, channel) prologue: thread (c = tid / 4, seg = tid % 4)
// owns channel c at slots 4 seg .. 4 seg + 3.  la = cumsum(lw) as a scan:
// each thread sums its four slots, the four threads of a channel (adjacent
// lanes) scan their totals with shuffles.  Writes kscale and exp(la_L);
// returns la (inclusive) in ``la`` and la_L.
__device__ __forceinline__ float prologue(Chunk& ch, float la[4]) {
  const int c = threadIdx.x >> 2, seg = threadIdx.x & 3;
  float run = 0.0f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    run += ch.w[4 * seg + q][c];
    la[q] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, off, 4);
    if (seg >= off) incl += y;
  }
  const float before = incl - run;
  const float laL = __shfl_sync(0xffffffffu, incl, 3, 4);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    la[q] += before;
    const int l = 4 * seg + q;
    ch.ks[l][c] = ch.k[l][c] * __expf(laL - la[q]);
  }
  if (seg == 0) ch.dec[c] = __expf(laL);
  return laL;
}

// The thread's 4x4 quad of kscale^T v: state rows k0..k0+3, lanes
// v0..v0+3, with k0 = (tid / 16) * 4 and v0 = (tid % 16) * 4.
__device__ __forceinline__ void chunk_update(const Chunk& ch,
                                             float acc[4][4]) {
  const int k0 = (threadIdx.x >> 4) * 4, v0 = (threadIdx.x & 15) * 4;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
#pragma unroll
  for (int l = 0; l < LMAX; ++l) {
    const float4 ks = *reinterpret_cast<const float4*>(&ch.ks[l][k0]);
    const float4 vv = *reinterpret_cast<const float4*>(&ch.v[l][v0]);
    const float kq[4] = {ks.x, ks.y, ks.z, ks.w};
    const float vq[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(kq[a], vq[b], acc[a][b]);
  }
}

// ---- phase 1: U and d of each group of G chunks, from a zero state
__global__ void __launch_bounds__(NT)
rwkv6_wkv_chunk_state(const bf16* __restrict__ k, const bf16* __restrict__ v,
                      const bf16* __restrict__ lw, float* __restrict__ U,
                      float* __restrict__ D, int S, int H, int L, int nc,
                      int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Chunk& ch = *reinterpret_cast<Chunk*>(smem_raw);
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int ng = gridDim.x;
  const int k0 = (threadIdx.x >> 4) * 4, v0 = (threadIdx.x & 15) * 4;
  const int c_end = min(nc, (g + 1) * G);
  const bf16* src[3] = {k, lw, v};
  float* dst[3] = {&ch.k[0][0], &ch.w[0][0], &ch.v[0][0]};
  const int ld[3] = {K, K, V};
  float st[4][4];
  float laG = 0.0f;   // sum of the chunks' la_L: the group's log decay
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int j = 0; j < 4; ++j) st[a][j] = 0.0f;

  for (int c = g * G; c < c_end; ++c) {
    const size_t row0 = (((size_t)b * S + (size_t)c * L) * H + h) * K;
    __syncthreads();   // the previous chunk's readers are done
    stage<3>(src, dst, ld, row0, (size_t)H * K, L);
    __syncthreads();
    float la[4];
    laG += prologue(ch, la);
    __syncthreads();
    float acc[4][4];
    chunk_update(ch, acc);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float d = ch.dec[k0 + a];
#pragma unroll
      for (int j = 0; j < 4; ++j) st[a][j] = fmaf(d, st[a][j], acc[a][j]);
    }
  }

  const size_t item = ((size_t)b * H + h) * ng + g;
  float* u = U + item * K * V;
#pragma unroll
  for (int a = 0; a < 4; ++a)
    *reinterpret_cast<float4*>(u + (k0 + a) * V + v0) =
        make_float4(st[a][0], st[a][1], st[a][2], st[a][3]);
  if ((threadIdx.x & 3) == 0) D[item * K + (threadIdx.x >> 2)] = __expf(laG);
}

// ---- phase 2: S_in of every group, in place over U; the final state
__global__ void __launch_bounds__(PASS_NT)
rwkv6_wkv_state_pass(float* __restrict__ U, const float* __restrict__ D,
                     float* __restrict__ state_out, int ng) {
  const size_t bh = blockIdx.y;
  const int q = blockIdx.x * PASS_NT + threadIdx.x;   // float4 of the state
  const int row = q * 4 / V;
  float4* u = reinterpret_cast<float4*>(U + bh * ng * K * V) + q;
  const float4 s = pass_states(u, K * V / 4, D + bh * ng * K + row, K, ng);
  if (state_out != nullptr)
    reinterpret_cast<float4*>(state_out + bh * K * V)[q] = s;
}

// ---- phase 3: o of each chunk of a group, from the group's S_in
template <bool FAULT>
__global__ void __launch_bounds__(NT)
rwkv6_wkv_chunk_scan(const bf16* __restrict__ r, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ lw,
                     const float* __restrict__ u,
                     const float* __restrict__ Sin, bf16* __restrict__ o,
                     int S, int H, int L, int nc, int G, LaneFaultArgs f) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ScanSmem& sm = *reinterpret_cast<ScanSmem*>(smem_raw);
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int ng = gridDim.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tg = lane & 3;   // mma fragment coordinates
  const int c_end = min(nc, (g + 1) * G);
  const bf16* src[4] = {r, k, lw, v};
  float* dst[4] = {&sm.r[0][0], &sm.k[0][0], &sm.w[0][0], &sm.vs[0][0]};
  const int ld[4] = {K, K, K, LDVS};

  {
    const float4* s_in = reinterpret_cast<const float4*>(
        Sin + (((size_t)b * H + h) * ng + g) * K * V);
#pragma unroll
    for (int it = 0; it < K * V / 4 / NT; ++it) {
      const int q = tid + it * NT, row = q / (V / 4), c4 = (q % (V / 4)) * 4;
      *reinterpret_cast<float4*>(&sm.vs[LMAX + row][c4]) = s_in[q];
    }
    if (tid < K) sm.u[tid] = u[(size_t)h * K + tid];
  }

  for (int c = g * G; c < c_end; ++c) {
    const size_t row0 = (((size_t)b * S + (size_t)c * L) * H + h) * K;
    __syncthreads();   // the state is in; the previous chunk's readers done
    stage<4>(src, dst, ld, row0, (size_t)H * K, L);
    __syncthreads();

    // ---- per (slot, channel): la = cumsum(lw) (a scan over the four
    // threads of a channel), qexp, kexp, kscale, exp(la_L)
    {
      const int ch = tid >> 2, seg = tid & 3;
      float la[4], run = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        run += sm.w[4 * seg + q][ch];
        la[q] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, incl, off, 4);
        if (seg >= off) incl += y;
      }
      const float before = incl - run;
      const float laL = __shfl_sync(0xffffffffu, incl, 3, 4);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int l = 4 * seg + q;
        const float a = la[q] + before, kk = sm.k[l][ch];
        sm.aq[l][LMAX + ch] = sm.r[l][ch] * __expf(a - sm.w[l][ch]);
        sm.ke[l][ch] = kk * __expf(-a);
        sm.ks[l][ch] = kk * __expf(laL - a);
      }
      if (seg == 0) sm.dec[ch] = __expf(laL);
    }
    // ---- bonus_l = sum_k r u k: each warp two slots
#pragma unroll
    for (int q = 0; q < LMAX / 8; ++q) {
      const int l = warp * (LMAX / 8) + q;
      float p = sm.r[l][lane] * sm.u[lane] * sm.k[l][lane] +
                sm.r[l][lane + 32] * sm.u[lane + 32] * sm.k[l][lane + 32];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (lane == 0) sm.bonus[l] = p;
    }
    __syncthreads();

    // ---- scores: one (i, j) a thread, f32; only i > j is computed
    // (selected), the rest is zero
    {
      const int i = tid & 15, j = tid >> 4;
      float acc = 0.0f;
      if (j < i) {
#pragma unroll 16
        for (int c2 = 0; c2 < K; ++c2)
          acc = fmaf(sm.aq[i][LMAX + c2], sm.ke[j][c2], acc);
      }
      sm.aq[i][j] = acc;
    }
    __syncthreads();

    // ---- o = [scores | qexp] [v ; S] + bonus v: warp w owns lanes
    // 8w..8w+7 of V, all 16 rows
    {
      const int n0 = warp * 8;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int k0 = 0; k0 < LMAX + K; k0 += 8) {
        uint32_t ah[4], al[4], bh[2], bl[2];
        split_tf32(sm.aq[gq][k0 + tg], ah[0], al[0]);
        split_tf32(sm.aq[gq + 8][k0 + tg], ah[1], al[1]);
        split_tf32(sm.aq[gq][k0 + tg + 4], ah[2], al[2]);
        split_tf32(sm.aq[gq + 8][k0 + tg + 4], ah[3], al[3]);
        split_tf32(sm.vs[k0 + tg][n0 + gq], bh[0], bl[0]);
        split_tf32(sm.vs[k0 + tg + 4][n0 + gq], bh[1], bl[1]);
        if (k0 >= LMAX) mma_tf32(acc, ah, bl);   // v (k0 < 16) is exact
        mma_tf32(acc, al, bh);
        mma_tf32(acc, ah, bh);
      }
      const int lv = n0 + 2 * tg;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = gq + 8 * half;
        if (i < L) {
          const float bi = sm.bonus[i];
          const float v0 = acc[2 * half] + bi * sm.vs[i][lv];
          const float v1 = acc[2 * half + 1] + bi * sm.vs[i][lv + 1];
          *reinterpret_cast<__nv_bfloat162*>(
              o + (((size_t)b * S + (size_t)c * L + i) * H + h) * V + lv) =
              __floats2bfloat162_rn(apply_lane_fault<FAULT>(v0, lv, f),
                                    apply_lane_fault<FAULT>(v1, lv + 1, f));
        }
      }
    }

    // ---- the state the next chunk of the group enters with:
    // S = exp(la_L) S + kscale^T v; warp rows 16 (w % 4).., lanes
    // 32 (w / 4)..
    if (c + 1 < c_end) {
      __syncthreads();   // every reader of the old state is done
      const int m0 = (warp & 3) * 16, n0 = (warp >> 2) * 32;
      float acc[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int col = n0 + 8 * t + 2 * tg;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + gq + 8 * half;
          const float d = sm.dec[row];
          acc[t][2 * half] = d * sm.vs[LMAX + row][col];
          acc[t][2 * half + 1] = d * sm.vs[LMAX + row][col + 1];
        }
      }
#pragma unroll
      for (int k0 = 0; k0 < LMAX; k0 += 8) {
        uint32_t ah[4], al[4];
        split_tf32(sm.ks[k0 + tg][m0 + gq], ah[0], al[0]);
        split_tf32(sm.ks[k0 + tg][m0 + gq + 8], ah[1], al[1]);
        split_tf32(sm.ks[k0 + tg + 4][m0 + gq], ah[2], al[2]);
        split_tf32(sm.ks[k0 + tg + 4][m0 + gq + 8], ah[3], al[3]);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint32_t bf[2] = {
              __float_as_uint(sm.vs[k0 + tg][n0 + 8 * t + gq]),
              __float_as_uint(sm.vs[k0 + tg + 4][n0 + 8 * t + gq])};
          mma_tf32(acc[t], al, bf);   // v is exact: two products
          mma_tf32(acc[t], ah, bf);
        }
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int col = n0 + 8 * t + 2 * tg;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + gq + 8 * half;
          sm.vs[LMAX + row][col] = acc[t][2 * half];
          sm.vs[LMAX + row][col + 1] = acc[t][2 * half + 1];
        }
      }
    }
  }
}

int smem_state() { return (int)sizeof(Chunk); }
int smem_scan() { return (int)sizeof(ScanSmem); }

template <bool FAULT>
cudaError_t launch(const bf16* r, const bf16* k, const bf16* v,
                   const bf16* lw, const float* u, bf16* o, float* state_out,
                   float* scratch, int Bt, int S, int H, int L,
                   const Plan& p, LaneFaultArgs f, cudaStream_t s) {
  // once per instantiation and device (an attribute of the function in
  // each device's context)
  static bool opted_in[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES || !opted_in[dev]) {
    e = cudaFuncSetAttribute(
        rwkv6_wkv_chunk_scan<FAULT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_scan());
    if (e != cudaSuccess) return e;
    if (dev < MAX_DEVICES) opted_in[dev] = true;
  }
  float* U = scratch;
  float* D = scratch + (size_t)Bt * H * p.ng * K * V;
  const dim3 items(p.ng, H, Bt);
  rwkv6_wkv_chunk_state<<<items, NT, smem_state(), s>>>(k, v, lw, U, D, S, H,
                                                        L, p.nc, p.group);
  rwkv6_wkv_state_pass<<<dim3(PASS_BLOCKS, Bt * H), PASS_NT, 0, s>>>(
      U, D, state_out, p.ng);
  rwkv6_wkv_chunk_scan<FAULT><<<items, NT, smem_scan(), s>>>(
      r, k, v, lw, u, U, o, S, H, L, p.nc, p.group, f);
  return cudaGetLastError();
}

}  // namespace

// The launch plan (``kernel.plan`` computes the same in Python): chunks,
// group size G, groups per (b, h), the blocks of the three phases, the
// scratch bytes and the dynamic shared memory of phases 1 and 3.
extern "C" int rwkv6_wkv_plan(int Bt, int S, int H, int L, long long* out) {
  if (Bt < 1 || H < 1 || L < 1 || L > LMAX || S < L || S % L != 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(Bt, S, H, L);
  const long long items = (long long)Bt * H * p.ng;
  out[0] = p.nc;
  out[1] = p.group;
  out[2] = p.ng;
  out[3] = items;
  out[4] = (long long)PASS_BLOCKS * Bt * H;
  out[5] = items;
  out[6] = items * (K * V + K) * (long long)sizeof(float);
  out[7] = smem_state();
  out[8] = smem_scan();
  return 0;
}

extern "C" int rwkv6_wkv_fwd(const void* r, const void* k, const void* v,
                             const void* lw, const void* u, void* o,
                             void* state_out, void* scratch,
                             long long scratch_bytes, int Bt, int S, int H,
                             int L, int fault_kind, const void* fault_mask,
                             float fault_value, float fault_gain,
                             void* stream) {
  long long pl[9];
  const int rc = rwkv6_wkv_plan(Bt, S, H, L, pl);
  if (rc != 0) return rc;
  if (scratch_bytes < pl[6]) return (int)cudaErrorInvalidValue;
  const Plan p = make_plan(Bt, S, H, L);
  LaneFaultArgs f;
  f.kind = fault_kind;
  f.mask = static_cast<const uint32_t*>(fault_mask);
  f.value = fault_value;
  f.gain = fault_gain;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* rb = static_cast<const bf16*>(r);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* wb = static_cast<const bf16*>(lw);
  const float* uf = static_cast<const float*>(u);
  bf16* ob = static_cast<bf16*>(o);
  float* so = static_cast<float*>(state_out);
  float* sc = static_cast<float*>(scratch);
  const cudaError_t e =
      fault_kind < 0
          ? launch<false>(rb, kb, vb, wb, uf, ob, so, sc, Bt, S, H, L, p, f,
                          s)
          : launch<true>(rb, kb, vb, wb, uf, ob, so, sc, Bt, S, H, L, p, f,
                         s);
  return (int)e;
}

extern "C" const char* rwkv6_wkv_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
