// Chunked RWKV-6 WKV forward for Hopper (sm_90a): one (b, h) per block,
// chunks walked in order with the (K, V) f32 state in shared memory.
//
// Replaces the Pallas TPU kernel ``_wkv_kernel`` / ``wkv6_chunked_pallas``
// (src/repro/kernels/rwkv6_scan/kernel.py).  The TPU kernel walks the chunk
// axis as the minor grid dimension and carries the state in VMEM scratch
// between grid steps; blocks on the card run in no order, so here the chunk
// walk is a loop inside one block per (b, h).  Per chunk of L <= 16 tokens
// (the TPU kernel's factorization, kept as it is):
//
//   la = cumsum(lw),  qexp = r * exp(la - lw),  kexp = k * exp(-la)
//   scores[i, j] = qexp_i . kexp_j  for i > j (selected), else 0
//   bonus_i      = sum_k r_ik u_k k_ik
//   o      = scores v + qexp state + bonus * v     lane fault on V, bf16
//   state' = exp(la_L) * state + (k * exp(la_L - la))^T v
//
// Range: lw lies in [-4, -1e-4] (the model clamps it), so |la| <= 64 at
// L = 16 and exp(-la) <= e^64, inside f32 (the wrapper refuses L > 16).
// qexp, kexp, the scores and the state are f32; the upper triangle of the
// scores is never computed, so it cannot overflow.
//
// What bounds it on an H100: at the rwkv6-1.6b prefill (S = 512, H = 32,
// K = V = 64) the call moves ~10.5 MB (r, k, v, lw and o in bf16, the f32
// state out): 3.1 us at 3.35 TB/s, against 0.34 GFLOP of products (0.34 us
// at the bf16 tensor rate, 5 us at the 67 TFLOP/s f32 rate of the CUDA
// cores).  This first version does its products with f32 FMA on the CUDA
// cores from shared memory and runs only B * H blocks (32 of 132 SMs at
// B = 1), each walking S / L chunks in turn with five block barriers per
// chunk: it is bound by that sequential walk, not by memory.  No wgmma, TMA
// or pipelining yet.  Shared memory per block (static, under the 48 KB
// default): the state (K x V f32, 16 KB), the chunk's r, k, v, lw and the
// derived qexp, kexp, kscale (7 x L x (K+1) f32, rows padded against bank
// conflicts, 29 KB), the scores (L x (L+1) f32), bonus, exp(la_L) and u:
// 47,168 bytes.
//
// Requirements checked by the wrapper: K = V = 64 (the wrapper zero-pads
// narrower operands: zero r/k channels with lw = 0 and u = 0, and zero v
// lanes, add nothing and are sliced away), S a multiple of L (the op
// zero-pads, which leaves the real tokens' o and the final state exact),
// contiguous tensors, 16-byte aligned rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "lane_fault.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int LMAX = 16;       // longest chunk
constexpr int K = 64;          // key channels (padded by the wrapper)
constexpr int V = 64;          // value lanes (padded by the wrapper)
constexpr int NTHREADS = 256;
constexpr int LDK = K + 1;     // row stride of the (L, K) tiles
constexpr int LDV = V + 1;     // row stride of the v tile
constexpr int LDS = LMAX + 1;  // row stride of the scores
constexpr int OROWS = NTHREADS / V;   // o rows per pass (4)
constexpr int SROWS = K / OROWS;       // state rows a thread (16)
static_assert(NTHREADS % V == 0 && LMAX % OROWS == 0, "thread layout");
static_assert(SROWS * OROWS == K, "state layout");
static_assert(LMAX * LMAX <= NTHREADS, "one score a thread");

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

template <bool FAULT>
__global__ void __launch_bounds__(NTHREADS)
rwkv6_wkv_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ lw,
                 const float* __restrict__ u, bf16* __restrict__ o,
                 float* __restrict__ state_out, int S, int H, int L,
                 LaneFaultArgs f) {
  __shared__ float sS[K * V];          // the carried state
  __shared__ float sR[LMAX * LDK];     // r
  __shared__ float sK[LMAX * LDK];     // k
  __shared__ float sW[LMAX * LDK];     // lw, then la
  __shared__ float sV[LMAX * LDV];     // v
  __shared__ float sQ[LMAX * LDK];     // qexp = r * exp(la - lw)
  __shared__ float sKe[LMAX * LDK];    // kexp = k * exp(-la)
  __shared__ float sKs[LMAX * LDK];    // kscale = k * exp(la_L - la)
  __shared__ float sSc[LMAX * LDS];    // scores, strict lower triangle
  __shared__ float sBonus[LMAX];
  __shared__ float sDecay[K];          // exp(la_L)
  __shared__ float sU[K];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  for (int e = tid; e < K * V; e += NTHREADS) sS[e] = 0.0f;
  if (tid < K) sU[tid] = u[(size_t)h * K + tid];

  for (int s0 = 0; s0 < S; s0 += L) {
    // ---- load the chunk's rows (bf16 -> f32): 8 values a thread and tensor
    __syncthreads();   // the previous chunk's readers are done
    for (int e = tid; e < L * (K / 8); e += NTHREADS) {
      const int l = e / (K / 8);
      const int c0 = (e % (K / 8)) * 8;
      const size_t row = (((size_t)b * S + s0 + l) * H + h) * K + c0;
      float vr[8], vk[8], vw[8], vv[8];
      load8_bf16(r + row, vr);
      load8_bf16(k + row, vk);
      load8_bf16(lw + row, vw);
      load8_bf16(v + row, vv);   // V == K: the same row offsets
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sR[l * LDK + c0 + i] = vr[i];
        sK[l * LDK + c0 + i] = vk[i];
        sW[l * LDK + c0 + i] = vw[i];
        sV[l * LDV + c0 + i] = vv[i];
      }
    }
    __syncthreads();

    if (tid < K) {
      // ---- per channel: la = cumsum(lw), qexp, kexp; then kscale
      const int c = tid;
      float la = 0.0f;
      for (int l = 0; l < L; ++l) {
        const float w = sW[l * LDK + c];
        la += w;
        sQ[l * LDK + c] = sR[l * LDK + c] * expf(la - w);
        sKe[l * LDK + c] = sK[l * LDK + c] * expf(-la);
        sW[l * LDK + c] = la;
      }
      for (int l = 0; l < L; ++l)
        sKs[l * LDK + c] = sK[l * LDK + c] * expf(la - sW[l * LDK + c]);
      sDecay[c] = expf(la);
    } else if (warp >= 4) {
      // ---- bonus_l = sum_k r u k: warps 4..7, one row at a time each
      for (int l = warp - 4; l < L; l += 4) {
        float p = sR[l * LDK + lane] * sU[lane] * sK[l * LDK + lane] +
                  sR[l * LDK + lane + 32] * sU[lane + 32] *
                      sK[l * LDK + lane + 32];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          p += __shfl_xor_sync(0xffffffffu, p, off);
        if (lane == 0) sBonus[l] = p;
      }
    }
    __syncthreads();

    // ---- scores: one (i, j) a thread; only i > j is computed (selected)
    {
      const int i = tid / LMAX, j = tid % LMAX;
      float acc = 0.0f;
      if (i < L && j < i) {
#pragma unroll 16
        for (int c = 0; c < K; ++c)
          acc = fmaf(sQ[i * LDK + c], sKe[j * LDK + c], acc);
      }
      sSc[i * LDS + j] = acc;
    }
    __syncthreads();

    // ---- o = scores v + qexp state + bonus v: lane t % V, rows t / V + 4n
    {
      const int lv = tid % V;
#pragma unroll
      for (int n = 0; n < LMAX / OROWS; ++n) {
        const int i = tid / V + OROWS * n;
        if (i >= L) break;
        float a_sc = 0.0f, a_st = 0.0f;
        for (int j = 0; j < i; ++j)
          a_sc = fmaf(sSc[i * LDS + j], sV[j * LDV + lv], a_sc);
#pragma unroll 16
        for (int c = 0; c < K; ++c)
          a_st = fmaf(sQ[i * LDK + c], sS[c * V + lv], a_st);
        const float val = (a_sc + a_st) + sBonus[i] * sV[i * LDV + lv];
        o[(((size_t)b * S + s0 + i) * H + h) * V + lv] =
            __float2bfloat16(apply_lane_fault<FAULT>(val, lv, f));
      }
    }
    __syncthreads();   // every reader of the old state is done

    // ---- state' = exp(la_L) state + kscale^T v: lane t % V, rows t / V + 4n
    {
      const int lv = tid % V;
      const int c0 = tid / V;
      float acc[SROWS];
#pragma unroll
      for (int n = 0; n < SROWS; ++n) acc[n] = 0.0f;
      for (int l = 0; l < L; ++l) {
        const float x = sV[l * LDV + lv];
#pragma unroll
        for (int n = 0; n < SROWS; ++n)
          acc[n] = fmaf(sKs[l * LDK + c0 + OROWS * n], x, acc[n]);
      }
#pragma unroll
      for (int n = 0; n < SROWS; ++n) {
        const int c = c0 + OROWS * n;
        float* s = sS + c * V + lv;
        *s = sDecay[c] * *s + acc[n];
      }
    }
  }

  if (state_out != nullptr) {
    __syncthreads();
    float* dst = state_out + ((size_t)b * H + h) * K * V;
    for (int e = tid; e < K * V; e += NTHREADS) dst[e] = sS[e];
  }
}

template <bool FAULT>
cudaError_t launch(const bf16* r, const bf16* k, const bf16* v,
                   const bf16* lw, const float* u, bf16* o, float* state_out,
                   int Bt, int S, int H, int L, LaneFaultArgs f,
                   cudaStream_t s) {
  rwkv6_wkv_kernel<FAULT><<<dim3(H, Bt), NTHREADS, 0, s>>>(
      r, k, v, lw, u, o, state_out, S, H, L, f);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rwkv6_wkv_fwd(const void* r, const void* k, const void* v,
                             const void* lw, const void* u, void* o,
                             void* state_out, int Bt, int S, int H, int L,
                             int fault_kind, const void* fault_mask,
                             float fault_value, float fault_gain,
                             void* stream) {
  if (L < 1 || L > LMAX || S % L != 0) return (int)cudaErrorInvalidValue;
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
  const cudaError_t e =
      fault_kind < 0
          ? launch<false>(rb, kb, vb, wb, uf, ob, so, Bt, S, H, L, f, s)
          : launch<true>(rb, kb, vb, wb, uf, ob, so, Bt, S, H, L, f, s);
  return (int)e;
}

extern "C" const char* rwkv6_wkv_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
