// Chunked Mamba2 SSD forward for Hopper (sm_90a): one (b, h) per block,
// chunks walked in order with the (N, P) f32 state in shared memory.
//
// Replaces the Pallas TPU kernel ``_ssd_kernel`` / ``ssd_chunked_pallas``
// (src/repro/kernels/mamba2_scan/kernel.py).  The TPU kernel walks the chunk
// axis as the minor grid dimension and carries the state in VMEM scratch
// between grid steps; blocks on the card run in no order, so here the chunk
// walk is a loop inside one block per (b, h).  Per chunk of L <= 128 tokens:
//
//   xdt = x * dt,  da = dt * A,  cum = cumsum(da),  tot = cum[L-1]
//   W[i, j] = (C B^T)[i, j] * exp(cum_i - cum_j)   for i >= j, else 0
//   y       = W xdt + (C state) * exp(cum)          lane fault on P, bf16
//   state'  = exp(tot) * state + (B * exp(tot - cum))^T xdt
//
// The pre-scale is fused here (the reference does it in the launcher).  The
// triangle is selected BEFORE the exponent, so every exponent is <= 0 in the
// scan's domain (dt > 0, A < 0): no inf and no NaN however fast a chunk
// decays.
//
// What bounds it on an H100: at the zamba2-1.2b prefill (S = 384, H = 64,
// N = P = 64) the call moves ~7.5 MB (x and y in bf16, the f32 state out):
// 2.2 us at 3.35 TB/s, against 0.8 GFLOP of products (0.8 us at the bf16
// tensor rate).  This first version does its four products with f32 FMA on
// the CUDA cores from shared memory (register tiles of 8x8, 8x4 and 4x4
// outputs per thread) and runs only B * H blocks (64 of 132 SMs at B = 1),
// so it is bound by the CUDA cores' FMA throughput, not by memory: no wgmma, TMA
// or pipelining yet.  Shared memory per block: B, C (L x (N+1) f32, padded
// rows against bank conflicts), xdt (L x P f32), W (L x (L+1) f32) and the
// state (N x P f32), 183,808 bytes, above the 48 KB default: the launcher
// opts in with cudaFuncAttributeMaxDynamicSharedMemorySize.
//
// Requirements checked by the wrapper: N = P = 64 (the wrapper zero-pads
// narrower operands: zero B/C columns and zero x lanes add nothing and are
// sliced away), S a multiple of L (the op zero-pads with dt = 0, which
// leaves the real tokens' y and the final state exact), contiguous tensors,
// 16-byte aligned rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "lane_fault.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr int LMAX = 128;      // longest chunk
constexpr int N = 64;          // state width (padded by the wrapper)
constexpr int P = 64;          // head channels (padded by the wrapper)
constexpr int NTHREADS = 256;
constexpr int LDN = N + 1;     // row stride of the B and C tiles
constexpr int LDW = LMAX + 1;  // row stride of W

constexpr size_t SMEM_FLOATS = 2 * LMAX * LDN   // B, C
                               + LMAX * P       // xdt
                               + LMAX * LDW     // W
                               + N * P          // state
                               + 4 * LMAX;      // da/cum, exp(cum), exp(tot - cum), dt
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

__device__ __forceinline__ void load8_bf16(const bf16* src, float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    dst[2 * k] = f.x;
    dst[2 * k + 1] = f.y;
  }
}

template <bool FAULT>
__global__ void __launch_bounds__(NTHREADS)
mamba2_ssd_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const bf16* __restrict__ Bm,
                  const bf16* __restrict__ Cm, bf16* __restrict__ y,
                  float* __restrict__ state_out, int S, int H, int L,
                  LaneFaultArgs f) {
  extern __shared__ __align__(16) float smem[];
  float* sB = smem;                    // (LMAX, LDN)
  float* sC = sB + LMAX * LDN;         // (LMAX, LDN)
  float* sX = sC + LMAX * LDN;         // (LMAX, P): xdt
  float* sW = sX + LMAX * P;           // (LMAX, LDW)
  float* sS = sW + LMAX * LDW;         // (N, P): the carried state
  float* sCum = sS + N * P;            // (LMAX)
  float* sEcum = sCum + LMAX;          // exp(cum)
  float* sEtail = sEcum + LMAX;        // exp(tot - cum)
  float* sDt = sEtail + LMAX;          // dt of the chunk

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const float a = A[h];

  for (int e = tid; e < N * P; e += NTHREADS) sS[e] = 0.0f;

  for (int s0 = 0; s0 < S; s0 += L) {
    // ---- load the chunk: dt, B, C (bf16 -> f32) and xdt = x * dt
    __syncthreads();   // the previous chunk's readers are done
    for (int l = tid; l < L; l += NTHREADS)
      sDt[l] = dt[((size_t)b * S + s0 + l) * H + h];
    for (int e = tid; e < L * (N / 8); e += NTHREADS) {
      const int l = e / (N / 8);
      const int n0 = (e % (N / 8)) * 8;
      const size_t row = ((size_t)b * S + s0 + l) * N + n0;
      float vb[8], vc[8];
      load8_bf16(Bm + row, vb);
      load8_bf16(Cm + row, vc);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        sB[l * LDN + n0 + k] = vb[k];
        sC[l * LDN + n0 + k] = vc[k];
      }
    }
    __syncthreads();   // sDt ready
    for (int e = tid; e < L * (P / 8); e += NTHREADS) {
      const int l = e / (P / 8);
      const int p0 = (e % (P / 8)) * 8;
      float vx[8];
      load8_bf16(x + (((size_t)b * S + s0 + l) * H + h) * P + p0, vx);
      const float d = sDt[l];
#pragma unroll
      for (int k = 0; k < 8; ++k) sX[l * P + p0 + k] = vx[k] * d;
    }
    // ---- cum = cumsum(dt * A): one warp, 4 tokens a lane, shuffle scan
    if (warp == 0) {
      float v[4];
      float run = 0.0f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int l = lane * 4 + k;
        v[k] = l < L ? sDt[l] * a : 0.0f;
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
        const int l = lane * 4 + k;
        acc += v[k];
        if (l < L) sCum[l] = acc;
      }
    }
    __syncthreads();
    const float tot = sCum[L - 1];
    for (int l = tid; l < L; l += NTHREADS) {
      sEcum[l] = expf(sCum[l]);
      sEtail[l] = expf(tot - sCum[l]);
    }

    // ---- W = (C B^T) * exp(cum_i - cum_j) on i >= j; 8x8 outputs a thread
    {
      const int ti = tid / 16, tj = tid % 16;
      float acc[8][8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
      const int i0 = ti * 8;
      if (i0 < L) {
        for (int n = 0; n < N; ++n) {
          float ci[8], bj[8];
#pragma unroll
          for (int r = 0; r < 8; ++r) ci[r] = sC[(i0 + r) * LDN + n];
#pragma unroll
          for (int c = 0; c < 8; ++c) bj[c] = sB[(tj + 16 * c) * LDN + n];
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(ci[r], bj[c], acc[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = i0 + r;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int j = tj + 16 * c;
            // select first: exp only ever sees cum_i - cum_j <= 0, and the
            // rows and columns past L (stale tiles) never reach W
            const bool keep = j <= i && i < L;
            const float d = keep ? sCum[i] - sCum[j] : 0.0f;
            sW[i * LDW + j] = keep ? acc[r][c] * expf(d) : 0.0f;
          }
        }
      }
    }
    __syncthreads();

    // ---- y = W xdt + (C state) * exp(cum); 8 rows x 4 lanes a thread
    {
      const int ti = tid / 16, tp = tid % 16;
      const int i0 = ti * 8;
      if (i0 < L) {
        float acc[8][4], ast[8][4];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = ast[r][c] = 0.0f;
        const int jend = min(L, i0 + 8);   // W is zero past the diagonal
        for (int j = 0; j < jend; ++j) {
          float w[8], xv[4];
#pragma unroll
          for (int r = 0; r < 8; ++r) w[r] = sW[(i0 + r) * LDW + j];
#pragma unroll
          for (int c = 0; c < 4; ++c) xv[c] = sX[j * P + tp + 16 * c];
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(w[r], xv[c], acc[r][c]);
        }
        for (int n = 0; n < N; ++n) {
          float cv[8], sv[4];
#pragma unroll
          for (int r = 0; r < 8; ++r) cv[r] = sC[(i0 + r) * LDN + n];
#pragma unroll
          for (int c = 0; c < 4; ++c) sv[c] = sS[n * P + tp + 16 * c];
#pragma unroll
          for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) ast[r][c] = fmaf(cv[r], sv[c], ast[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = i0 + r;
          if (i >= L) break;
          const float ec = sEcum[i];
          bf16* yrow = y + (((size_t)b * S + s0 + i) * H + h) * P;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int p = tp + 16 * c;
            const float v = acc[r][c] + ast[r][c] * ec;
            yrow[p] = __float2bfloat16(apply_lane_fault<FAULT>(v, p, f));
          }
        }
      }
    }
    __syncthreads();   // every reader of the old state is done

    // ---- state' = exp(tot) state + (B * exp(tot - cum))^T xdt; 4x4 a thread
    {
      const int tn = tid / 16, tp = tid % 16;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
      for (int l = 0; l < L; ++l) {
        const float e = sEtail[l];
        float bv[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) bv[r] = sB[l * LDN + tn + 16 * r] * e;
#pragma unroll
        for (int c = 0; c < 4; ++c) xv[c] = sX[l * P + tp + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(bv[r], xv[c], acc[r][c]);
      }
      const float et = expf(tot);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float* s = sS + (tn + 16 * r) * P + tp + 16 * c;
          *s = *s * et + acc[r][c];
        }
    }
  }

  if (state_out != nullptr) {
    __syncthreads();
    float* dst = state_out + ((size_t)b * H + h) * N * P;
    for (int e = tid; e < N * P; e += NTHREADS) dst[e] = sS[e];
  }
}

template <bool FAULT>
cudaError_t launch(const bf16* x, const float* dt, const float* A,
                   const bf16* Bm, const bf16* Cm, bf16* y, float* state_out,
                   int Bt, int S, int H, int L, LaneFaultArgs f,
                   cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      mamba2_ssd_kernel<FAULT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (e != cudaSuccess) return e;
  mamba2_ssd_kernel<FAULT><<<dim3(H, Bt), NTHREADS, SMEM_BYTES, s>>>(
      x, dt, A, Bm, Cm, y, state_out, S, H, L, f);
  return cudaGetLastError();
}

}  // namespace

extern "C" int mamba2_ssd_fwd(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, void* y,
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
  const bf16* xb = static_cast<const bf16*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const bf16* Bb = static_cast<const bf16*>(Bm);
  const bf16* Cb = static_cast<const bf16*>(Cm);
  bf16* yb = static_cast<bf16*>(y);
  float* so = static_cast<float*>(state_out);
  const cudaError_t e =
      fault_kind < 0
          ? launch<false>(xb, dtf, Af, Bb, Cb, yb, so, Bt, S, H, L, f, s)
          : launch<true>(xb, dtf, Af, Bb, Cb, yb, so, Bt, S, H, L, f, s);
  return (int)e;
}

extern "C" const char* mamba2_ssd_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
