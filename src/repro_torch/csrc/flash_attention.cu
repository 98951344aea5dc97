// Flash-attention forward for Hopper (sm_90a), bf16 in/out, f32 accumulate.
//
// Replaces the Pallas TPU kernel ``_attn_kernel`` / ``flash_attention_bhsd``
// (src/repro/kernels/flash_attention/kernel.py).  Same function: online
// softmax over K tiles in order with f32 m/l/acc, scores (q.k) * scale with
// an optional tanh softcap, masks kp < kv_len, causal kp <= qp and window
// kp > qp - window, whole masked K tiles skipped by the same predicates,
// GQA head h -> h * Hkv / H, output width Dv = v's head dim, and the lane
// fault applied to acc / l at finalize.
//
// What bounds it on an H100: at the serving shapes (prefill, B=1, H=Hkv=20,
// D=128, S = prompt length <= a few hundred) the work is a few hundred
// MFLOP over a few MB, so the tensor cores bound it in principle, but the
// grid is small (B * H * ceil(S/64) blocks, 40 at S=128) and launch latency
// dominates.  The design keeps it simple and right first:
//   * one thread block of 4 warps per (b, h, 64-row q tile); a loop over
//     64-row K tiles replaces the TPU grid's sequential nk axis;
//   * Q.K^T and P.V run on the tensor cores through WMMA 16x16x16 bf16
//     fragments with f32 accumulators; each warp owns 16 query rows;
//   * the score tile, the f32 output accumulator and m/l live in shared
//     memory (about 105 KB, so two blocks fit an SM); two lanes per row do
//     the online-softmax update with shuffles;
//   * P is rounded to bf16 for the P.V product (l sums the f32 p);
//   * K/V for GQA are addressed through the kv-head index, never repeated.
// No TMA, wgmma or pipelining yet: that is later work.
//
// Requirements checked by the wrapper: D and Dv multiples of 16 and <= 128
// (the wrapper zero-pads narrower widths), row-contiguous (B, H, S, D)
// tensors, 16-byte aligned.  Any Sq, Skv: the ragged edge is masked here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "lane_fault.cuh"

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NTHREADS = 128;  // 4 warps x 16 query rows
constexpr int DMAX = 128;
constexpr float NEG_INF = -1e30f;  // finite, as in the reference kernel

constexpr size_t SMEM_BYTES =
    BQ * DMAX * sizeof(bf16)         // Q tile
    + 2 * BK * DMAX * sizeof(bf16)   // K and V tiles
    + BQ * BK * sizeof(float)        // scores
    + BQ * BK * sizeof(bf16)         // probabilities
    + BQ * DMAX * sizeof(float)      // output accumulator
    + 2 * BQ * sizeof(float);        // m, l

struct AttnArgs {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int H, Hkv, Sq, Skv, D, Dv, kv_len;
  float scale, softcap;
  int causal, window;
};

// rows [row0, row0 + 64) of a row-major (nrows, width) bf16 matrix into
// shared memory with row stride ``width``; rows past ``nrows`` are zero.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row0, int nrows, int width) {
  const int vec = width / 8;
  for (int idx = threadIdx.x; idx < 64 * vec; idx += NTHREADS) {
    const int r = idx / vec;
    const int c = (idx % vec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * width + c);
    *reinterpret_cast<uint4*>(dst + r * width + c) = val;
  }
}

template <bool FAULT>
__global__ void __launch_bounds__(NTHREADS)
flash_attn_fwd_kernel(AttnArgs a, LaneFaultArgs f) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * DMAX;
  bf16* sV = sK + BK * DMAX;
  float* sS = reinterpret_cast<float*>(sV + BK * DMAX);
  bf16* sP = reinterpret_cast<bf16*>(sS + BQ * BK);
  float* sO = reinterpret_cast<float*>(sP + BQ * BK);
  float* sM = sO + BQ * DMAX;
  float* sL = sM + BQ;

  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h * a.Hkv / a.H;
  const int D = a.D;
  const int Dv = a.Dv;
  const bf16* qg = a.q + (size_t)(b * a.H + h) * a.Sq * D;
  const bf16* kg = a.k + (size_t)(b * a.Hkv + kvh) * a.Skv * D;
  const bf16* vg = a.v + (size_t)(b * a.Hkv + kvh) * a.Skv * Dv;

  load_tile(sQ, qg, q_start, a.Sq, D);
  for (int i = threadIdx.x; i < BQ * Dv; i += NTHREADS) sO[i] = 0.0f;
  for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
    sM[i] = NEG_INF;
    sL[i] = 0.0f;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;           // this warp's first query row
  const int row = r0 + lane / 2;      // the row this lane updates
  const int half = lane & 1;          // which half of the row's columns
  const int qp = q_start + row;
  const int nk = (a.Skv + BK - 1) / BK;

  for (int kt = 0; kt < nk; ++kt) {
    const int k_start = kt * BK;
    // block-level admissibility: the reference kernel's predicates
    bool run = k_start < a.kv_len;
    if (a.causal) run = run && (k_start <= q_start + BQ - 1);
    if (a.window > 0) run = run && (k_start + BK - 1 > q_start - a.window);
    if (!run) continue;

    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(sK, kg, k_start, a.Skv, D);
    load_tile(sV, vg, k_start, a.Skv, Dv);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, sQ + r0 * D + kk, D);
        wmma::load_matrix_sync(fb, sK + (j * 16) * D + kk, D);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sS + r0 * BK + j * 16, acc, BK,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax: two lanes per row, 32 columns each
    float* srow = sS + row * BK;
    const int c0 = half * (BK / 2);
    float mx = NEG_INF;
    for (int c = c0; c < c0 + BK / 2; ++c) {
      float s = srow[c] * a.scale;
      if (a.softcap > 0.0f) s = tanhf(s / a.softcap) * a.softcap;
      const int kp = k_start + c;
      bool ok = kp < a.kv_len;
      if (a.causal) ok = ok && (kp <= qp);
      if (a.window > 0) ok = ok && (kp > qp - a.window);
      s = ok ? s : NEG_INF;
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_prev = sM[row];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.0f;
    for (int c = c0; c < c0 + BK / 2; ++c) {
      const float p = expf(srow[c] - m_new);
      sum += p;
      sP[row * BK + c] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float corr = expf(m_prev - m_new);
    __syncwarp();  // both lanes have read sM[row] before it changes
    if (half == 0) {
      sL[row] = sL[row] * corr + sum;
      sM[row] = m_new;
    }
    float* orow = sO + row * Dv;
    for (int c = half * (Dv / 2); c < (half + 1) * (Dv / 2); ++c) orow[c] *= corr;
    __syncwarp();

    // O += P V for this warp's 16 rows
    for (int n = 0; n < Dv; n += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sO + r0 * Dv + n, Dv, wmma::mem_row_major);
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sP + r0 * BK + kk, BK);
        wmma::load_matrix_sync(fb, sV + kk * Dv + n, Dv);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sO + r0 * Dv + n, acc, Dv, wmma::mem_row_major);
    }
    __syncwarp();
  }
  __syncthreads();  // sO/sL written by the last iteration are visible

  // finalize: acc / l, lane fault in f32, bf16 store
  if (qp < a.Sq) {
    const float l = fmaxf(sL[row], 1e-30f);
    bf16* og = a.o + ((size_t)(b * a.H + h) * a.Sq + qp) * Dv;
    for (int c = half * (Dv / 2); c < (half + 1) * (Dv / 2); ++c) {
      const float val = sO[row * Dv + c] / l;
      og[c] = __float2bfloat16(apply_lane_fault<FAULT>(val, c, f));
    }
  }
}

template <bool FAULT>
cudaError_t launch(const AttnArgs& a, const LaneFaultArgs& f, int B,
                   cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      flash_attn_fwd_kernel<FAULT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, B);
  flash_attn_fwd_kernel<FAULT><<<grid, NTHREADS, SMEM_BYTES, stream>>>(a, f);
  return cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Hkv, int Sq, int Skv, int D, int Dv, int kv_len, float scale,
    int causal, int window, float softcap, int fault_kind,
    const void* fault_mask, float fault_value, float fault_gain,
    void* stream) {
  AttnArgs a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.o = static_cast<bf16*>(o);
  a.H = H;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Skv = Skv;
  a.D = D;
  a.Dv = Dv;
  a.kv_len = kv_len;
  a.scale = scale;
  a.softcap = softcap;
  a.causal = causal;
  a.window = window;
  LaneFaultArgs f;
  f.kind = fault_kind;
  f.mask = static_cast<const uint32_t*>(fault_mask);
  f.value = fault_value;
  f.gain = fault_gain;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = fault_kind < 0 ? launch<false>(a, f, B, s)
                                       : launch<true>(a, f, B, s);
  return (int)e;
}

extern "C" const char* flash_attention_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
