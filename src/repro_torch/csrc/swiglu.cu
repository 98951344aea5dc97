// Fused gated MLP for Hopper (sm_90a): y = (act(x@w1) * (x@w3)) @ w2,
// bf16 in/out, f32 accumulate, act = silu h*sigmoid(h) or tanh-gelu.
//
// Replaces the Pallas TPU kernel ``_swiglu_kernel`` / ``swiglu_pallas``
// (src/repro/kernels/swiglu/kernel.py).  The TPU kernel walks F in order
// into one (bm, Do) f32 accumulator resident in VMEM.  At Do = 2560 that row
// block is 640 KB for bm = 64, far over a block's 227 KB of shared memory,
// so this kernel takes design (b): split F across blocks.
//
//   pass 1 (swiglu_partial_kernel): one block per (64-wide F chunk, 64-row
//     M tile).  It streams D in 64-wide chunks to build its h1 = x@w1 and
//     h3 = x@w3 tiles (64 x 64, f32 in WMMA accumulators), applies the gate
//     in shared memory, rounds g to bf16, and contracts g against its 64
//     rows of w2, Do in 64-wide chunks, into a per-F-chunk f32 partial
//     (nF, Mp, Do) in device memory.  The gate product never leaves shared
//     memory and is never wider than (64, 64).
//   pass 2 (swiglu_reduce_kernel): sums the nF partials in fixed order
//     (deterministic), applies the lane fault in f32, stores bf16.
//
// What bounds it on an H100: at decode (M = slots, 1-8) the weights,
// 3 * 2560 * 6912 * 2 B = 106 MB, must be read once: memory-bound, 32 us at
// 3.35 TB/s.  Each block reads only its F chunk of w1, w3 and w2, once, so
// the weights cross HBM once per call; the partials add nF * Mp * Do * 4 B
// of writes (18 MB at Mp = 16).  At prefill (M = prompt length) the 6 M D F
// operations bound it; there the M tiles re-read the weights (through L2)
// and the partials cost nF * M * Do * 8 B, which a later PR should cut.
// Products run on the tensor cores through WMMA 16x16x16 bf16 fragments;
// loads are 16-byte vectors without TMA or pipelining (later work).
//
// Requirements checked by the wrapper: D, F and Do multiples of 64 (the
// wrapper zero-pads otherwise), row-contiguous tensors, 16-byte aligned.
// Any M: rows past M are zero-filled and never stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

#include "lane_fault.cuh"

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int BM = 64;   // rows of x per block
constexpr int FC = 64;   // F chunk per block (one gate tile)
constexpr int KD = 64;   // D chunk streamed through shared memory
constexpr int BN = 64;   // Do chunk of the second product
constexpr int NTHREADS = 128;  // 4 warps x 16 rows

constexpr size_t SMEM_BYTES =
    BM * KD * sizeof(bf16)           // x chunk
    + 2 * KD * FC * sizeof(bf16)     // w1, w3 chunks
    + 2 * BM * FC * sizeof(float)    // h1, h3
    + BM * FC * sizeof(bf16)         // g
    + FC * BN * sizeof(bf16);        // w2 chunk

// rows [row0, row0 + 64) x cols [col0, col0 + 64) of a row-major bf16
// matrix with row stride ``ld`` into a compact 64 x 64 shared tile; rows
// past ``nrows`` are zero.
__device__ __forceinline__ void load_tile64(bf16* dst, const bf16* src,
                                            int row0, int nrows, int col0,
                                            int ld) {
  for (int idx = threadIdx.x; idx < 64 * 8; idx += NTHREADS) {
    const int r = idx / 8;
    const int c = (idx % 8) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld + col0 + c);
    *reinterpret_cast<uint4*>(dst + r * 64 + c) = val;
  }
}

__device__ __forceinline__ float gate(float h, int act) {
  if (act == 0) return h * (1.0f / (1.0f + expf(-h)));  // silu: h * logistic(h)
  return 0.5f * h *
         (1.0f + tanhf(0.7978845608028654f * (h + 0.044715f * h * h * h)));
}

__global__ void __launch_bounds__(NTHREADS)
swiglu_partial_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                      const bf16* __restrict__ w3, const bf16* __restrict__ w2,
                      float* __restrict__ ws, int M, int D, int F, int Do,
                      int Mp, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sX = reinterpret_cast<bf16*>(smem);
  bf16* sW1 = sX + BM * KD;
  bf16* sW3 = sW1 + KD * FC;
  float* sH1 = reinterpret_cast<float*>(sW3 + KD * FC);
  float* sH3 = sH1 + BM * FC;
  bf16* sG = reinterpret_cast<bf16*>(sH3 + BM * FC);
  bf16* sW2 = sG + BM * FC;

  const int fi = blockIdx.x;
  const int m0 = blockIdx.y * BM;
  const int f0 = fi * FC;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const bool active = m0 + r0 < M;  // warp-uniform: any real row here?

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc1[FC / 16];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc3[FC / 16];
  for (int j = 0; j < FC / 16; ++j) {
    wmma::fill_fragment(acc1[j], 0.0f);
    wmma::fill_fragment(acc3[j], 0.0f);
  }

  // h1, h3 = x @ w1[:, chunk], x @ w3[:, chunk], D streamed in KD chunks
  for (int d0 = 0; d0 < D; d0 += KD) {
    __syncthreads();
    load_tile64(sX, x, m0, M, d0, D);
    load_tile64(sW1, w1, d0, D, f0, F);
    load_tile64(sW3, w3, d0, D, f0, F);
    __syncthreads();
    if (active) {
      for (int kk = 0; kk < KD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, sX + r0 * KD + kk, KD);
        for (int j = 0; j < FC / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, sW1 + kk * FC + j * 16, FC);
          wmma::mma_sync(acc1[j], fa, fb, acc1[j]);
          wmma::load_matrix_sync(fb, sW3 + kk * FC + j * 16, FC);
          wmma::mma_sync(acc3[j], fa, fb, acc3[j]);
        }
      }
    }
  }
  for (int j = 0; j < FC / 16; ++j) {
    wmma::store_matrix_sync(sH1 + r0 * FC + j * 16, acc1[j], FC,
                            wmma::mem_row_major);
    wmma::store_matrix_sync(sH3 + r0 * FC + j * 16, acc3[j], FC,
                            wmma::mem_row_major);
  }
  __syncwarp();
  // gate this warp's 16 rows; g never leaves shared memory
  for (int e = lane; e < 16 * FC; e += 32) {
    const int i = (r0 + e / FC) * FC + e % FC;
    sG[i] = __float2bfloat16(gate(sH1[i], act) * sH3[i]);
  }
  __syncwarp();

  // partial[fi] = g @ w2[chunk, :], Do streamed in BN chunks
  float* wsf = ws + (size_t)fi * Mp * Do;
  for (int n0 = 0; n0 < Do; n0 += BN) {
    __syncthreads();
    load_tile64(sW2, w2, f0, F, n0, Do);
    __syncthreads();
    if (active) {
      for (int j = 0; j < BN / 16; ++j) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.0f);
        for (int kk = 0; kk < FC; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fa, sG + r0 * FC + kk, FC);
          wmma::load_matrix_sync(fb, sW2 + kk * BN + j * 16, BN);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(wsf + (size_t)(m0 + r0) * Do + n0 + j * 16,
                                acc, Do, wmma::mem_row_major);
      }
    }
  }
}

template <bool FAULT>
__global__ void swiglu_reduce_kernel(const float* __restrict__ ws,
                                     bf16* __restrict__ out, int M, int Do,
                                     int Mp, int nF, LaneFaultArgs f) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)M * Do) return;
  const int m = (int)(idx / Do);
  const int n = (int)(idx % Do);
  float s = 0.0f;
  for (int fi = 0; fi < nF; ++fi) s += ws[((size_t)fi * Mp + m) * Do + n];
  out[idx] = __float2bfloat16(apply_lane_fault<FAULT>(s, n, f));
}

}  // namespace

extern "C" int swiglu_fwd(const void* x, const void* w1, const void* w3,
                          const void* w2, void* ws, void* out, int M, int D,
                          int F, int Do, int act, int fault_kind,
                          const void* fault_mask, float fault_value,
                          float fault_gain, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Mp = (M + 15) / 16 * 16;
  const int nF = F / FC;
  cudaError_t e = cudaFuncSetAttribute(
      swiglu_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid1(nF, (M + BM - 1) / BM);
  swiglu_partial_kernel<<<grid1, NTHREADS, SMEM_BYTES, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const bf16*>(w3), static_cast<const bf16*>(w2),
      static_cast<float*>(ws), M, D, F, Do, Mp, act);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  LaneFaultArgs f;
  f.kind = fault_kind;
  f.mask = static_cast<const uint32_t*>(fault_mask);
  f.value = fault_value;
  f.gain = fault_gain;
  const size_t total = (size_t)M * Do;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  if (fault_kind < 0)
    swiglu_reduce_kernel<false><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(ws), static_cast<bf16*>(out), M, Do, Mp,
        nF, f);
  else
    swiglu_reduce_kernel<true><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(ws), static_cast<bf16*>(out), M, Do, Mp,
        nF, f);
  return (int)cudaGetLastError();
}

extern "C" const char* swiglu_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
