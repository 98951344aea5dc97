// State passing shared by the chunked scans (rwkv6_wkv.cu, mamba2_ssd.cu).
//
// Both scans split into the chunk-state / state-passing / chunk-scan phases
// of Dao & Gu, "Transformers are SSMs" (2024), section 6.  The first phase
// leaves, for every group of chunks of one (b, h), the state U that the
// group would leave behind from a zero start and the decay d that the group
// applies to whatever state it receives.  This pass is the short sequential
// part that joins them:
//
//   S_in[0] = 0,   S_in[g] = d[g-1] * S_in[g-1] + U[g-1],
//
// written over U in place (group g's U is read before its S_in is stored),
// and the final state d[ng-1] * S_in[ng-1] + U[ng-1] returned.  A thread
// carries four consecutive entries of one row of the state (one float4),
// so they share one decay: a K-vector entry for the WKV, a scalar per
// (b, h, chunk) for the SSD.  The loads of U do not wait on the carried
// state, so they go out 16 groups at a time, ahead of the stores.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

constexpr int PASS_DEPTH = 16;  // groups whose U is loaded ahead

// U: the thread's float4 in group 0; ``ustride`` float4s between groups.
// d: the thread's decay in group 0; ``dstride`` floats between groups.
__device__ __forceinline__ float4 pass_states(float4* U, size_t ustride,
                                              const float* d,
                                              size_t dstride, int ng) {
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int g0 = 0; g0 < ng; g0 += PASS_DEPTH) {
    float4 u[PASS_DEPTH];
    float dec[PASS_DEPTH];
#pragma unroll
    for (int q = 0; q < PASS_DEPTH; ++q) {
      if (g0 + q < ng) {
        u[q] = U[(size_t)(g0 + q) * ustride];
        dec[q] = d[(size_t)(g0 + q) * dstride];
      }
    }
#pragma unroll
    for (int q = 0; q < PASS_DEPTH; ++q) {
      if (g0 + q < ng) {
        U[(size_t)(g0 + q) * ustride] = s;
        s.x = fmaf(dec[q], s.x, u[q].x);
        s.y = fmaf(dec[q], s.y, u[q].y);
        s.z = fmaf(dec[q], s.z, u[q].z);
        s.w = fmaf(dec[q], s.w, u[q].w);
      }
    }
  }
  return s;
}
