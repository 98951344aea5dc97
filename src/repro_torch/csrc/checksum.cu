// The paper's Fig. 4 checksum for Hopper (sm_90a): the total popcount of a
// tensor's bytes, mod 2^32, added into one uint32 slot.
//
// Replaces the Pallas TPU kernel ``_checksum_kernel`` /
// ``checksum_pallas_words`` (src/repro/kernels/checksum/kernel.py).  The TPU
// kernel reads the reference's uint32 word view (``ref.as_words``: each
// element bitcast to an unsigned integer of its width and zero-extended),
// zero-padded to blocks of 64 x 128 words, reduces each block to one partial
// popcount and sums the partials mod 2^32.  Zero-extension and padding add
// no set bits, so that is the popcount of the tensor's raw bytes for every
// dtype, and addition mod 2^32 is associative: any order of summation gives
// the same bits.  So here there is no word view and no padded copy: the
// kernel reads the contiguous bytes as they lie in memory.
//
// Layout: a grid-stride loop over 16-byte vectors from the first 16-byte
// boundary at or after the start (``__ldg`` of a uint4, four in flight per
// thread, ``__popc`` on each 32-bit word); thread 0..15 of block 0 take the
// unaligned head bytes and threads 16..31 the ragged tail, so a view at any
// byte offset needs no copy.  Each thread counts into a uint32 that wraps;
// the block sums with warp shuffles and shared memory; one ``atomicAdd`` a
// block adds its partial to the output slot.  Integer atomics are exact and
// wrap mod 2^32, so the result does not depend on the blocks' order.
//
// What bounds it on an H100: it reads each byte once and does a few integer
// operations per 4 bytes, so it is bound by memory, nbytes / 3.35 TB/s
// (0.32 ms for 1 GiB).  Grid: up to 4 blocks of 256 threads per SM.  The
// output has no lane axis: there is no lane fault (the reference's ``_hw``
// reads no injection either).
//
// Requirements checked by the wrapper: a contiguous tensor (the wrapper
// copies a strided one), the output slot zeroed by the caller.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NTHREADS = 256;
constexpr int UNROLL = 4;         // 16-byte loads in flight per thread
constexpr int BLOCKS_PER_SM = 4;
constexpr int MAX_DEVICES = 64;  // devices whose SM count is kept

__device__ __forceinline__ unsigned popc16(const uint4& q) {
  return __popc(q.x) + __popc(q.y) + __popc(q.z) + __popc(q.w);
}

__global__ void __launch_bounds__(NTHREADS)
checksum_kernel(const uint8_t* __restrict__ base, size_t head, size_t nvec,
                size_t tail, unsigned* __restrict__ out) {
  const uint4* vec = reinterpret_cast<const uint4*>(base + head);
  const size_t stride = (size_t)gridDim.x * NTHREADS;
  size_t i = (size_t)blockIdx.x * NTHREADS + threadIdx.x;
  unsigned count = 0;
  for (; i + (UNROLL - 1) * stride < nvec; i += UNROLL * stride) {
    uint4 q[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) q[u] = __ldg(vec + i + u * stride);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) count += popc16(q[u]);
  }
  for (; i < nvec; i += stride) count += popc16(__ldg(vec + i));
  if (blockIdx.x == 0) {       // fewer than 16 bytes each
    const unsigned t = threadIdx.x;
    if (t < head) {
      count += __popc((unsigned)base[t]);
    } else if (t >= 16 && t - 16 < tail) {
      count += __popc((unsigned)base[head + nvec * 16 + (t - 16)]);
    }
  }

  __shared__ unsigned warp_sums[NTHREADS / 32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  if (lane == 0) warp_sums[warp] = count;
  __syncthreads();
  if (warp == 0) {
    count = lane < NTHREADS / 32 ? warp_sums[lane] : 0u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      count += __shfl_down_sync(0xffffffffu, count, off);
    if (lane == 0 && count != 0u) atomicAdd(out, count);
  }
}

// the current device's SMs (the caller's operand's: its wrapper enters
// that device), read once per device
int sm_count() {
  static int sms[MAX_DEVICES] = {};
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (dev < MAX_DEVICES && sms[dev] != 0) return sms[dev];
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    n = 132;
  if (dev < MAX_DEVICES) sms[dev] = n;
  return n;
}

}  // namespace

// Adds the popcount of ``nbytes`` bytes at ``data`` into the uint32 at
// ``out`` (mod 2^32).  One launch, on ``stream``, even for 0 bytes.
extern "C" int checksum_popcount(const void* data, long long nbytes,
                                 void* out, void* stream) {
  if (nbytes < 0) return (int)cudaErrorInvalidValue;
  const uint8_t* base = static_cast<const uint8_t*>(data);
  const size_t n = (size_t)nbytes;
  size_t head = (16 - (reinterpret_cast<uintptr_t>(base) & 15)) & 15;
  if (head > n) head = n;
  const size_t nvec = (n - head) / 16;
  const size_t tail = (n - head) % 16;
  const size_t want = (nvec + NTHREADS - 1) / NTHREADS;
  const size_t cap = (size_t)sm_count() * BLOCKS_PER_SM;
  const unsigned blocks = (unsigned)(want < 1 ? 1 : (want < cap ? want : cap));
  checksum_kernel<<<blocks, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      base, head, nvec, tail, static_cast<unsigned*>(out));
  return (int)cudaGetLastError();
}

extern "C" const char* checksum_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
