// Lane-fault epilogue shared by the Hopper kernels.
//
// Replaces the Pallas kernels' ``apply_fault`` hook
// (src/repro/viscosity/lanefault.py, ``LaneFault.apply``): a masked
// corruption of the output tile's lane (minor) axis, applied in float32
// just before the bf16 store.  ``FAULT`` is a template parameter, so the
// healthy instantiation carries no fault logic at all.  The wrapper selects
// the fault instantiation only when the output width equals the fault's
// ``width``, as ``LaneFault.apply`` does.
#pragma once

#include <cstdint>

struct LaneFaultArgs {
  int kind;              // 0 stuck, 1 dropped_mac, 2 gain
  const uint32_t* mask;  // device bitmask over the lanes, ceil(width/32) words
  float value;           // stuck-at level
  float gain;            // gain skew
};

template <bool FAULT>
__device__ __forceinline__ float apply_lane_fault(float x, int lane,
                                                  const LaneFaultArgs& f) {
  if constexpr (FAULT) {
    if ((f.mask[lane >> 5] >> (lane & 31)) & 1u) {
      if (f.kind == 0) return f.value;
      if (f.kind == 1) return 0.0f;
      return x * f.gain;
    }
  }
  return x;
}
