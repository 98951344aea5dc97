from repro_torch.viscosity.lang import (DEGRADED_REDUCED, DEGRADED_REMAP,
                                        DEGRADED_TARGETS, HW, INTERPRET,
                                        REGISTRY, SW, OpSpec, defop,
                                        finite_valid)

__all__ = ["DEGRADED_REDUCED", "DEGRADED_REMAP", "DEGRADED_TARGETS", "HW",
           "INTERPRET", "REGISTRY", "SW", "OpSpec", "defop", "finite_valid"]
