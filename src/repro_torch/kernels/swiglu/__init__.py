from repro_torch.kernels.swiglu.kernel import swiglu_fused
from repro_torch.kernels.swiglu.ops import SWIGLU, swiglu
from repro_torch.kernels.swiglu.ref import (gate, swiglu_flops, swiglu_ref,
                                            swiglu_ref_blocked)

__all__ = ["SWIGLU", "gate", "swiglu", "swiglu_flops", "swiglu_fused",
           "swiglu_ref", "swiglu_ref_blocked"]
