from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd
from repro_torch.kernels.flash_attention.ops import ATTENTION, attention
from repro_torch.kernels.flash_attention.ref import (attention_chunked,
                                                     attention_flops,
                                                     attention_naive,
                                                     attention_ref_blocked)

__all__ = ["ATTENTION", "attention", "attention_chunked", "attention_flops",
           "attention_naive", "attention_ref_blocked", "flash_attention_bhsd"]
