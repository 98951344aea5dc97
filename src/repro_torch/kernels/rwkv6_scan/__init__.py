from repro_torch.kernels.rwkv6_scan.kernel import wkv6_chunked_cuda
from repro_torch.kernels.rwkv6_scan.ops import WKV6, wkv6
from repro_torch.kernels.rwkv6_scan.ref import (wkv6_chunked, wkv6_flops,
                                                wkv6_ref_blocked,
                                                wkv6_ref_state_passing,
                                                wkv6_scan_ref, wkv6_step)

__all__ = ["WKV6", "wkv6", "wkv6_chunked", "wkv6_chunked_cuda", "wkv6_flops",
           "wkv6_ref_blocked", "wkv6_ref_state_passing",
           "wkv6_scan_ref", "wkv6_step"]
