from repro_torch.kernels.mamba2_scan.kernel import ssd_chunked_cuda
from repro_torch.kernels.mamba2_scan.ops import SSD, ssd
from repro_torch.kernels.mamba2_scan.ref import (ssd_chunked, ssd_flops,
                                                 ssd_ref_blocked,
                                                 ssd_ref_state_passing,
                                                 ssd_scan_ref, ssd_step)

__all__ = ["SSD", "ssd", "ssd_chunked", "ssd_chunked_cuda", "ssd_flops",
           "ssd_ref_blocked", "ssd_ref_state_passing", "ssd_scan_ref",
           "ssd_step"]
