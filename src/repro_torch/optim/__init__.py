from repro_torch.optim.adamw import (AdamWConfig, AdamWState,
                                     clip_by_global_norm, global_norm, init,
                                     schedule, update)
from repro_torch.optim.compression import compress_tree, init_error

__all__ = ["AdamWConfig", "AdamWState", "init", "update", "schedule",
           "global_norm", "clip_by_global_norm", "compress_tree",
           "init_error"]
