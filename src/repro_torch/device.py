"""Device resolution: entry points run on the card unless asked otherwise.

``resolve_device(None)`` is ``cuda``; asking for CUDA on a machine without
it raises instead of carrying on on the CPU.  Resolving a CUDA device also
pins the float32 precision of products: a float32 matmul and a float32
cuDNN convolution both run in full float32, never TF32 (cuDNN's default is
TF32), so float32 results on the card compare with the CPU's.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the "
                "CPU explicitly")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
