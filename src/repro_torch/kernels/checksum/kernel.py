"""The Fig. 4 checksum on Hopper: the wrapper of ``csrc/checksum.cu``.

Replaces the Pallas kernel ``checksum_pallas_words``
(src/repro/kernels/checksum/kernel.py).  On a CUDA tensor the wrapper
launches the kernel over the tensor's bytes (a strided tensor is copied
contiguous first), or raises; on a CPU tensor it runs the plain version,
``checksum_ref_blocked``.  ``checksum_popcount.launches`` counts CUDA
launches and nothing else.

``checksum_tree`` launches once per CUDA leaf into one slot each of a
device buffer and copies the buffer to the host once: one synchronisation
per tree.  The fold over the leaves runs on the host in Python integers.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.checksum.ref import (MASK32, checksum_ref,
                                              checksum_ref_blocked, fold)
from repro_torch.viscosity.lang import tree_leaves

_NAME = "checksum"
_P = ctypes.c_void_p
_PROTOTYPES = {
    "checksum_popcount": (
        _P, ctypes.c_longlong, _P,           # data, nbytes, output slot
        _P),                                 # stream
}


def _launch(x: torch.Tensor, out: torch.Tensor, slot: int):
    """Add the popcount of ``x``'s bytes into ``out[slot]`` (int32 holding
    uint32 bits, zeroed by the caller)."""
    _build.require(out.dtype == torch.int32 and out.device == x.device,
                   "checksum: the output must be int32 on the input's device")
    x = x if x.is_contiguous() else x.contiguous()
    lib = _build.load(_NAME, _PROTOTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):   # the kernel reads its SM count
        rc = lib.checksum_popcount(x.data_ptr(),
                                   x.numel() * x.element_size(),
                                   out.data_ptr() + 4 * slot, stream)
    _build.check(lib, _NAME, rc)
    checksum_popcount.launches += 1


def checksum_popcount(x: torch.Tensor) -> torch.Tensor:
    """Total popcount of ``x``'s bit pattern mod 2^32, as an int64 scalar on
    ``x``'s device.  CUDA tensors: the Hopper kernel on that device and its
    current stream, any dtype, any layout.  CPU tensors: the plain blocked version."""
    if x.device.type == "cuda":
        out = torch.zeros(1, dtype=torch.int32, device=x.device)
        _launch(x, out, 0)
        return out[0].to(torch.int64) & MASK32
    if x.device.type != "cpu":
        raise ValueError(f"checksum: unsupported device {x.device}")
    return checksum_ref_blocked(x)


checksum_popcount.launches = 0


def checksum_tree(tree) -> int:
    """Checksum of a tree of tensors, leaves in ``jax.tree_util`` order,
    folded as the reference folds them: a Python int in [0, 2^32).  CUDA
    leaves go through the kernel, CPU leaves through ``checksum_ref``."""
    leaves = [torch.as_tensor(leaf) for leaf in tree_leaves(tree)]
    sums: List[Optional[int]] = [None] * len(leaves)
    on_card: List[int] = []
    for i, leaf in enumerate(leaves):
        if leaf.device.type == "cuda":
            on_card.append(i)
        elif leaf.device.type == "cpu":
            sums[i] = int(checksum_ref(leaf))
        else:
            raise ValueError(f"checksum: unsupported device {leaf.device}")
    if on_card:
        device = leaves[on_card[0]].device
        _build.require(all(leaves[i].device == device for i in on_card),
                       "checksum_tree: the CUDA leaves must share one device")
        out = torch.zeros(len(on_card), dtype=torch.int32, device=device)
        for slot, i in enumerate(on_card):
            _launch(leaves[i], out, slot)
        for i, c in zip(on_card, out.tolist()):     # one copy to the host
            sums[i] = c & MASK32
    return fold(sums)
