"""Plain PyTorch versions of the paper's Fig. 4 checksum (popcount) module.

Port of the reference's ``kernels/checksum/ref.py``.  The checksum of a
tensor is the total popcount of its bit pattern, mod 2^32: bit-exact
across lowerings, so one integer compare detects any stuck-at discrepancy
between the HW and SW paths on identical inputs.

``torch.uint32`` lacks ``>>`` and ``+``, so the word view here is the
reference's uint32 view zero-extended to ``int64``, and every function
returns an ``int64`` value in [0, 2^32).  Zero-extension adds no set bits:
the checksum is the popcount of the tensor's raw bytes, for every dtype.
"""
from __future__ import annotations

import torch

from repro_torch.viscosity.lang import tree_leaves

MASK32 = 0xFFFFFFFF
FOLD = 1000003              # checksum_tree's multiplier
_SIGNED = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int32}
_CHUNK = 1 << 22            # elements per pass of checksum_ref


def as_words(x: torch.Tensor) -> torch.Tensor:
    """Flatten any tensor to its uint32 word view (bool -> uint8, 8-byte
    items -> pairs of words), each word zero-extended to int64."""
    if x.dtype == torch.bool:
        x = x.view(torch.uint8)
    item = x.element_size()
    w = x.contiguous().reshape(-1).view(_SIGNED[item]).to(torch.int64)
    return w & ((1 << (8 * min(item, 4))) - 1)


def popcount_fig4(w: torch.Tensor) -> torch.Tensor:
    """The paper's Fig. 4 mask-and-add sequence on words in [0, 2^32)
    (the kernel body's oracle)."""
    w = (w & 0x55555555) + ((w >> 1) & 0x55555555)
    w = (w & 0x33333333) + ((w >> 2) & 0x33333333)
    w = (w & 0x0F0F0F0F) + ((w >> 4) & 0x0F0F0F0F)
    w = (w & 0x00FF00FF) + ((w >> 8) & 0x00FF00FF)
    return (w & 0x0000FFFF) + ((w >> 16) & 0x0000FFFF)


def checksum_ref(x: torch.Tensor) -> torch.Tensor:
    """Total popcount of the bit pattern, mod 2^32 (an int64 scalar on
    ``x``'s device).  Walks ``x`` in slices of 2^22 elements, so the int64
    word view never holds more than 32 MiB."""
    flat = x.reshape(-1)
    total = torch.zeros((), dtype=torch.int64, device=x.device)
    for i in range(0, flat.numel(), _CHUNK):
        total = total + popcount_fig4(as_words(flat[i:i + _CHUNK])).sum()
    return total & MASK32


def checksum_ref_blocked(x: torch.Tensor, *, block_rows: int = 64,
                         lanes: int = 128) -> torch.Tensor:
    """The TPU kernel's blocked algorithm (the INTERPRET route): the word
    view zero-padded to blocks of ``block_rows x lanes`` words, one partial
    popcount per block, the partials summed mod 2^32."""
    w = as_words(x)
    per_block = block_rows * lanes
    nb = max(1, -(-w.numel() // per_block))
    padded = torch.zeros(nb * per_block, dtype=torch.int64, device=w.device)
    padded[:w.numel()] = w
    partials = popcount_fig4(padded.view(nb, per_block)).sum(1) & MASK32
    return partials.sum() & MASK32


def fold(sums) -> int:
    """The reference's order-dependent fold over per-leaf checksums (leaves
    in ``viscosity.lang.tree_leaves`` order, which is JAX's):
    ``total = total * 1000003 + c`` mod 2^32."""
    total = 0
    for c in sums:
        total = (total * FOLD + int(c)) & MASK32
    return total


def checksum_tree_ref(tree) -> int:
    """Checksum of a tree of tensors (the plain version of
    ``kernel.checksum_tree``): the fold over the leaves' ``checksum_ref``,
    as a Python int in [0, 2^32)."""
    return fold(checksum_ref(torch.as_tensor(leaf))
                for leaf in tree_leaves(tree))
