"""Int8 error-feedback gradient compression.

Port of the reference's ``optim/compression.py``: each leaf is quantized
to int8 with a shared absmax scale after its error residual is added
back, and the new residual is kept for the next step.  Rounding is half
to even (``torch.round``, as ``jnp.round``), so ``q`` and ``scale`` equal
the reference's bit for bit.  End to end the function models the effect
of the int8 all-reduce on the values; the bytes enter analytically
(``compressed_bytes``).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.viscosity.lang import tree_leaves, tree_map

PyTree = Any


def quantize_leaf(g: torch.Tensor, err: Optional[torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """g (+err) -> (int8 q, f32 scale, new error residual)."""
    gf = g.to(torch.float32)
    if err is not None:
        gf = gf + err
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return q, scale, gf - deq


def compress_tree(grads: PyTree, err: Optional[PyTree]
                  ) -> Tuple[PyTree, PyTree]:
    """Quantize + dequantize each leaf with error feedback.  Returns
    (dequantized grads, new error buffers), both of ``grads``' structure."""
    residuals = []

    def leaf(g, e=None):
        q, s, r = quantize_leaf(g, e)
        residuals.append(r)
        return q.to(torch.float32) * s
    deq = tree_map(leaf, grads) if err is None else tree_map(leaf, grads, err)
    it = iter(residuals)        # tree_map visits both trees in one order
    return deq, tree_map(lambda _: next(it), grads)


def init_error(params: PyTree) -> PyTree:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_bytes(params: PyTree) -> int:
    return sum(p.numel() for p in tree_leaves(params))
