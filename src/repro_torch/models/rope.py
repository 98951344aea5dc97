"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE (port of
the reference's ``models/rope.py``)."""
from __future__ import annotations

from typing import Sequence

import torch


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., S) int -> cos/sin (..., S, head_dim//2) f32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (B, S, H, D); cos/sin (B, S, D/2) or (S, D/2)."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


def mrope_tables(positions3: torch.Tensor, head_dim: int, theta: float,
                 sections: Sequence[int]):
    """Qwen2-VL M-RoPE: positions3 (B, S, 3) = (t, h, w) coordinates ->
    cos/sin (B, S, head_dim//2) f32.  The head_dim/2 frequency channels
    are split into ``sections`` (summing to head_dim/2); section i
    rotates by coordinate i."""
    half = head_dim // 2
    assert sum(sections) == half, (sections, half)
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions3.device) / half)
    coord = torch.cat([positions3[..., i:i + 1].expand(
        *positions3.shape[:-1], sec) for i, sec in enumerate(sections)],
        dim=-1).to(torch.float32)
    ang = coord * freqs
    return torch.cos(ang), torch.sin(ang)


def positions_default(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)
