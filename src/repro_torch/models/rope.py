"""Rotary position embeddings (port of the reference's ``models/rope.py``;
M-RoPE waits for the qwen2-vl slice)."""
from __future__ import annotations

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


def positions_default(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)
