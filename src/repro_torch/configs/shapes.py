"""Assigned input shapes (LM family): each (arch x shape) is a dry-run cell.

A copy of the reference's ``configs/shapes.py``."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

SMOKE_SHAPES = {
    "train_4k": ShapeSpec("train_4k", 64, 2, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 64, 2, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 64, 2, "decode"),
    "long_500k": ShapeSpec("long_500k", 128, 1, "decode"),
}


def applicable(cfg, shape: ShapeSpec) -> tuple[bool, str]:
    """Assignment rules: which cells run vs are recorded as skipped."""
    if shape.name == "long_500k" and not cfg.sub_quadratic():
        return False, "full-attention arch: 512k decode KV inadmissible (see DESIGN.md §6)"
    return True, ""
