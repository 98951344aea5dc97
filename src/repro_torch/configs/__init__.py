"""Architecture registry of the port: ``get_config(name)``.

Every architecture of the reference's model zoo is registered, under the
reference's name; ``<name>-smoke`` gives its reduced config.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.gemma2_2b import CONFIG as _GEMMA2_2B
from repro_torch.configs.gemma3_1b import CONFIG as _GEMMA3_1B
from repro_torch.configs.llama4_scout_17b import CONFIG as _LLAMA4_SCOUT
from repro_torch.configs.mistral_nemo_12b import CONFIG as _MISTRAL_NEMO
from repro_torch.configs.mixtral_8x7b import CONFIG as _MIXTRAL_8X7B
from repro_torch.configs.qwen1p5_4b import CONFIG as _QWEN1P5_4B
from repro_torch.configs.qwen2_vl_7b import CONFIG as _QWEN2_VL_7B
from repro_torch.configs.rwkv6_1p6b import CONFIG as _RWKV6_1P6B
from repro_torch.configs.shapes import (SHAPES, SMOKE_SHAPES, ShapeSpec,
                                        applicable)
from repro_torch.configs.whisper_base import CONFIG as _WHISPER_BASE
from repro_torch.configs.zamba2_1p2b import CONFIG as _ZAMBA2_1P2B

_CONFIGS = {"qwen1.5-4b": _QWEN1P5_4B, "zamba2-1.2b": _ZAMBA2_1P2B,
            "rwkv6-1.6b": _RWKV6_1P6B, "mistral-nemo-12b": _MISTRAL_NEMO,
            "mixtral-8x7b": _MIXTRAL_8X7B,
            "llama4-scout-17b-a16e": _LLAMA4_SCOUT, "gemma2-2b": _GEMMA2_2B,
            "gemma3-1b": _GEMMA3_1B, "qwen2-vl-7b": _QWEN2_VL_7B,
            "whisper-base": _WHISPER_BASE}

ARCH_NAMES = tuple(_CONFIGS)


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).reduced()
    if name in _CONFIGS:
        return _CONFIGS[name]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(_CONFIGS)}")


__all__ = ["ARCH_NAMES", "SHAPES", "SMOKE_SHAPES", "ModelConfig", "ShapeSpec",
           "applicable", "get_config"]
