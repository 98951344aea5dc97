"""Architecture registry of the port: ``get_config(name)``.

Only the serving slice's architecture is ported so far; every other
reference architecture raises ``NotImplementedError`` naming the ROADMAP
item that brings it.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.qwen1p5_4b import CONFIG as _QWEN1P5_4B

_CONFIGS = {"qwen1.5-4b": _QWEN1P5_4B}

# Reference architectures not yet ported -> the ROADMAP queue item.
_PENDING = {
    "gemma2-2b": "queue 1 item 12.1 (gemma2/gemma3)",
    "gemma3-1b": "queue 1 item 12.1 (gemma2/gemma3)",
    "mistral-nemo-12b": "queue 1 item 12 (rest of the model zoo)",
    "mixtral-8x7b": "queue 1 item 12.2 (mixtral/llama4, models/moe.py)",
    "llama4-scout-17b-a16e": "queue 1 item 12.2 (mixtral/llama4)",
    "zamba2-1.2b": "queue 1 item 12.3 (zamba2, SSD kernel)",
    "rwkv6-1.6b": "queue 1 item 12.4 (rwkv6, WKV kernel)",
    "qwen2-vl-7b": "queue 1 item 12.5 (qwen2-vl, M-RoPE)",
    "whisper-base": "queue 1 item 12.6 (whisper, encdec)",
}

ARCH_NAMES = tuple(_CONFIGS)


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).reduced()
    if name in _CONFIGS:
        return _CONFIGS[name]
    if name in _PENDING:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet; see ROADMAP "
            f"{_PENDING[name]}")
    raise KeyError(f"unknown arch {name!r}; known: {sorted(_CONFIGS)}")


__all__ = ["ARCH_NAMES", "ModelConfig", "get_config"]
