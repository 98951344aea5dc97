"""Port of ``model_stage_names`` from the reference's ``train/runner.py``;
``TrainRunner`` and ``canary_stages`` wait for the training slice."""
from __future__ import annotations

from typing import List

from repro_torch.configs.base import ModelConfig


def model_stage_names(cfg: ModelConfig) -> List[str]:
    """The Viscosity stages this architecture actually exercises."""
    names = []
    if not cfg.attn_free or cfg.shared_attn_every:
        names.append("flash_attention")
    if cfg.gated_mlp and cfg.moe is None:
        names.append("swiglu_mlp")
    if cfg.family == "hybrid":
        names.append("mamba2_ssd")
    if cfg.family == "ssm" and cfg.layer_pattern and cfg.layer_pattern[0] == 3:
        names.append("rwkv6_wkv")
    return names
