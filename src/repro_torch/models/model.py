"""Unified model API: ``build_model(cfg, routes)`` (port of the
reference's ``models/model.py``; the dry-run specs have no counterpart
yet, see ROADMAP queue 1 item 14)."""
from __future__ import annotations

from typing import Union

from repro_torch.configs.base import ModelConfig
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.transformer import LMModel

Model = Union[LMModel, EncDecModel]


def build_model(cfg: ModelConfig, routes=None) -> Model:
    """Build a model under a routing: a RoutingPlan, a mapping of stage ->
    target / ResidentRoute handle, or None (every stage takes SW).  An
    encoder-decoder config (whisper) gives an ``EncDecModel``, any other
    an ``LMModel``."""
    if cfg.is_encdec:
        return EncDecModel(cfg, routes=routes)
    return LMModel(cfg, routes=routes)
