"""Unified model API: ``build_model(cfg, routes)`` (port of the
reference's ``models/model.py``; the dry-run specs have no counterpart
yet, see ROADMAP queue 1 item 14)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import LMModel


def build_model(cfg: ModelConfig, routes=None) -> LMModel:
    """Build a model under a routing: a RoutingPlan, a mapping of stage ->
    target / ResidentRoute handle, or None (every stage takes SW)."""
    if cfg.is_encdec:
        raise NotImplementedError(
            "encoder-decoder models are not ported yet (ROADMAP queue 1 "
            "item 12.6)")
    return LMModel(cfg, routes=routes)
