"""Unified model API: ``build_model(cfg, routes)`` and ``input_specs(cfg,
shape)`` (port of the reference's ``models/model.py``).

The ``*_specs`` functions give stand-ins for every model input of an
(arch x shape) cell: tensors on ``torch.device("meta")``, which carry a
shape and a dtype and allocate nothing, where the reference gives
``jax.ShapeDtypeStruct``s.  The dry run (``launch/dryrun.py``) runs the
cell's step on them.  A meta tree is built from a CPU ``torch.Generator``
(no generator lives on meta), so ``params_specs`` draws as ``init`` does,
in the same order, and only the values are missing.
"""
from __future__ import annotations

from typing import Any, Dict, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.transformer import LMModel

Model = Union[LMModel, EncDecModel]
META = torch.device("meta")


def build_model(cfg: ModelConfig, routes=None) -> Model:
    """Build a model under a routing: a RoutingPlan, a mapping of stage ->
    target / ResidentRoute handle, or None (every stage takes SW).  An
    encoder-decoder config (whisper) gives an ``EncDecModel``, any other
    an ``LMModel``."""
    if cfg.is_encdec:
        return EncDecModel(cfg, routes=routes)
    return LMModel(cfg, routes=routes)


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def train_batch_specs(cfg: ModelConfig, B: int, S: int) -> Dict[str, Any]:
    if cfg.is_encdec:
        T = min(cfg.max_target_len, S)
        return {
            "embeds": _spec((B, S, cfg.d_model), torch.bfloat16),
            "dec_tokens": _spec((B, T), torch.int32),
            "dec_targets": _spec((B, T), torch.int32),
        }
    batch = {"tokens": _spec((B, S), torch.int32),
             "targets": _spec((B, S), torch.int32)}
    if cfg.stub_frontend:  # vlm: precomputed patch embeddings + 3D positions
        batch["embeds"] = _spec((B, S, cfg.d_model), torch.bfloat16)
        batch["positions3"] = _spec((B, S, 3), torch.int32)
        del batch["tokens"]
    return batch


def prefill_batch_specs(cfg: ModelConfig, model: Model, B: int, S: int):
    cache = model.init_cache(B, S, device=META)
    if cfg.is_encdec:
        T = min(cfg.max_target_len, S)
        return {"embeds": _spec((B, S, cfg.d_model), torch.bfloat16),
                "dec_tokens": _spec((B, T), torch.int32),
                "cache": cache}
    batch = {"tokens": _spec((B, S), torch.int32), "cache": cache}
    if cfg.stub_frontend:
        batch["embeds"] = _spec((B, S, cfg.d_model), torch.bfloat16)
        batch["positions3"] = _spec((B, S, 3), torch.int32)
        del batch["tokens"]
    return batch


def decode_state_specs(cfg: ModelConfig, model: Model, B: int, S: int):
    """Decode-mode stand-ins: (cache/state, tokens, t).  ``t`` is a host
    int, as the port's ``decode_step`` takes it: the last position of the
    self-attention cache (``S`` slots; whisper's ``min(S,
    max_target_len)``), where the reference's is a traced int32 scalar."""
    if cfg.is_encdec:
        cache = model.init_cache(B, S, device=META)
        cross = model.cross_kv_cache(
            params_specs(model), _spec((B, S, cfg.d_model), torch.bfloat16))
        state = {"cross": cross, "self": cache}
        S = min(S, cfg.max_target_len)
    else:
        state = model.init_cache(B, S, device=META)
    return state, _spec((B, 1), torch.int32), S - 1


def params_specs(model: Model):
    """The param tree of ``model.init`` on meta, in the param dtype."""
    return model.init(torch.Generator().manual_seed(0), device=META)


def input_specs(cfg: ModelConfig, shape: ShapeSpec, model: Model = None):
    """All input stand-ins for one dry-run cell."""
    model = model or build_model(cfg)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"batch": train_batch_specs(cfg, B, S)}
    if shape.kind == "prefill":
        return {"batch": prefill_batch_specs(cfg, model, B, S)}
    if shape.kind == "decode":
        state, tok, t = decode_state_specs(cfg, model, B, S)
        return {"cache": state, "tokens": tok, "t": t}
    raise ValueError(shape.kind)
