"""Decoder blocks: attention + gated MLP (dense, and the hybrid family's
shared block), Mamba2, RWKV-6.

Port of the reference's ``models/blocks.py`` (``LayerMeta``,
``make_metas``, ``attn_block``, ``init_mamba_block``, ``mamba_block``,
``init_rwkv_block``, ``rwkv_block``); the MoE block waits for its slice.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import viscosity
from repro_torch.configs.base import ATTN_LOCAL, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models import rwkv6 as rwkv_mod


@torch.library.custom_op("repro_torch::checkpoint_name", mutates_args=())
def _checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()


@_checkpoint_name.register_fake
def _(x, name):
    return torch.empty_like(x)


_checkpoint_name.register_autograd(
    lambda ctx, grad: (grad, None),
    setup_context=lambda ctx, inputs, output: None)

# the op remat_policy="collectives" saves (models/transformer.py _remat)
CHECKPOINT_NAME = torch.ops.repro_torch.checkpoint_name.default


def checkpoint_name(x: torch.Tensor, name: str, cfg: ModelConfig
                    ) -> torch.Tensor:
    """The reference's ``ad_checkpoint.checkpoint_name``: tags ``x`` (a
    copy, under autograd with the ``collectives`` remat policy only) so
    that the policy saves it."""
    if (cfg.remat and cfg.remat_policy == "collectives"
            and torch.is_grad_enabled() and x.requires_grad):
        return _checkpoint_name(x, name)
    return x


@dataclass(frozen=True)
class LayerMeta:
    kind: int
    window: int          # 0 = full attention
    theta: float         # rope theta for this layer
    local: bool          # uses the local rope table (gemma3)


def make_metas(cfg: ModelConfig):
    """One LayerMeta per *pattern position* (layer i uses i % len(pattern))."""
    metas = []
    for k in cfg.layer_pattern or (0,):
        local = (k == ATTN_LOCAL) and bool(cfg.rope_theta_local)
        metas.append(LayerMeta(
            kind=k,
            window=cfg.window if k == ATTN_LOCAL else 0,
            theta=(cfg.rope_theta_local if local else cfg.rope_theta),
            local=local))
    return metas


def attn_block(p, x, cfg: ModelConfig, meta: LayerMeta, rope, routes,
               cache=None, layer=None, t=None, tpos=None, step=False):
    """Returns x after one block.  Prefill (``cache`` given, ``step``
    False) writes the layer's KV into ``cache``; decode (``step``) reads
    and writes it, per slot."""
    route_attn = routes.get("flash_attention", viscosity.SW)
    route_mlp = routes.get("swiglu_mlp", viscosity.SW)
    kw = dict(n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
              head_dim=cfg.resolved_head_dim, window=meta.window,
              softcap=cfg.attn_softcap, scale=cfg.attn_scale)
    cos, sin = rope
    if step:
        h = L.per_row(lambda r: L.norm(p["ln1"], r, eps=cfg.norm_eps), x)
        attn_out = attn_mod.attn_decode(p["attn"], h, cache, layer, t, tpos,
                                        cos, sin, **kw)
    else:
        h = L.norm(p["ln1"], x, eps=cfg.norm_eps)
        res = attn_mod.attn_full(p["attn"], h, cos, sin, causal=True,
                                 route=route_attn, kv_out=cache is not None,
                                 kv_chunk=cfg.attn_chunk, **kw)
        if cache is not None:
            attn_out, (k, v) = res
            attn_mod.cache_write_prefill(cache, layer, k, v)
        else:
            attn_out = res
    # tagged so remat_policy="collectives" keeps the block's output
    x = x + checkpoint_name(attn_out, "attn_out", cfg)
    if step:
        h = L.per_row(lambda r: L.norm(p["ln2"], r, eps=cfg.norm_eps), x)
    else:
        h = L.norm(p["ln2"], x, eps=cfg.norm_eps)
    ffn_out = L.mlp(p["mlp"], h, act=cfg.mlp_act, route=route_mlp,
                    row_independent=step)
    return x + checkpoint_name(ffn_out, "ffn_out", cfg)


def _per_slot(block, x, state):
    """``block(x_i, state_i)`` for each slot i on its own, as a B=1 decode
    would run it, so batched decode equals single-request decode bit for
    bit; each slot's state views are written in place."""
    return torch.cat([
        block(x[i:i + 1], {k: v[i:i + 1] for k, v in state.items()})
        for i in range(x.shape[0])])


def init_mamba_block(gen, n, cfg: ModelConfig, dtype, device):
    """``n`` stacked Mamba2 layers: pre-norm + mixer."""
    return {"ln1": L.init_norm(cfg.d_model, dtype, device, lead=(n,)),
            "mix": mamba_mod.init_mamba2(gen, n, cfg, dtype, device)}


def mamba_block(p, x, cfg: ModelConfig, routes, state=None, step=False):
    """Returns x after one Mamba2 layer.  ``state`` (views of the layer's
    conv tail and SSM state) is written in place by a prefill and by a
    decode step; decode runs each slot on its own, as a B=1 decode would,
    so batched decode equals single-request decode bit for bit."""
    if step and x.shape[0] > 1:
        return _per_slot(lambda xi, si: mamba_block(p, xi, cfg, routes, si,
                                                    step=True), x, state)
    route = routes.get("mamba2_ssd", viscosity.SW)
    h = L.norm(p["ln1"], x, eps=cfg.norm_eps)
    return x + mamba_mod.mamba2_block(p["mix"], h, cfg, route=route,
                                      state=state, step=step)


def init_rwkv_block(gen, n, cfg: ModelConfig, dtype, device):
    """``n`` stacked RWKV-6 layers: pre-norms, time-mix and channel-mix
    (both under ``tm``, as in the reference)."""
    return {"ln1": L.init_norm(cfg.d_model, dtype, device, lead=(n,)),
            "tm": rwkv_mod.init_rwkv6(gen, n, cfg, dtype, device),
            "ln2": L.init_norm(cfg.d_model, dtype, device, lead=(n,))}


def rwkv_block(p, x, cfg: ModelConfig, routes, state=None, step=False):
    """Returns x after one RWKV-6 layer.  ``state`` (views of the layer's
    token shifts and WKV state) is written in place by a prefill and by a
    decode step; decode runs each slot on its own."""
    if step and x.shape[0] > 1:
        return _per_slot(lambda xi, si: rwkv_block(p, xi, cfg, routes, si,
                                                   step=True), x, state)
    route = routes.get("rwkv6_wkv", viscosity.SW)
    h = L.norm(p["ln1"], x, eps=cfg.norm_eps)
    x = x + rwkv_mod.time_mix(p["tm"], h, cfg, route=route, state=state,
                              step=step)
    h = L.norm(p["ln2"], x, eps=cfg.norm_eps)
    return x + rwkv_mod.channel_mix(p["tm"], h, state=state)
