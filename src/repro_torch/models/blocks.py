"""Decoder block of the dense family: attention + gated MLP.

Port of the reference's ``models/blocks.py`` (``LayerMeta``,
``make_metas``, ``attn_block``); the MoE, RWKV6 and Mamba2 blocks wait for
their slices.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch import viscosity
from repro_torch.configs.base import ATTN_LOCAL, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L


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
    x = x + attn_out
    if step:
        h = L.per_row(lambda r: L.norm(p["ln2"], r, eps=cfg.norm_eps), x)
    else:
        h = L.norm(p["ln2"], x, eps=cfg.norm_eps)
    return x + L.mlp(p["mlp"], h, act=cfg.mlp_act, route=route_mlp,
                     row_independent=step)
