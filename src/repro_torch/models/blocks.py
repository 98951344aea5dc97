"""Decoder blocks: attention + FFN (a gated MLP for the dense family and
the hybrid family's shared block, the MoE FFN for the MoE family),
Mamba2, RWKV-6.

Port of the reference's ``models/blocks.py`` (``LayerMeta``,
``make_metas``, ``attn_block``, ``init_mamba_block``, ``mamba_block``,
``init_rwkv_block``, ``rwkv_block``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import viscosity
from repro_torch.configs.base import ATTN_LOCAL, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models import moe as moe_mod
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

# the op remat_policy="collectives" saves (models/stack.py remat)
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


def init_attn_layers(gen, n, cfg: ModelConfig, dtype, norm_dtype, device):
    """``n`` stacked attention blocks: pre-norms (scales in
    ``norm_dtype``), attention, and the gated MLP or (``cfg.moe``) the MoE
    FFN; with ``cfg.post_norms`` the post-norms too, which draw nothing
    (ones), so the generator's order is the same either way."""
    p = {"ln1": L.init_norm(cfg.d_model, norm_dtype, device, lead=(n,)),
         "attn": attn_mod.init_attention(
             gen, n, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
             cfg.resolved_head_dim, dtype, device, qkv_bias=cfg.qkv_bias,
             qk_norm=cfg.qk_norm),
         "ln2": L.init_norm(cfg.d_model, norm_dtype, device, lead=(n,))}
    if cfg.moe is not None:
        p["moe"] = moe_mod.init_moe(gen, n, cfg.d_model, cfg.d_ff,
                                    cfg.moe.num_experts, dtype, device,
                                    shared=cfg.moe.shared_expert)
    else:
        p["mlp"] = L.init_mlp(gen, n, cfg.d_model, cfg.d_ff, dtype, device)
    if cfg.post_norms:
        for name in ("post_ln1", "post_ln2"):
            p[name] = L.init_norm(cfg.d_model, norm_dtype, device, lead=(n,))
    return p


def attn_block(p, x, cfg: ModelConfig, meta: LayerMeta, ropes, routes,
               cache=None, layer=None, t=None, tpos=None, step=False):
    """Returns (x after one block, aux): ``aux`` holds the MoE FFN's
    metrics (``aux_loss``, ``z_loss``, ``drop_frac``) of a prefill or
    train forward, and is None for a gated MLP and in decode.  ``ropes``
    is {"global", "local"} -> (cos, sin) at the positions of ``x``; a
    layer with ``meta.local`` (gemma3's local theta) takes "local", in
    prefill and in decode.  Prefill
    (``cache`` given, ``step`` False) writes the layer's KV into
    ``cache``; decode (``step``) reads and writes it, per slot.  With
    ``cfg.post_norms`` the attention and FFN outputs are normed before
    each residual add (per slot in decode, as the pre-norms are)."""
    route_attn = routes.get("flash_attention", viscosity.SW)
    route_mlp = routes.get("swiglu_mlp", viscosity.SW)
    kw = dict(n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
              head_dim=cfg.resolved_head_dim, window=meta.window,
              softcap=cfg.attn_softcap, scale=cfg.attn_scale)
    cos, sin = ropes["local" if meta.local else "global"]
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
            attn_mod.cache_write_prefill(cache, layer, k, v,
                                         n_kv=cfg.num_kv_heads)
        else:
            attn_out = res
    attn_out = _post_norm(p, "post_ln1", attn_out, cfg, step)
    # tagged so remat_policy="collectives" keeps the block's output
    x = x + checkpoint_name(attn_out, "attn_out", cfg)
    if step:
        h = L.per_row(lambda r: L.norm(p["ln2"], r, eps=cfg.norm_eps), x)
    else:
        h = L.norm(p["ln2"], x, eps=cfg.norm_eps)
    aux = None
    if cfg.moe is not None:
        def moe(r):
            return moe_mod.moe_ffn(p["moe"], r, top_k=cfg.moe.top_k,
                                   capacity_factor=cfg.moe.capacity_factor,
                                   act=cfg.mlp_act,
                                   combine_first=cfg.moe.combine_first,
                                   d_ff=cfg.d_ff,
                                   n_experts=cfg.moe.num_experts)
        if step:
            # each slot is its own dispatch group (S = 1, C = top_k), as
            # the reference's vmapped B=1 decode sees it
            ffn_out = L.per_row(lambda r: moe(r)[0], h)
        else:
            ffn_out, aux = moe(h)
    else:
        ffn_out = L.mlp(p["mlp"], h, act=cfg.mlp_act, route=route_mlp,
                        row_independent=step, d_ff=cfg.d_ff)
    ffn_out = _post_norm(p, "post_ln2", ffn_out, cfg, step)
    return x + checkpoint_name(ffn_out, "ffn_out", cfg), aux


def _post_norm(p, name, y, cfg: ModelConfig, step):
    """``y`` through the block's post-norm ``name`` (gemma2), if it has
    one; per slot in decode."""
    if not cfg.post_norms:
        return y
    if step:
        return L.per_row(lambda r: L.norm(p[name], r, eps=cfg.norm_eps), y)
    return L.norm(p[name], y, eps=cfg.norm_eps)


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
    so batched decode equals single-request decode bit for bit.  Under
    ``spmd`` a state cut otherwise than the params is moved to their cut
    before the layer and back after it, every slot at once."""
    if state is None:
        return _mamba_layer(p, x, cfg, routes, None, step)
    work = mamba_mod.to_params_cut(state, cfg)
    y = _mamba_layer(p, x, cfg, routes, work, step)
    mamba_mod.to_cache_cut(work, state, cfg)
    return y


def _mamba_layer(p, x, cfg: ModelConfig, routes, state, step):
    if step and x.shape[0] > 1:
        return _per_slot(lambda xi, si: _mamba_layer(p, xi, cfg, routes, si,
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
    return x + rwkv_mod.channel_mix(p["tm"], h, state=state, d_ff=cfg.d_ff)
