"""Whisper-style encoder-decoder backbone (the conv frontend is a stub).

Port of the reference's ``models/encdec.py``.  The inputs are precomputed
frame embeddings (B, S_enc, D) in place of the mel/conv frontend.  The
encoder: sinusoidal positions and bidirectional attention.  The decoder:
learned positions, causal self-attention without rope, cross-attention
over the encoder output, LayerNorm and plain (ungated) GELU MLPs; the
logits come from the tied embedding table.

Params are the reference's tree: ``enc`` and ``dec`` stacked with a
leading layer axis, ``embed``, ``dec_pos``, ``enc_norm`` and ``dec_norm``.
Every attention call routes through the Viscosity ``flash_attention`` op
as the reference's does: the encoder's, the decoder's prefill
self-attention and every cross-attention, a decode step's too (it carries
no position, so its HW route is the kernel at ``Sq = 1``); a decode step's
self-attention is the plain ``attention_naive`` over the KV cache, as in
the reference.  Serving is ``prefill`` (the encoder, the per-layer cross-KV
cache and the decoder prompt) then ``decode_step`` with a scalar position.
"""
from __future__ import annotations

from typing import Any, Union

import torch

from repro_torch import viscosity
from repro_torch.configs.base import ModelConfig
from repro_torch.core.routing import as_routes
from repro_torch.device import resolve_device
from repro_torch.launch import spmd
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers as L
from repro_torch.models import stack

PyTree = Any


def _sinusoid(S: int, D: int, device) -> torch.Tensor:
    """(S, D) f32: [sin, cos] halves, as the reference's."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(D // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10_000.0, device=device), 2 * dim / D)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EncDecModel:
    """Functional model: all methods take params explicitly.  ``routes``
    as ``LMModel``'s; only ``flash_attention`` is read."""

    def __init__(self, cfg: ModelConfig, routes=None):
        if not cfg.is_encdec:
            raise ValueError(f"{cfg.name} is not an encoder-decoder config; "
                             "use LMModel")
        self.cfg = cfg
        self.routes = as_routes(routes)
        self.compute_dtype = getattr(torch, cfg.dtype)
        self.param_dtype = getattr(torch, cfg.param_dtype)

    def _attn_kw(self):
        cfg = self.cfg
        return dict(n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
                    head_dim=cfg.resolved_head_dim)

    def _route(self):
        return self.routes.get("flash_attention", viscosity.SW)

    def _norm(self, p, x):
        return L.norm(p, x, eps=self.cfg.norm_eps, layernorm=True)

    def _mlp(self, p, x):
        return L.mlp(p, x, act="gelu_plain", d_ff=self.cfg.d_ff)

    # ------------------------------------------------------------- init
    def init(self, seed: Union[int, torch.Generator] = 0,
             device=None) -> PyTree:
        """Random params from a seed (or a generator on ``device``), in the
        param dtype."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator(device=dev).manual_seed(int(seed))
        dt, d, hd = self.param_dtype, cfg.d_model, cfg.resolved_head_dim
        Le, Ld = cfg.enc_layers, cfg.dec_layers

        def norm(n):
            return L.init_norm(d, dt, dev, lead=(n,), layernorm=True)

        def attn(n):
            return attn_mod.init_attention(gen, n, d, cfg.num_heads,
                                           cfg.num_kv_heads, hd, dt, dev,
                                           qkv_bias=True)

        def mlp(n):
            return L.init_mlp(gen, n, d, cfg.d_ff, dt, dev, gated=False)
        enc = {"ln1": norm(Le), "attn": attn(Le), "ln2": norm(Le),
               "mlp": mlp(Le)}
        dec = {"ln1": norm(Ld), "self_attn": attn(Ld), "ln_x": norm(Ld),
               "cross_attn": attn(Ld), "ln2": norm(Ld), "mlp": mlp(Ld)}
        params = {
            "embed": L.init_embed(gen, cfg.vocab_size, d, dt, dev),
            "dec_pos": (torch.randn((cfg.max_target_len, d), generator=gen,
                                    device=dev) * 0.01).to(dt),
            "enc": enc,
            "dec": dec,
            "enc_norm": L.init_norm(d, dt, dev, layernorm=True),
            "dec_norm": L.init_norm(d, dt, dev, layernorm=True),
        }
        return params

    # ---------------------------------------------------------- encoder
    def encode(self, params, enc_embeds: torch.Tensor) -> torch.Tensor:
        """(B, S_enc, D) frame embeddings -> the normed encoder output."""
        cfg = self.cfg
        x = enc_embeds.to(self.compute_dtype)
        x = x + _sinusoid(x.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
        route = self._route()
        for i in range(cfg.enc_layers):
            p = stack.layer(params["enc"], i)

            def body(x, p=p):
                h = self._norm(p["ln1"], x)
                x = x + attn_mod.attn_full(p["attn"], h, None, None,
                                           causal=False, route=route,
                                           **self._attn_kw())
                h = self._norm(p["ln2"], x)
                return x + self._mlp(p["mlp"], h)
            x = stack.remat(cfg, body, x)(x)
        return self._norm(params["enc_norm"], x)

    # ---------------------------------------------------------- decoder
    def _dec_layer(self, p, x, enc_out, *, cache=None, layer=None, t=None,
                   tpos=None, step=False, cross=None):
        route = self._route()
        kw = self._attn_kw()
        h = self._norm(p["ln1"], x)
        if step:
            a = attn_mod.attn_decode(p["self_attn"], h, cache, layer, t,
                                     tpos, None, None, **kw)
        else:
            res = attn_mod.attn_full(p["self_attn"], h, None, None,
                                     causal=True, route=route,
                                     kv_out=cache is not None, **kw)
            if cache is not None:
                a, (k, v) = res
                attn_mod.cache_write_prefill(cache, layer, k, v,
                                             n_kv=kw["n_kv"])
            else:
                a = res
        x = x + a
        h = self._norm(p["ln_x"], x)
        # cross-attention over the encoder output (no positions,
        # bidirectional); serving passes the layer's cross-KV of prefill
        x = x + attn_mod.attn_full(
            p["cross_attn"], h, None, None, causal=False, route=route,
            cross_kv=None if cross is not None else enc_out,
            precomputed_kv=cross, **kw)
        h = self._norm(p["ln2"], x)
        return x + self._mlp(p["mlp"], h)

    def cross_kv_cache(self, params, enc_out: torch.Tensor):
        """Per decoder layer, the cross-attention's keys and values of
        ``enc_out``, computed once at prefill: (k, v), each (L, B, S_enc,
        Hkv, Dh); under ``spmd`` the rank's kv heads."""
        cfg = self.cfg
        sh = spmd.AttnShard.of(cfg.num_heads, cfg.num_kv_heads,
                               cfg.resolved_head_dim)
        kvs = [attn_mod.project_kv(
                   stack.layer(params["dec"], i)["cross_attn"], enc_out,
                   cfg.num_kv_heads, cfg.resolved_head_dim, sh)
               for i in range(cfg.dec_layers)]
        return (torch.stack([k for k, _ in kvs]),
                torch.stack([v for _, v in kvs]))

    def decode(self, params, enc_out, dec_tokens, *, caches=None, t=None,
               step=False, cross=None):
        """The decoder over ``dec_tokens`` (B, T): teacher-forced (``enc_out``
        given), a prompt that writes ``caches`` (in place), or one decode
        step at the scalar position ``t`` (``step``).  ``cross``: the
        ``cross_kv_cache`` to attend over instead of ``enc_out``.  Returns
        (the normed hidden states, ``caches``)."""
        cfg = self.cfg
        x = L.embed(params["embed"], dec_tokens,
                    compute_dtype=self.compute_dtype, vocab=cfg.vocab_size)
        tl = tpos = None
        if step:
            x = x + params["dec_pos"][t][None, None].to(x.dtype)
            tl = [int(t)] * x.shape[0]
            tpos = torch.full((x.shape[0],), int(t), dtype=torch.int32,
                              device=x.device)
        else:
            x = x + params["dec_pos"][None, :x.shape[1]].to(x.dtype)
        for i in range(cfg.dec_layers):
            p = stack.layer(params["dec"], i)
            ckv = None if cross is None else (cross[0][i], cross[1][i])

            def body(x, p=p, i=i, ckv=ckv):
                return self._dec_layer(p, x, enc_out, cache=caches, layer=i,
                                       t=tl, tpos=tpos, step=step, cross=ckv)
            x = body(x) if step or caches is not None else \
                stack.remat(cfg, body, x)(x)
        return self._norm(params["dec_norm"], x), caches

    def _logits(self, params, h):
        return L.logits_from_embed(params["embed"]["table"], h,
                                   vocab=self.cfg.vocab_size)

    # ------------------------------------------------------------ modes
    def forward(self, params, batch):
        """Training forward: (loss, metrics) of ``batch["dec_targets"]``
        given ``batch["embeds"]`` and ``batch["dec_tokens"]``."""
        enc_out = self.encode(params, batch["embeds"])
        h, _ = self.decode(params, enc_out, batch["dec_tokens"])
        loss, denom = L.chunked_xent(
            h, batch["dec_targets"], params["embed"]["table"], tied=True,
            chunk=self.cfg.loss_chunk, mask=batch.get("loss_mask"),
            vocab=self.cfg.vocab_size)
        return loss, {"xent": loss, "tokens": denom, "loss": loss}

    def logits_all(self, params, batch) -> torch.Tensor:
        """Full (B, T, V) teacher-forced logits (tests / tiny models)."""
        enc_out = self.encode(params, batch["embeds"])
        h, _ = self.decode(params, enc_out, batch["dec_tokens"])
        return self._logits(params, h)

    def init_cache(self, Bt: int, max_len: int, device=None) -> PyTree:
        """The decoder self-attention's KV cache of every layer, stacked:
        ``min(max_len, max_target_len)`` slots."""
        cfg = self.cfg
        return attn_mod.init_kv_cache(
            cfg.dec_layers, Bt, min(max_len, cfg.max_target_len),
            cfg.num_kv_heads, cfg.resolved_head_dim, self.compute_dtype,
            resolve_device(device))

    def prefill(self, params, batch):
        """Encode ``batch["embeds"]`` and run the decoder prompt
        ``batch["dec_tokens"]``, writing ``batch["cache"]`` in place.
        Returns (last-token logits, state): state = {"cross": the
        per-layer cross-KV, "self": the self-attention caches}."""
        enc_out = self.encode(params, batch["embeds"])
        cross = self.cross_kv_cache(params, enc_out)
        h, caches = self.decode(params, enc_out, batch["dec_tokens"],
                                caches=batch["cache"], cross=cross)
        return self._logits(params, h[:, -1:]), {"cross": cross,
                                                 "self": caches}

    def decode_step(self, params, state, tokens, t: int):
        """One token: tokens (B, 1), ``t`` the scalar absolute position of
        every row.  The self-attention cache is written in place."""
        h, caches = self.decode(params, None, tokens, caches=state["self"],
                                t=int(t), step=True, cross=state["cross"])
        return self._logits(params, h), {"cross": state["cross"],
                                         "self": caches}
