"""Decoder-only LM of the dense family: train forward (loss), prefill,
decode, caches.

Port of the reference's ``models/transformer.py``.  Params are a nested
dict with the reference's keys and its stacked (L, ...) layer layout, so
slicing a layer is a free view; the reference's ``lax.scan`` over layer
groups is a Python loop.  Families other than dense (MoE, hybrid, SSM,
VLM, audio) and the dense variants this slice does not need (windows,
softcaps, post-norms, LayerNorm, qk-norm, tied embeddings) raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple, Union

import torch

from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig
from repro_torch.core.routing import as_routes
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import rope as rope_mod

PyTree = Any
_NORMS = ("ln1", "ln2", "final_norm")


def _unsupported(cfg: ModelConfig):
    if cfg.family != "dense":
        return f"family {cfg.family!r}"
    for flag in ("window", "attn_softcap", "final_softcap", "post_norms",
                 "use_layernorm", "qk_norm", "embed_scale", "mrope_sections",
                 "stub_frontend", "is_encdec", "tie_embeddings"):
        if getattr(cfg, flag):
            return f"{flag}={getattr(cfg, flag)!r}"
    if set(cfg.layer_pattern or (ATTN_GLOBAL,)) != {ATTN_GLOBAL}:
        return f"layer_pattern={cfg.layer_pattern!r}"
    if not cfg.gated_mlp:
        return "gated_mlp=False"
    return None


def _layer(tree, i: int):
    """Layer ``i`` of a stacked (L, ...) param tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def compute_params(params: PyTree, dtype: torch.dtype,
                   device=None) -> PyTree:
    """Weights, biases and tables cast once to the compute dtype (and
    moved to ``device`` when given); norm scales keep the param dtype (the
    norms compute in f32).  The
    reference casts each weight on every call (``astype`` in the layers);
    the cast is deterministic, so casting once gives the same values.
    Leaves already in ``dtype`` are shared, not copied."""
    def walk(tree, under_norm):
        if isinstance(tree, dict):
            return {k: walk(v, under_norm or k in _NORMS)
                    for k, v in tree.items()}
        return tree.to(device=device, dtype=tree.dtype if under_norm
                       else dtype)
    return walk(params, False)


class LMModel:
    """Functional model: all methods take params explicitly.

    ``routes`` is the RoutingPlan (stage -> lowering target), or a mapping
    of ResidentRoute handles for the resident engine."""

    def __init__(self, cfg: ModelConfig, routes=None):
        why = _unsupported(cfg)
        if why is not None:
            raise NotImplementedError(
                f"{cfg.name}: {why} is not ported yet (the port covers the "
                "dense qwen1.5-4b path; see ROADMAP queue 1 item 12)")
        self.cfg = cfg
        self.routes = as_routes(routes)
        self.meta = B.make_metas(cfg)[0]
        self.compute_dtype = getattr(torch, cfg.dtype)
        self.param_dtype = getattr(torch, cfg.param_dtype)

    # ------------------------------------------------------------- init
    def init(self, seed: Union[int, torch.Generator] = 0,
             device=None) -> PyTree:
        """Random params from a seed (or a generator on ``device``)."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator(device=dev).manual_seed(int(seed))
        dt, n = self.param_dtype, cfg.num_layers
        hd = cfg.resolved_head_dim
        return {
            "embed": L.init_embed(gen, cfg.vocab_size, cfg.d_model, dt, dev),
            "final_norm": L.init_norm(cfg.d_model, dt, dev),
            "layers": {
                "ln1": L.init_norm(cfg.d_model, dt, dev, lead=(n,)),
                "attn": attn_mod.init_attention(
                    gen, n, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, hd,
                    dt, dev, qkv_bias=cfg.qkv_bias),
                "ln2": L.init_norm(cfg.d_model, dt, dev, lead=(n,)),
                "mlp": L.init_mlp(gen, n, cfg.d_model, cfg.d_ff, dt, dev),
            },
            "lm_head": L.init_lm_head(gen, cfg.d_model, cfg.vocab_size, dt,
                                      dev),
        }

    def init_cache(self, Bt: int, max_len: int, device=None) -> PyTree:
        cfg = self.cfg
        return attn_mod.init_kv_cache(
            cfg.num_layers, Bt, max_len, cfg.num_kv_heads,
            cfg.resolved_head_dim, self.compute_dtype,
            resolve_device(device))

    # --------------------------------------------------------- backbone
    def _rope(self, positions):
        """cos/sin tables for ``positions`` (one theta: no local layers)."""
        return rope_mod.rope_tables(positions, self.cfg.resolved_head_dim,
                                    self.cfg.rope_theta)

    def _embed_in(self, params, tokens):
        return L.embed(params["embed"], tokens,
                       compute_dtype=self.compute_dtype)

    def _logits(self, params, h):
        h = L.norm(params["final_norm"], h, eps=self.cfg.norm_eps)
        return L.lm_head(params["lm_head"], h)

    def _run_layers(self, params, x, rope, cache=None, t=None, tpos=None,
                    step=False):
        for i in range(self.cfg.num_layers):
            x = B.attn_block(_layer(params["layers"], i), x, self.cfg,
                             self.meta, rope, self.routes, cache=cache,
                             layer=i, t=t, tpos=tpos, step=step)
        return x

    # ----------------------------------------------------------- modes
    def forward(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """Training forward: returns (loss, metrics).  Forward only: the
        kernels have no backward, as in the reference."""
        cfg = self.cfg
        x = self._embed_in(params, batch["tokens"])
        Bt, S = x.shape[:2]
        x = self._run_layers(params, x, self._rope(
            rope_mod.positions_default(Bt, S, x.device)))
        h = L.norm(params["final_norm"], x, eps=cfg.norm_eps)
        loss, denom = L.chunked_xent(
            h, batch["targets"], params["lm_head"]["w"], tied=False,
            chunk=cfg.loss_chunk, mask=batch.get("loss_mask"))
        return loss, {"xent": loss, "tokens": denom, "loss": loss}

    def logits_all(self, params, batch) -> torch.Tensor:
        """Full (B, S, V) teacher-forced logits (tests / tiny models)."""
        x = self._embed_in(params, batch["tokens"])
        Bt, S = x.shape[:2]
        x = self._run_layers(params, x, self._rope(
            rope_mod.positions_default(Bt, S, x.device)))
        return self._logits(params, x)

    def prefill(self, params, batch) -> Tuple[torch.Tensor, PyTree]:
        """Run the prompt; returns (last-token logits, cache).  The cache
        in ``batch['cache']`` (allocated to the serving max length) is
        written in place."""
        x = self._embed_in(params, batch["tokens"])
        Bt, S = x.shape[:2]
        cache = batch["cache"]
        x = self._run_layers(params, x, self._rope(
            rope_mod.positions_default(Bt, S, x.device)), cache=cache)
        return self._logits(params, x[:, -1:]), cache

    def decode_step(self, params, cache, tokens,
                    t: Union[int, Sequence[int]]
                    ) -> Tuple[torch.Tensor, PyTree]:
        """One token per slot: tokens (B, 1); ``t`` the per-slot absolute
        positions (host ints; an int applies to every slot).  The cache is
        written in place.  Every plain op runs per slot, so each slot's
        logits equal a B=1 decode's bit for bit; a HW SwiGLU stage takes
        all slots in one kernel launch (its rows are independent by
        construction)."""
        Bt = tokens.shape[0]
        t = [int(t)] * Bt if isinstance(t, int) else [int(v) for v in t]
        if len(t) != Bt:
            raise ValueError(f"{len(t)} positions for {Bt} slots")
        x = self._embed_in(params, tokens)
        tpos = torch.tensor(t, dtype=torch.int32, device=x.device)
        x = self._run_layers(params, x, self._rope(tpos[:, None]),
                             cache=cache, t=t, tpos=tpos, step=True)
        return L.per_row(lambda r: self._logits(params, r), x), cache
