"""Decoder-only LM of the dense, hybrid and SSM families: train forward
(loss), prefill, decode, caches.

Port of the reference's ``models/transformer.py``.  Params are a nested
dict with the reference's keys and its stacked (L, ...) layer layout, so
slicing a layer is a free view; the reference's ``lax.scan`` over layer
groups is a Python loop.  The hybrid family (Zamba2) is a Mamba2 backbone
with one shared (tied) attention+MLP block applied after every
``shared_attn_every`` Mamba2 layers; the SSM family (RWKV-6) is a stack of
attention-free RWKV-6 layers.  Other families (MoE, VLM, audio) and the
variants these slices do not need (windows, softcaps, post-norms,
LayerNorm, qk-norm) raise ``NotImplementedError``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Sequence, Tuple, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ATTN_GLOBAL, MAMBA2, RWKV6, ModelConfig
from repro_torch.core.routing import as_routes
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models import rope as rope_mod
from repro_torch.models import rwkv6 as rwkv_mod

PyTree = Any
# Subtrees and leaves that keep the param dtype in ``compute_params``: the
# norm scales (the norms compute in f32), the Mamba2 scalars and conv, and
# the RWKV-6 decay params and bonus, which the reference reads in f32 and
# never casts to the compute dtype.
_KEEP_DTYPE = ("ln1", "ln2", "final_norm", "A_log", "D", "dt_bias",
               "conv_w", "conv_b", "w0", "w_lora_a", "w_lora_b", "u")
_PATTERN = {"dense": ATTN_GLOBAL, "hybrid": MAMBA2, "ssm": RWKV6}


def _unsupported(cfg: ModelConfig):
    if cfg.family not in _PATTERN:
        return f"family {cfg.family!r}"
    for flag in ("window", "attn_softcap", "final_softcap", "post_norms",
                 "use_layernorm", "qk_norm", "embed_scale", "mrope_sections",
                 "stub_frontend", "is_encdec"):
        if getattr(cfg, flag):
            return f"{flag}={getattr(cfg, flag)!r}"
    if set(cfg.layer_pattern or (ATTN_GLOBAL,)) != {_PATTERN[cfg.family]}:
        return f"layer_pattern={cfg.layer_pattern!r}"
    if cfg.family == "hybrid" and not cfg.shared_attn_every:
        return "shared_attn_every=0"
    # the SSM family's MLP is RWKV-6's own channel-mix, never gated
    if not cfg.gated_mlp and cfg.family != "ssm":
        return "gated_mlp=False"
    return None


def _tree_map(fn, tree):
    """``fn`` applied to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked (L, ...) param tree (views, no copies)."""
    return _tree_map(lambda a: a[i], tree)


def _unstack(tree, n: int):
    """The ``n`` layers of a stacked (L, ...) param tree, as views.  One
    ``unbind`` a leaf: its backward stacks the layers' grads once, where
    indexing each layer would scatter each layer's grad into a zero
    tensor of the whole stack (L times the stack's bytes a step)."""
    per = _tree_map(lambda a: a.unbind(0), tree)
    return [_tree_map(lambda t: t[i], per) for i in range(n)]


def _remat(cfg: ModelConfig, body, x: torch.Tensor):
    """Activation checkpointing of a layer (group) body, the reference's
    ``remat_wrap``, when autograd records ``x`` (serving, whose params
    never require grad, runs the body as it is).  ``full`` recomputes
    everything in the backward; ``dots`` saves the matmul outputs without
    batch dims (``mm``/``addmm``, as JAX's
    ``dots_with_no_batch_dims_saveable``); ``collectives`` saves the
    attention and MLP block outputs (``blocks.checkpoint_name``)."""
    if not (cfg.remat and cfg.remat_policy != "none"
            and torch.is_grad_enabled() and x.requires_grad):
        return body
    saved = {"dots": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default),
             "collectives": (B.CHECKPOINT_NAME,)}.get(cfg.remat_policy)
    kw = {}
    if saved is not None:
        def policy(ctx, op, *args, **kwargs):
            return (CheckpointPolicy.MUST_SAVE if op in saved
                    else CheckpointPolicy.PREFER_RECOMPUTE)
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)
    elif cfg.remat_policy != "full":
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")

    def wrapped(*args):
        return checkpoint(body, *args, use_reentrant=False, **kw)
    return wrapped


def compute_params(params: PyTree, dtype: torch.dtype,
                   device=None) -> PyTree:
    """Weights, biases and tables cast once to the compute dtype (and
    moved to ``device`` when given); the ``_KEEP_DTYPE`` subtrees keep the
    param dtype.  The reference casts each weight on every call
    (``astype`` in the layers); the cast is deterministic, so casting once
    gives the same values.  Leaves already in ``dtype`` are shared, not
    copied."""
    def walk(tree, keep):
        if isinstance(tree, dict):
            return {k: walk(v, keep or k in _KEEP_DTYPE)
                    for k, v in tree.items()}
        return tree.to(device=device, dtype=tree.dtype if keep else dtype)
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
                "dense qwen1.5-4b, hybrid zamba2-1.2b and ssm rwkv6-1.6b "
                "paths; see ROADMAP queue 1 item 12)")
        self.cfg = cfg
        self.routes = as_routes(routes)
        if cfg.family == "hybrid":
            self.meta = B.LayerMeta(kind=ATTN_GLOBAL, window=0,
                                    theta=cfg.rope_theta, local=False)
            self.n_groups = cfg.num_layers // cfg.shared_attn_every
            self.n_tail = cfg.num_layers % cfg.shared_attn_every
        else:
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

        def attn_layers(n):
            return {
                "ln1": L.init_norm(cfg.d_model, dt, dev, lead=(n,)),
                "attn": attn_mod.init_attention(
                    gen, n, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim, dt, dev, qkv_bias=cfg.qkv_bias),
                "ln2": L.init_norm(cfg.d_model, dt, dev, lead=(n,)),
                "mlp": L.init_mlp(gen, n, cfg.d_model, cfg.d_ff, dt, dev),
            }
        params = {
            "embed": L.init_embed(gen, cfg.vocab_size, cfg.d_model, dt, dev),
            "final_norm": L.init_norm(cfg.d_model, dt, dev),
        }
        if cfg.family == "hybrid":
            params["layers"] = B.init_mamba_block(gen, n, cfg, dt, dev)
            params["shared"] = _layer(attn_layers(1), 0)
        elif cfg.family == "ssm":
            params["layers"] = B.init_rwkv_block(gen, n, cfg, dt, dev)
        else:
            params["layers"] = attn_layers(n)
        if not cfg.tie_embeddings:
            params["lm_head"] = L.init_lm_head(gen, cfg.d_model,
                                               cfg.vocab_size, dt, dev)
        return params

    def init_cache(self, Bt: int, max_len: int, device=None) -> PyTree:
        """Dense: the KV cache of every layer.  Hybrid: {"mamba": conv
        tails and SSM states of every Mamba2 layer, "attn": the KV cache of
        each shared-block application}.  SSM: the token shifts and WKV
        states of every RWKV-6 layer (no KV; ``max_len`` is unused).  Every
        leaf has the slot axis at dim 1."""
        cfg = self.cfg
        dev = resolve_device(device)
        if cfg.family == "ssm":
            return rwkv_mod.init_rwkv6_state(cfg.num_layers, Bt, cfg,
                                             self.compute_dtype, dev)
        n_kv = self.n_groups if cfg.family == "hybrid" else cfg.num_layers
        kv = attn_mod.init_kv_cache(
            n_kv, Bt, max_len, cfg.num_kv_heads, cfg.resolved_head_dim,
            self.compute_dtype, dev)
        if cfg.family != "hybrid":
            return kv
        return {"mamba": mamba_mod.init_mamba2_state(
            cfg.num_layers, Bt, cfg, self.compute_dtype, dev), "attn": kv}

    @staticmethod
    def cache_lane(cache: PyTree, i: int) -> PyTree:
        """Slot ``i``'s lane of a cache: views (slot axis kept, size 1) of
        every leaf, which a prefill writes in place."""
        return _tree_map(lambda c: c[:, i:i + 1], cache)

    @staticmethod
    def clear_lane(lane: PyTree) -> PyTree:
        """Empty a lane in place for a new sequence: KV and SSM state
        zeroed, KV positions -1 (nothing written)."""
        def clear(tree):
            for k, v in tree.items():
                if isinstance(v, dict):
                    clear(v)
                elif k == "pos":
                    v.fill_(-1)
                else:
                    v.zero_()
        clear(lane)
        return lane

    # --------------------------------------------------------- backbone
    def _rope(self, positions):
        """cos/sin tables for ``positions`` (one theta: no local layers);
        None for the attention-free SSM family."""
        if self.cfg.attn_free:
            return None
        return rope_mod.rope_tables(positions, self.cfg.resolved_head_dim,
                                    self.cfg.rope_theta)

    def _embed_in(self, params, tokens):
        return L.embed(params["embed"], tokens,
                       compute_dtype=self.compute_dtype)

    def _logits(self, params, h):
        h = L.norm(params["final_norm"], h, eps=self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            return L.logits_from_embed(params["embed"]["table"], h)
        return L.lm_head(params["lm_head"], h)

    def _run_layers(self, params, x, rope, cache=None, t=None, tpos=None,
                    step=False):
        """Every layer over ``x``; under autograd each layer is one remat
        body (``_remat``), as each pattern group is in the reference."""
        cfg = self.cfg
        if cfg.family == "hybrid":
            return self._run_hybrid(params, x, rope, cache, t, tpos, step)
        layers = _unstack(params["layers"], cfg.num_layers)
        for i, p in enumerate(layers):
            if cfg.family == "ssm":
                state = (None if cache is None else
                         {k: v[i] for k, v in cache.items()})

                def body(x, p=p, state=state):
                    return B.rwkv_block(p, x, cfg, self.routes, state=state,
                                        step=step)
            else:
                def body(x, p=p, i=i):
                    return B.attn_block(p, x, cfg, self.meta, rope,
                                        self.routes, cache=cache, layer=i,
                                        t=t, tpos=tpos, step=step)
            x = _remat(cfg, body, x)(x)
        return x

    def _run_hybrid(self, params, x, rope, cache, t, tpos, step):
        """Zamba2: groups of ``shared_attn_every`` Mamba2 layers, each
        followed by the shared block (its KV in cache layer ``g``), then
        the tail of ``num_layers % shared_attn_every`` Mamba2 layers."""
        cfg = self.cfg
        per = cfg.shared_attn_every
        layers = _unstack(params["layers"], cfg.num_layers)

        def mamba(li, x):
            state = (None if cache is None else
                     {k: v[li] for k, v in cache["mamba"].items()})
            return B.mamba_block(layers[li], x, cfg, self.routes,
                                 state=state, step=step)

        def group(x, g):
            for j in range(per):
                x = mamba(g * per + j, x)
            return B.attn_block(params["shared"], x, cfg, self.meta, rope,
                                self.routes,
                                cache=None if cache is None else cache["attn"],
                                layer=g, t=t, tpos=tpos, step=step)
        for g in range(self.n_groups):      # the reference's remat'd scan
            x = _remat(cfg, functools.partial(group, g=g), x)(x)
        for j in range(self.n_tail):        # its unrolled tail: no remat
            x = mamba(self.n_groups * per + j, x)
        return x

    # ----------------------------------------------------------- modes
    def forward(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """Training forward: returns (loss, metrics).  Differentiable on
        the SW route only: every other lowering refuses to run under
        autograd (the kernels have no backward, as in the reference)."""
        cfg = self.cfg
        x = self._embed_in(params, batch["tokens"])
        Bt, S = x.shape[:2]
        x = self._run_layers(params, x, self._rope(
            rope_mod.positions_default(Bt, S, x.device)))
        h = L.norm(params["final_norm"], x, eps=cfg.norm_eps)
        tied = cfg.tie_embeddings
        w = params["embed"]["table"] if tied else params["lm_head"]["w"]
        loss, denom = L.chunked_xent(
            h, batch["targets"], w, tied=tied, chunk=cfg.loss_chunk,
            mask=batch.get("loss_mask"))
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
