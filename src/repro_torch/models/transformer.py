"""Decoder-only LM of the dense, MoE, VLM, hybrid and SSM families: train
forward (loss), prefill, decode, caches.

Port of the reference's ``models/transformer.py``.  Params are a nested
dict with the reference's keys and its stacked (L, ...) layer layout, so
slicing a layer is a free view; the reference's ``lax.scan`` over layer
groups is a Python loop, and layer ``i`` takes pattern position ``i %
len(pattern)`` (the reference's groups, then its tail).  The MoE family
is uniform attention blocks, all global or all windowed (sliding-window
layers keep a ring-buffer KV cache of ``window`` slots); MoE blocks
replace the gated MLP with ``models/moe.py``'s FFN, whose aux losses join
the training loss.  The dense family may also alternate local (windowed)
and global layers, as gemma2-2b does, with the attention and final
softcaps, post-norms and the sqrt(d) embedding scale.  The hybrid family
(Zamba2) is a Mamba2 backbone with one shared (tied) attention+MLP block
applied after every ``shared_attn_every`` Mamba2 layers; the SSM family
(RWKV-6) is a stack of attention-free RWKV-6 layers.  gemma3-1b adds
qk-norm and a second rope theta for its local layers (five local to one
global, a two-layer tail at 26 layers); the VLM family (qwen2-vl) is
uniform global attention with M-RoPE over (t, h, w) positions, whose stub
frontend hands in precomputed embeddings (``batch["embeds"]``,
``batch["positions3"]``) in place of tokens.  The audio family (whisper)
is ``models/encdec.py``'s; LayerNorm in a decoder-only model raises
``NotImplementedError``.
"""
from __future__ import annotations

import functools
import hashlib
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.configs.base import (ATTN_GLOBAL, ATTN_LOCAL, MAMBA2, RWKV6,
                                     ModelConfig)
from repro_torch.core.routing import as_routes
from repro_torch.device import resolve_device
from repro_torch.launch import partition, spmd
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as mamba_mod
from repro_torch.models import rope as rope_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models import stack

PyTree = Any
# Subtrees and leaves that keep the param dtype in ``compute_params``: the
# norms' scales and biases (the norms compute in f32; whisper's ``ln_x``,
# ``enc_norm`` and ``dec_norm`` too), the MoE router (its logits are
# f32), the Mamba2 scalars and conv, and the RWKV-6 decay params and bonus,
# which the reference reads in f32 and never casts to the compute dtype.
_KEEP_DTYPE = ("ln1", "ln2", "post_ln1", "post_ln2", "final_norm", "router",
               "A_log", "D", "dt_bias", "conv_w", "conv_b", "w0", "w_lora_a",
               "w_lora_b", "u", "ln_x", "enc_norm", "dec_norm")
_PATTERN = {"dense": ATTN_GLOBAL, "moe": ATTN_GLOBAL, "vlm": ATTN_GLOBAL,
            "hybrid": MAMBA2, "ssm": RWKV6}


def _unsupported(cfg: ModelConfig):
    if cfg.family not in _PATTERN:
        return f"family {cfg.family!r}"
    for flag in ("use_layernorm", "is_encdec"):
        if getattr(cfg, flag):
            return f"{flag}={getattr(cfg, flag)!r}"
    kinds = set(cfg.layer_pattern or (ATTN_GLOBAL,))
    if (kinds == {ATTN_LOCAL} and _PATTERN[cfg.family] == ATTN_GLOBAL
            or kinds == {ATTN_LOCAL, ATTN_GLOBAL} and cfg.family == "dense"):
        if not cfg.window:          # windowed layers: a ring cache
            return "window=0 with local layers"
    elif kinds != {_PATTERN[cfg.family]}:
        return f"layer_pattern={cfg.layer_pattern!r}"
    elif cfg.window:
        return f"window={cfg.window!r}"
    if cfg.family == "hybrid" and not cfg.shared_attn_every:
        return "shared_attn_every=0"
    # the SSM family's MLP is RWKV-6's own channel-mix, never gated
    if not cfg.gated_mlp and cfg.family != "ssm":
        return "gated_mlp=False"
    return None


def key_seed(seed: int, key: str) -> int:
    """The seed of draw ``key`` under ``seed`` (``LMModel.init_keyed``): 63
    bits of the SHA-256 of both, the same in every process."""
    digest = hashlib.sha256(f"{int(seed)}/{key}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


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
                f"{cfg.name}: {why} is not a decoder-only model of the "
                "dense, MoE, VLM, hybrid or SSM family (encoder-decoder "
                "models are models/encdec.py's EncDecModel)")
        self.cfg = cfg
        self.routes = as_routes(routes)
        if cfg.family == "hybrid":
            self.metas = (B.LayerMeta(kind=ATTN_GLOBAL, window=0,
                                      theta=cfg.rope_theta, local=False),)
            self.n_groups = cfg.num_layers // cfg.shared_attn_every
            self.n_tail = cfg.num_layers % cfg.shared_attn_every
        else:
            self.metas = tuple(B.make_metas(cfg))
        self._kv_at = self._kv_layout()
        self.compute_dtype = getattr(torch, cfg.dtype)
        self.param_dtype = getattr(torch, cfg.param_dtype)

    # ------------------------------------------------------------- init
    def init(self, seed: Union[int, torch.Generator] = 0, device=None,
             dtype: Optional[torch.dtype] = None) -> PyTree:
        """Random params from a seed (or a generator on ``device``).

        ``dtype`` (a compute dtype, e.g. ``torch.bfloat16``) gives the
        tree ``compute_params(init(seed), dtype)`` bit for bit without the
        param-dtype tree: the dense and MoE families draw each leaf in the
        param dtype, from the same generator in the same order, and cast
        it at once (the ``_KEEP_DTYPE`` leaves stay in the param dtype),
        so the peak is the cast tree plus one leaf.  The hybrid and SSM
        families (at most 1.6 B params) init in the param dtype and
        cast."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = seed if isinstance(seed, torch.Generator) else \
            torch.Generator(device=dev).manual_seed(int(seed))
        pdt, n = self.param_dtype, cfg.num_layers
        if dtype is not None and cfg.family in ("hybrid", "ssm"):
            return compute_params(self.init(gen, dev), dtype)
        dt = pdt if dtype is None else dtype
        params = {
            "embed": L.init_embed(gen, cfg.vocab_size, cfg.d_model, dt, dev),
            "final_norm": L.init_norm(cfg.d_model, pdt, dev),
        }
        if cfg.family == "hybrid":
            params["layers"] = B.init_mamba_block(gen, n, cfg, dt, dev)
            params["shared"] = stack.layer(B.init_attn_layers(gen, 1, cfg, dt,
                                                         pdt, dev), 0)
        elif cfg.family == "ssm":
            params["layers"] = B.init_rwkv_block(gen, n, cfg, dt, dev)
        else:
            params["layers"] = B.init_attn_layers(gen, n, cfg, dt, pdt,
                                                  dev)
        if not cfg.tie_embeddings:
            params["lm_head"] = L.init_lm_head(gen, cfg.d_model,
                                               cfg.vocab_size, dt, dev)
        return params

    def init_keyed(self, seed: int = 0, device=None,
                   dtype: Optional[torch.dtype] = None,
                   cut: Optional[Callable[[str, torch.Tensor],
                                          torch.Tensor]] = None) -> PyTree:
        """Random params from a draw keyed by (seed, leaf, layer), which a
        rank of a mesh makes for its own block alone.

        Layer ``l`` of the stacked leaves is drawn by a generator on
        ``device`` seeded from (``seed``, l) (``key_seed``) through
        ``init_attn_layers(gen, 1, ...)``; the embedding and the head each
        from a key of their own, whole.  ``cut(path, t)`` (default: the
        whole ``t``) returns the block kept of leaf ``path`` ("layers/moe/
        w1"), given one layer of it (its stacked dim 1) or the whole
        unstacked leaf: a drawn weight is cut in float32 as it is drawn,
        then cast to ``dtype`` as ``init(dtype=...)`` casts it.  So layer
        ``l`` is the same at every depth, a rank's tree equals its slice
        of the whole draw bit for bit, and the peak is the kept tree plus
        one layer's leaf in float32 and its block.  Its bits are not
        ``init``'s.  The attention families (dense, MoE, VLM) only."""
        cfg = self.cfg
        if cfg.family not in ("dense", "moe", "vlm"):
            raise NotImplementedError(
                f"{cfg.name}: the keyed draw covers the dense, MoE and VLM "
                f"families, not {cfg.family!r}")
        dev = resolve_device(device)
        pdt, n = self.param_dtype, cfg.num_layers
        dt = pdt if dtype is None else dtype

        def gen(key):
            return torch.Generator(device=dev).manual_seed(key_seed(seed,
                                                                    key))

        def own(path, t):
            # the kept block, holding its own memory
            b = t if cut is None else cut(path, t)
            return b if b is t else b.clone(
                memory_format=torch.contiguous_format)

        params = {"embed": {"table": own("embed/table", L.init_embed(
            gen("embed"), cfg.vocab_size, cfg.d_model, dt, dev)["table"])},
            "final_norm": partition.map_with_path(
                L.init_norm(cfg.d_model, pdt, dev),
                lambda path, t: own("final_norm/" + path, t))}
        if not cfg.tie_embeddings:
            with L.draw_hook(lambda t: own("lm_head/w", t)):
                params["lm_head"] = L.init_lm_head(
                    gen("lm_head"), cfg.d_model, cfg.vocab_size, dt, dev)
        # which leaf each draw of a layer is: the draw order on meta
        # (float32 everywhere, so each drawn tensor is its leaf)
        order = []
        with L.draw_hook(lambda t: order.append(t) or t):
            meta = B.init_attn_layers(torch.Generator().manual_seed(0), 1,
                                      cfg, torch.float32, torch.float32,
                                      torch.device("meta"))
        where = {id(t): path for path, t in partition.flatten(meta).items()}
        drawn = [where[id(t)] for t in order]
        stacked: Dict[str, torch.Tensor] = {}

        def put(li):
            def copy(path, t):
                if path not in drawn:       # ones and zeros: cut whole
                    t = own("layers/" + path, t)
                if path not in stacked:
                    stacked[path] = torch.empty(
                        (n,) + tuple(t.shape[1:]), dtype=t.dtype,
                        device=dev)
                stacked[path][li].copy_(t[0])
            return copy
        layer = None
        for li in range(n):
            paths = iter(drawn)
            with L.draw_hook(lambda t: own("layers/" + next(paths), t)):
                layer = B.init_attn_layers(gen(f"layers/{li}"), 1, cfg, dt,
                                           pdt, dev)
            # copied into the stacks; the layer keeps its structure alone
            # (no block) while the next one is drawn
            layer = partition.map_with_path(layer, put(li))
        params["layers"] = partition.map_with_path(
            layer, lambda path, _: stacked[path])
        return params

    def _kv_layout(self):
        """Per attention layer, where its KV lives: (None, i) in the one
        stacked cache of a model whose layers are all of one kind, else
        ("local" or "global", its index among the layers of its kind)."""
        cfg = self.cfg
        if cfg.family in ("ssm", "hybrid"):   # no KV, or the shared block's
            return ()
        kinds = [self.metas[i % len(self.metas)].kind
                 for i in range(cfg.num_layers)]
        if len(set(kinds)) == 1:
            return tuple((None, i) for i in range(cfg.num_layers))
        names = ["local" if k == ATTN_LOCAL else "global" for k in kinds]
        return tuple((n, names[:i].count(n)) for i, n in enumerate(names))

    def init_cache(self, Bt: int, max_len: int, device=None) -> PyTree:
        """Dense and MoE: the KV cache of every layer, of
        ``min(max_len, window)`` slots for windowed layers (a ring buffer)
        and ``max_len`` for global ones, as the reference's ``smax_for``:
        one stacked {"k", "v", "pos"} when the layers are all of one kind,
        else {"local": the local layers', "global": the global layers'}
        (``_kv_layout``).  Hybrid: {"mamba": conv tails and SSM states of
        every Mamba2 layer, "attn": the KV cache of each shared-block
        application}.  SSM: the token shifts and WKV states of every
        RWKV-6 layer (no KV; ``max_len`` is unused).  Every leaf has the
        slot axis at dim 1."""
        cfg = self.cfg
        dev = resolve_device(device)
        if cfg.family == "ssm":
            return rwkv_mod.init_rwkv6_state(cfg.num_layers, Bt, cfg,
                                             self.compute_dtype, dev)

        def kv(n, window):
            return attn_mod.init_kv_cache(
                n, Bt, min(max_len, window) if window else max_len,
                cfg.num_kv_heads, cfg.resolved_head_dim, self.compute_dtype,
                dev)
        if cfg.family == "hybrid":
            return {"mamba": mamba_mod.init_mamba2_state(
                cfg.num_layers, Bt, cfg, self.compute_dtype, dev),
                "attn": kv(self.n_groups, 0)}
        if self._kv_at[0][0] is None:
            return kv(cfg.num_layers, self.metas[0].window)
        return {n: kv(sum(1 for k, _ in self._kv_at if k == n),
                      cfg.window if n == "local" else 0)
                for n in ("local", "global")}

    @staticmethod
    def cache_lane(cache: PyTree, i: int) -> PyTree:
        """Slot ``i``'s lane of a cache: views (slot axis kept, size 1) of
        every leaf, which a prefill writes in place."""
        return stack.tree_map(lambda c: c[:, i:i + 1], cache)

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
    def _ropes(self, positions, positions3=None):
        """{"global", "local"} -> the cos/sin tables at ``positions`` (B,
        S): "local" at ``rope_theta_local`` where the config has one
        (gemma3), else the global tables.  With ``mrope_sections``
        (qwen2-vl) both are the M-RoPE tables at ``positions3`` (B, S, 3),
        the 1-D positions repeated three times where none are given.
        None for the attention-free SSM family."""
        cfg = self.cfg
        if cfg.attn_free:
            return None
        hd = cfg.resolved_head_dim
        if cfg.mrope_sections:
            if positions3 is None:
                positions3 = positions[..., None].expand(
                    *positions.shape, 3)
            cs = rope_mod.mrope_tables(positions3, hd, cfg.rope_theta,
                                       cfg.mrope_sections)
            return {"global": cs, "local": cs}
        ropes = {"global": rope_mod.rope_tables(positions, hd,
                                                cfg.rope_theta)}
        ropes["local"] = (rope_mod.rope_tables(positions, hd,
                                               cfg.rope_theta_local)
                          if cfg.rope_theta_local else ropes["global"])
        return ropes

    def _embed_in(self, params, batch):
        """The input activations: ``batch["embeds"]`` (the stub modality
        frontend's precomputed embeddings) when present, else the embedded
        ``batch["tokens"]``."""
        if "embeds" in batch:
            return batch["embeds"].to(self.compute_dtype)
        return L.embed(params["embed"], batch["tokens"],
                       scale_by_dim=self.cfg.embed_scale,
                       compute_dtype=self.compute_dtype,
                       vocab=self.cfg.vocab_size)

    def _logits(self, params, h):
        cfg = self.cfg
        h = L.norm(params["final_norm"], h, eps=cfg.norm_eps)
        if cfg.tie_embeddings:
            return L.logits_from_embed(params["embed"]["table"], h,
                                       softcap=cfg.final_softcap,
                                       vocab=cfg.vocab_size)
        return L.lm_head(params["lm_head"], h, softcap=cfg.final_softcap,
                         vocab=cfg.vocab_size)

    def _run_layers(self, params, x, ropes, cache=None, t=None, tpos=None,
                    step=False):
        """Every layer over ``x``; returns (x, aux): the MoE metrics summed
        over layers (None without MoE, and in decode).  Under autograd each
        layer is one remat body (``stack.remat``), as each pattern group is in
        the reference."""
        cfg = self.cfg
        spmd.check_runtime(cfg)
        if cfg.family == "hybrid":
            return self._run_hybrid(params, x, ropes, cache, t, tpos,
                                    step), None
        layers = stack.unstack(params["layers"], cfg.num_layers)
        aux = None
        for i, p in enumerate(layers):
            if cfg.family == "ssm":
                state = (None if cache is None else
                         {k: v[i] for k, v in cache.items()})

                def body(x, p=p, state=state):
                    return B.rwkv_block(p, x, cfg, self.routes, state=state,
                                        step=step)
                x = stack.remat(cfg, body, x)(x)
                continue

            name, j = self._kv_at[i]
            kv = cache if cache is None or name is None else cache[name]

            def body(x, p=p, kv=kv, j=j,
                     meta=self.metas[i % len(self.metas)]):
                return B.attn_block(p, x, cfg, meta, ropes, self.routes,
                                    cache=kv, layer=j, t=t, tpos=tpos,
                                    step=step)
            x, aux_i = stack.remat(cfg, body, x)(x)
            if aux_i is not None:
                aux = aux_i if aux is None else {
                    k: aux[k] + aux_i[k] for k in aux}
        return x, aux

    def _run_hybrid(self, params, x, ropes, cache, t, tpos, step):
        """Zamba2: groups of ``shared_attn_every`` Mamba2 layers, each
        followed by the shared block (its KV in cache layer ``g``), then
        the tail of ``num_layers % shared_attn_every`` Mamba2 layers."""
        cfg = self.cfg
        per = cfg.shared_attn_every
        layers = stack.unstack(params["layers"], cfg.num_layers)

        def mamba(li, x):
            state = (None if cache is None else
                     {k: v[li] for k, v in cache["mamba"].items()})
            return B.mamba_block(layers[li], x, cfg, self.routes,
                                 state=state, step=step)

        def group(x, g):
            for j in range(per):
                x = mamba(g * per + j, x)
            return B.attn_block(params["shared"], x, cfg, self.metas[0],
                                ropes, self.routes,
                                cache=None if cache is None else cache["attn"],
                                layer=g, t=t, tpos=tpos, step=step)[0]
        for g in range(self.n_groups):      # the reference's remat'd scan
            x = stack.remat(cfg, functools.partial(group, g=g), x)(x)
        for j in range(self.n_tail):        # its unrolled tail: no remat
            x = mamba(self.n_groups * per + j, x)
        return x

    # ----------------------------------------------------------- modes
    def forward(self, params, batch) -> Tuple[torch.Tensor, Dict]:
        """Training forward: returns (loss, metrics).  Differentiable on
        the SW route only: every other lowering refuses to run under
        autograd (the kernels have no backward, as in the reference)."""
        cfg = self.cfg
        x = self._embed_in(params, batch)
        Bt, S = x.shape[:2]
        x, aux = self._run_layers(params, x, self._ropes(
            rope_mod.positions_default(Bt, S, x.device),
            batch.get("positions3")))
        h = L.norm(params["final_norm"], x, eps=cfg.norm_eps)
        tied = cfg.tie_embeddings
        w = params["embed"]["table"] if tied else params["lm_head"]["w"]
        xent, denom = L.chunked_xent(
            h, batch["targets"], w, tied=tied, softcap=cfg.final_softcap,
            chunk=cfg.loss_chunk, mask=batch.get("loss_mask"),
            vocab=cfg.vocab_size)
        metrics = {"xent": xent, "tokens": denom}
        loss = xent
        if cfg.moe is not None:
            n = max(1, cfg.num_layers)
            loss = loss + cfg.moe.aux_coef * aux["aux_loss"] / n \
                + cfg.moe.router_z_coef * aux["z_loss"] / n
            metrics.update({k: v / n for k, v in aux.items()})
        metrics["loss"] = loss
        return loss, metrics

    def logits_all(self, params, batch) -> torch.Tensor:
        """Full (B, S, V) teacher-forced logits (tests / tiny models)."""
        x = self._embed_in(params, batch)
        Bt, S = x.shape[:2]
        x, _ = self._run_layers(params, x, self._ropes(
            rope_mod.positions_default(Bt, S, x.device),
            batch.get("positions3")))
        return self._logits(params, x)

    def prefill(self, params, batch) -> Tuple[torch.Tensor, PyTree]:
        """Run the prompt; returns (last-token logits, cache).  The cache
        in ``batch['cache']`` (allocated to the serving max length) is
        written in place."""
        x = self._embed_in(params, batch)
        Bt, S = x.shape[:2]
        cache = batch["cache"]
        x, _ = self._run_layers(params, x, self._ropes(
            rope_mod.positions_default(Bt, S, x.device),
            batch.get("positions3")), cache=cache)
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
        x = self._embed_in(params, {"tokens": tokens})
        tpos = torch.tensor(t, dtype=torch.int32, device=x.device)
        # M-RoPE decodes at positions3 = (t, t, t), as the reference does
        # (after an image prefill too)
        x, _ = self._run_layers(params, x, self._ropes(tpos[:, None]),
                                cache=cache, t=t, tpos=tpos, step=True)
        return L.per_row(lambda r: self._logits(params, r), x), cache
