"""Stacked (L, ...) param trees and per-layer activation checkpointing,
shared by the decoder-only ``LMModel`` and the encoder-decoder
``EncDecModel``."""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import spmd
from repro_torch.models.blocks import CHECKPOINT_NAME


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def layer(tree, i: int):
    """Layer ``i`` of a stacked (L, ...) param tree (views, no copies)."""
    return tree_map(lambda a: a[i], tree)


def unstack(tree, n: int):
    """The ``n`` layers of a stacked (L, ...) param tree, as views.  One
    ``unbind`` a leaf: its backward stacks the layers' grads once, where
    indexing each layer would scatter each layer's grad into a zero
    tensor of the whole stack (L times the stack's bytes a step)."""
    per = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda t: t[i], per) for i in range(n)]


def remat(cfg: ModelConfig, body, x: torch.Tensor):
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
             "collectives": (CHECKPOINT_NAME,)}.get(cfg.remat_policy)
    kw = {}
    if saved is not None:
        def policy(ctx, op, *args, **kwargs):
            return (CheckpointPolicy.MUST_SAVE if op in saved
                    else CheckpointPolicy.PREFER_RECOMPUTE)
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)
    elif cfg.remat_policy != "full":
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")

    # the recompute runs in the backward, on the card on autograd's device
    # thread: it re-enters the forward's tensor-parallel context
    body = spmd.bound(body)

    def wrapped(*args):
        return checkpoint(body, *args, use_reentrant=False, **kw)
    return wrapped
