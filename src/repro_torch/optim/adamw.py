"""AdamW + global-norm clipping + warmup-cosine schedule.

Port of the reference's ``optim/adamw.py``.  Optimizer state mirrors the
params (f32 moments whatever the param dtype).  The reference is
functional; here ``update`` works in place under ``torch.no_grad()`` —
the moments and the params are overwritten and the same trees returned,
and the grads serve as the step's scratch — so a full-width model needs
no second copy of its params or moments (qwen1.5-4b: 63 GB of f32
params, grads and moments).  The arithmetic is the reference's, in f32: ``count`` is
incremented before ``schedule``, bias corrections ``1 - b**c``, weight
decay on every leaf, the step computed in f32 and cast to the param
dtype.  Scalars (``count``, ``lr``, the norm) stay on the params' device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.viscosity.lang import tree_leaves, tree_map

PyTree = Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    count: torch.Tensor
    mu: PyTree
    nu: PyTree


def init(params: PyTree) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return AdamWState(count=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.to(torch.float32)
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) /
                       max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree: PyTree) -> torch.Tensor:
    leaves = [x.float() for x in tree_leaves(tree)]
    return torch.stack(torch._foreach_norm(leaves)).square().sum().sqrt()


@torch.no_grad()
def clip_by_global_norm(grads: PyTree, max_norm: float
                        ) -> Tuple[PyTree, torch.Tensor]:
    """Scales f32 ``grads`` in place; returns (grads, norm before)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    torch._foreach_mul_(tree_leaves(grads), scale)
    return grads, norm


@torch.no_grad()
def update(cfg: AdamWConfig, grads: PyTree, state: AdamWState,
           params: PyTree) -> Tuple[PyTree, AdamWState, dict]:
    """One AdamW step in place: ``params`` and the moments are overwritten
    and returned.  f32 ``grads`` are consumed: clipped, then overwritten
    by the step (others are cast first)."""
    grads = tree_map(lambda g: g.to(torch.float32), grads)
    if cfg.clip_norm:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = global_norm(grads)
    count = state.count + 1
    lr = schedule(cfg, count)
    b1, b2 = cfg.b1, cfg.b2
    gs, ms, vs = (tree_leaves(t) for t in (grads, state.mu, state.nu))
    torch._foreach_mul_(ms, b1)
    torch._foreach_add_(ms, gs, alpha=1 - b1)
    torch._foreach_mul_(vs, b2)
    torch._foreach_addcmul_(vs, gs, gs, value=1 - b2)
    c = count.to(torch.float32)
    bc1 = 1 - b1 ** c
    bc2 = 1 - b2 ** c
    # leaf by leaf; the moments hold all the grads carry, so each step is
    # computed in its grad's storage and one leaf-sized temporary suffices
    for p, g, m, v in zip(tree_leaves(params), gs, ms, vs):
        denom = (v / bc2).sqrt_().add_(cfg.eps)
        step = torch.div(m, bc1, out=g).div_(denom)
        del denom
        p32 = p if p.dtype == torch.float32 else p.float()
        step.add_(p32, alpha=cfg.weight_decay).mul_(lr)
        if p32 is p:
            p.sub_(step)
        else:
            p.copy_(p32.sub_(step))
    return params, AdamWState(count, state.mu, state.nu), \
        {"grad_norm": gnorm, "lr": lr}
