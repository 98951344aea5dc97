"""Mamba2 (SSD) block: in_proj -> causal depthwise conv -> SSD -> gated out.

Port of the reference's ``models/mamba2.py``.  The SSD core routes through
the Viscosity ``mamba2_ssd`` stage.  Decode state per layer: conv tail
(B, K-1, conv_dim) + SSM state (B, H, N, P) f32, written in place.

The prefill's final SSM state follows the route.  On the HW target it is
the one the kernel's state pass ends with (the reference recomputes it with
the plain ``ssd_chunked``; the port does not run the plain version on the
card's main path); on SW it is the one the oracle's scan ends with; every
other target (INTERPRET, the DEGRADED rungs, whose lanes are partly the
oracle's) takes it from ``ssd_chunked``, as the reference does.

Under the tensor-parallel runtime (``launch/spmd.py``) a rank holds the
block of every packed leaf that ``partition.shard_tree`` gives it (1/m of
z, x, B, C and dt; of the conv's x, B and C) and 1/m of the heads: the
depthwise conv runs on its channels (exact per channel; its tail is the
rank's ``conv`` cache shard), B and C are gathered (one group: every head
reads all of both), the SSD runs on the rank's heads, the gated norm over
the whole ``d_inner`` sums its squares over the ``ssm`` axis, and
``out_proj``'s rows end in a partial sum.  The serving cache cuts the
state over the ``attn`` axis (``spmd.state_axes``), which a variant may
set apart from the ``ssm`` one (``attn2d`` cuts the params finer, the
``ep`` variants coarser): ``to_params_cut`` moves a layer's state, every
slot at once, to the params' cut before the step and ``to_cache_cut``
moves the new one back after it.  The conv tail is packed (x, B, C), so
each component moves on its own.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import viscosity
from repro_torch.core.routing import state_from_lowering
from repro_torch.kernels.mamba2_scan import ops as ssd_ops
from repro_torch.kernels.mamba2_scan import ref as ssd_ref
from repro_torch.launch import partition, spmd
from repro_torch.launch.sharding import constrain
from repro_torch.models.layers import _he, rms_norm_simple


def dims(cfg):
    d_inner = cfg.ssm.expand * cfg.d_model
    nheads = d_inner // cfg.ssm.head_dim
    conv_dim = d_inner + 2 * cfg.ssm.state_dim
    return d_inner, nheads, conv_dim


def init_mamba2(gen, L, cfg, dtype, device):
    """``L`` stacked layers of Mamba2 params, the reference's keys and
    initialisers; A_log, D and dt_bias are f32 whatever ``dtype``."""
    d = cfg.d_model
    N = cfg.ssm.state_dim
    d_inner, nheads, conv_dim = dims(cfg)
    proj_out = 2 * d_inner + 2 * N + nheads        # z, x, B, C, dt
    f32 = dict(dtype=torch.float32, device=device)
    u = torch.rand((L, nheads), generator=gen, **f32)
    lo, hi = torch.log(torch.tensor(1e-3)), torch.log(torch.tensor(1e-1))
    dt0 = torch.exp(lo + (hi - lo) * u)
    return {
        "in_proj": _he(gen, (L, d, proj_out), d, dtype, device),
        "conv_w": (torch.randn((L, cfg.ssm.conv_kernel, conv_dim),
                               generator=gen, **f32) * 0.1).to(dtype),
        "conv_b": torch.zeros((L, conv_dim), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads, **f32)
                           ).expand(L, nheads).clone(),
        "D": torch.ones((L, nheads), **f32),
        "dt_bias": torch.log(torch.expm1(dt0)),
        "out_proj": _he(gen, (L, d_inner, d), d_inner, dtype, device),
        "norm_scale": torch.ones((L, d_inner), dtype=dtype, device=device),
    }


def _split(cfg, proj, m=1):
    """in_proj output -> (z, xBC, dt_raw); ``m``: the ranks the columns
    are cut over (a rank's block holds 1/m of each)."""
    d_inner, nheads, conv_dim = dims(cfg)
    return torch.split(proj, [d_inner // m, conv_dim // m, nheads // m],
                       dim=-1)


def _causal_conv(xbc, w, b, *, tail=None):
    """Depthwise causal conv along seq.  xbc (B,S,C); w (K,C).

    ``tail`` (B, K-1, C): previous tokens (decode); else zero history.
    Returns (y (B,S,C), new_tail (B,K-1,C))."""
    B, S, C = xbc.shape
    K = w.shape[0]
    hist = tail if tail is not None else xbc.new_zeros((B, K - 1, C))
    xx = torch.cat([hist.to(xbc.dtype), xbc], dim=1)
    y = torch.zeros((B, S, C), dtype=torch.float32, device=xbc.device)
    for i in range(K):  # K static and tiny (4)
        y = y + xx[:, i:i + S].float() * w[i].float()
    y = F.silu(y + b.float()).to(xbc.dtype)
    return y, xx[:, -(K - 1):]


def mamba2_block(p, x, cfg, *, route=viscosity.SW, state=None, step=False):
    """x (B,S,D) -> (B,S,D).  ``state`` = {"conv": (B,K-1,conv_dim), "ssm":
    (B,H,N,P)}, views into the cache that the prefill (``step`` False) and
    the single-token decode (``step``) overwrite in place."""
    B, S, _ = x.shape
    d_inner, nheads, conv_dim = dims(cfg)
    N = cfg.ssm.state_dim
    P = cfg.ssm.head_dim
    ax = spmd.leaf_axis("in_proj", (cfg.d_model, d_inner + conv_dim
                                    + nheads), -1)
    m = spmd.axis_ranks(ax)
    proj = spmd.replicate_over(x, ax) @ p["in_proj"].to(x.dtype)
    z, xbc, dt_raw = _split(cfg, proj, m)
    xbc = constrain(xbc, "batch", "seq", "ssm_inner")
    tail = state["conv"] if state is not None else None
    xbc, new_tail = _causal_conv(xbc, p["conv_w"], p["conv_b"], tail=tail)
    xs, B_, C_ = torch.split(xbc, [d_inner // m, N // m, N // m], dim=-1)
    if ax is not None:
        # every local head reads all of B and C (one group)
        bc = spmd.gather_over(torch.stack([B_, C_]), ax, -1)
        bc = spmd.replicate_over(bc, ax)
        B_, C_ = bc[0], bc[1]
    xs = xs.reshape(B, S, nheads // m, P)
    dt = F.softplus(dt_raw.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"])

    if step:
        y, new_ssm = ssd_ref.ssd_step(state["ssm"], xs[:, 0], dt[:, 0], A,
                                      B_[:, 0], C_[:, 0])
        y = y[:, None]
    elif state is not None and state_from_lowering(route):
        y, new_ssm = ssd_ops.ssd(xs, dt, A, B_, C_, route=route,
                                 chunk=cfg.ssm.chunk, with_state=True)
    else:
        y = ssd_ops.ssd(xs, dt, A, B_, C_, route=route, chunk=cfg.ssm.chunk)
        if state is not None:
            _, new_ssm = ssd_ref.ssd_chunked(xs, dt, A, B_, C_,
                                             chunk=cfg.ssm.chunk)
    if state is not None:
        state["conv"].copy_(new_tail)
        state["ssm"].copy_(new_ssm)
    y = y + xs.float() * p["D"][None, None, :, None]
    y = y.reshape(B, S, d_inner // m).to(x.dtype)
    if ax is None:
        y = rms_norm_simple(y * F.silu(z), eps=cfg.norm_eps) * \
            p["norm_scale"].to(x.dtype)
        return constrain(y @ p["out_proj"].to(x.dtype), "batch", "seq",
                         "embed")
    # the gated norm over all of d_inner: the squares summed over the axis
    g = (y * F.silu(z)).float()
    ss = spmd.reduce_over(g.square().sum(-1, keepdim=True), ax)
    ss = spmd.replicate_over(ss, ax)
    y = (g * torch.rsqrt(ss / d_inner + cfg.norm_eps)).to(x.dtype) * \
        spmd.scatter_over(p["norm_scale"], ax, -1).to(x.dtype)
    out = spmd.reduce_over(y @ p["out_proj"].to(x.dtype), ax)
    return constrain(out, "batch", "seq", "embed")


def _move(state, cfg, to_params: bool):
    """Each leaf of a layer's state moved between the cache's cut and the
    params' (``spmd.reshard``; the conv tail by component): the leaf
    itself where the two cuts agree."""
    moves = spmd.state_axes(cfg)
    parts = tuple(w for _, w in partition.packed_layout(cfg)["conv"])
    out = {}
    for name, t in state.items():
        dim, cache_ax, param_ax = moves.get(name, (0, None, None))
        have, want = ((cache_ax, param_ax) if to_params
                      else (param_ax, cache_ax))
        out[name] = spmd.reshard(t, dim, have, want,
                                 parts if name == "conv" else None)
    return out


def to_params_cut(state, cfg):
    """A layer's state views (cut as the cache is) -> the state at the
    params' cut, ``state`` itself where nothing moves (always outside
    ``spmd``)."""
    moved = _move(state, cfg, to_params=True)
    return state if all(moved[k] is state[k] for k in state) else moved


def to_cache_cut(work, state, cfg):
    """Write ``work`` (``to_params_cut``'s result, which the step updated)
    back into the cache views ``state``, moved to the cache's cut."""
    if work is state:
        return
    for name, t in _move(work, cfg, to_params=False).items():
        state[name].copy_(t)


def init_mamba2_state(L, B, cfg, dtype, device):
    """Stacked per-layer decode state: conv (L,B,K-1,conv_dim) in
    ``dtype``, ssm (L,B,H,N,P) f32."""
    _, nheads, conv_dim = dims(cfg)
    return {
        "conv": torch.zeros((L, B, cfg.ssm.conv_kernel - 1, conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((L, B, nheads, cfg.ssm.state_dim,
                            cfg.ssm.head_dim), dtype=torch.float32,
                           device=device),
    }
