"""Capacity-based top-k MoE with group-local gather/scatter dispatch.

Port of the reference's ``models/moe.py`` (``init_moe``, ``moe_ffn``).
Tokens keep their (B, S) grouping: each row of the batch is one dispatch
group, and a token's position within its expert's capacity buffer comes
from a cumsum over the group's (B, S, E) assignment, so no (tokens, E, C)
one-hot tensor is built.  Tokens past an expert's capacity are dropped:
they write no slot, and their gate is zero.

The expert products are plain PyTorch (``einsum``), as the reference's are
plain ``jnp.einsum``: no Pallas kernel computes them there, so none is
ported here.  Params are stacked over layers, (L, ...) for each leaf; the
router is float32 whatever the dtype, and its logits are computed from
``x`` in float32.

Losses: the switch-style load-balance aux loss and the router z-loss.

Under the tensor-parallel runtime (``launch/spmd.py``) the router's
columns may be sharded (its logits are gathered), each expert runs on
the rank's d_ff slice (and, with an expert axis, only the rank's
experts), and the combined output is summed over those axes once, after
the gates are folded in; the load statistics are averaged over the batch
axes.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.launch import spmd
from repro_torch.launch.sharding import constrain
from repro_torch.models.layers import _he


# what each call's router probabilities go to (``observe_router``)
_ROUTER_OBSERVERS = []


@contextlib.contextmanager
def observe_router(fn):
    """Within the body, ``fn(probs)`` sees each ``moe_ffn`` call's router
    probabilities, the float32 (B, S, E) softmax (gathered over the
    router's column axis under ``spmd``), in call order."""
    _ROUTER_OBSERVERS.append(fn)
    try:
        yield
    finally:
        _ROUTER_OBSERVERS.remove(fn)


def init_moe(gen, L, d, f, num_experts, dtype, device, *, shared=False):
    """``L`` stacked MoE FFNs: router (L, d, E) in float32, experts
    (L, E, d, f) / (L, E, f, d), and the always-on ``shared`` expert."""
    E = num_experts
    p = {
        "router": _he(gen, (L, d, E), d, torch.float32, device),
        "w1": _he(gen, (L, E, d, f), d, dtype, device),
        "w3": _he(gen, (L, E, d, f), d, dtype, device),
        "w2": _he(gen, (L, E, f, d), f, dtype, device),
    }
    if shared:
        p["shared"] = {"w1": _he(gen, (L, d, f), d, dtype, device),
                       "w3": _he(gen, (L, d, f), d, dtype, device),
                       "w2": _he(gen, (L, f, d), f, dtype, device)}
    return p


def capacity(S: int, top_k: int, capacity_factor: float,
             num_experts: int) -> int:
    """Slots per expert and group, the reference's formula in Python
    (``round`` takes half to even) from the group's unpadded length."""
    C = int(max(top_k, round(S * top_k * capacity_factor / num_experts)))
    return min(C, S * top_k)


def _act(h, act: str):
    return F.silu(h) if act == "silu" else F.gelu(h, approximate="tanh")


def _top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest, ties to the lower index (a stable
    descending sort keeps equal values in index order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_ffn(p, x, *, top_k: int, capacity_factor: float, act: str = "silu",
            combine_first: bool = False, d_ff=None, n_experts=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, D) -> (y (B, S, D), {"aux_loss", "z_loss", "drop_frac"}).

    ``combine_first`` gathers the experts' hidden states back to token
    order and folds the gates in before the second product, as the
    reference's option does.  ``d_ff`` and ``n_experts`` (the global
    sizes) say, under ``spmd``, what is sharded."""
    B, S, D = x.shape
    E_loc = p["w1"].shape[0]
    E = n_experts or p["router"].shape[1]
    r_ax = spmd.param_axis("ffn", E)      # the router's columns
    f_ax = spmd.ffn_axis(d_ff) if d_ff else None
    e_ax = spmd.expert_axis(E)
    e0 = spmd.axis_offset(e_ax, E_loc)
    part = spmd.join_axes(f_ax, e_ax)     # the routed output's partial axes
    C = capacity(S, top_k, capacity_factor, E)
    dev = x.device

    logits = spmd.replicate_over(x, r_ax).float() @ p["router"]   # (B,S,E)
    logits = spmd.gather_over(logits, r_ax, -1)
    probs = torch.softmax(logits, dim=-1)
    for fn in _ROUTER_OBSERVERS:
        fn(probs)
    gate_vals, gate_idx = _top_k(probs, top_k)                  # (B,S,K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # position of token s within expert e's buffer: tokens before s that
    # chose e, plus this token's earlier choices of e
    assign = F.one_hot(gate_idx, E)                             # (B,S,K,E)
    assign_se = assign.sum(2)                                   # (B,S,E)
    cum = torch.cumsum(assign_se, 1) - assign_se
    pos_k = torch.gather(cum, 2, gate_idx)
    intra = torch.cumsum(assign, 2) - assign
    pos_k = pos_k + torch.gather(intra, 3, gate_idx[..., None])[..., 0]
    keep = pos_k < C                                            # capacity
    gate_vals = gate_vals * keep.to(gate_vals.dtype)

    # the (B, E, C) slot table: a kept (s, k) writes s; dropped ones write
    # column C of a (B, E, C + 1) table, which is cut off (a static-shape
    # scatter, as the reference's mode="drop"); empty slots keep S, which
    # reads a zero row below.  Kept slots are unique, so the order of the
    # writes does not matter
    slot_tok = torch.full((B, E, C + 1), S, dtype=torch.long, device=dev)
    b_idx = torch.arange(B, device=dev)[:, None, None].expand(B, S, top_k)
    s_idx = torch.arange(S, device=dev)[None, :, None].expand(B, S, top_k)
    slot_tok[b_idx, gate_idx, torch.where(keep, pos_k, C)] = s_idx
    slot_tok = slot_tok[:, e0:e0 + E_loc, :C]
    xr = spmd.replicate_over(x, part)
    x_pad = torch.cat([xr, xr.new_zeros((B, 1, D))], dim=1)
    rows = torch.arange(B, device=dev)[:, None]
    xe = x_pad[rows, slot_tok.reshape(B, E_loc * C)].reshape(
        B, E_loc, C, D)
    xe = constrain(xe, "batch", "experts", "expert_cap", "embed")

    h1 = torch.einsum("becd,edf->becf", xe, p["w1"].to(xe.dtype))
    h3 = torch.einsum("becd,edf->becf", xe, p["w3"].to(xe.dtype))
    h = constrain(_act(h1, act) * h3, "batch", "experts", "expert_cap",
                  "mlp")
    gates = spmd.replicate_over(gate_vals, part)
    local = gate_idx
    if e_ax is not None:
        # the rank's experts: a choice of another rank's expert reads row
        # 0 of this rank's table and weighs it 0
        local = gate_idx - e0
        gates = gates * ((local >= 0) & (local < E_loc)).to(gates.dtype)
        local = local.clamp(0, E_loc - 1)
    gidx = local * C + torch.clamp(pos_k, 0, C - 1)             # (B,S,K)
    gather_rows = gidx.reshape(B, S * top_k)
    if combine_first:
        Fh = h.shape[-1]
        hk = h.reshape(B, E_loc * C, Fh)[rows, gather_rows].reshape(
            B, S, top_k, Fh)
        onehot_g = F.one_hot(local, E_loc).to(hk.dtype) * \
            gates[..., None].to(hk.dtype)                       # (B,S,K,E)
        Gm = torch.einsum("bske,bskf->bsef", onehot_g, hk)
        y = torch.einsum("bsef,efd->bsd", Gm, p["w2"].to(hk.dtype))
    else:
        ye = torch.einsum("becf,efd->becd", h, p["w2"].to(xe.dtype))
        ye = constrain(ye, "batch", "experts", "expert_cap", "embed")
        yk = ye.reshape(B, E_loc * C, D)[rows, gather_rows].reshape(
            B, S, top_k, D)
        y = (yk * gates[..., None].to(yk.dtype)).sum(2)

    if "shared" in p:
        sh = p["shared"]
        xs = spmd.replicate_over(x, f_ax)
        g = _act(xs @ sh["w1"].to(x.dtype), act) * \
            (xs @ sh["w3"].to(x.dtype))
        y_sh = g @ sh["w2"].to(x.dtype)
        if e_ax is None:
            y = y + y_sh
        else:                   # partial over the FFN axis only
            y = spmd.reduce_over(y, part) + spmd.reduce_over(y_sh, f_ax)
            part = None
    y = spmd.reduce_over(y, part)

    me = spmd.mean_over_batch(probs.mean((0, 1)))               # (E,)
    fe = spmd.mean_over_batch(F.one_hot(gate_idx[..., 0], E).float()
                              .mean((0, 1)))
    aux = E * (me * fe).sum()
    z = spmd.mean_over_batch(torch.logsumexp(logits, dim=-1).square()
                             .mean())
    dropped = 1.0 - spmd.mean_over_batch(keep.float().mean())
    y = constrain(y.to(x.dtype), "batch", "seq", "embed")
    return y, {"aux_loss": aux, "z_loss": z, "drop_frac": dropped}
