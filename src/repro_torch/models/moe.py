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
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _he


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
            combine_first: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, D) -> (y (B, S, D), {"aux_loss", "z_loss", "drop_frac"}).

    ``combine_first`` gathers the experts' hidden states back to token
    order and folds the gates in before the second product, as the
    reference's option does."""
    B, S, D = x.shape
    E = p["router"].shape[1]
    C = capacity(S, top_k, capacity_factor, E)
    dev = x.device

    logits = x.float() @ p["router"]                            # (B,S,E)
    probs = torch.softmax(logits, dim=-1)
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
    slot_tok = slot_tok[..., :C]
    x_pad = torch.cat([x, x.new_zeros((B, 1, D))], dim=1)
    rows = torch.arange(B, device=dev)[:, None]
    xe = x_pad[rows, slot_tok.reshape(B, E * C)].reshape(B, E, C, D)

    h1 = torch.einsum("becd,edf->becf", xe, p["w1"].to(xe.dtype))
    h3 = torch.einsum("becd,edf->becf", xe, p["w3"].to(xe.dtype))
    h = _act(h1, act) * h3
    gidx = gate_idx * C + torch.clamp(pos_k, 0, C - 1)          # (B,S,K)
    gather_rows = gidx.reshape(B, S * top_k)
    if combine_first:
        Fh = h.shape[-1]
        hk = h.reshape(B, E * C, Fh)[rows, gather_rows].reshape(
            B, S, top_k, Fh)
        onehot_g = F.one_hot(gate_idx, E).to(hk.dtype) * \
            gate_vals[..., None].to(hk.dtype)                   # (B,S,K,E)
        Gm = torch.einsum("bske,bskf->bsef", onehot_g, hk)
        y = torch.einsum("bsef,efd->bsd", Gm, p["w2"].to(hk.dtype))
    else:
        ye = torch.einsum("becf,efd->becd", h, p["w2"].to(xe.dtype))
        yk = ye.reshape(B, E * C, D)[rows, gather_rows].reshape(
            B, S, top_k, D)
        y = (yk * gate_vals[..., None].to(yk.dtype)).sum(2)

    if "shared" in p:
        sh = p["shared"]
        g = _act(x @ sh["w1"].to(x.dtype), act) * (x @ sh["w3"].to(x.dtype))
        y = y + g @ sh["w2"].to(x.dtype)

    me = probs.mean((0, 1))                                     # (E,)
    fe = F.one_hot(gate_idx[..., 0], E).float().mean((0, 1))
    aux = E * (me * fe).sum()
    z = torch.logsumexp(logits, dim=-1).square().mean()
    dropped = 1.0 - keep.float().mean()
    return y.to(x.dtype), {"aux_loss": aux, "z_loss": z,
                           "drop_frac": dropped}
