"""RWKV-6 "Finch" block: time-mix (WKV with data-dependent decay) and
channel-mix.

Port of the reference's ``models/rwkv6.py``: static token-shift mixes, the
LoRA'd data-dependent decay, the bonus ``u``, the per-head group norm and
the squared-ReLU channel-mix.  The WKV core routes through the Viscosity
``rwkv6_wkv`` stage.  Decode state per layer: ``shift_tm`` and ``shift_cm``
(B, d) in the compute dtype and ``wkv`` (B, H, K, V) f32, written in place.

Decay clamp: lw = -exp(...) clamped to [-4, -1e-4] in f32, then cast to
the compute dtype, so the chunked factorized WKV stays inside f32 range at
chunk 16 (see ``kernels/rwkv6_scan``).

The prefill's final WKV state follows the route, as for Mamba2.  On the HW
target it is the one the kernel's state pass ends with (the reference
recomputes it with the plain ``wkv6_chunked``; the port does not run the
plain version on the card's main path); on SW it is the one the oracle's
scan ends with; every other target (INTERPRET, the DEGRADED rungs, whose
lanes are partly the oracle's) takes it from ``wkv6_chunked``, as the
reference does.

Under the tensor-parallel runtime (``launch/spmd.py``) each leaf is cut
as its spec says: r, k, v, g and ``wo`` on the ``attn`` axis (the rank's
heads); the decay LoRA, ``u`` and the channel-mix on the ``ffn`` axis.
The LoRA's tanh (its columns) is gathered and multiplied by the rank's
columns of ``w_lora_b``, the decay and ``u`` are resharded onto the
heads' axis where the two differ, the replicated ``w0`` and ``ln_scale``
are sliced to the rank's part, ``wo`` and ``cwv`` end in partial sums,
and the channel-mix's column-cut ``r`` is gathered before the product.
The token shifts hold the rank's slice of the last ``x`` (the cache's
cut) and are gathered where a mix reads them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import viscosity
from repro_torch.core.routing import state_from_lowering
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.kernels.rwkv6_scan import ref as wkv_ref
from repro_torch.launch import spmd
from repro_torch.launch.sharding import constrain
from repro_torch.models.layers import _he

LW_MIN = -4.0


def dims(cfg):
    """(heads, head width K = V)."""
    hK = cfg.ssm.rwkv_head_dim
    return cfg.d_model // hK, hK


def init_rwkv6(gen, L, cfg, dtype, device):
    """``L`` stacked layers of RWKV-6 params, the reference's keys and
    initialisers; the decay params (w0, the LoRA) and ``u`` are f32
    whatever ``dtype``."""
    d, f = cfg.d_model, cfg.d_ff
    H, hK = dims(cfg)
    lora = cfg.ssm.rwkv_decay_lora
    f32 = dict(dtype=torch.float32, device=device)

    def half(name):
        return {name: torch.full((L, d), 0.5, dtype=dtype, device=device)}

    p = {}
    for name in ("mix_r", "mix_k", "mix_v", "mix_g", "mix_w"):
        p.update(half(name))
    for name in ("wr", "wk", "wv", "wg", "wo"):
        p[name] = _he(gen, (L, d, d), d, dtype, device)
    p.update({
        "w0": torch.zeros((L, d), **f32),
        "w_lora_a": _he(gen, (L, d, lora), d, torch.float32, device),
        "w_lora_b": torch.randn((L, lora, d), generator=gen, **f32) * 0.01,
        "u": torch.randn((L, H, hK), generator=gen, **f32) * 0.1,
        "ln_scale": torch.ones((L, d), dtype=dtype, device=device),
    })
    for name in ("cmix_r", "cmix_k"):
        p.update(half(name))
    p["cwr"] = _he(gen, (L, d, d), d, dtype, device)
    p["cwk"] = _he(gen, (L, d, f), d, dtype, device)
    p["cwv"] = _he(gen, (L, f, d), f, dtype, device)
    return p


def _shift(x, last=None):
    """Token shift: x_{t-1} (zeros, or ``last`` for t = 0).  x (B,S,D)."""
    if x.shape[1] == 1 and last is not None:
        return last[:, None, :]
    pad = torch.zeros_like(x[:, :1]) if last is None else last[:, None, :]
    return torch.cat([pad.to(x.dtype), x[:, :-1]], dim=1)


def _mix(x, xs, m):
    return x + (xs - x) * m.to(x.dtype)


def _last(state, name, d):
    """The previous token's whole ``x`` from a token-shift cache leaf (the
    rank's slice under ``spmd``, gathered), None without a state."""
    if state is None:
        return None
    return spmd.gather_over(state[name], spmd.cache_axis(d), -1)


def _keep_last(state, name, x):
    """Write the last token of ``x`` into a token-shift cache leaf (the
    rank's slice of it under ``spmd``)."""
    state[name].copy_(spmd.scatter_over(x[:, -1], spmd.cache_axis(
        x.shape[-1]), -1))


def time_mix(p, x, cfg, *, route=viscosity.SW, state=None, step=False):
    """x (B,S,D) -> (B,S,D).  ``state`` (views of the layer's cache) gets
    ``shift_tm`` and ``wkv`` written in place."""
    Bt, S, d = x.shape
    H, hK = dims(cfg)
    lora = cfg.ssm.rwkv_decay_lora
    col = spmd.leaf_axis("wr", (d, d), -1)      # r k v g columns, wo rows
    a_ax = spmd.leaf_axis("w_lora_a", (d, lora), -1)
    b_ax = spmd.leaf_axis("w_lora_b", (lora, d), -1)
    u_ax = spmd.leaf_axis("u", (H, hK), -2)
    Hl = H // spmd.axis_ranks(col)
    xs = _shift(x, _last(state, "shift_tm", d))

    def proj(mix, w):
        return spmd.replicate_over(_mix(x, xs, p[mix]), col) @ \
            p[w].to(x.dtype)
    r, k, v, g = (proj(f"mix_{n}", f"w{n}") for n in "rkvg")
    xw = spmd.replicate_over(_mix(x, xs, p["mix_w"]).float(), a_ax)
    a = spmd.gather_over(torch.tanh(xw @ p["w_lora_a"]), a_ax, -1)
    lw = -torch.exp(spmd.scatter_over(p["w0"], b_ax, -1)[None, None] +
                    spmd.replicate_over(a, b_ax) @ p["w_lora_b"])
    lw = spmd.reshard(torch.clamp(lw, LW_MIN, -1e-4), -1, b_ax, col)
    u = spmd.reshard(p["u"], -2, u_ax, col)

    rh, kh, vh = (t.reshape(Bt, S, Hl, hK) for t in (r, k, v))
    lwh = lw.reshape(Bt, S, Hl, hK).to(x.dtype)
    rh = constrain(rh, "batch", "seq", "ssm_heads", "head_dim")
    chunk = cfg.ssm.rwkv_chunk
    if step:
        o, new_wkv = wkv_ref.wkv6_step(state["wkv"], rh[:, 0], kh[:, 0],
                                       vh[:, 0], lwh[:, 0], u)
        o = o[:, None]
    elif state is not None and state_from_lowering(route):
        o, new_wkv = wkv_ops.wkv6(rh, kh, vh, lwh, u, route=route,
                                  chunk=chunk, with_state=True)
    else:
        o = wkv_ops.wkv6(rh, kh, vh, lwh, u, route=route, chunk=chunk)
        if state is not None:
            _, new_wkv = wkv_ref.wkv6_chunked(rh, kh, vh, lwh, u,
                                              chunk=chunk)
    if state is not None:
        _keep_last(state, "shift_tm", x)
        state["wkv"].copy_(new_wkv)
    # per-head group norm, f32, population variance
    of = o.reshape(Bt, S, Hl, hK).float()
    mu = of.mean(-1, keepdim=True)
    var = of.var(-1, keepdim=True, correction=0)
    of = (of - mu) * torch.rsqrt(var + 64e-5)
    o = of.reshape(Bt, S, Hl * hK).to(x.dtype) * \
        spmd.scatter_over(p["ln_scale"], col, -1).to(x.dtype)
    out = spmd.reduce_over((o * F.silu(g)) @ p["wo"].to(x.dtype), col)
    return constrain(out, "batch", "seq", "embed")


def channel_mix(p, x, state=None, d_ff=None):
    """Squared-ReLU channel-mix; ``state["shift_cm"]`` written in place.
    ``d_ff`` (the global width) says, under ``spmd``, what is cut."""
    d = x.shape[-1]
    f = d_ff or p["cwk"].shape[-1]
    r_ax = spmd.leaf_axis("cwr", (d, d), -1)
    f_ax = spmd.leaf_axis("cwk", (d, f), -1)    # cwk columns, cwv rows
    xs = _shift(x, _last(state, "shift_cm", d))
    xr = spmd.replicate_over(_mix(x, xs, p["cmix_r"]), r_ax)
    xk = spmd.replicate_over(_mix(x, xs, p["cmix_k"]), f_ax)
    r = spmd.gather_over(torch.sigmoid(xr @ p["cwr"].to(x.dtype)), r_ax, -1)
    k = torch.square(torch.relu(xk @ p["cwk"].to(x.dtype)))
    k = constrain(k, "batch", "seq", "mlp")
    if state is not None:
        _keep_last(state, "shift_cm", x)
    out = r * spmd.reduce_over(k @ p["cwv"].to(x.dtype), f_ax)
    return constrain(out, "batch", "seq", "embed")


def init_rwkv6_state(L, B, cfg, dtype, device):
    """Stacked per-layer decode state: shift_tm, shift_cm (L,B,d) in
    ``dtype``, wkv (L,B,H,K,V) f32."""
    d = cfg.d_model
    H, hK = dims(cfg)
    return {
        "shift_tm": torch.zeros((L, B, d), dtype=dtype, device=device),
        "shift_cm": torch.zeros((L, B, d), dtype=dtype, device=device),
        "wkv": torch.zeros((L, B, H, hK, hK), dtype=torch.float32,
                           device=device),
    }
