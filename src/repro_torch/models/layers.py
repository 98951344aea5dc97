"""Shared layers: norms, embeddings, the gated MLP (via the SwiGLU stage)
and the chunked cross-entropy.  Port of the reference's
``models/layers.py``; params are nested dicts of tensors."""
from __future__ import annotations

import torch

from repro_torch import viscosity
from repro_torch.kernels.swiglu import ops as swiglu_ops


def _he(gen, shape, fan_in, dtype, device):
    return (torch.randn(shape, generator=gen, device=device)
            / fan_in ** 0.5).to(dtype)


def per_row(fn, x):
    """``fn`` applied to each leading row of ``x`` on its own, so a row's
    result does not depend on how many rows share the call (batched
    decode must equal single-request decode bit for bit)."""
    if x.shape[0] == 1:
        return fn(x)
    return torch.cat([fn(x[i:i + 1]) for i in range(x.shape[0])])


# ---------------------------------------------------------------- norms
def init_norm(d, dtype, device, lead=()):
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=dtype,
                                device=device)}


def norm(p, x, *, eps=1e-6, layernorm=False):
    xf = x.float()
    if layernorm:
        xf = xf - xf.mean(-1, keepdim=True)
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


# ------------------------------------------------------------ embeddings
def init_embed(gen, vocab, d, dtype, device):
    return {"table": (torch.randn((vocab, d), generator=gen, device=device)
                      * 0.02).to(dtype)}


def embed(p, tokens, *, scale_by_dim=False, compute_dtype=torch.bfloat16):
    x = p["table"][tokens].to(compute_dtype)
    if scale_by_dim:
        x = x * torch.tensor(float(p["table"].shape[1]) ** 0.5,
                             dtype=compute_dtype, device=x.device)
    return x


def logits_from_embed(table, x, *, softcap=0.0):
    out = x @ table.to(x.dtype).T
    if softcap:
        out = torch.tanh(out / softcap) * softcap
    return out


def init_lm_head(gen, d, vocab, dtype, device):
    return {"w": _he(gen, (d, vocab), d, dtype, device)}


def lm_head(p, x, *, softcap=0.0):
    out = x @ p["w"].to(x.dtype)
    if softcap:
        out = torch.tanh(out / softcap) * softcap
    return out


# -------------------------------------------------------------- gated MLP
def init_mlp(gen, L, d, f, dtype, device):
    return {"w1": _he(gen, (L, d, f), d, dtype, device),
            "w2": _he(gen, (L, f, d), f, dtype, device),
            "w3": _he(gen, (L, d, f), d, dtype, device)}


def mlp(p, x, *, act="silu", route=viscosity.SW,
        row_independent: bool = False):
    """Gated MLP through the Viscosity SwiGLU stage (dense family: the
    plain ungated MLP waits for the whisper slice)."""
    cd = x.dtype
    lead = x.shape[:-1]
    act_name = "gelu" if act in ("gelu", "gelu_plain") else "silu"
    y = swiglu_ops.swiglu(
        x.reshape(-1, x.shape[-1]), p["w1"].to(cd), p["w3"].to(cd),
        p["w2"].to(cd), act=act_name, route=route,
        row_independent=row_independent)
    return y.reshape(*lead, -1)


# -------------------------------------------------- chunked cross-entropy
def chunked_xent(h, targets, table_or_w, *, tied: bool, softcap=0.0,
                 chunk=512, mask=None):
    """Cross-entropy without materializing full (B, S, V) logits.
    h (B, S, D); targets (B, S) int; returns (mean_loss, denom)."""
    B, S, _ = h.shape
    if mask is None:
        mask = targets >= 0
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c0 in range(0, S, min(chunk, S)):
        hh = h[:, c0:c0 + chunk]
        tt = targets[:, c0:c0 + chunk]
        mm = mask[:, c0:c0 + chunk].float()
        w = table_or_w.to(hh.dtype)
        logits = hh @ (w.T if tied else w)
        if softcap:
            logits = torch.tanh(logits / softcap) * softcap
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, tt.clamp(min=0).long()[..., None])[..., 0]
        tot = tot + ((lse - tgt) * mm).sum()
        cnt = cnt + mm.sum()
    return tot / torch.clamp(cnt, min=1.0), cnt
