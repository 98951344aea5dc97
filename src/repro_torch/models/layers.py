"""Shared layers: norms (RMSNorm and LayerNorm), embeddings, the MLP (gated
through the SwiGLU stage, or plain) and the chunked cross-entropy.  Port of the reference's
``models/layers.py``; params are nested dicts of tensors.

Under the tensor-parallel runtime (``launch/spmd.py``) the vocab-sharded
embedding looks up the rank's rows (others zeroed) and sums them over the
vocab axis; the logits of a vocab-sharded head or tied table are gathered
before anyone samples them, and the loss gathers each chunk's logits
(no vocab-parallel cross-entropy); the MLP, gated or plain, runs on the
rank's ``w1``(/``w3``) columns and ``w2`` rows and sums its partial
output.
``vocab`` and ``d_ff`` (the global sizes) say what is sharded; outside
``spmd`` they change nothing."""
from __future__ import annotations

import contextlib

import torch

from repro_torch import viscosity
from repro_torch.kernels.swiglu import ops as swiglu_ops
from repro_torch.launch import spmd
from repro_torch.launch.sharding import constrain


# What each weight ``_he`` draws goes through, in float32 before its cast
# (``draw_hook``); None: the weight as drawn
_DRAW_HOOK = None


@contextlib.contextmanager
def draw_hook(fn):
    """Within the body, ``_he`` passes each weight it draws, in float32 and
    in draw order, through ``fn`` and casts what ``fn`` returns
    (``LMModel.init_keyed`` keeps a rank's block of each as it is
    drawn)."""
    global _DRAW_HOOK
    prev, _DRAW_HOOK = _DRAW_HOOK, fn
    try:
        yield
    finally:
        _DRAW_HOOK = prev


def _he(gen, shape, fan_in, dtype, device):
    # scaled in place: a leaf's draw takes one float32 copy, not two
    t = torch.randn(shape, generator=gen, device=device).div_(fan_in ** 0.5)
    return (t if _DRAW_HOOK is None else _DRAW_HOOK(t)).to(dtype)


def per_row(fn, x):
    """``fn`` applied to each leading row of ``x`` on its own, so a row's
    result does not depend on how many rows share the call (batched
    decode must equal single-request decode bit for bit)."""
    if x.shape[0] == 1:
        return fn(x)
    return torch.cat([fn(x[i:i + 1]) for i in range(x.shape[0])])


# ---------------------------------------------------------------- norms
def init_norm(d, dtype, device, lead=(), layernorm=False):
    shape = tuple(lead) + (d,)
    p = {"scale": torch.ones(shape, dtype=dtype, device=device)}
    if layernorm:
        p["bias"] = torch.zeros(shape, dtype=dtype, device=device)
    return p


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


def rms_norm_simple(x, *, eps=1e-6):
    """RMS norm without a scale, computed in f32 (the Mamba2 gated norm,
    and qk-norm before its scale)."""
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
            ).to(x.dtype)


# ------------------------------------------------------------ embeddings
def init_embed(gen, vocab, d, dtype, device):
    return {"table": (torch.randn((vocab, d), generator=gen, device=device)
                      * 0.02).to(dtype)}


def embed(p, tokens, *, scale_by_dim=False, compute_dtype=torch.bfloat16,
          vocab=None):
    table = p["table"]
    ax = spmd.vocab_axis(vocab) if vocab else None
    if ax is None:
        x = table[tokens].to(compute_dtype)
    else:                       # the rank's rows; the others are zero
        n = table.shape[0]
        loc = tokens - spmd.axis_offset(ax, n)
        mine = (loc >= 0) & (loc < n)
        x = table[loc.clamp(0, n - 1)] * mine[..., None].to(table.dtype)
        x = spmd.reduce_over(x, ax).to(compute_dtype)
    if scale_by_dim:
        x = x * torch.tensor(float(table.shape[1]) ** 0.5,
                             dtype=compute_dtype, device=x.device)
    return constrain(x, "batch", "seq", "embed")


def _vocab_logits(x, w_cols, vocab, softcap):
    """``x @ w_cols`` (the rank's vocab columns under ``spmd``), softcapped,
    gathered over the vocab axis."""
    ax = spmd.vocab_axis(vocab) if vocab else None
    out = spmd.replicate_over(x, ax) @ w_cols
    if softcap:
        out = torch.tanh(out / softcap) * softcap
    out = constrain(out, "batch", "seq", "vocab")
    return spmd.gather_over(out, ax, -1)


def logits_from_embed(table, x, *, softcap=0.0, vocab=None):
    return _vocab_logits(x, table.to(x.dtype).T, vocab, softcap)


def init_lm_head(gen, d, vocab, dtype, device):
    return {"w": _he(gen, (d, vocab), d, dtype, device)}


def lm_head(p, x, *, softcap=0.0, vocab=None):
    return _vocab_logits(x, p["w"].to(x.dtype), vocab, softcap)


# -------------------------------------------------------------------- MLP
def init_mlp(gen, L, d, f, dtype, device, *, gated=True):
    p = {"w1": _he(gen, (L, d, f), d, dtype, device),
         "w2": _he(gen, (L, f, d), f, dtype, device)}
    if gated:
        p["w3"] = _he(gen, (L, d, f), d, dtype, device)
    return p


def mlp(p, x, *, act="silu", route=viscosity.SW,
        row_independent: bool = False, d_ff=None):
    """Gated MLP through the Viscosity SwiGLU stage; without ``w3`` the
    plain MLP (whisper's: ``w1``, tanh-gelu, ``w2``), two plain products
    as in the reference, whatever the route.  Under ``spmd`` either runs
    on the rank's d_ff slice (``w1``/``w3`` columns, ``w2`` rows) and its
    partial sum is summed over the FFN axis here."""
    cd = x.dtype
    ax = spmd.ffn_axis(d_ff) if d_ff else None
    if "w3" not in p:
        h = spmd.replicate_over(x, ax) @ p["w1"].to(cd)
        h = (torch.nn.functional.gelu(h, approximate="tanh")
             if act.startswith("gelu") else torch.nn.functional.silu(h))
        return spmd.reduce_over(h @ p["w2"].to(cd), ax)
    lead = x.shape[:-1]
    act_name = "gelu" if act in ("gelu", "gelu_plain") else "silu"
    y = swiglu_ops.swiglu(
        spmd.replicate_over(x.reshape(-1, x.shape[-1]), ax), p["w1"].to(cd),
        p["w3"].to(cd), p["w2"].to(cd), act=act_name, route=route,
        row_independent=row_independent)
    y = spmd.reduce_over(y, ax)
    return constrain(y.reshape(*lead, -1), "batch", "seq", "embed")


# -------------------------------------------------- chunked cross-entropy
def chunked_xent(h, targets, table_or_w, *, tied: bool, softcap=0.0,
                 chunk=512, mask=None, vocab=None):
    """Cross-entropy without materializing full (B, S, V) logits.
    h (B, S, D); targets (B, S) int; returns (mean_loss, denom).  Under
    ``spmd`` each chunk's vocab-sharded logits are gathered, and the sums
    run over the batch axes."""
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
        logits = _vocab_logits(hh, w.T if tied else w, vocab, softcap)
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, tt.clamp(min=0).long()[..., None])[..., 0]
        tot = tot + ((lse - tgt) * mm).sum()
        cnt = cnt + mm.sum()
    tot, cnt = spmd.sum_over_batch(tot), spmd.sum_over_batch(cnt)
    return tot / torch.clamp(cnt, min=1.0), cnt
