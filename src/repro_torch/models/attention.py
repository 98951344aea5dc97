"""Attention layer: GQA + RoPE/M-RoPE + QKV bias + qk-norm + sliding
windows, and cross-attention (whisper).

Port of the reference's ``models/attention.py``.  The score/softmax/PV
core of train and prefill routes through the Viscosity
``flash_attention`` op; decode attends with the plain ``attention_naive``
whatever the route, as the reference does (it has no decode kernel).

Cache layout: every layer's KV stacked, ``k``/``v`` (L, B, Smax, Hkv, Dh)
and an explicit per-slot position array ``pos`` (L, B, Smax), -1 where
nothing is written.  A windowed model's cache has Smax = min(max_len,
window) slots, written round-robin (a ring buffer); the positions make
the masks the same for both.  The reference vmaps a B=1 decode over
serving slots (``(S, G, 1, Smax, Hkv, Dh)``); the port writes the slot
batch out.  Prefill and decode write the cache in place.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import viscosity
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.flash_attention import ref as attn_ref
from repro_torch.models import rope as rope_mod
from repro_torch.models.layers import _he, rms_norm_simple


def init_attention(gen, L, d_model, n_heads, n_kv, head_dim, dtype, device,
                   *, qkv_bias=False, qk_norm=False):
    p = {
        "wq": _he(gen, (L, d_model, n_heads * head_dim), d_model, dtype,
                  device),
        "wk": _he(gen, (L, d_model, n_kv * head_dim), d_model, dtype, device),
        "wv": _he(gen, (L, d_model, n_kv * head_dim), d_model, dtype, device),
        "wo": _he(gen, (L, n_heads * head_dim, d_model), n_heads * head_dim,
                  dtype, device),
    }
    if qkv_bias:
        for name, width in (("bq", n_heads), ("bk", n_kv), ("bv", n_kv)):
            p[name] = torch.zeros((L, width * head_dim), dtype=dtype,
                                  device=device)
    if qk_norm:                     # ones: they draw nothing
        for name in ("q_norm", "k_norm"):
            p[name] = torch.ones((L, head_dim), dtype=dtype, device=device)
    return p


def _qk_norm(t, scale, eps=1e-6):
    """gemma3's qk-norm: the RMS norm in f32, back to the compute dtype,
    then the scale in the compute dtype, in the reference's order."""
    return rms_norm_simple(t, eps=eps) * scale.to(t.dtype)


def _project_q_only(p, x, n_heads, head_dim):
    B, S, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    q = q.reshape(B, S, n_heads, head_dim)
    return _qk_norm(q, p["q_norm"]) if "q_norm" in p else q


def project_kv(p, x, n_kv, head_dim):
    """Keys and values of ``x`` (B, S, D) -> two (B, S, n_kv, head_dim);
    for cross-attention, of the encoder output.  As in the reference,
    ``bk``'s presence adds both biases."""
    B, S, _ = x.shape
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bk" in p:
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    k = k.reshape(B, S, n_kv, head_dim)
    v = v.reshape(B, S, n_kv, head_dim)
    if "k_norm" in p:
        k = _qk_norm(k, p["k_norm"])
    return k, v


def _project_qkv(p, x, n_heads, n_kv, head_dim):
    return (_project_q_only(p, x, n_heads, head_dim),
            *project_kv(p, x, n_kv, head_dim))


def attn_full(p, x, cos, sin, *, n_heads, n_kv, head_dim, causal=True,
              window=0, softcap=0.0, scale=0.0, route=viscosity.SW,
              kv_out=False, kv_chunk=0, cross_kv=None, precomputed_kv=None):
    """Full-sequence attention (train / prefill).

    ``cross_kv``: an encoder output (B, S_enc, D), from which the keys and
    values are projected instead of from ``x`` (whisper's cross-attention).
    ``precomputed_kv``: (k, v) already projected (the cross-KV cache of a
    prefill, so decode does not project the encoder output again)."""
    q = _project_q_only(p, x, n_heads, head_dim)
    if precomputed_kv is not None:
        k, v = precomputed_kv
    else:
        k, v = project_kv(p, x if cross_kv is None else cross_kv.to(x.dtype),
                          n_kv, head_dim)
    if cos is not None and cross_kv is None:
        q = rope_mod.apply_rope(q, cos, sin)
        k = rope_mod.apply_rope(k, cos, sin)
    o = attn_ops.attention(q, k, v, causal=causal, window=window,
                           softcap=softcap, scale=scale, route=route,
                           kv_chunk=kv_chunk)
    B, S = x.shape[:2]
    out = o.reshape(B, S, -1) @ p["wo"].to(x.dtype)
    return (out, (k, v)) if kv_out else out


def init_kv_cache(L, B, smax, n_kv, head_dim, dtype, device):
    return {
        "k": torch.zeros((L, B, smax, n_kv, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((L, B, smax, n_kv, head_dim), dtype=dtype,
                         device=device),
        "pos": torch.full((L, B, smax), -1, dtype=torch.int32,
                          device=device),
    }


def cache_write_prefill(cache, layer: int, k, v):
    """Write a prefill's k/v into ``layer`` of the cache (in place).

    S <= Smax: slots [0, S).  S > Smax (a ring buffer: windowed attention
    with Smax = window): keep the last Smax tokens, token ``pos`` at slot
    ``pos % Smax``, so decode's writes at ``t % Smax`` stay consistent."""
    S = k.shape[1]
    smax = cache["k"].shape[2]
    if S <= smax:
        cache["k"][layer, :, :S] = k.to(cache["k"].dtype)
        cache["v"][layer, :, :S] = v.to(cache["v"].dtype)
        cache["pos"][layer, :, :S] = torch.arange(S, dtype=torch.int32,
                                                  device=k.device)
        return cache
    p0 = S - smax                       # first kept absolute position
    idx = (torch.arange(smax, device=k.device) - p0) % smax
    cache["k"][layer] = k[:, p0:][:, idx].to(cache["k"].dtype)
    cache["v"][layer] = v[:, p0:][:, idx].to(cache["v"].dtype)
    cache["pos"][layer] = (p0 + idx).to(torch.int32)
    return cache


def attn_decode(p, x, cache, layer: int, t: Sequence[int], tpos, cos, sin,
                *, n_heads, n_kv, head_dim, window=0, softcap=0.0,
                scale=0.0):
    """One decode step over B slots.  x (B, 1, D); ``t`` the per-slot
    absolute positions (host ints), ``tpos`` the same as a (B,) device
    tensor, ``cos``/``sin`` their RoPE tables (B, 1, Dh/2), or None (no
    rope: whisper's decoder).

    Row i writes slot ``t[i] % Smax`` of its own cache row and attends
    over it with explicit per-slot positions.  Each row is computed on its
    own, as a B=1 decode would, so batched decode equals single-request
    decode bit for bit."""
    smax = cache["k"].shape[2]
    outs = []
    for i, ti in enumerate(t):
        q, k, v = _project_qkv(p, x[i:i + 1], n_heads, n_kv, head_dim)
        if cos is not None:
            q = rope_mod.apply_rope(q, cos[i:i + 1], sin[i:i + 1])
            k = rope_mod.apply_rope(k, cos[i:i + 1], sin[i:i + 1])
        slot = ti % smax
        cache["k"][layer, i, slot] = k[0, 0].to(cache["k"].dtype)
        cache["v"][layer, i, slot] = v[0, 0].to(cache["v"].dtype)
        cache["pos"][layer, i, slot] = ti
        o = attn_ref.attention_naive(
            q, cache["k"][layer, i:i + 1], cache["v"][layer, i:i + 1],
            causal=True, window=window, softcap=softcap, scale=scale,
            q_offset=tpos[i:i + 1], k_positions=cache["pos"][layer, i:i + 1])
        outs.append(o.reshape(1, 1, -1) @ p["wo"].to(x.dtype))
    return torch.cat(outs) if len(outs) > 1 else outs[0]
