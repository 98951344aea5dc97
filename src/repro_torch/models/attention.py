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

Under the tensor-parallel runtime (``launch/spmd.py``) a rank holds its
columns of ``wq``/``wk``/``wv`` and rows of ``wo``, computes its own query
and kv heads (``AttnShard``: K/V that stay replicated are read through the
global GQA map), and sums the ``wo`` products over the rank's axis.  Its
cache is cut as ``make_cache_pspec_fn`` says: by kv heads where they
divide the axis (the positions cut along the sequence, gathered where
attention reads them; where the rules cut the kv heads otherwise, as the
``ep`` variants do, each write and read moves them: ``AttnShard.to_cache``
and ``from_cache``), else along the sequence (``spmd.kv_seq_axis``: the
rank holds slots [s0, s0 + n) of k, v and the positions).  Over such a
cache a decode step attends with every query head over the rank's slots,
gathers the f32 softmax partials over the axis and folds them in rank
order (``combine_partials``), and keeps its own heads' rows for ``wo``;
prefill is unchanged and writes the rank's slots.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch import viscosity
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.flash_attention import ref as attn_ref
from repro_torch.launch import spmd
from repro_torch.launch.sharding import constrain
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


def _project_q_only(p, x, n_heads, head_dim, sh=None):
    B, S, _ = x.shape
    sh = sh or spmd.AttnShard(n_heads=n_heads)
    x = spmd.replicate_over(x, sh.q_cols)
    q = x @ p["wq"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    q = sh.q(q).reshape(B, S, -1, head_dim)
    if "q_norm" in p:
        q = _qk_norm(q, sh.head_param(p["q_norm"]))
    return constrain(q, "batch", "seq", "heads", "head_dim")


def project_kv(p, x, n_kv, head_dim, sh=None):
    """Keys and values of ``x`` (B, S, D) -> two (B, S, n_kv, head_dim)
    (the rank's kv heads under ``spmd``); for cross-attention, of the
    encoder output.  As in the reference, ``bk``'s presence adds both
    biases."""
    B, S, _ = x.shape
    sh = sh or spmd.AttnShard(n_kv=n_kv)
    x = spmd.replicate_over(x, sh.kv_cols)
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bk" in p:
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    k = sh.kv(k).reshape(B, S, -1, head_dim)
    v = sh.kv(v).reshape(B, S, -1, head_dim)
    if "k_norm" in p:
        k = _qk_norm(k, sh.kv_param(p["k_norm"]))
    return (constrain(k, "batch", "kv_seq", "kv_heads", "head_dim"),
            constrain(v, "batch", "kv_seq", "kv_heads", "head_dim"))


def _project_qkv(p, x, n_heads, n_kv, head_dim, sh=None):
    return (_project_q_only(p, x, n_heads, head_dim, sh),
            *project_kv(p, x, n_kv, head_dim, sh))


def attn_full(p, x, cos, sin, *, n_heads, n_kv, head_dim, causal=True,
              window=0, softcap=0.0, scale=0.0, route=viscosity.SW,
              kv_out=False, kv_chunk=0, cross_kv=None, precomputed_kv=None):
    """Full-sequence attention (train / prefill).

    ``cross_kv``: an encoder output (B, S_enc, D), from which the keys and
    values are projected instead of from ``x`` (whisper's cross-attention).
    ``precomputed_kv``: (k, v) already projected (the cross-KV cache of a
    prefill, so decode does not project the encoder output again)."""
    sh = spmd.AttnShard.of(n_heads, n_kv, head_dim)
    q = _project_q_only(p, x, n_heads, head_dim, sh)
    if precomputed_kv is not None:
        k, v = precomputed_kv
    else:
        k, v = project_kv(p, x if cross_kv is None else cross_kv.to(x.dtype),
                          n_kv, head_dim, sh)
    if cos is not None and cross_kv is None:
        q = rope_mod.apply_rope(q, cos, sin)
        k = rope_mod.apply_rope(k, cos, sin)
    q = constrain(q, "batch", "seq", "heads", "head_dim")
    k = constrain(k, "batch", "seq", "kv_heads", "head_dim")
    v = constrain(v, "batch", "seq", "kv_heads", "head_dim")
    ka, va = sh.kv_for_heads(k, v)
    o = attn_ops.attention(q, ka, va, causal=causal, window=window,
                           softcap=softcap, scale=scale, route=route,
                           kv_chunk=kv_chunk)
    o = constrain(o, "batch", "seq", "heads", "head_dim")
    B, S = x.shape[:2]
    out = sh.finish(sh.partial(o.reshape(B, S, -1), p["wo"].to(x.dtype)))
    out = constrain(out, "batch", "seq", "embed")
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


def cache_write_prefill(cache, layer: int, k, v, *, n_kv: int = 0):
    """Write a prefill's k/v into ``layer`` of the cache (in place).

    S <= Smax: slots [0, S).  S > Smax (a ring buffer: windowed attention
    with Smax = window): keep the last Smax tokens, token ``pos`` at slot
    ``pos % Smax``, so decode's writes at ``t % Smax`` stay consistent.
    Under ``spmd`` the rank writes its own slots [s0, s0 + n) of the
    positions where they are cut along the sequence, and of k/v too where
    the cache's slots are (``n_kv``, the layer's global kv head count,
    does not divide the axis: ``spmd.kv_seq_axis``); k/v come cut over
    the rules' kv heads axis and are moved to the cache's first."""
    S = k.shape[1]
    if n_kv:
        k, v = (spmd.reshard(t, -2, spmd.kv_heads_axis(n_kv),
                             spmd.cache_axis(n_kv)) for t in (k, v))
    kax = spmd.kv_seq_axis(n_kv) if n_kv else None
    pax = kax if kax is not None else spmd.pos_axis(cache)
    n = cache["pos"].shape[-1]
    s0 = spmd.axis_offset(pax, n)
    smax = n * spmd.axis_ranks(pax)     # the global slots
    if S <= smax:
        lo, hi = s0, min(s0 + n, S)
        if kax is None:
            cache["k"][layer, :, :S] = k.to(cache["k"].dtype)
            cache["v"][layer, :, :S] = v.to(cache["v"].dtype)
        elif hi > lo:
            cache["k"][layer, :, :hi - lo] = k[:, lo:hi].to(cache["k"].dtype)
            cache["v"][layer, :, :hi - lo] = v[:, lo:hi].to(cache["v"].dtype)
        if hi > lo:
            cache["pos"][layer, :, :hi - lo] = torch.arange(
                lo, hi, dtype=torch.int32, device=k.device)
        return cache
    p0 = S - smax                       # first kept absolute position
    idx = (torch.arange(smax, device=k.device) - p0) % smax
    kidx = idx if kax is None else idx[s0:s0 + n]
    cache["k"][layer] = k[:, p0:][:, kidx].to(cache["k"].dtype)
    cache["v"][layer] = v[:, p0:][:, kidx].to(cache["v"].dtype)
    cache["pos"][layer] = (p0 + idx[s0:s0 + n]).to(torch.int32)
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
    decode bit for bit (under ``spmd`` the rows' ``wo`` partial sums are
    reduced together: an elementwise sum, the same per row)."""
    sh = spmd.AttnShard.of(n_heads, n_kv, head_dim)
    kax = spmd.kv_seq_axis(n_kv)
    if kax is not None:
        return _decode_over_cut_slots(
            p, x, cache, layer, t, tpos, cos, sin, sh, kax, n_heads=n_heads,
            n_kv=n_kv, head_dim=head_dim, window=window, softcap=softcap,
            scale=scale)
    smax = cache["k"].shape[2]
    pax = spmd.pos_axis(cache)
    pos_loc = cache["pos"][layer]
    n = pos_loc.shape[-1]
    s0 = spmd.axis_offset(pax, n)
    pos_all = spmd.gather_over(pos_loc, pax, -1)
    outs = []
    for i, ti in enumerate(t):
        q, k, v = _project_qkv(p, x[i:i + 1], n_heads, n_kv, head_dim, sh)
        if cos is not None:
            q = rope_mod.apply_rope(q, cos[i:i + 1], sin[i:i + 1])
            k = rope_mod.apply_rope(k, cos[i:i + 1], sin[i:i + 1])
        slot = ti % smax
        cache["k"][layer, i, slot] = sh.to_cache(k)[0, 0].to(
            cache["k"].dtype)
        cache["v"][layer, i, slot] = sh.to_cache(v)[0, 0].to(
            cache["v"].dtype)
        if s0 <= slot < s0 + n:
            pos_loc[i, slot - s0] = ti
        if pax is not None:
            pos_all[i, slot] = ti
        ka, va = sh.cached_kv_for_heads(cache["k"][layer, i:i + 1],
                                        cache["v"][layer, i:i + 1])
        o = attn_ref.attention_naive(
            q, ka, va, causal=True, window=window, softcap=softcap,
            scale=scale, q_offset=tpos[i:i + 1],
            k_positions=pos_all[i:i + 1])
        outs.append(sh.partial(o.reshape(1, 1, -1), p["wo"].to(x.dtype)))
    return sh.finish(torch.cat(outs) if len(outs) > 1 else outs[0])


def _decode_over_cut_slots(p, x, cache, layer, t, tpos, cos, sin, sh, kax,
                           *, n_heads, n_kv, head_dim, window, softcap,
                           scale):
    """``attn_decode`` over a cache whose slots are cut along ``kax``: the
    rank holds slots [s0, s0 + n) of every kv head.  Per row, the token's
    k/v (every kv head) go to the rank that owns slot ``t % Smax``; every
    rank attends with every query head (gathered over the heads axis) over
    its own slots, the f32 partials are gathered over ``kax`` and folded
    in rank order (the same bits on every rank), and the rank keeps its
    own heads' rows for its ``wo`` term."""
    n = cache["k"].shape[2]
    s0 = spmd.axis_offset(kax, n)
    smax = n * spmd.axis_ranks(kax)
    pos = cache["pos"][layer]
    outs = []
    for i, ti in enumerate(t):
        q, k, v = _project_qkv(p, x[i:i + 1], n_heads, n_kv, head_dim, sh)
        if cos is not None:
            q = rope_mod.apply_rope(q, cos[i:i + 1], sin[i:i + 1])
            k = rope_mod.apply_rope(k, cos[i:i + 1], sin[i:i + 1])
        k = spmd.gather_over(k, sh.kv_heads, 2)
        v = spmd.gather_over(v, sh.kv_heads, 2)
        slot = ti % smax
        if s0 <= slot < s0 + n:
            cache["k"][layer, i, slot - s0] = k[0, 0].to(cache["k"].dtype)
            cache["v"][layer, i, slot - s0] = v[0, 0].to(cache["v"].dtype)
            pos[i, slot - s0] = ti
        hl = q.shape[2]
        part = attn_ref.attention_partials(
            spmd.gather_over(q, sh.heads, 2), cache["k"][layer, i:i + 1],
            cache["v"][layer, i:i + 1], causal=True, window=window,
            softcap=softcap, scale=scale, q_offset=tpos[i:i + 1],
            k_positions=pos[i:i + 1])
        o = attn_ref.combine_partials(spmd.gather_over(part[None], kax, 0))
        o = o[:, :, sh.h0:sh.h0 + hl].to(x.dtype)
        outs.append(sh.partial(o.reshape(1, 1, -1), p["wo"].to(x.dtype)))
    return sh.finish(torch.cat(outs) if len(outs) > 1 else outs[0])
