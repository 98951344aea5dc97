"""PyTorch oracles for attention (the Viscosity "software" lowering).

Ports of the reference's ``kernels/flash_attention/ref.py``:
  * ``attention_naive`` — the masked-softmax oracle (decode uses it);
  * ``attention_chunked`` — the online-softmax software fallback, a Python
    loop over KV chunks where the reference scans;
  * ``attention_ref_blocked`` — the kernel's blocked algorithm, the plain
    version of ``kernel.flash_attention_bhsd``;
  * ``attention_flops``.

And the port's own ``attention_partials`` / ``combine_partials``: the
naive oracle over one part of the keys, unnormalised, and the fold of the
parts (decode over a KV cache whose slots are cut across ranks).

Layout: q (B, Sq, H, D); k, v (B, Skv, Hkv, D); output (B, Sq, H, D),
except ``attention_ref_blocked``, which is (B, H, S, D) like the kernel.
Products take bf16/f32 inputs and accumulate in float32.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Union

import torch

from repro_torch.viscosity.lanefault import apply_fault

NEG_INF = -1e30
Positions = Union[torch.Tensor, Sequence[int], None]
# (Sq, C) of each ``attention_chunked`` call in progress, innermost last:
# its score tensors are (..., Sq, C).  ``launch/op_analysis.py`` reads it
# to tell the score tensors from the other ops' results.
_SCORE_GEOMETRY: list = []


def score_geometry():
    """(Sq, C) of the innermost ``attention_chunked`` call in progress,
    or None outside one."""
    return _SCORE_GEOMETRY[-1] if _SCORE_GEOMETRY else None


@contextlib.contextmanager
def _scores_of(Sq: int, C: int):
    _SCORE_GEOMETRY.append((Sq, C))
    try:
        yield
    finally:
        _SCORE_GEOMETRY.pop()


def _softcap(scores, cap: float):
    if cap and cap > 0.0:
        return torch.tanh(scores / cap) * cap
    return scores


def _positions(B, S, offset: Positions, device):
    pos = torch.arange(S, dtype=torch.int32, device=device)[None, :]
    if offset is not None:
        off = torch.as_tensor(offset, dtype=torch.int32, device=device)
        pos = pos + off.reshape(-1, 1)
    return pos.expand(B, S)


def _mask(q_pos, k_pos, *, causal: bool, window: int, kv_len: Positions,
          explicit_kpos: bool = False):
    """(B, Sq, Skv) boolean admissibility mask."""
    qp = q_pos[:, :, None]
    kp = k_pos[:, None, :]
    m = torch.ones((q_pos.shape[0], q_pos.shape[1], k_pos.shape[1]),
                   dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= kp <= qp
    if window and window > 0:
        m &= kp > qp - window
    if kv_len is not None:
        kl = torch.as_tensor(kv_len, dtype=torch.int32, device=q_pos.device)
        m &= kp < kl.reshape(-1, 1, 1)
    if explicit_kpos:
        m &= kp >= 0  # ring-buffer slots not yet written carry position -1
    return m


def _repeat_kv(k, H):
    Hkv = k.shape[2]
    if Hkv == H:
        return k
    if H % Hkv:
        raise ValueError(f"GQA needs H % Hkv == 0, got {H}, {Hkv}")
    return torch.repeat_interleave(k, H // Hkv, dim=2)


def attention_naive(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: float = 0.0,
                    q_offset: Positions = None, kv_len: Positions = None,
                    k_positions: Optional[torch.Tensor] = None):
    """O(Sq*Skv) oracle.  ``k_positions`` (B, Skv): explicit key positions
    (ring-buffer caches); slots marked -1 are masked out."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    sc = scale or (1.0 / D ** 0.5)
    kf = _repeat_kv(k, H).float()
    vf = _repeat_kv(v, H)
    qf = (q.float() * sc).to(q.dtype).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    scores = _softcap(scores, softcap)
    q_pos = _positions(B, Sq, q_offset, q.device)
    k_pos = (k_positions.to(torch.int32) if k_positions is not None
             else _positions(B, Skv, None, q.device))
    mask = _mask(q_pos, k_pos, causal=causal, window=window, kv_len=kv_len,
                 explicit_kpos=k_positions is not None)
    scores = torch.where(mask[:, None], scores,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(vf.dtype).float(),
                       vf.float())
    return out.to(q.dtype)


def attention_partials(q, k, v, *, causal: bool = True, window: int = 0,
                       softcap: float = 0.0, scale: float = 0.0,
                       q_offset: Positions = None,
                       k_positions: Optional[torch.Tensor] = None):
    """``attention_naive`` over one part of the keys, unnormalised: (B, Sq,
    H, Dv + 2) f32 holding, per query row and head, o = sum_j p_j v_j, the
    row max m of the masked scores and l = sum_j p_j, with p_j = exp(s_j -
    m) (rounded to v's dtype for the product, as ``attention_naive`` rounds
    its probabilities).  ``combine_partials`` joins the parts of disjoint
    key sets into the softmax over their union (a decode over a cache whose
    slots are cut across ranks)."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    sc = scale or (1.0 / D ** 0.5)
    kf = _repeat_kv(k, H).float()
    vf = _repeat_kv(v, H)
    qf = (q.float() * sc).to(q.dtype).float()
    scores = _softcap(torch.einsum("bqhd,bkhd->bhqk", qf, kf), softcap)
    q_pos = _positions(B, Sq, q_offset, q.device)
    k_pos = (k_positions.to(torch.int32) if k_positions is not None
             else _positions(B, Skv, None, q.device))
    mask = _mask(q_pos, k_pos, causal=causal, window=window, kv_len=None,
                 explicit_kpos=k_positions is not None)
    scores = torch.where(mask[:, None], scores,
                         torch.tensor(NEG_INF, device=q.device))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(vf.dtype).float(), vf.float())
    return torch.cat([o, m, p.sum(dim=-1, keepdim=True)],
                     dim=-1).permute(0, 2, 1, 3)


def combine_partials(parts: torch.Tensor) -> torch.Tensor:
    """(R, B, Sq, H, Dv + 2) ``attention_partials`` of R disjoint key sets
    -> the (B, Sq, H, Dv) f32 softmax output over their union.  The parts
    are folded in order, so every holder of the same parts gets the same
    bits.  A part whose keys are all masked weighs exp(NEG_INF - m) = 0
    wherever another part admits a key."""
    m = parts[0, ..., -2]
    for r in range(1, parts.shape[0]):
        m = torch.maximum(m, parts[r, ..., -2])
    o = l = None
    for r in range(parts.shape[0]):
        w = torch.exp(parts[r, ..., -2] - m)
        o_r, l_r = parts[r, ..., :-2] * w[..., None], parts[r, ..., -1] * w
        o, l = (o_r, l_r) if o is None else (o + o_r, l + l_r)
    return o / torch.clamp(l, min=1e-30)[..., None]


def attention_chunked(q, k, v, *, causal: bool = True, window: int = 0,
                      softcap: float = 0.0, scale: float = 0.0,
                      q_offset: Positions = None, kv_len: Positions = None,
                      kv_chunk: int = 512):
    """Online softmax over KV chunks: peak activation O(Sq * kv_chunk).
    The production software fallback; equals ``attention_naive`` to f32
    rounding."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    Dv = v.shape[-1]   # may be < D under reduced width
    C = min(kv_chunk, Skv)
    if Skv % C:  # pad KV to a chunk multiple; padding masked via kv_len
        pad = C - Skv % C
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        if kv_len is None:
            kv_len = [Skv] * B
        Skv = Skv + pad
    nC = Skv // C
    sc = scale or (1.0 / D ** 0.5)
    qf = (q.float() * sc).to(k.dtype).float()
    q_pos = _positions(B, Sq, q_offset, q.device)
    kr = _repeat_kv(k, H)
    vr = _repeat_kv(v, H)
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, Dv), dtype=torch.float32, device=q.device)
    neg = torch.tensor(NEG_INF, device=q.device)
    with _scores_of(Sq, C):
        for ci in range(nC):
            kb = kr[:, ci * C:(ci + 1) * C].float()
            vb = vr[:, ci * C:(ci + 1) * C]
            scores = _softcap(torch.einsum("bqhd,bkhd->bhqk", qf, kb),
                              softcap)
            k_pos = (ci * C + torch.arange(
                C, dtype=torch.int32, device=q.device))[None, :].expand(B, C)
            mask = _mask(q_pos, k_pos, causal=causal, window=window,
                         kv_len=kv_len)
            scores = torch.where(mask[:, None], scores, neg)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            p = torch.exp(scores - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(vb.dtype).float(), vb.float())
            m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def attention_ref_blocked(q, k, v, *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0, scale: float = 0.0,
                          kv_len: int = 0, bq: int = 128, bk: int = 128,
                          lane_fault=None):
    """PyTorch replica of the flash kernel's blocked algorithm.

    Layout (B, H, S, D) like ``kernel.flash_attention_bhsd``; the same
    block skipping, masks, f32 online-softmax update order, GQA head
    mapping and fault point (``lane_fault`` on acc / l at finalize), with
    (B, H) batched into each tile product.  The output width is
    ``v.shape[3]``.
    """
    B, H, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    Dv = v.shape[3]
    if Sq % bq or Skv % bk:
        raise ValueError(f"blocked attention needs Sq % bq == Skv % bk == 0;"
                         f" got {(Sq, bq, Skv, bk)}")
    nq, nk = Sq // bq, Skv // bk
    sc = scale or (1.0 / D ** 0.5)
    kv_len = kv_len or Skv
    kh = torch.arange(H, device=q.device) * Hkv // H   # GQA index map
    kf = k[:, kh].float()
    vf = v[:, kh].float()
    out = torch.empty((B, H, Sq, Dv), dtype=q.dtype, device=q.device)
    neg = torch.tensor(NEG_INF, device=q.device)
    for qi in range(nq):
        q_start = qi * bq
        m = torch.full((B, H, bq, 1), NEG_INF, device=q.device)
        l = torch.zeros((B, H, bq, 1), device=q.device)
        acc = torch.zeros((B, H, bq, Dv), device=q.device)
        qb = q[:, :, q_start:q_start + bq].float() * sc
        qp = q_start + torch.arange(bq, device=q.device)[:, None]
        for ki in range(nk):
            k_start = ki * bk
            run = k_start < kv_len
            if causal:
                run &= k_start <= q_start + bq - 1
            if window and window > 0:
                run &= (k_start + bk - 1) > (q_start - window)
            if not run:
                continue
            kb = kf[:, :, k_start:k_start + bk]
            vb = vf[:, :, k_start:k_start + bk]
            s = _softcap(qb @ kb.transpose(-1, -2), softcap)
            kp = k_start + torch.arange(bk, device=q.device)[None, :]
            mask = kp < kv_len
            if causal:
                mask = mask & (kp <= qp)
            if window and window > 0:
                mask = mask & (kp > qp - window)
            s = torch.where(mask, s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            m = m_new
            acc = acc * corr + p @ vb
        o = apply_fault(acc / torch.clamp(l, min=1e-30), lane_fault)
        out[:, :, q_start:q_start + bq] = o.to(q.dtype)
    return out


def attention_flops(B, Sq, Skv, H, D, causal=True) -> int:
    """Analytic useful-FLOP model (used by the roofline report)."""
    frac = 0.5 if (causal and Sq == Skv) else 1.0
    return int(4 * B * H * Sq * Skv * D * frac)
