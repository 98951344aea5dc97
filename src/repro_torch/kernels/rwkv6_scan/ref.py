"""PyTorch oracles for the RWKV-6 "Finch" WKV recurrence.

Port of the reference's ``kernels/rwkv6_scan/ref.py``.  Shapes:
r, k, lw (B, S, H, K); v (B, S, H, V); u (H, K).  ``lw`` is the per-token,
per-channel LOG decay (the model computes lw = -exp(w0 + lora(x)) and
clamps it to [-4, -1e-4], so the chunked factorized form stays inside f32
range for chunks of up to 16 tokens: |la| <= 64 and exp(-la) <= e^64).

Recurrence (state S: (B, H, K, V), f32):
    o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.viscosity.lanefault import apply_fault


def wkv6_scan_ref(r, k, v, lw, u):
    """Token-by-token scan (oracle).  Returns (o in r's dtype, final state
    f32)."""
    Bt, S, H, K = r.shape
    V = v.shape[-1]
    rf, kf, vf, lwf = r.float(), k.float(), v.float(), lw.float()
    uf = u.float()
    state = torch.zeros((Bt, H, K, V), dtype=torch.float32, device=r.device)
    os = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]          # (B,H,K,V)
        os.append(torch.einsum("bhk,bhkv->bhv", rf[:, t],
                               state + uf[None, :, :, None] * kv))
        state = torch.exp(lwf[:, t])[..., None] * state + kv
    return torch.stack(os, dim=1).to(r.dtype), state


def _pad_seq(L, *ts):
    S = ts[0].shape[1]
    if S % L == 0:
        return ts
    pad = L - S % L
    return tuple(F.pad(t, (0, 0, 0, 0, 0, pad)) for t in ts)


def _chunk_terms(rc, kc, lwc, uf):
    """One chunk's factorized terms, all f32; rc, kc, lwc (B, H, L, K).
    Returns (qexp, scores with the strict lower triangle selected, bonus
    (B, H, L, 1), la)."""
    L = rc.shape[2]
    la = torch.cumsum(lwc, dim=2)
    la_prev = la - lwc                                           # exclusive
    qexp = rc * torch.exp(la_prev)
    kexp = kc * torch.exp(-la)
    strict = torch.ones((L, L), dtype=torch.bool,
                        device=rc.device).tril(diagonal=-1)
    scores = torch.where(strict, qexp @ kexp.transpose(-1, -2), 0.0)
    bonus = (rc * uf[None, :, None, :] * kc).sum(-1, keepdim=True)
    return qexp, scores, bonus, la


def wkv6_chunked(r, k, v, lw, u, *, chunk: int = 16):
    """Chunked factorized WKV (matmul form): the software path.  S is
    zero-padded to a multiple of ``L = min(chunk, S)``.  Returns (o in r's
    dtype, final state f32)."""
    Bt, S, H, K = r.shape
    V = v.shape[-1]
    L = min(chunk, S)
    r, k, v, lw = _pad_seq(L, r, k, v, lw)
    nc = r.shape[1] // L

    def resh(x):                                         # (nc, B, H, L, .)
        return x.float().reshape(Bt, nc, L, H, -1).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lwc = resh(r), resh(k), resh(v), resh(lw)
    uf = u.float()
    state = torch.zeros((Bt, H, K, V), dtype=torch.float32, device=r.device)
    os = []
    for c in range(nc):
        qexp, scores, bonus, la = _chunk_terms(rc[c], kc[c], lwc[c], uf)
        os.append(scores @ vc[c] + qexp @ state + bonus * vc[c])
        tot = la[:, :, -1:, :]                                   # (B,H,1,K)
        kscale = kc[c] * torch.exp(tot - la)
        state = torch.exp(tot[:, :, 0, :])[..., None] * state + \
            kscale.transpose(-1, -2) @ vc[c]
    o = torch.stack(os).permute(1, 0, 3, 2, 4).reshape(Bt, nc * L, H, V)
    return o[:, :S].to(r.dtype), state


def wkv6_ref_blocked(r, k, v, lw, u, *, chunk: int = 16, lane_fault=None):
    """The blocked form of the chunked WKV, a reference for the kernel and
    ``wkv6_ref_state_passing``: chunks of ``L = min(chunk, S)`` walked in
    order with one f32 (K, V) state per (b, h); per chunk the cumsum of lw,
    ``qexp = r e^{la - lw}``, ``kexp = k e^{-la}``, the scores' strict lower
    triangle selected (not multiplied), ``o = scores v + qexp state +
    bonus v``, the lane fault on o's V axis before the cast, and the state
    update ``e^{la_L} state + (k e^{la_L - la})^T v``.  V is
    ``v.shape[3]`` (narrow under DEGRADED_REDUCED).  S must be a multiple
    of L (the op pads).  Returns (o in r's dtype, final state f32)."""
    Bt, S, H, K = r.shape
    V = v.shape[3]
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"blocked WKV needs S % L == 0; got S={S}, L={L}")
    uf = u.float()
    state = torch.zeros((Bt, H, K, V), dtype=torch.float32, device=r.device)
    os = []
    for s0 in range(0, S, L):
        rc, kc, vc, lwc = (t[:, s0:s0 + L].float().transpose(1, 2)
                           for t in (r, k, v, lw))               # (B,H,L,.)
        qexp, scores, bonus, la = _chunk_terms(rc, kc, lwc, uf)
        o = (scores @ vc + qexp @ state) + bonus * vc
        os.append(apply_fault(o, lane_fault).to(r.dtype))
        tot = la[:, :, -1:, :]
        kscale = kc * torch.exp(tot - la)
        state = torch.exp(tot[:, :, 0, :])[..., None] * state + \
            kscale.transpose(-1, -2) @ vc
    return torch.cat(os, dim=2).transpose(1, 2), state


def wkv6_ref_state_passing(r, k, v, lw, u, *, chunk: int = 16,
                           group: int = 1, lane_fault=None):
    """PyTorch replica of the Hopper kernel's three phases
    (``csrc/rwkv6_wkv.cu``), the plain version of
    ``kernel.wkv6_chunked_cuda``: chunks of ``L = min(chunk, S)`` cut into
    groups of ``group`` chunks, and per chunk the factorization of
    ``wkv6_ref_blocked`` (cumsum of lw, ``qexp``, ``kexp``, the scores'
    strict lower triangle selected, the bonus).

    1. chunk state: each chunk's own update ``U = (k e^{la_L - la})^T v``
       and decay ``d = e^{la_L}``; each group's, walking its chunks from a
       zero state (``st = d st + U``), with the decay ``exp(sum la_L)``;
    2. state pass: ``S_in[g] = d[g-1] S_in[g-1] + U[g-1]``, ``S_in[0] = 0``;
    3. chunk scan: from ``S_in[g]``, walking the group's chunks,
       ``o = scores v + qexp state + bonus v``, the lane fault on o's V axis
       before the cast.

    V is ``v.shape[3]`` (narrow under DEGRADED_REDUCED).  S must be a
    multiple of L (the op pads).  Returns (o in r's dtype, final state
    f32)."""
    Bt, S, H, K = r.shape
    V = v.shape[3]
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"state-passing WKV needs S % L == 0; got S={S}, "
                         f"L={L}")
    nc = S // L
    G = group
    ng = -(-nc // G)
    pad = ng * G - nc

    def chunks(t):
        # (B, H, ng * G, L, .) f32; the padded chunks are zero: lw = 0
        # (decay 1) and k = v = 0 (update 0), their o is dropped
        t = t.float().reshape(Bt, nc, L, H, -1).permute(0, 3, 1, 2, 4)
        return F.pad(t, (0, 0, 0, 0, 0, pad))

    rc, kc, vc, lwc = chunks(r), chunks(k), chunks(v), chunks(lw)
    uf = u.float()[:, None, None, :]                        # (H, 1, 1, K)
    la = torch.cumsum(lwc, dim=3)
    laL = la[..., -1:, :]                                   # (B,H,nc,1,K)
    qexp = rc * torch.exp(la - lwc)
    kexp = kc * torch.exp(-la)
    strict = torch.ones((L, L), dtype=torch.bool,
                        device=r.device).tril(diagonal=-1)
    scores = torch.where(strict, qexp @ kexp.transpose(-1, -2), 0.0)
    bonus = (rc * uf * kc).sum(-1, keepdim=True)
    U = (kc * torch.exp(laL - la)).transpose(-1, -2) @ vc   # (B,H,nc,K,V)
    dec = torch.exp(laL).transpose(-1, -2)                  # (B,H,nc,K,1)

    def at(t, q):                                # chunk q of every group
        return t[:, :, q::G]

    # phase 1: each group's update and decay from a zero state
    st = torch.zeros((Bt, H, ng, K, V), dtype=torch.float32,
                     device=r.device)
    laG = torch.zeros((Bt, H, ng, K), dtype=torch.float32, device=r.device)
    for q in range(G):
        st = at(dec, q) * st + at(U, q)
        laG = laG + at(laL, q)[..., 0, :]
    decG = torch.exp(laG)[..., None]
    # phase 2: the state each group enters with
    s = torch.zeros((Bt, H, K, V), dtype=torch.float32, device=r.device)
    s_in = []
    for g in range(ng):
        s_in.append(s)
        s = decG[:, :, g] * s + st[:, :, g]
    state = torch.stack(s_in, dim=2)                        # (B,H,ng,K,V)
    # phase 3: o of each chunk, walking the group
    os = []
    for q in range(G):
        os.append((at(scores, q) @ at(vc, q) + at(qexp, q) @ state)
                  + at(bonus, q) * at(vc, q))
        state = at(dec, q) * state + at(U, q)
    o = torch.stack(os, dim=3).reshape(Bt, H, ng * G * L, V)[:, :, :S]
    o = apply_fault(o, lane_fault).to(r.dtype).transpose(1, 2)
    return o, s


def wkv6_step(state, r_t, k_t, v_t, lw_t, u):
    """Single decode step.  state (B,H,K,V) f32; returns (o_t, state)."""
    kv = k_t[..., :, None].float() * v_t[..., None, :].float()
    o = torch.einsum("bhk,bhkv->bhv", r_t.float(),
                     state + u.float()[None, :, :, None] * kv)
    state = torch.exp(lw_t.float())[..., None] * state + kv
    return o.to(r_t.dtype), state


def wkv6_flops(B, S, H, K, V, chunk=16) -> int:
    L = min(chunk, S)
    per_chunk = 2 * L * L * K + 2 * L * L * V + 4 * L * K * V
    return int(B * H * (S // max(L, 1)) * per_chunk)
