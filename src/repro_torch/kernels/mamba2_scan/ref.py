"""PyTorch oracles for the Mamba2 SSD scan.

Port of the reference's ``kernels/mamba2_scan/ref.py``.  Shapes
(ngroups = 1):
  x  (B, S, H, P)   inner activations split into H heads of dim P
  dt (B, S, H)      positive step sizes (softplus applied upstream)
  A  (H,)           negative per-head decay
  B_ (B, S, N)      input projection onto N-dim state
  C  (B, S, N)      output projection
  y  (B, S, H, P);  state (B, H, N, P)

Recurrence:  h_t = exp(dt_t A) h_{t-1} + dt_t * (B_t outer x_t)
             y_t = C_t . h_t

Every exponent the chunked forms take is ``cum_i - cum_j`` for ``i >= j``
(or ``cum``, ``tot - cum``, ``tot``), which is <= 0 inside the domain
(dt > 0, A < 0).  The intra-chunk weight selects the lower triangle BEFORE
the exponent: the reference multiplies ``exp(cum_i - cum_j)`` by the mask
(``ref.py:75``), so above the diagonal a chunk whose decay passes e^88
gives inf * 0 = NaN; here those entries are never exponentiated.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.viscosity.lanefault import apply_fault


def ssd_scan_ref(x, dt, A, B_, C):
    """Naive token-by-token scan (oracle).  Returns (y in x's dtype,
    final state f32)."""
    Bt, S, H, P = x.shape
    N = B_.shape[-1]
    xf, dtf = x.float(), dt.float()
    Bf, Cf, Af = B_.float(), C.float(), A.float()
    h = torch.zeros((Bt, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af[None, :])                 # (B,H)
        upd = dtf[:, t, :, None, None] * Bf[:, t, None, :, None] * \
            xf[:, t, :, None, :]
        h = h * decay[..., None, None] + upd                       # (B,H,N,P)
        ys.append(torch.einsum("bn,bhnp->bhp", Cf[:, t], h))
    return torch.stack(ys, dim=1).to(x.dtype), h


def _pad_seq(L, *ts):
    S = ts[0].shape[1]
    if S % L == 0:
        return ts
    pad = L - S % L
    return tuple(F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in ts)


def _tril_exp(cum):
    """exp(cum_i - cum_j) on i >= j, 0 above the diagonal; cum (..., L).
    The upper triangle is replaced by -inf before the exponent."""
    L = cum.shape[-1]
    tril = torch.ones((L, L), dtype=torch.bool, device=cum.device).tril()
    diff = cum[..., :, None] - cum[..., None, :]
    return torch.exp(torch.where(tril, diff, float("-inf")))


def ssd_chunked(x, dt, A, B_, C, *, chunk: int = 128):
    """Chunked SSD (matmul form): the production software path.
    Returns (y in x's dtype, final state f32)."""
    Bt, S, H, P = x.shape
    N = B_.shape[-1]
    L = min(chunk, S)
    x, dt, B_, C = _pad_seq(L, x, dt, B_, C)
    nc = x.shape[1] // L
    xdt = (x.float() * dt.float()[..., None]).reshape(Bt, nc, L, H, P)
    da = (dt.float() * A.float()[None, None, :]).reshape(Bt, nc, L, H)
    Bf = B_.float().reshape(Bt, nc, L, N)
    Cf = C.float().reshape(Bt, nc, L, N)
    state = torch.zeros((Bt, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        xc, bc, cc = xdt[:, c], Bf[:, c], Cf[:, c]
        cum = torch.cumsum(da[:, c], dim=1)                         # (B,L,H)
        cb = torch.einsum("bln,bsn->bls", cc, bc)                   # (B,L,L)
        dec = _tril_exp(cum.transpose(1, 2))                        # (B,H,L,L)
        w = cb[:, None] * dec
        y_intra = torch.einsum("bhls,bshp->blhp", w, xc)
        y_state = torch.einsum("bln,bhnp->blhp", cc, state) * \
            torch.exp(cum)[..., None]
        tot = cum[:, -1:, :]                                        # (B,1,H)
        bscale = torch.exp(tot - cum)                               # (B,L,H)
        upd = torch.einsum("bln,blhp->bhnp", bc, xc * bscale[..., None])
        state = state * torch.exp(tot)[:, 0, :, None, None] + upd
        ys.append(y_intra + y_state)
    y = torch.cat(ys, dim=1)[:, :S]
    return y.to(x.dtype), state


def ssd_ref_blocked(x, dt, A, B_, C, *, chunk: int = 128, lane_fault=None):
    """The blocked form of the chunked SSD, a reference for the kernel and
    ``ssd_ref_state_passing``: chunks of ``L = min(chunk, S)`` walked in
    order, one f32 (N, P) state per (b, h), the pre-scale ``xdt = x * dt``,
    ``da = dt * A`` done per chunk, the lower-triangle select before the
    exponent, and the lane fault on y's P axis before the cast.  P is
    ``x.shape[3]`` (narrow under DEGRADED_REDUCED).  S must be a multiple of
    L (the op pads).  Returns (y in x's dtype, final state f32)."""
    Bt, S, H, P = x.shape
    N = B_.shape[-1]
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"blocked SSD needs S % L == 0; got S={S}, L={L}")
    state = torch.zeros((Bt, H, N, P), dtype=torch.float32, device=x.device)
    Af = A.float()
    ys = []
    for s0 in range(0, S, L):
        dtc = dt[:, s0:s0 + L].float().transpose(1, 2)              # (B,H,L)
        xdt = x[:, s0:s0 + L].float().permute(0, 2, 1, 3) * dtc[..., None]
        bc = B_[:, s0:s0 + L].float()                               # (B,L,N)
        cc = C[:, s0:s0 + L].float()
        cum = torch.cumsum(dtc * Af[None, :, None], dim=-1)         # (B,H,L)
        tot = cum[..., -1:]
        w = (cc @ bc.transpose(1, 2))[:, None] * _tril_exp(cum)     # (B,H,L,L)
        y = w @ xdt + (cc[:, None] @ state) * torch.exp(cum)[..., None]
        ys.append(apply_fault(y, lane_fault).to(x.dtype))
        upd = (bc[:, None] * torch.exp(tot - cum)[..., None]
               ).transpose(2, 3) @ xdt                              # (B,H,N,P)
        state = state * torch.exp(tot)[..., None] + upd
    return torch.cat(ys, dim=2).permute(0, 2, 1, 3), state


def ssd_ref_state_passing(x, dt, A, B_, C, *, chunk: int = 128,
                          lane_fault=None):
    """PyTorch replica of the Hopper kernel's three phases
    (``csrc/mamba2_ssd.cu``), the plain version of
    ``kernel.ssd_chunked_cuda``, over chunks of ``L = min(chunk, S)``:

    1. chunk state: ``CB = C B^T`` once per (b, chunk); each chunk's own
       update ``U = B^T (xdt e^{tot - cum})`` and decay ``d = e^{tot}``;
    2. state pass: ``S_in[c] = d[c-1] S_in[c-1] + U[c-1]``, ``S_in[0] = 0``;
    3. chunk scan: ``W = CB e^{cum_i - cum_j}`` with the lower triangle
       selected before the exponent, ``y = W xdt + e^{cum} (C S_in)``, the
       lane fault on y's P axis before the cast.

    P is ``x.shape[3]`` (narrow under DEGRADED_REDUCED).  S must be a
    multiple of L (the op pads).  Returns (y in x's dtype, final state
    f32)."""
    Bt, S, H, P = x.shape
    N = B_.shape[-1]
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"state-passing SSD needs S % L == 0; got S={S}, "
                         f"L={L}")
    nc = S // L
    dtc = dt.float().reshape(Bt, nc, L, H).permute(0, 3, 1, 2)  # (B,H,nc,L)
    xdt = x.float().reshape(Bt, nc, L, H, P).permute(0, 3, 1, 2, 4) * \
        dtc[..., None]                                          # (B,H,nc,L,P)
    bc = B_.float().reshape(Bt, nc, L, N)                       # (B,nc,L,N)
    cc = C.float().reshape(Bt, nc, L, N)
    cum = torch.cumsum(dtc * A.float()[None, :, None, None], dim=-1)
    tot = cum[..., -1:]
    # phase 1
    cb = cc @ bc.transpose(-1, -2)                              # (B,nc,L,L)
    U = bc[:, None].transpose(-1, -2) @ \
        (xdt * torch.exp(tot - cum)[..., None])                 # (B,H,nc,N,P)
    dec = torch.exp(tot)[..., None]                             # (B,H,nc,1,1)
    # phase 2
    s = torch.zeros((Bt, H, N, P), dtype=torch.float32, device=x.device)
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = dec[:, :, c] * s + U[:, :, c]
    # phase 3
    w = cb[:, None] * _tril_exp(cum)                            # (B,H,nc,L,L)
    y = w @ xdt + (cc[:, None] @ torch.stack(s_in, dim=2)) * \
        torch.exp(cum)[..., None]
    y = apply_fault(y, lane_fault).to(x.dtype)
    return y.reshape(Bt, H, S, P).transpose(1, 2), s


def ssd_step(state, x_t, dt_t, A, B_t, C_t):
    """Single decode step.  state (B,H,N,P); returns (y_t, state)."""
    decay = torch.exp(dt_t.float() * A[None, :])
    upd = dt_t[..., None, None].float() * B_t[:, None, :, None].float() * \
        x_t[:, :, None, :].float()
    state = state * decay[..., None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", C_t.float(), state)
    return y.to(x_t.dtype), state


def ssd_flops(B, S, H, P, N, chunk=128) -> int:
    L = min(chunk, S)
    per_chunk = 2 * L * L * N + 2 * L * L * P * H + 4 * L * N * P * H
    return int(B * (S // max(L, 1)) * per_chunk)
