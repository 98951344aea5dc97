"""Chunked RWKV-6 WKV on Hopper: the wrapper of ``csrc/rwkv6_wkv.cu``.

Replaces the Pallas kernel ``wkv6_chunked_pallas``
(src/repro/kernels/rwkv6_scan/kernel.py).  On a CUDA tensor the wrapper
checks its inputs, zero-pads K and V to the kernel's 64, allocates o and
(when asked) the final state, and launches the kernel, or raises; on a CPU
tensor it runs the plain version, ``wkv6_ref_blocked``.
``wkv6_chunked_cuda.launches`` counts CUDA launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref_blocked

_NAME = "rwkv6_wkv"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PROTOTYPES = {
    "rwkv6_wkv_fwd": (
        _P, _P, _P, _P, _P, _P, _P,          # r, k, v, lw, u, o, state
        _I, _I, _I, _I,                      # B, S, H, L
        _I, _P, _F, _F,                      # fault kind, mask, value, gain
        _P),                                 # stream
}
WIDTH = 64   # the kernel's K and V
# The longest chunk: the factorization takes exp(-la) with |la| up to
# L * 4 (lw >= -4), which stays inside f32 (e^64 < e^88) only for L <= 16.
LMAX = 16


def _pad_last(t, width):
    return t if t.shape[-1] == width else F.pad(t, (0, width - t.shape[-1]))


def _launch(r, k, v, lw, u, *, L, lane_fault, with_state):
    req = _build.require
    for name, t, dtype in (("r", r, torch.bfloat16), ("k", k, torch.bfloat16),
                           ("v", v, torch.bfloat16),
                           ("lw", lw, torch.bfloat16), ("u", u, torch.float32)):
        req(t.dtype == dtype, f"rwkv6_wkv: {name} must be {dtype}, "
            f"got {t.dtype}")
        req(t.device == r.device,
            f"rwkv6_wkv: {name} is on {t.device}, r on {r.device}")
    req(r.dim() == 4, "rwkv6_wkv: r must be (B, S, H, K)")
    Bt, S, H, K = r.shape
    V = v.shape[-1]
    req(k.shape == r.shape and lw.shape == r.shape
        and v.shape == (Bt, S, H, V) and u.shape == (H, K),
        f"rwkv6_wkv: shapes r {tuple(r.shape)} k {tuple(k.shape)} "
        f"v {tuple(v.shape)} lw {tuple(lw.shape)} u {tuple(u.shape)} "
        "do not agree")
    req(K <= WIDTH and V <= WIDTH,
        f"rwkv6_wkv: K={K}, V={V} exceed the kernel's {WIDTH}")
    req(1 <= L <= LMAX and S % L == 0,
        f"rwkv6_wkv: chunk L={L} must be in [1, {LMAX}] and divide S={S}")
    # zero r/k channels (with lw = 0 and u = 0) and zero v lanes add
    # nothing; their outputs are sliced away
    rp, kp, vp, lwp = (_pad_last(t, WIDTH).contiguous()
                       for t in (r, k, v, lw))
    up = _pad_last(u, WIDTH).contiguous()
    for t in (rp, kp, vp, lwp):
        req(t.data_ptr() % 16 == 0, "rwkv6_wkv: inputs must be 16-byte "
            "aligned")
    o = torch.empty((Bt, S, H, WIDTH), dtype=r.dtype, device=r.device)
    state = (torch.empty((Bt, H, WIDTH, WIDTH), dtype=torch.float32,
                         device=r.device) if with_state else None)
    kind, mask, value, gain = _build.lane_fault_args(lane_fault, V, r.device)
    if mask is not None and mask.numel() < WIDTH // 32:
        mask = F.pad(mask, (0, WIDTH // 32 - mask.numel()))  # padded lanes
    lib = _build.load(_NAME, _PROTOTYPES)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    rc = lib.rwkv6_wkv_fwd(
        rp.data_ptr(), kp.data_ptr(), vp.data_ptr(), lwp.data_ptr(),
        up.data_ptr(), o.data_ptr(),
        state.data_ptr() if state is not None else None, Bt, S, H, L, kind,
        mask.data_ptr() if mask is not None else None, value, gain, stream)
    _build.check(lib, _NAME, rc)
    wkv6_chunked_cuda.launches += 1
    o = o if V == WIDTH else o[..., :V]
    if state is not None and (K, V) != (WIDTH, WIDTH):
        state = state[:, :, :K, :V]
    return o, state


def wkv6_chunked_cuda(r, k, v, lw, u, *, chunk: int = 16, lane_fault=None,
                      with_state: bool = False):
    """r/k/lw (B,S,H,K), v (B,S,H,V), u (H,K) f32 -> (o (B,S,H,V) in r's
    dtype, the final state (B,H,K,V) f32 when ``with_state`` else None).
    S must be a multiple of ``L = min(chunk, S)`` (the op pads).

    CUDA tensors: the Hopper kernel; r, k, v and lw bf16, K and V up to
    64.  CPU tensors: the plain blocked version.  On both, L up to 16."""
    L = min(chunk, r.shape[1])
    _build.require(L <= LMAX, f"rwkv6_wkv: chunk {chunk} exceeds {LMAX}: "
                   "the factorization leaves f32 range past it")
    if r.device.type == "cuda":
        return _launch(r, k, v, lw, u, L=L, lane_fault=lane_fault,
                       with_state=with_state)
    if r.device.type != "cpu":
        raise ValueError(f"rwkv6_wkv: unsupported device {r.device}")
    o, state = wkv6_ref_blocked(r, k, v, lw, u, chunk=L,
                                lane_fault=lane_fault)
    return o, (state if with_state else None)


wkv6_chunked_cuda.launches = 0
