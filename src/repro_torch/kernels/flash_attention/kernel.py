"""Flash-attention forward on Hopper: the wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas kernel ``flash_attention_bhsd``
(src/repro/kernels/flash_attention/kernel.py).  On a CUDA tensor the
wrapper checks its inputs and launches the CUDA kernel, or raises; on a
CPU tensor it runs the plain version, ``attention_ref_blocked`` (the
kernel's blocked algorithm in PyTorch).  ``flash_attention_bhsd.launches``
counts CUDA launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref_blocked

_NAME = "flash_attention"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PROTOTYPES = {
    "flash_attention_fwd": (
        _P, _P, _P, _P,                      # q, k, v, o
        _I, _I, _I, _I, _I, _I, _I, _I,      # B, H, Hkv, Sq, Skv, D, Dv, kv_len
        _F, _I, _I, _F,                      # scale, causal, window, softcap
        _I, _P, _F, _F,                      # fault kind, mask, value, gain
        _P),                                 # stream
}
DMAX = 128   # the CUDA kernel's widest head dim


def _pad_last(x, m):
    r = x.shape[-1] % m
    return x if r == 0 else F.pad(x, (0, m - r))


def _launch(q, k, v, *, causal, window, softcap, scale, kv_len, lane_fault):
    req = _build.require
    for name, t in (("q", q), ("k", k), ("v", v)):
        req(t.dtype == torch.bfloat16,
            f"flash_attention: {name} must be bfloat16, got {t.dtype}")
        req(t.device == q.device,
            f"flash_attention: {name} is on {t.device}, q on {q.device}")
        req(t.dim() == 4, f"flash_attention: {name} must be (B, H, S, D)")
    B, H, Sq, D = q.shape
    _, Hkv, Skv, Dv = v.shape
    req(k.shape == (B, Hkv, Skv, D) and v.shape[:3] == (B, Hkv, Skv),
        f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
        f"v {tuple(v.shape)} do not agree")
    req(Hkv >= 1 and H % Hkv == 0, f"flash_attention: H={H} % Hkv={Hkv}")
    req(D <= DMAX and Dv <= DMAX,
        f"flash_attention: head dims {D}, {Dv} exceed {DMAX}")
    # the kernel takes head dims in multiples of 16: zero lanes add nothing
    # to q.k and produce output lanes that are sliced away
    qp, kp, vp = (_pad_last(t, 16).contiguous() for t in (q, k, v))
    for t in (qp, kp, vp):
        req(t.data_ptr() % 16 == 0, "flash_attention: inputs must be "
            "16-byte aligned")
    Dp, Dvp = qp.shape[-1], vp.shape[-1]
    out = torch.empty((B, H, Sq, Dvp), dtype=torch.bfloat16, device=q.device)
    kind, mask, value, gain = _build.lane_fault_args(lane_fault, Dv, q.device)
    lib = _build.load(_NAME, _PROTOTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention_fwd(
        qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), out.data_ptr(),
        B, H, Hkv, Sq, Skv, Dp, Dvp, kv_len or Skv,
        scale or 1.0 / D ** 0.5, int(causal), int(window or 0),
        float(softcap or 0.0), kind,
        mask.data_ptr() if mask is not None else None, value, gain, stream)
    _build.check(lib, _NAME, rc)
    flash_attention_bhsd.launches += 1
    return out if Dvp == Dv else out[..., :Dv]


def flash_attention_bhsd(q, k, v, *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0, scale: float = 0.0,
                         kv_len: int = 0, bq: int = 128, bk: int = 128,
                         lane_fault=None):
    """q (B, H, Sq, D); k (B, Hkv, Skv, D); v (B, Hkv, Skv, Dv).  The output
    width is ``v.shape[3]`` (narrow under DEGRADED_REDUCED).

    CUDA tensors: the Hopper kernel, bf16 only, with its own 64x64 tiles
    (``bq``/``bk`` shape only the plain version); any Sq, Skv.  CPU
    tensors: the plain blocked version, Sq % bq == Skv % bk == 0."""
    if q.device.type == "cuda":
        return _launch(q, k, v, causal=causal, window=window,
                       softcap=softcap, scale=scale, kv_len=kv_len,
                       lane_fault=lane_fault)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return attention_ref_blocked(q, k, v, causal=causal, window=window,
                                 softcap=softcap, scale=scale, kv_len=kv_len,
                                 bq=bq, bk=bk, lane_fault=lane_fault)


flash_attention_bhsd.launches = 0
