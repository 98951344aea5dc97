"""Chunked Mamba2 SSD on Hopper: the wrapper of ``csrc/mamba2_ssd.cu``.

Replaces the Pallas kernel ``ssd_chunked_pallas``
(src/repro/kernels/mamba2_scan/kernel.py).  On a CUDA tensor the wrapper
checks its inputs, zero-pads N and P to the kernel's 64, allocates y and
(when asked) the final state, and launches the kernel, or raises; on a CPU
tensor it runs the plain version, ``ssd_ref_blocked``.
``ssd_chunked_cuda.launches`` counts CUDA launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.mamba2_scan.ref import ssd_ref_blocked

_NAME = "mamba2_ssd"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PROTOTYPES = {
    "mamba2_ssd_fwd": (
        _P, _P, _P, _P, _P, _P, _P,          # x, dt, A, B, C, y, state
        _I, _I, _I, _I,                      # B, S, H, L
        _I, _P, _F, _F,                      # fault kind, mask, value, gain
        _P),                                 # stream
}
WIDTH = 64   # the kernel's N and P
LMAX = 128   # the kernel's longest chunk


def _pad_last(t, width):
    return t if t.shape[-1] == width else F.pad(t, (0, width - t.shape[-1]))


def _launch(x, dt, A, B_, C, *, L, lane_fault, with_state):
    req = _build.require
    for name, t, dtype in (("x", x, torch.bfloat16), ("B_", B_, torch.bfloat16),
                           ("C", C, torch.bfloat16), ("dt", dt, torch.float32),
                           ("A", A, torch.float32)):
        req(t.dtype == dtype, f"mamba2_ssd: {name} must be {dtype}, "
            f"got {t.dtype}")
        req(t.device == x.device,
            f"mamba2_ssd: {name} is on {t.device}, x on {x.device}")
    req(x.dim() == 4, "mamba2_ssd: x must be (B, S, H, P)")
    Bt, S, H, P = x.shape
    N = B_.shape[-1]
    req(dt.shape == (Bt, S, H) and A.shape == (H,)
        and B_.shape == (Bt, S, N) and C.shape == (Bt, S, N),
        f"mamba2_ssd: shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
        f"A {tuple(A.shape)} B {tuple(B_.shape)} C {tuple(C.shape)} "
        "do not agree")
    req(P <= WIDTH and N <= WIDTH,
        f"mamba2_ssd: P={P}, N={N} exceed the kernel's {WIDTH}")
    req(1 <= L <= LMAX and S % L == 0,
        f"mamba2_ssd: chunk L={L} must be in [1, {LMAX}] and divide S={S}")
    # zero B/C columns and zero x lanes add nothing; their outputs are
    # sliced away
    xp = _pad_last(x, WIDTH).contiguous()
    Bp, Cp = (_pad_last(t, WIDTH).contiguous() for t in (B_, C))
    dtc, Ac = dt.contiguous(), A.contiguous()
    for t in (xp, Bp, Cp):
        req(t.data_ptr() % 16 == 0, "mamba2_ssd: inputs must be 16-byte "
            "aligned")
    y = torch.empty((Bt, S, H, WIDTH), dtype=x.dtype, device=x.device)
    state = (torch.empty((Bt, H, WIDTH, WIDTH), dtype=torch.float32,
                         device=x.device) if with_state else None)
    kind, mask, value, gain = _build.lane_fault_args(lane_fault, P, x.device)
    if mask is not None and mask.numel() < WIDTH // 32:
        mask = F.pad(mask, (0, WIDTH // 32 - mask.numel()))  # padded lanes
    lib = _build.load(_NAME, _PROTOTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.mamba2_ssd_fwd(
        xp.data_ptr(), dtc.data_ptr(), Ac.data_ptr(), Bp.data_ptr(),
        Cp.data_ptr(), y.data_ptr(),
        state.data_ptr() if state is not None else None, Bt, S, H, L, kind,
        mask.data_ptr() if mask is not None else None, value, gain, stream)
    _build.check(lib, _NAME, rc)
    ssd_chunked_cuda.launches += 1
    y = y if P == WIDTH else y[..., :P]
    if state is not None and (N, P) != (WIDTH, WIDTH):
        state = state[:, :, :N, :P]
    return y, state


def ssd_chunked_cuda(x, dt, A, B_, C, *, chunk: int = 128, lane_fault=None,
                     with_state: bool = False):
    """x (B,S,H,P), dt (B,S,H) f32, A (H,) f32, B_/C (B,S,N) -> (y
    (B,S,H,P) in x's dtype, the final state (B,H,N,P) f32 when
    ``with_state`` else None).  S must be a multiple of ``L = min(chunk,
    S)`` (the op pads).

    CUDA tensors: the Hopper kernel; x, B_ and C bf16, P and N up to 64,
    L up to 128.  CPU tensors: the plain blocked version."""
    L = min(chunk, x.shape[1])
    if x.device.type == "cuda":
        return _launch(x, dt, A, B_, C, L=L, lane_fault=lane_fault,
                       with_state=with_state)
    if x.device.type != "cpu":
        raise ValueError(f"mamba2_ssd: unsupported device {x.device}")
    y, state = ssd_ref_blocked(x, dt, A, B_, C, chunk=L,
                               lane_fault=lane_fault)
    return y, (state if with_state else None)


ssd_chunked_cuda.launches = 0
