"""Fused gated MLP on Hopper: the wrapper of ``csrc/swiglu.cu``.

Replaces the Pallas kernel ``swiglu_pallas``
(src/repro/kernels/swiglu/kernel.py).  On a CUDA tensor the wrapper checks
its inputs, allocates the output and the per-F-chunk f32 partials, and
launches the kernel (two CUDA kernels: the F-split pass and the
fixed-order reduction), or raises; on a CPU tensor it runs the plain
version, ``swiglu_ref_blocked``.  ``swiglu_fused.launches`` counts CUDA
launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.swiglu.ref import swiglu_ref_blocked

_NAME = "swiglu"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PROTOTYPES = {
    "swiglu_fwd": (
        _P, _P, _P, _P, _P, _P,              # x, w1, w3, w2, ws, out
        _I, _I, _I, _I, _I,                  # M, D, F, Do, act
        _I, _P, _F, _F,                      # fault kind, mask, value, gain
        _P),                                 # stream
}
ACTS = {"silu": 0, "gelu": 1}
TILE = 64   # the kernel's D chunk, F chunk and Do chunk


def _pad(x, rows, cols):
    r = (TILE - rows % TILE) % TILE
    c = (TILE - cols % TILE) % TILE
    return x if r == 0 and c == 0 else F.pad(x, (0, c, 0, r))


def _launch(x, w1, w3, w2, *, act, lane_fault):
    req = _build.require
    for name, t in (("x", x), ("w1", w1), ("w3", w3), ("w2", w2)):
        req(t.dtype == torch.bfloat16,
            f"swiglu: {name} must be bfloat16, got {t.dtype}")
        req(t.device == x.device,
            f"swiglu: {name} is on {t.device}, x on {x.device}")
        req(t.dim() == 2, f"swiglu: {name} must be 2-D")
    req(act in ACTS, f"swiglu: unknown act {act!r}")
    M, D = x.shape
    Fd = w1.shape[1]
    Do = w2.shape[1]
    req(M >= 1 and w1.shape == (D, Fd) and w3.shape == (D, Fd)
        and w2.shape[0] == Fd,
        f"swiglu: shapes x {tuple(x.shape)} w1 {tuple(w1.shape)} "
        f"w3 {tuple(w3.shape)} w2 {tuple(w2.shape)} do not agree")
    # the kernel takes D, F and Do in multiples of 64: zero rows/columns
    # add nothing (silu(0) * 0 = gelu(0) * 0 = 0) and extra output lanes
    # are sliced away
    xp = _pad(x, 0, D).contiguous()
    w1p, w3p = (_pad(w, D, Fd).contiguous() for w in (w1, w3))
    w2p = _pad(w2, Fd, Do).contiguous()
    for t in (xp, w1p, w3p, w2p):
        req(t.data_ptr() % 16 == 0, "swiglu: inputs must be 16-byte aligned")
    Dp, Fp, Dop = xp.shape[1], w1p.shape[1], w2p.shape[1]
    mp = (M + 15) // 16 * 16
    ws = torch.empty((Fp // TILE, mp, Dop), dtype=torch.float32,
                     device=x.device)
    out = torch.empty((M, Dop), dtype=torch.bfloat16, device=x.device)
    kind, mask, value, gain = _build.lane_fault_args(lane_fault, Do, x.device)
    lib = _build.load(_NAME, _PROTOTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.swiglu_fwd(
        xp.data_ptr(), w1p.data_ptr(), w3p.data_ptr(), w2p.data_ptr(),
        ws.data_ptr(), out.data_ptr(), M, Dp, Fp, Dop, ACTS[act], kind,
        mask.data_ptr() if mask is not None else None, value, gain, stream)
    _build.check(lib, _NAME, rc)
    swiglu_fused.launches += 1
    return out if Dop == Do else out[:, :Do]


def swiglu_fused(x, w1, w3, w2, *, act: str = "silu", bm: int = 128,
                 bf: int = 512, bs: int = 128, lane_fault=None):
    """x (M, D); w1/w3 (D, F); w2 (F, Do) -> (M, Do).

    CUDA tensors: the Hopper kernel, bf16 only, with its own 64-wide tiles
    (``bm``/``bf``/``bs`` shape only the plain version); any M.  CPU
    tensors: the plain blocked version."""
    if x.device.type == "cuda":
        return _launch(x, w1, w3, w2, act=act, lane_fault=lane_fault)
    if x.device.type != "cpu":
        raise ValueError(f"swiglu: unsupported device {x.device}")
    return swiglu_ref_blocked(x, w1, w3, w2, act=act, bm=bm, bf=bf, bs=bs,
                              lane_fault=lane_fault)


swiglu_fused.launches = 0
