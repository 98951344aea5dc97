"""Wrapper + Viscosity registration for the Mamba2 SSD stage.

Port of the reference's ``kernels/mamba2_scan/ops.py``.  The chunk is
the tuning cache's (``_tuned_chunk``) for the SW lowering and for the HW
lowering on CUDA tensors, else the reference's default, 128; the plain
version and the INTERPRET replica on CPU tensors keep the default.

Both full lowerings take ``with_state``: the HW lowering then also returns
the final state from the kernel's state pass, the SW lowering the one its
``ssd_chunked`` scan ends with.
"""
from __future__ import annotations

import functools

import torch.nn.functional as F

from repro_torch import viscosity
from repro_torch.kernels import tuning
from repro_torch.kernels.mamba2_scan import ref as _ref
from repro_torch.kernels.mamba2_scan.kernel import ssd_chunked_cuda
from repro_torch.viscosity import lanefault

CHUNK = 128


def _tuned_chunk(kind, x, B_, default):
    cfg = tuning.lookup_once(
        "mamba2_ssd", kind,
        (x.shape[0], x.shape[1], x.shape[2], x.shape[3], B_.shape[-1]),
        x.dtype) or {}
    return cfg.get("chunk") or default


def _sw(x, dt, A, B_, C, *, chunk=None, with_state: bool = False):
    chunk = chunk or _tuned_chunk("sw", x, B_, CHUNK)
    y, state = _ref.ssd_chunked(x, dt, A, B_, C, chunk=chunk)
    return (y, state) if with_state else y


def _hw(x, dt, A, B_, C, *, chunk=None, interpret: bool = False,
        with_state: bool = False):
    if not chunk:
        chunk = (_tuned_chunk("hw", x, B_, CHUNK)
                 if x.device.type == "cuda" and not interpret else CHUNK)
    S = x.shape[1]
    L = min(chunk, S)
    if S % L:
        # zero tokens with dt = 0 change neither the real tokens' y nor the
        # final state (decay exp(0) = 1, update 0)
        pad = L - S % L
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, B_, C = (F.pad(t, (0, 0, 0, pad)) for t in (dt, B_, C))
    fault = lanefault.injection("mamba2_ssd")
    if interpret:
        if x.device.type != "cpu":
            raise ValueError("the INTERPRET route replays the kernel's "
                             "three phases on the CPU; got a "
                             f"{x.device} tensor")
        y, state = _ref.ssd_ref_state_passing(x, dt, A, B_, C, chunk=L,
                                              lane_fault=fault)
    else:
        y, state = ssd_chunked_cuda(x, dt, A, B_, C, chunk=L,
                                    lane_fault=fault, with_state=with_state)
    return (y[:, :S], state) if with_state else y[:, :S]


def _lane_slicer(args, kw, keep):
    # y's head-channel lane j depends only on x[..., j] (the SSD mixes over
    # sequence/state, never across P): slicing x is exact reduced width.
    x, dt, A, B_, C = args
    return (x[..., list(keep)], dt, A, B_, C), kw


SSD = viscosity.defop(
    "mamba2_ssd",
    ref=_sw,
    kernel=_hw,
    interpret=functools.partial(_hw, interpret=True),
    valid=viscosity.finite_valid,
    tol=2e-2,
    flops=lambda x, dt, A, B_, C, **kw: _ref.ssd_flops(
        x.shape[0], x.shape[1], x.shape[2], x.shape[3], B_.shape[-1]),
    lane_slicer=_lane_slicer,
)


def ssd(x, dt, A, B_, C, *, route: str = viscosity.SW, **kw):
    return SSD(x, dt, A, B_, C, route=route, **kw)
