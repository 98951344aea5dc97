"""Wrapper + Viscosity registration for the Mamba2 SSD stage.

Port of the reference's ``kernels/mamba2_scan/ops.py``.  There is no
tuning cache yet (Hopper tuning spaces are ROADMAP queue 1 item 13): the
chunk is the reference's default, 128.

Both full lowerings take ``with_state``: the HW lowering then also returns
the final state from the kernel's state pass, the SW lowering the one its
``ssd_chunked`` scan ends with.
"""
from __future__ import annotations

import functools

import torch.nn.functional as F

from repro_torch import viscosity
from repro_torch.kernels.mamba2_scan import ref as _ref
from repro_torch.kernels.mamba2_scan.kernel import ssd_chunked_cuda
from repro_torch.viscosity import lanefault

CHUNK = 128


def _sw(x, dt, A, B_, C, *, chunk=None, with_state: bool = False):
    y, state = _ref.ssd_chunked(x, dt, A, B_, C, chunk=chunk or CHUNK)
    return (y, state) if with_state else y


def _hw(x, dt, A, B_, C, *, chunk=None, interpret: bool = False,
        with_state: bool = False):
    S = x.shape[1]
    L = min(chunk or CHUNK, S)
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
