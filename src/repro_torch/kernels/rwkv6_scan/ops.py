"""Wrapper + Viscosity registration for the RWKV-6 WKV stage.

Port of the reference's ``kernels/rwkv6_scan/ops.py``.  The chunk is
the tuning cache's (``_tuned_chunk``; at most 16, the f32 range bound) for
the SW lowering and for the HW lowering on CUDA tensors, else the
reference's default, 16; the plain version and the INTERPRET replica on
CPU tensors keep the default.

Both full lowerings take ``with_state``: the HW lowering then also returns
the final state from the kernel's state pass, the SW lowering the one its
``wkv6_chunked`` scan ends with.
"""
from __future__ import annotations

import functools

import torch.nn.functional as F

from repro_torch import viscosity
from repro_torch.kernels import tuning
from repro_torch.kernels.rwkv6_scan import ref as _ref
from repro_torch.kernels.rwkv6_scan.kernel import plan, wkv6_chunked_cuda
from repro_torch.viscosity import lanefault

CHUNK = 16


def _tuned_chunk(kind, r, v, default):
    cfg = tuning.lookup_once(
        "rwkv6_wkv", kind,
        (r.shape[0], r.shape[1], r.shape[2], r.shape[3], v.shape[-1]),
        r.dtype) or {}
    return cfg.get("chunk") or default


def _sw(r, k, v, lw, u, *, chunk=None, with_state: bool = False):
    chunk = chunk or _tuned_chunk("sw", r, v, CHUNK)
    o, state = _ref.wkv6_chunked(r, k, v, lw, u, chunk=chunk)
    return (o, state) if with_state else o


def _hw(r, k, v, lw, u, *, chunk=None, interpret: bool = False,
        with_state: bool = False):
    if not chunk:
        chunk = (_tuned_chunk("hw", r, v, CHUNK)
                 if r.device.type == "cuda" and not interpret else CHUNK)
    S = r.shape[1]
    L = min(chunk, S)
    if S % L:
        # zero tokens (k = v = 0, lw = 0) change neither the real tokens' o
        # nor the final state (decay e^0 = 1, update 0)
        r, k, v, lw = (F.pad(t, (0, 0, 0, 0, 0, L - S % L))
                       for t in (r, k, v, lw))
    fault = lanefault.injection("rwkv6_wkv")
    if interpret:
        if r.device.type != "cpu":
            raise ValueError("the INTERPRET route replays the kernel's "
                             "three phases on the CPU; got a "
                             f"{r.device} tensor")
        o, state = _ref.wkv6_ref_state_passing(
            r, k, v, lw, u, chunk=L,
            group=plan(r.shape[0], r.shape[1], r.shape[2], L).group,
            lane_fault=fault)
    else:
        o, state = wkv6_chunked_cuda(r, k, v, lw, u, chunk=L,
                                     lane_fault=fault, with_state=with_state)
    return (o[:, :S], state) if with_state else o[:, :S]


def _lane_slicer(args, kw, keep):
    # o's value lane j depends only on v[..., j] (scores and the state's
    # decay mix over K and the sequence, never across V): slicing v is
    # exact reduced width.
    r, k, v, lw, u = args
    return (r, k, v[..., list(keep)], lw, u), kw


WKV6 = viscosity.defop(
    "rwkv6_wkv",
    ref=_sw,
    kernel=_hw,
    interpret=functools.partial(_hw, interpret=True),
    valid=viscosity.finite_valid,
    tol=2e-2,
    flops=lambda r, k, v, *a, **kw: _ref.wkv6_flops(
        r.shape[0], r.shape[1], r.shape[2], r.shape[3], v.shape[-1]),
    lane_slicer=_lane_slicer,
)


def wkv6(r, k, v, lw, u, *, route: str = viscosity.SW, **kw):
    return WKV6(r, k, v, lw, u, route=route, **kw)
