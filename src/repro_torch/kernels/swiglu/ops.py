"""Wrapper + Viscosity registration for the fused gated-MLP stage.

Port of the reference's ``kernels/swiglu/ops.py``.  There is no tuning
cache yet (Hopper tuning spaces are ROADMAP queue 1 item 13): the tiles
are the reference's hardcoded defaults.
"""
from __future__ import annotations

import functools

from repro_torch import viscosity
from repro_torch.kernels.swiglu import ref as _ref
from repro_torch.kernels.swiglu.kernel import swiglu_fused
from repro_torch.viscosity import lanefault


def default_tiles(M: int, F: int):
    """The reference's hardcoded (bm, bf, bs) for an (M, F) call."""
    bm = 128 if M % 128 == 0 else (8 if M % 8 == 0 else 1)
    bf = 512 if F % 512 == 0 else (128 if F % 128 == 0 else F)
    bs = 128 if min(bf, F) % 128 == 0 else bf
    return bm, bf, bs


def _hw(x, w1, w3, w2, *, act: str = "silu", interpret: bool = False,
        bm=None, bf=None, bs=None, row_independent: bool = False):
    # ``row_independent`` is a promise the kernel keeps by construction:
    # each output row depends only on its own input row.
    dbm, dbf, dbs = default_tiles(x.shape[0], w1.shape[1])
    bm, bf, bs = bm or dbm, bf or dbf, bs or dbs
    fault = lanefault.injection("swiglu_mlp")
    if interpret:
        if x.device.type != "cpu":
            raise ValueError("the INTERPRET route replays the kernel's "
                             "blocked algorithm on the CPU; got a "
                             f"{x.device} tensor")
        return _ref.swiglu_ref_blocked(x, w1, w3, w2, act=act, bm=bm, bf=bf,
                                       bs=bs, lane_fault=fault)
    return swiglu_fused(x, w1, w3, w2, act=act, bm=bm, bf=bf, bs=bs,
                        lane_fault=fault)


def _lane_slicer(args, kw, keep):
    # Output lane j depends only on w2[:, j]: slicing w2's columns to the
    # surviving lanes is exact reduced-width execution.
    x, w1, w3, w2 = args
    return (x, w1, w3, w2[:, list(keep)]), kw


SWIGLU = viscosity.defop(
    "swiglu_mlp",
    ref=_ref.swiglu_ref,
    kernel=_hw,
    interpret=functools.partial(_hw, interpret=True),
    valid=viscosity.finite_valid,
    tol=2e-2,
    flops=lambda x, w1, *a, **kw: _ref.swiglu_flops(
        x.shape[0], x.shape[1], w1.shape[1]),
    lane_slicer=_lane_slicer,
)


def swiglu(x, w1, w3, w2, *, route: str = viscosity.SW, **kw):
    return SWIGLU(x, w1, w3, w2, route=route, **kw)
