"""Wrapper + Viscosity registration for the checksum detector.

Port of the reference's ``kernels/checksum/ops.py``: SW is the plain
``checksum_ref``, HW the Hopper kernel (its plain blocked version on a CPU
tensor), INTERPRET the TPU kernel's blocked algorithm on the CPU.  The
contract is bit-exact (``tol=0.0``).
"""
from __future__ import annotations

import functools

from repro_torch import viscosity
from repro_torch.kernels.checksum import ref as _ref
from repro_torch.kernels.checksum.kernel import checksum_popcount


def _hw(x, *, interpret: bool = False):
    if interpret:
        if x.device.type != "cpu":
            raise ValueError("the INTERPRET route replays the kernel's "
                             "blocked algorithm on the CPU; got a "
                             f"{x.device} tensor")
        return _ref.checksum_ref_blocked(x)
    return checksum_popcount(x)


CHECKSUM = viscosity.defop(
    "checksum",
    ref=_ref.checksum_ref,
    kernel=_hw,
    interpret=functools.partial(_hw, interpret=True),
    tol=0.0,  # bit-exact contract
)


def checksum(x, *, route: str = viscosity.SW, **kw):
    return CHECKSUM(x, route=route, **kw)
