"""Value-level lane faults and the DEGRADED route family (paper §III-A).

Port of the reference's ``viscosity/lanefault.py``:

  * ``LaneFault`` describes a value-level defect on the lane (minor) axis
    of a kernel's output tile: a stuck-at lane, a dropped-MAC column
    (-> 0) or a gain-skewed lane.  It touches only tensors whose minor
    axis equals its ``width``.
  * The **injection registry** (``inject``/``injection``): each kernel's
    ``ops.py`` reads it on the HW path and hands the fault to the kernel,
    whose epilogue corrupts the output tile in float32 before the store.
    With nothing registered the healthy kernel instantiation runs.
  * The **lane-map registry** (``known_map``/``fault_map``): what
    detection has localized.  Routing consults it.
  * The **DEGRADED lowerings** (``lower_degraded``): remap heals the dead
    lanes from the SW oracle; reduced runs the kernel on the surviving
    lanes (through the op's ``lane_slicer``) and takes the dead lanes from
    the oracle.

Both registries are process-global and keyed by stage name: they model
this host's silicon.  In eager PyTorch they are read at call time.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.viscosity.lang import (DEGRADED_REDUCED, DEGRADED_REMAP,
                                        DEGRADED_TARGETS, HW, INTERPRET, SW)

# Fault kinds (the value-level defects a LaneFault can describe).
STUCK = "stuck"                # lane pinned to ``value``
DROPPED_MAC = "dropped_mac"    # dead MAC column: accumulates nothing -> 0
GAIN = "gain"                  # lane scaled by ``gain``
KINDS = (STUCK, DROPPED_MAC, GAIN)

# The degradation ladder: fault k on a lane-mapped stage lands on rung k.
RUNGS = (DEGRADED_REMAP, DEGRADED_REDUCED, SW)


def _tree_map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (tuple, list)):
        return type(t0)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _lane_tensor(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point() \
        and x.dim() >= 1


@dataclass(frozen=True)
class LaneFault:
    """One value-level defect on the lane (minor) axis of a stage's output.

    ``width`` is the lane-axis width the map refers to; ``apply`` touches
    only tensors whose minor axis matches it.  ``value`` defaults to a
    nonzero stuck-at level: a stuck-at-zero lane over a zero activation is
    undetectable.
    """

    kind: str
    lanes: Tuple[int, ...]
    width: int
    value: float = 1.5
    gain: float = 1.25

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown lane-fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.width < 2:
            raise ValueError(f"lane width must be >= 2, got {self.width}")
        lanes = tuple(sorted(set(int(x) for x in self.lanes)))
        object.__setattr__(self, "lanes", lanes)
        if not lanes:
            raise ValueError("a LaneFault must name at least one lane")
        if lanes[0] < 0 or lanes[-1] >= self.width:
            raise ValueError(f"lanes {lanes} out of range for width "
                             f"{self.width}")
        if len(lanes) >= self.width:
            raise ValueError(f"all {self.width} lanes dead: that is a device "
                             "fault, not a lane fault")

    # ------------------------------------------------------------ queries
    def survivors(self) -> Tuple[int, ...]:
        dead = set(self.lanes)
        return tuple(i for i in range(self.width) if i not in dead)

    def lane_mask(self, x: torch.Tensor) -> torch.Tensor:
        """Boolean mask shaped like ``x`` (True on faulted lanes of the
        minor axis)."""
        m = torch.zeros(x.shape[-1], dtype=torch.bool, device=x.device)
        m[list(self.lanes)] = True
        return m.expand(x.shape)

    # ----------------------------------------------------------- corrupt
    def apply(self, x):
        """Masked corruption of ``x``'s minor axis; identity for tensors
        whose minor axis is not this fault's ``width``."""
        if not _lane_tensor(x) or x.shape[-1] != self.width:
            return x
        mask = self.lane_mask(x)
        if self.kind == STUCK:
            return torch.where(mask, torch.tensor(self.value, dtype=x.dtype,
                                                  device=x.device), x)
        if self.kind == DROPPED_MAC:
            return torch.where(mask, torch.zeros((), dtype=x.dtype,
                                                 device=x.device), x)
        return torch.where(mask, x * torch.tensor(self.gain, dtype=x.dtype,
                                                  device=x.device), x)

    def corrupt_tree(self, out):
        return _tree_map(self.apply, out)


# ---------------------------------------------------------------- registry
#   _INJECT: the defect active in the silicon — kernels corrupt with it.
#   _MAPS:   the defect detection has localized — routing degrades with it.
_INJECT: Dict[str, LaneFault] = {}
_MAPS: Dict[str, Tuple[LaneFault, str]] = {}


def set_injection(stage: str, fault: LaneFault):
    _INJECT[stage] = fault


def clear_injection(stage: str):
    _INJECT.pop(stage, None)


def injection(stage: str) -> Optional[LaneFault]:
    """The fault actively corrupting ``stage``'s HW path (None = healthy)."""
    return _INJECT.get(stage)


@contextlib.contextmanager
def inject(stage: str, fault: LaneFault):
    """Corrupt ``stage``'s HW path for the duration of the context."""
    set_injection(stage, fault)
    try:
        yield fault
    finally:
        clear_injection(stage)


def set_map(stage: str, fault: LaneFault, base: str = HW):
    """Record a localized lane map for ``stage``; ``base`` is the target
    the DEGRADED lowerings wrap."""
    if base not in (HW, SW, INTERPRET):
        raise ValueError(f"degraded base target must be one of "
                         f"{(HW, SW, INTERPRET)}, got {base!r}")
    _MAPS[stage] = (fault, base)


def clear_map(stage: str):
    _MAPS.pop(stage, None)


def fault_map(stage: str) -> Optional[LaneFault]:
    rec = _MAPS.get(stage)
    return rec[0] if rec else None


def map_base(stage: str) -> Optional[str]:
    rec = _MAPS.get(stage)
    return rec[1] if rec else None


@contextlib.contextmanager
def known_map(stage: str, fault: LaneFault, base: str = HW):
    set_map(stage, fault, base)
    try:
        yield fault
    finally:
        clear_map(stage)


def reset():
    """Drop every registered injection and lane map (test hygiene)."""
    _INJECT.clear()
    _MAPS.clear()


# ---------------------------------------------------------------- kernels
def apply_fault(x, fault: Optional[LaneFault]):
    """The plain versions' fault point: masked corruption of one output
    tile (the CUDA kernels apply the same in their epilogue)."""
    if fault is None:
        return x
    return fault.apply(x)


# ----------------------------------------------------------------- ladder
def rung_for(n_faults: int) -> str:
    """Target for the ``n_faults``-th fault on a lane-mapped stage:
    remap -> reduced-width -> full SW oracle (and it stays there)."""
    if n_faults < 1:
        raise ValueError(f"rung_for needs >= 1 fault, got {n_faults}")
    return RUNGS[min(n_faults - 1, len(RUNGS) - 1)]


def degraded_plan(plan, counts: Mapping[str, int]):
    """Ladder a RoutingPlan by per-stage fault counts: stages with a known
    lane map take the count's rung; unmapped stages keep whatever binary
    fallback the plan already assigned them."""
    for stage, n in sorted(counts.items()):
        if n > 0 and fault_map(stage) is not None:
            plan = plan.with_target(stage, rung_for(n))
    return plan


# -------------------------------------------------------------- lowerings
def lower_degraded(spec, target: str) -> Callable:
    """Lower one OpSpec to a DEGRADED target using its registered lane map.

    remap:   out = oracle on the dead lanes, base HW path elsewhere
    reduced: run the kernel on the surviving-lane operand window (via the
             op's ``lane_slicer``) and fill the dead lanes from the
             oracle; no slicer -> remap semantics.
    """
    if target not in DEGRADED_TARGETS:
        raise ValueError(f"{target!r} is not a DEGRADED target")
    rec = _MAPS.get(spec.name)
    if rec is None:
        raise ValueError(
            f"stage {spec.name!r} routed to {target!r} but no lane map is "
            "registered; detection must localize the fault first "
            "(lanefault.set_map / known_map)")
    fault, base = rec
    hw_fn = spec.lower(base)
    ref_fn = spec.ref

    def _heal(h, r):
        if _lane_tensor(h) and h.shape[-1] == fault.width:
            return torch.where(fault.lane_mask(h), r.to(h.dtype), h)
        return h

    def remap(*args, **kw):
        return _tree_map(_heal, hw_fn(*args, **kw), ref_fn(*args, **kw))

    if target == DEGRADED_REMAP or getattr(spec, "lane_slicer", None) is None:
        return remap

    keep = fault.survivors()
    slicer = spec.lane_slicer

    def reduced(*args, **kw):
        nargs, nkw = slicer(args, dict(kw), keep)
        narrow = hw_fn(*nargs, **nkw)
        ref_out = ref_fn(*args, **kw)

        def leaf(n, r):
            if (_lane_tensor(r) and r.shape[-1] == fault.width
                    and n.shape[-1] == len(keep)):
                out = r.clone()
                out[..., list(keep)] = n.to(r.dtype)
                return out
            return n
        return _tree_map(leaf, narrow, ref_out)

    return reduced
