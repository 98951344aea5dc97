"""RoutingPlan: the unified routing IR (paper §III queue configuration).

Port of the reference's ``core/routing.py`` (``RoutingPlan``,
``ResidentRoute``, ``as_routes``).  A plan is a frozen, hashable
``stage -> lowering target`` mapping that keys the Dispatcher's cache
(one model build per queue configuration).

Resident routing (the paper's hot-spare mode) differs from the reference
in mechanism only.  The reference puts both lowerings in one executable
behind ``lax.cond`` on a traced health mask.  PyTorch runs eagerly, so a
``ResidentRoute`` reads a **host-side** health bit each time the op is
called and runs the HW or the SW lowering: the resident model is built
once, failover rebuilds nothing, and reading the bit never waits for the
device.  The fleet layer (``SparePool``, ``FleetPlan``,
``rung_occupancy``) is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import (Any, Callable, Dict, Iterable, Mapping, MutableSequence,
                    Optional, Sequence, Tuple)

from repro_torch.viscosity import lanefault
from repro_torch.viscosity.lang import DEGRADED_TARGETS, HW, INTERPRET, SW

# Every target a plan may assign.
TARGETS = (HW, SW, INTERPRET) + DEGRADED_TARGETS


@dataclass(frozen=True)
class RoutingPlan:
    """Frozen, hashable ``stage -> lowering target`` mapping.

    ``assignments`` is kept sorted so equal mappings are equal plans.
    ``default`` is the target for stages not listed; None defers to the
    consumer's own default (models fall back to SW).
    """

    assignments: Tuple[Tuple[str, str], ...] = ()
    default: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "assignments",
                           tuple(sorted(dict(self.assignments).items())))
        for stage, target in self.assignments:
            if target not in TARGETS:
                raise ValueError(
                    f"unknown lowering target {target!r} for stage "
                    f"{stage!r}; expected one of {TARGETS}")
        if self.default is not None and self.default not in TARGETS:
            raise ValueError(f"unknown default target {self.default!r}")

    # ------------------------------------------------------- constructors
    @staticmethod
    def make(mapping: Mapping[str, str],
             default: Optional[str] = None) -> "RoutingPlan":
        return RoutingPlan(tuple(mapping.items()), default)

    @staticmethod
    def for_stages(stage_names: Sequence[str], target: str = HW,
                   default: Optional[str] = None) -> "RoutingPlan":
        return RoutingPlan(tuple((s, target) for s in stage_names), default)

    @staticmethod
    def from_signature(signature, healthy: str = HW, fallback: str = SW,
                       default: Optional[str] = None) -> "RoutingPlan":
        """Derive a plan from a FaultSignature: healthy stages get
        ``healthy``, quarantined stages ``fallback``."""
        return RoutingPlan(
            tuple((s, healthy if r == HW else fallback)
                  for s, r in signature.routes), default)

    # ------------------------------------------------------------ queries
    def as_dict(self) -> Dict[str, str]:
        return dict(self.assignments)

    def stages(self) -> Tuple[str, ...]:
        return tuple(s for s, _ in self.assignments)

    def target_for(self, stage: str) -> str:
        for s, t in self.assignments:
            if s == stage:
                return t
        if self.default is not None:
            return self.default
        raise KeyError(f"stage {stage!r} not in routing plan "
                       f"{self.stages()} (and no default target)")

    def get(self, stage: str, fallback: Optional[str] = None):
        """dict-compatible lookup (models consult routes via ``.get``)."""
        for s, t in self.assignments:
            if s == stage:
                return t
        return self.default if self.default is not None else fallback

    # ------------------------------------------------------------ updates
    def with_target(self, stage: str, target: str) -> "RoutingPlan":
        d = self.as_dict()
        d[stage] = target
        return RoutingPlan(tuple(d.items()), self.default)

    def with_fault(self, stage: str, fallback: str = SW) -> "RoutingPlan":
        return self.with_target(stage, fallback)

    # --------------------------------------------------------- validation
    def validate(self, *, registry=None,
                 stages: Optional[Iterable[str]] = None) -> "RoutingPlan":
        """Check the plan against the Viscosity registry and/or an explicit
        stage universe; returns self so call sites can chain."""
        known = set(stages) if stages is not None else None
        for stage, target in self.assignments:
            if registry is not None and known is None and stage not in registry:
                raise ValueError(
                    f"routing plan names unknown viscosity op {stage!r}; "
                    f"registered: {registry.names()}")
            if known is not None and stage not in known:
                raise ValueError(
                    f"routing plan names unknown stage {stage!r}; "
                    f"known: {sorted(known)}")
            if (target in DEGRADED_TARGETS
                    and lanefault.fault_map(stage) is None):
                raise ValueError(
                    f"stage {stage!r} routed to {target!r} but no lane map "
                    "is registered; detection must localize the fault first "
                    "(lanefault.set_map / known_map)")
        return self

    # ----------------------------------------------------- lowering hooks
    def resident_routes(self, health_mask: MutableSequence[bool],
                        stage_names: Sequence[str]
                        ) -> Dict[str, "ResidentRoute"]:
        """Per-stage resident route handles.  ``health_mask`` is a host
        list of bools that the owner flips on failover; bit i is read each
        time stage i runs."""
        return {s: ResidentRoute(hw=self.target_for(s), mask=health_mask,
                                 index=i)
                for i, s in enumerate(stage_names)}


@dataclass
class ResidentRoute:
    """Runtime route handle: the paper's hot-spare residency, per stage.

    ``select`` lowers an OpSpec to a function that reads ``mask[index]``
    when called and runs the planned target while healthy, the SW oracle
    once quarantined.  Not hashable on purpose: it never keys a cache.
    """

    hw: str                          # target while the stage is healthy
    mask: MutableSequence[bool]      # host-side health bits (shared)
    index: int

    def select(self, spec) -> Callable[..., Any]:
        hw_fn = spec.lower(self.hw)
        sw_fn = spec.ref
        if hw_fn is sw_fn:      # plan already routes software
            return sw_fn
        mask, i = self.mask, self.index

        def resident(*args, **kw):
            return (hw_fn if mask[i] else sw_fn)(*args, **kw)
        return resident


def as_routes(routes) -> Any:
    """Normalize a build_model ``routes`` argument: None (empty plan), a
    RoutingPlan, or a mapping of targets / ResidentRoute handles."""
    if routes is None:
        return RoutingPlan()
    if hasattr(routes, "get"):
        return routes
    raise TypeError(f"routes must be None, a RoutingPlan, or a mapping; "
                    f"got {type(routes)!r}")
