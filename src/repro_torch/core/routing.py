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
device.

The fleet layer (``SparePool``, ``FleetPlan``, ``rung_occupancy``) is the
reference's, transition for transition: a device-indexed table of plans
with a hot-spare pool, pure Python over ``RoutingPlan`` and the
degradation ladder (``lanefault.rung_for``).
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


# --------------------------------------------------------------------------
# Fleet layer: device-indexed plans + hot-spare pool (paper §II Fig. 2,
# §V Fig. 8).  A FleetPlan lifts RoutingPlan from "one plan per process" to
# a frozen device_index -> RoutingPlan table with explicit spare semantics:
# a faulted device's work migrates to a hot spare *before* any stage drops
# to its SW oracle; only once spares are exhausted does a device degrade in
# place (per-stage SW fallback), and at device death with no spare left its
# capacity is simply lost.  All transitions are pure (each returns a new
# FleetPlan), so fleet health history is a value, exactly like RoutingPlan.
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class SparePool:
    """Hot-spare bookkeeping (paper Fig. 8 semantics).

    ``spares`` is the reserved device-index pool; ``assignments`` maps each
    migrated-away device to the spare now carrying its traffic.  Invariant:
    no spare ever serves two devices (each target appears at most once).
    """

    spares: Tuple[int, ...] = ()
    assignments: Tuple[Tuple[int, int], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "spares", tuple(sorted(set(self.spares))))
        object.__setattr__(self, "assignments",
                           tuple(sorted(self.assignments)))
        targets = [s for _, s in self.assignments]
        if len(set(targets)) != len(targets):
            raise ValueError(
                f"spare pool maps two devices to one spare: {self.assignments}")
        sources = [d for d, _ in self.assignments]
        if len(set(sources)) != len(sources):
            raise ValueError(
                f"device migrated to two spares: {self.assignments}")
        for _, s in self.assignments:
            if s not in self.spares:
                raise ValueError(f"assignment target {s} is not in the spare "
                                 f"pool {self.spares}")

    # ------------------------------------------------------------ queries
    def free(self) -> Tuple[int, ...]:
        """Spares not yet carrying anyone's traffic (lowest index first)."""
        used = {s for _, s in self.assignments}
        return tuple(s for s in self.spares if s not in used)

    def in_service(self) -> Tuple[int, ...]:
        """Spares currently carrying a migrated device's traffic."""
        return tuple(s for _, s in self.assignments)

    def spare_for(self, device: int) -> Optional[int]:
        for d, s in self.assignments:
            if d == device:
                return s
        return None

    # ------------------------------------------------------- transitions
    def assign(self, device: int, exclude: Sequence[int] = ()
               ) -> Tuple["SparePool", Optional[int]]:
        """Claim the lowest free spare for ``device``; (self, None) when the
        pool is exhausted.  ``exclude`` holds spares that must not be handed
        out (quarantined spares released back by a recovery)."""
        free = tuple(s for s in self.free() if s not in exclude)
        if not free:
            return self, None
        spare = free[0]
        return SparePool(self.spares,
                         self.assignments + ((device, spare),)), spare

    def release(self, device: int) -> "SparePool":
        """Return ``device``'s spare to the pool (fault-then-recover)."""
        return SparePool(self.spares, tuple((d, s) for d, s in
                                            self.assignments if d != device))


def _plan_sort_key(plan: RoutingPlan):
    return (plan.assignments, plan.default or "")


@dataclass(frozen=True)
class FleetPlan:
    """Frozen, hashable ``device_index -> RoutingPlan`` table + spare pool.

    ``plans[i]`` is the routing plan device ``i`` runs *when serving*;
    ``pool`` carries the hot spares; ``quarantined`` lists devices out of
    service (migrated away or dead).  A device is **serving** iff it is not
    quarantined and not an idle spare.  Equality/hash are exact-table (two
    identical fleet histories are one value); ``compile_key()`` is the
    *multiset* of serving plans — the Dispatcher key — so two fleets whose
    devices route the same way (in any device order) share executables.
    """

    plans: Tuple[RoutingPlan, ...] = ()
    pool: SparePool = SparePool()
    quarantined: Tuple[int, ...] = ()
    # Physical faults accumulated per device — independent of the route
    # strings (with hw_route=SW a faulted stage's target does not change,
    # but the silicon is still degraded and the capacity model must know).
    fault_counts: Tuple[int, ...] = ()
    # Per-(device, stage) fault counts: the index into the degradation
    # ladder (fault 1 -> remap, 2 -> reduced width, >=3 -> SW oracle).
    # Sparse — only nonzero entries are stored.
    stage_faults: Tuple[Tuple[Tuple[int, str], int], ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "plans", tuple(self.plans))
        object.__setattr__(self, "quarantined",
                           tuple(sorted(set(self.quarantined))))
        n = len(self.plans)
        if not self.fault_counts:
            object.__setattr__(self, "fault_counts", (0,) * n)
        else:
            object.__setattr__(self, "fault_counts",
                               tuple(self.fault_counts))
        if len(self.fault_counts) != n:
            raise ValueError(f"fault_counts has {len(self.fault_counts)} "
                             f"entries for a {n}-device fleet")
        sf = {tuple(k): int(v) for k, v in self.stage_faults if int(v) > 0}
        object.__setattr__(self, "stage_faults", tuple(sorted(sf.items())))
        for (d, _stage), _v in self.stage_faults:
            if not 0 <= d < n:
                raise ValueError(f"stage_faults device index {d} out of "
                                 f"range for a {n}-device fleet")
        for p in self.plans:
            if not isinstance(p, RoutingPlan):
                raise TypeError(f"FleetPlan entries must be RoutingPlans; "
                                f"got {type(p)!r}")
        for d in self.quarantined + self.pool.spares:
            if not 0 <= d < n:
                raise ValueError(f"device index {d} out of range for a "
                                 f"{n}-device fleet")

    # ------------------------------------------------------- constructors
    @staticmethod
    def healthy(n_devices: int, stage_names: Sequence[str], *,
                target: str = HW, n_spares: int = 0,
                default: Optional[str] = None) -> "FleetPlan":
        """All-healthy fleet; the last ``n_spares`` devices are the hot-
        spare pool (idle until a worker faults)."""
        if n_spares >= n_devices:
            raise ValueError(f"fleet of {n_devices} cannot reserve "
                             f"{n_spares} spares")
        plan = RoutingPlan.for_stages(stage_names, target=target,
                                      default=default)
        return FleetPlan(plans=(plan,) * n_devices,
                         pool=SparePool(tuple(range(n_devices - n_spares,
                                                    n_devices))))

    # ------------------------------------------------------------ queries
    @property
    def n_devices(self) -> int:
        return len(self.plans)

    def serving(self) -> Tuple[int, ...]:
        """Devices currently taking traffic: active workers + in-service
        spares, minus everything quarantined."""
        idle = set(self.pool.free())
        quarantined = set(self.quarantined)
        return tuple(d for d in range(self.n_devices)
                     if d not in idle and d not in quarantined)

    def device_mask(self) -> Tuple[bool, ...]:
        """Explicit health mask over *all* devices (True = serving) — the
        view launch/mesh.py and sharding.py consume."""
        serving = set(self.serving())
        return tuple(d in serving for d in range(self.n_devices))

    def plan_for(self, device: int) -> RoutingPlan:
        """The RoutingPlan ``device`` consults; KeyError when it is not
        serving (quarantined or an idle spare)."""
        if device not in self.serving():
            raise KeyError(f"device {device} is not serving (quarantined="
                           f"{self.quarantined}, idle spares="
                           f"{self.pool.free()})")
        return self.plans[device]

    def n_faults(self, device: int) -> int:
        """Physical faults device ``device`` has accumulated — the index
        into the VFA degradation curve (route-string independent)."""
        return self.fault_counts[device]

    def stage_fault_count(self, device: int, stage: str) -> int:
        """Faults accumulated on one (device, stage) — the degradation-
        ladder rung index for that stage."""
        for key, v in self.stage_faults:
            if key == (device, stage):
                return v
        return 0

    def compile_key(self) -> Tuple[Tuple[Tuple[str, str], ...], ...]:
        """Multiset (sorted tuple) of serving plans: the Dispatcher cache
        key.  Two fleets with the same per-device routing multiset share
        one compiled-executable set regardless of device numbering."""
        return tuple(tuple(_plan_sort_key(self.plans[d]))
                     for d in sorted(self.serving(),
                                     key=lambda d: _plan_sort_key(
                                         self.plans[d])))

    # ------------------------------------------------------- transitions
    def _set_plan(self, device: int, plan: RoutingPlan
                  ) -> Tuple[RoutingPlan, ...]:
        return self.plans[:device] + (plan,) + self.plans[device + 1:]

    def _bump(self, device: int) -> Tuple[int, ...]:
        return (self.fault_counts[:device]
                + (self.fault_counts[device] + 1,)
                + self.fault_counts[device + 1:])

    def _bump_stage(self, device: int, stage: str
                    ) -> Tuple[Tuple[Tuple[int, str], int], ...]:
        sf = dict(self.stage_faults)
        key = (device, stage)
        sf[key] = sf.get(key, 0) + 1
        return tuple(sorted(sf.items()))

    def with_stage_fault(self, device: int, stage: str,
                         fallback: str = SW) -> "FleetPlan":
        """One stage of ``device`` faults.  Paper Fig. 8 semantics: migrate
        the device's work to a free hot spare first; only with the pool
        exhausted does the stage degrade in place.  In-place degradation
        walks the ladder when detection has localized a lane map for the
        stage (fault 1 -> DEGRADED remap, 2 -> reduced width, >=3 -> the
        SW oracle); without a map it drops straight to ``fallback``."""
        if device not in self.serving():
            raise ValueError(f"device {device} is not serving; cannot fault "
                             f"stage {stage!r} there")
        n = self.stage_fault_count(device, stage) + 1
        if lanefault.fault_map(stage) is not None:
            fb = lanefault.rung_for(n)
        else:
            fb = fallback
        pool, spare = self.pool.assign(device, exclude=self.quarantined)
        plans = self._set_plan(device,
                               self.plans[device].with_fault(stage, fb))
        counts = self._bump(device)
        sfaults = self._bump_stage(device, stage)
        if spare is not None:
            return FleetPlan(plans=plans, pool=pool,
                             quarantined=self.quarantined + (device,),
                             fault_counts=counts, stage_faults=sfaults)
        return FleetPlan(plans=plans, pool=self.pool,
                         quarantined=self.quarantined, fault_counts=counts,
                         stage_faults=sfaults)

    def with_device_fault(self, device: int, *,
                          exclude: Sequence[int] = ()) -> "FleetPlan":
        """Whole-device loss: migrate to a spare when one is free,
        otherwise the device's capacity is simply gone.  ``exclude``
        holds spares that must not take the work (devices dying in the
        same transition — a host loss must not migrate onto the dying
        host's own spares)."""
        if device not in self.serving():
            raise ValueError(f"device {device} is not serving; cannot fail "
                             f"it")
        pool, _spare = self.pool.assign(
            device, exclude=tuple(self.quarantined) + tuple(exclude))
        return FleetPlan(plans=self.plans, pool=pool,
                         quarantined=self.quarantined + (device,),
                         fault_counts=self._bump(device),
                         stage_faults=self.stage_faults)

    def with_host_fault(self, devices: Sequence[int]) -> "FleetPlan":
        """A whole host drops out: every serving device in ``devices``
        quarantines in ONE transition (the multi-host runtime's host-loss
        event).  Each migrates to a free hot spare *outside* the dying
        block when one exists; the block's own idle spares leave the pool
        (they are unreachable hardware, not capacity)."""
        devices = tuple(sorted(set(devices)))
        for d in devices:
            if not 0 <= d < self.n_devices:
                raise ValueError(f"device index {d} out of range for a "
                                 f"{self.n_devices}-device fleet")
        fp = self
        for d in devices:
            if d in fp.serving():
                fp = fp.with_device_fault(d, exclude=devices)
        lost_idle = tuple(s for s in fp.pool.free() if s in devices)
        if lost_idle:
            pool = SparePool(tuple(s for s in fp.pool.spares
                                   if s not in lost_idle),
                             fp.pool.assignments)
            fp = FleetPlan(plans=fp.plans, pool=pool,
                           quarantined=fp.quarantined + lost_idle,
                           fault_counts=fp.fault_counts,
                           stage_faults=fp.stage_faults)
        return fp

    def with_recovery(self, device: int, stage_names: Sequence[str], *,
                      target: str = HW) -> "FleetPlan":
        """Repaired device rejoins healthy; its spare (if any) drains back
        to the idle pool.  Covers both quarantined devices and devices
        degraded in place (stage faults riding the degradation ladder
        with no quarantine — their serve capacity recovers too)."""
        degraded = (self.fault_counts[device] > 0
                    or any(k[0] == device for k, _ in self.stage_faults))
        if device not in self.quarantined and not degraded:
            raise ValueError(f"device {device} is neither quarantined nor "
                             f"degraded; nothing to recover")
        plans = self._set_plan(
            device, RoutingPlan.for_stages(stage_names, target=target,
                                           default=self.plans[device].default))
        counts = (self.fault_counts[:device] + (0,)
                  + self.fault_counts[device + 1:])
        sfaults = tuple((k, v) for k, v in self.stage_faults
                        if k[0] != device)
        return FleetPlan(plans=plans, pool=self.pool.release(device),
                         quarantined=tuple(d for d in self.quarantined
                                           if d != device),
                         fault_counts=counts, stage_faults=sfaults)

    def with_stage_recovery(self, device: int, stage: str, *,
                            target: str = HW) -> "FleetPlan":
        """Undo exactly one ``with_stage_fault`` on (device, stage): the
        probation verdict came back transient, so the detection that walked
        the ladder steps back up one rung.  At count 0 the stage's route
        restores to ``target`` (the HW path — the hardware probed clean);
        with residual faults and a localized lane map it re-lands on
        ``rung_for(n-1)``.  A device quarantined by that fault returns to
        service and releases its spare; other devices' and stages' faults
        are untouched (contrast ``with_recovery``, the full-device repair).
        """
        n = self.stage_fault_count(device, stage)
        if n < 1:
            raise ValueError(f"device {device} has no fault on stage "
                             f"{stage!r}; nothing to recover")
        sf = dict(self.stage_faults)
        key = (device, stage)
        if n == 1:
            sf.pop(key, None)
        else:
            sf[key] = n - 1
        counts = (self.fault_counts[:device]
                  + (max(0, self.fault_counts[device] - 1),)
                  + self.fault_counts[device + 1:])
        if n == 1:
            route = target
        elif lanefault.fault_map(stage) is not None:
            route = lanefault.rung_for(n - 1)
        else:
            route = self.plans[device].get(stage, target)
        plans = self._set_plan(device,
                               self.plans[device].with_target(stage, route))
        if device in self.quarantined:
            return FleetPlan(plans=plans, pool=self.pool.release(device),
                             quarantined=tuple(d for d in self.quarantined
                                               if d != device),
                             fault_counts=counts,
                             stage_faults=tuple(sorted(sf.items())))
        return FleetPlan(plans=plans, pool=self.pool,
                         quarantined=self.quarantined, fault_counts=counts,
                         stage_faults=tuple(sorted(sf.items())))

    # --------------------------------------------------------- validation
    def validate(self, *, registry=None,
                 stages: Optional[Iterable[str]] = None) -> "FleetPlan":
        for p in self.plans:
            p.validate(registry=registry, stages=stages)
        return self


def rung_occupancy(fleet: "FleetPlan") -> Dict[str, int]:
    """Degradation-ladder occupancy of a fleet, for the
    ``fleet_rung_devices`` telemetry gauge: per routing target, the
    number of serving (device, stage) assignments routed there, plus
    device-granular ``quarantined`` / ``spare`` counts.  Standard rungs
    are always present (zeroed) so gauge updates overwrite stale
    values."""
    occ: Dict[str, int] = {t: 0 for t in
                           (HW, INTERPRET, SW) + DEGRADED_TARGETS}
    for d in fleet.serving():
        plan = fleet.plans[d]
        for _stage, target in plan.assignments:
            occ[target] = occ.get(target, 0) + 1
    occ["quarantined"] = len(fleet.quarantined)
    occ["spare"] = len(fleet.pool.free())
    return occ


def state_from_lowering(route) -> bool:
    """True when the lowering a call under ``route`` runs returns the final
    state of its own scan (the scan stages' ``with_state``): HW (the
    kernel's state pass) and SW (the oracle's scan), as a target or as a
    resident handle whose healthy target is HW or SW."""
    target = route.hw if hasattr(route, "select") else route
    return target in (HW, SW)


def as_routes(routes) -> Any:
    """Normalize a build_model ``routes`` argument: None (empty plan), a
    RoutingPlan, or a mapping of targets / ResidentRoute handles."""
    if routes is None:
        return RoutingPlan()
    if hasattr(routes, "get"):
        return routes
    raise TypeError(f"routes must be None, a RoutingPlan, or a mapping; "
                    f"got {type(routes)!r}")
