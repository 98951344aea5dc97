"""Seeded randomized fault schedules over the full taxonomy.

Port of the reference's ``chaos/schedule.py``: numpy draws folded over
the port's ``FleetPlan``, so the same seed draws the same schedule in
both packages.

A schedule is a tuple of :class:`ChaosEvent` at strictly increasing
engine steps.  ``draw_schedule`` validates every candidate event
against a *shadow* ``FleetPlan`` folded with the same transition
algebra the engines use (``launch.distributed.apply_event``), so a
drawn schedule can never ask the fleet for an inapplicable transition
(a second fault on an already-quarantined device, a host loss that
leaves nothing serving, ...).  Same seed -> same schedule, always.

Taxonomy (``kind``):

========================  =================================================
``transient_stage``       canary-visible stage fault that clears after one
                          failing probe -> probation restores the HW route
``persistent_stage``      stage fault that keeps failing -> ladder rung
``lane_fault``            persistent stage fault with a *localized* lane
                          map registered -> DEGRADED rung, not binary SW
``device_loss``           whole device quarantines (spare-first migration)
``host_loss``             a host's whole device block quarantines at once
``spare_exhaustion``      burst of device losses sized to drain the spare
                          pool -- the last fault finds no spare
``coord_stall``           a peer host stops publishing; the coordinator's
                          bounded retries surface HostTimeoutError
========================  =================================================
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence, Tuple

import numpy as np

from repro_torch.core.routing import FleetPlan
from repro_torch.launch.distributed import FleetEvent, apply_event

TRANSIENT_STAGE = "transient_stage"
PERSISTENT_STAGE = "persistent_stage"
LANE_FAULT = "lane_fault"
DEVICE_LOSS = "device_loss"
HOST_LOSS = "host_loss"
SPARE_EXHAUSTION = "spare_exhaustion"
COORD_STALL = "coord_stall"

ALL_KINDS = (TRANSIENT_STAGE, PERSISTENT_STAGE, LANE_FAULT, DEVICE_LOSS,
             HOST_LOSS, SPARE_EXHAUSTION, COORD_STALL)
#: kinds a serve-under-traffic campaign can inject (host_loss joins when
#: the fleet has a topology); coord_stall fires a coordinator drill
#: alongside the traffic run — visible as a KV-retry counter spike
SERVE_KINDS = (TRANSIENT_STAGE, PERSISTENT_STAGE, LANE_FAULT, DEVICE_LOSS,
               SPARE_EXHAUSTION, COORD_STALL)
#: kinds the data-parallel train loop can inject (stage faults surface as
#: shard guard trips there -- device-granular); coord_stall as above
TRAIN_KINDS = (TRANSIENT_STAGE, DEVICE_LOSS, HOST_LOSS, COORD_STALL)


@dataclass(frozen=True)
class ChaosEvent:
    """One scheduled fault.  ``devices`` is the burst for
    ``spare_exhaustion`` (every other kind targets ``device`` /
    ``host`` / ``stage`` singly)."""
    step: int
    kind: str
    device: int = 0
    host: int = -1
    stage: str = ""
    devices: Tuple[int, ...] = field(default_factory=tuple)

    def __post_init__(self):
        if self.kind not in ALL_KINDS:
            raise ValueError(f"unknown chaos kind {self.kind!r}; one of "
                             f"{ALL_KINDS}")


def _shadow_apply(plan: FleetPlan, wire: Sequence, stage_names,
                  topology) -> Tuple[FleetPlan, bool]:
    ev = FleetEvent.from_engine(0, 0, 0, tuple(wire))
    return apply_event(plan, ev, stage_names, topology=topology)


def draw_schedule(seed: int, *, n_events: int, n_devices: int,
                  stage_names: Sequence[str], n_spares: int = 0,
                  topology=None, kinds: Sequence[str] = SERVE_KINDS,
                  start: int = 4, min_gap: int = 3, max_gap: int = 6,
                  min_serving: int = 2) -> Tuple[ChaosEvent, ...]:
    """Draw ``n_events`` applicable fault events from ``kinds``.

    The shadow plan tracks exactly what the fleet will do (transients
    net out; persistent faults migrate/ladder; losses quarantine), and
    any candidate whose transition would not apply -- or would leave
    fewer than ``min_serving`` devices serving -- is redrawn.  When the
    fleet is too degraded for any destructive kind, the draw falls back
    to transients (always applicable), so the schedule always reaches
    ``n_events``.
    """
    if n_events < 0:
        raise ValueError(f"n_events must be >= 0, got {n_events}")
    if not stage_names:
        raise ValueError("draw_schedule needs at least one stage name")
    rng = np.random.default_rng(seed)
    plan = FleetPlan.healthy(n_devices, stage_names, n_spares=n_spares)
    #: stages armed persistent (a later transient on one would not clear)
    hot_stages: set = set()
    #: stages transients already used -- persistent kinds avoid these
    #: (a probation episode's probes must not cross from a consumed
    #: transient spec into a hard fault queued behind it), and new
    #: transients prefer them so persistent kinds keep fresh stages
    transient_stages: set = set()

    def _pick_transient_stage(cold):
        reuse = sorted(s for s in cold if s in transient_stages)
        pool = reuse if reuse else cold
        return pool[int(rng.integers(0, len(pool)))]
    events = []
    step = start
    while len(events) < n_events:
        kind = kinds[int(rng.integers(0, len(kinds)))]
        serving = list(plan.serving())
        ev = None
        if kind == COORD_STALL:
            ev = ChaosEvent(step=step, kind=kind,
                            host=int(rng.integers(1, 4)))
        elif kind == TRANSIENT_STAGE:
            cold = [s for s in stage_names if s not in hot_stages]
            if cold and serving:
                ev = ChaosEvent(
                    step=step, kind=kind,
                    device=int(serving[rng.integers(0, len(serving))]),
                    stage=_pick_transient_stage(cold))
        elif kind in (PERSISTENT_STAGE, LANE_FAULT):
            # keep >= 1 stage cold so transients (the always-applicable
            # fallback) never run out of clean canaries
            cold = [s for s in stage_names if s not in hot_stages]
            pool = (list(hot_stages) if len(cold) <= 1 else
                    list(stage_names))
            pool = [s for s in pool if s not in transient_stages]
            if serving and pool:
                d = int(serving[rng.integers(0, len(serving))])
                s = sorted(pool)[int(rng.integers(0, len(pool)))]
                nxt, ok = _shadow_apply(plan, ("stage", d, s),
                                        stage_names, topology)
                if ok and len(nxt.serving()) >= min_serving:
                    plan = nxt
                    hot_stages.add(s)
                    ev = ChaosEvent(step=step, kind=kind, device=d,
                                    stage=s)
        elif kind == DEVICE_LOSS:
            if serving:
                d = int(serving[rng.integers(0, len(serving))])
                nxt, ok = _shadow_apply(plan, ("device", d),
                                        stage_names, topology)
                if ok and len(nxt.serving()) >= min_serving:
                    plan = nxt
                    ev = ChaosEvent(step=step, kind=kind, device=d)
        elif kind == HOST_LOSS:
            if topology is not None:
                h = int(rng.integers(0, topology.num_hosts))
                nxt, ok = _shadow_apply(plan, ("host", h),
                                        stage_names, topology)
                if ok and len(nxt.serving()) >= min_serving:
                    plan = nxt
                    ev = ChaosEvent(step=step, kind=kind, host=h)
        elif kind == SPARE_EXHAUSTION:
            burst = len(plan.pool.spares) + 1
            picked = []
            nxt = plan
            for _ in range(burst):
                alive = [d for d in nxt.serving() if d not in picked]
                if not alive:
                    break
                d = int(alive[rng.integers(0, len(alive))])
                cand, ok = _shadow_apply(nxt, ("device", d),
                                         stage_names, topology)
                if not ok or len(cand.serving()) < min_serving:
                    break
                nxt = cand
                picked.append(d)
            if len(picked) == burst:
                plan = nxt
                ev = ChaosEvent(step=step, kind=kind,
                                devices=tuple(picked))
        if ev is None:
            # fleet too degraded (or stages all hot) for this kind:
            # transients keep the campaign dense without eating capacity
            cold = [s for s in stage_names if s not in hot_stages]
            serving = list(plan.serving())
            if not cold or not serving:
                raise RuntimeError(
                    f"schedule seed {seed} wedged after {len(events)} "
                    f"event(s): no applicable fault remains "
                    f"({len(serving)} serving, {len(cold)} cold stages)")
            ev = ChaosEvent(
                step=step, kind=TRANSIENT_STAGE,
                device=int(serving[rng.integers(0, len(serving))]),
                stage=_pick_transient_stage(cold))
        if ev.kind == TRANSIENT_STAGE:
            transient_stages.add(ev.stage)
        events.append(ev)
        step += int(rng.integers(min_gap, max_gap + 1))
    return tuple(events)


def horizon_of(schedule: Sequence[ChaosEvent], *, settle: int = 8) -> int:
    """Engine steps a run must stay busy for so every scheduled event
    lands mid-run (plus ``settle`` steps for the last MTTR window)."""
    return (max((e.step for e in schedule), default=0)) + settle
