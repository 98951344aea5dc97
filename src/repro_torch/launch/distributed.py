"""Fleet host types: one FleetPlan agreed by every host (the port's
``launch/distributed.py``).

The design is the reference's deterministic replication.  Fleet health
transitions are *events* in one totally ordered log, and every host folds
the same log over the same initial ``FleetPlan``:

  * ``FleetEvent`` — one transition (``with_stage_fault`` /
    ``with_device_fault`` / ``with_recovery`` / host loss), stamped with
    (step, origin host, per-origin sequence number): a total order, so
    any multiset of events sorts into one canonical log.
  * ``EventChannel`` — per-step all-to-all exchange of locally observed
    events through a coordinator; returns the merged, ordered slice every
    host applies identically.
  * ``LocalCoordinator`` — the trivial single-process transport.

``HostTopology`` names the device→host partition and ``HostView`` extends
``FleetMeshView`` with per-host masks and global→local device index
translation, so ``launch.sharding.shard_bounds`` can partition a global
batch while each host executes only its owned slice.

The process runtime waits for the multi-host slice (ROADMAP queue 1 item
9: ``torch.distributed`` with gloo on the CPU and NCCL on the GPU, a
``TCPStore`` under the coordinator): ``initialize_runtime``,
``DistributedRuntime``, ``KVCoordinator``, ``coordination_client_errors``,
``HostTopology.current`` and ``HostView.local_submesh``.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.routing import FleetPlan
from repro_torch.launch.mesh import FleetMeshView, cuda_devices
from repro_torch.launch.sharding import shard_bounds
from repro_torch.viscosity.lang import HW, SW

# Event kinds, mirroring the FleetPlan transitions (plus host loss, which
# expands to one with_host_fault transition over the host's device block).
STAGE = "stage"
DEVICE = "device"
RECOVER = "recover"
HOST = "host"
EVENT_KINDS = (STAGE, DEVICE, RECOVER, HOST)


# -------------------------------------------------------------- topology
@dataclass(frozen=True)
class HostTopology:
    """The device→host partition: ``num_hosts`` hosts own contiguous
    blocks of ``devices_per_host`` logical fleet devices.

    ``host_id`` is this process's slot; ``None`` means single-process
    emulation (this process owns every host's devices — the benches and
    in-process tests exercise the host-axis semantics that way).
    """

    num_hosts: int
    devices_per_host: int
    host_id: Optional[int] = None

    def __post_init__(self):
        if self.num_hosts < 1 or self.devices_per_host < 1:
            raise ValueError(
                f"topology needs >= 1 host and >= 1 device/host, got "
                f"{self.num_hosts} x {self.devices_per_host}"
            )
        if self.host_id is not None and not (0 <= self.host_id < self.num_hosts):
            raise ValueError(
                f"host_id {self.host_id} out of range for "
                f"{self.num_hosts} host(s)"
            )

    @property
    def n_devices(self) -> int:
        return self.num_hosts * self.devices_per_host

    def host_of(self, device: int) -> int:
        if not 0 <= device < self.n_devices:
            raise ValueError(
                f"device {device} out of range for {self.n_devices} "
                f"fleet device(s)"
            )
        return device // self.devices_per_host

    def local_index(self, device: int) -> int:
        """Global fleet index → index among its host's devices."""
        self.host_of(device)
        return device % self.devices_per_host

    def global_index(self, host: int, local: int) -> int:
        if not 0 <= local < self.devices_per_host:
            raise ValueError(
                f"local index {local} out of range for "
                f"{self.devices_per_host} device(s)/host"
            )
        return host * self.devices_per_host + local

    def devices_of(self, host: Optional[int] = None) -> Tuple[int, ...]:
        """The device block a host owns (default: this host)."""
        host = self.host_id if host is None else host
        if host is None:
            raise ValueError(
                "topology has no host_id: pass devices_of(host) "
                "explicitly in single-process emulation"
            )
        lo = host * self.devices_per_host
        return tuple(range(lo, lo + self.devices_per_host))

    def is_local(self, device: int) -> bool:
        """Does this process execute ``device``?  Always true in
        single-process emulation (``host_id is None``)."""
        if self.host_id is None:
            return True
        return self.host_of(device) == self.host_id


# ------------------------------------------------------------- host view
@dataclass(frozen=True)
class HostView(FleetMeshView):
    """A ``FleetMeshView`` that knows the device→host partition.

    Adds per-host mask slices and global→local device-index translation
    on top of the fleet health mask, so multi-host launch code can pick
    its local devices and its slice of ``shard_bounds`` without ever
    re-deriving the partition.
    """

    topology: Optional[HostTopology] = None

    def __post_init__(self):
        if self.topology is None:
            raise ValueError("HostView requires a HostTopology")
        if self.topology.n_devices != len(self.mask):
            raise ValueError(
                f"topology covers {self.topology.n_devices} device(s), "
                f"fleet mask has {len(self.mask)}"
            )

    @classmethod
    def of(cls, fleet_plan, topology: HostTopology) -> "HostView":
        """Project a FleetPlan onto the host partition (the multi-host
        sibling of ``FleetMeshView.from_plan``)."""
        base = FleetMeshView.from_plan(fleet_plan)
        return cls(
            mask=base.mask,
            quarantined=base.quarantined,
            idle_spares=base.idle_spares,
            topology=topology,
        )

    # ------------------------------------------------------- host slices
    def host_mask(self, host: int) -> Tuple[bool, ...]:
        """The health mask restricted to ``host``'s device block."""
        devs = self.topology.devices_of(host)
        return tuple(self.mask[d] for d in devs)

    def serving_on(self, host: int) -> Tuple[int, ...]:
        return tuple(d for d in self.topology.devices_of(host) if self.mask[d])

    def hosts_serving(self) -> Tuple[int, ...]:
        """Hosts with at least one serving device (a fully lost host
        drops out of this tuple — the surviving hosts re-fold)."""
        return tuple(h for h in range(self.topology.num_hosts) if self.serving_on(h))

    def local_serving(self) -> Tuple[int, ...]:
        """Serving devices this process owns (global indices)."""
        if self.topology.host_id is None:
            return self.serving()
        return self.serving_on(self.topology.host_id)

    # --------------------------------------------- local mesh / sharding
    def local_serving_devices(self, devices=None) -> List:
        """This process's physical devices behind its serving indices
        (``devices``, default every CUDA device of the process, indexed
        via the topology translation).

        In single-process emulation (``host_id is None``) every logical
        index is local, so the mapping is identity — translating
        through ``local_index`` there would alias the per-host blocks
        onto the same physical devices."""
        local = list(cuda_devices() if devices is None else devices)
        if self.topology.host_id is None:
            return self.serving_devices(local)
        serving = self.local_serving()
        need = max((self.topology.local_index(d) for d in serving), default=-1)
        if need >= len(local):
            raise RuntimeError(
                f"host view needs local device {need}, process has "
                f"{len(local)}: short {need + 1 - len(local)} device(s)"
            )
        return [local[self.topology.local_index(d)] for d in serving]

    def shard_bounds(self, n_items: int) -> Dict[int, Tuple[int, int]]:
        """Global-batch partition over the whole fleet mask, filtered to
        the devices this process owns — every host computes the same
        global split and takes its own slice."""
        owned = None if self.topology.host_id is None else self.topology.devices_of()
        return shard_bounds(n_items, self.mask, owned=owned)


# ------------------------------------------------------------- event log
@dataclass(frozen=True, order=True)
class FleetEvent:
    """One fleet transition with its total-order stamp.

    ``(step, origin, seq)`` orders any multiset of events canonically:
    ``step`` is the engine step the event takes effect at, ``origin``
    the host that observed it, ``seq`` that host's running counter.
    ``device`` holds the host index when ``kind == "host"``.
    """

    step: int
    origin: int
    seq: int
    kind: str
    device: int
    stage: str = ""

    def __post_init__(self):
        if self.kind not in EVENT_KINDS:
            raise ValueError(
                f"unknown fleet event kind {self.kind!r}; expected one "
                f"of {EVENT_KINDS}"
            )
        if self.kind == STAGE and not self.stage:
            raise ValueError("stage events must name the faulted stage")

    # ------------------------------------------------- wire / engine form
    def to_wire(self) -> list:
        return [
            self.step,
            self.origin,
            self.seq,
            self.kind,
            self.device,
            self.stage,
        ]

    @staticmethod
    def from_wire(wire: Sequence) -> "FleetEvent":
        step, origin, seq, kind, device, stage = wire
        return FleetEvent(
            step=int(step),
            origin=int(origin),
            seq=int(seq),
            kind=str(kind),
            device=int(device),
            stage=str(stage),
        )

    def engine_tuple(self) -> Tuple:
        """The event in the FleetServeEngine's tuple dialect."""
        if self.kind == STAGE:
            return (STAGE, self.device, self.stage)
        if self.kind == RECOVER and self.stage:
            # Stage-scoped recovery (probation verdict: transient) —
            # undoes exactly one rung, not the whole device.
            return (RECOVER, self.device, self.stage)
        return (self.kind, self.device)

    @staticmethod
    def from_engine(step: int, origin: int, seq: int, event: Sequence) -> "FleetEvent":
        kind = event[0]
        stage = event[2] if kind in (STAGE, RECOVER) and len(event) > 2 else ""
        return FleetEvent(
            step=step,
            origin=origin,
            seq=seq,
            kind=kind,
            device=int(event[1]),
            stage=stage,
        )


def merge_event_logs(
    *logs: Sequence[FleetEvent],
) -> Tuple[FleetEvent, ...]:
    """Canonical merge: the sorted, deduplicated union of per-host logs.

    Deterministic under ANY arrival interleaving — the stamp is a total
    order, so every host that sees the same event multiset produces the
    same log (the property test permutes arrivals and asserts this).
    """
    merged = set()
    for log in logs:
        merged.update(log)
    return tuple(sorted(merged))


def apply_event(
    plan: FleetPlan,
    event: FleetEvent,
    stage_names: Sequence[str],
    *,
    target: str = HW,
    fallback: str = SW,
    topology: Optional[HostTopology] = None,
) -> Tuple[FleetPlan, bool]:
    """Fold one event over a FleetPlan; ``(plan, False)`` when the
    transition no longer applies (e.g. two hosts both reported a device
    that the first report already quarantined) — merged logs tolerate
    benign duplicates instead of desyncing the fleet."""
    try:
        if event.kind == STAGE:
            return plan.with_stage_fault(event.device, event.stage, fallback), True
        if event.kind == DEVICE:
            return plan.with_device_fault(event.device), True
        if event.kind == RECOVER:
            if event.stage:
                return (
                    plan.with_stage_recovery(event.device, event.stage, target=target),
                    True,
                )
            return plan.with_recovery(event.device, stage_names, target=target), True
        if topology is None:
            raise ValueError("host events need a HostTopology for the block")
        return plan.with_host_fault(topology.devices_of(event.device)), True
    except (ValueError, KeyError):
        return plan, False


def replay_log(
    plan: FleetPlan,
    events: Sequence[FleetEvent],
    stage_names: Sequence[str],
    *,
    target: str = HW,
    fallback: str = SW,
    topology: Optional[HostTopology] = None,
) -> Tuple[FleetPlan, Tuple[FleetEvent, ...]]:
    """Fold an ordered log over a plan; returns the final plan and the
    events that were dropped as inapplicable."""
    dropped: List[FleetEvent] = []
    for ev in merge_event_logs(events):
        plan, applied = apply_event(
            plan,
            ev,
            stage_names,
            target=target,
            fallback=fallback,
            topology=topology,
        )
        if not applied:
            dropped.append(ev)
    return plan, tuple(dropped)


def fleet_fingerprint(plan: FleetPlan) -> str:
    """Stable digest of a FleetPlan's full state — hosts exchange this
    to assert they agreed on the same plan (the hash() builtin is salted
    per process, so it cannot cross a process boundary)."""
    doc = {
        "plans": [list(p.assignments) + [p.default] for p in plan.plans],
        "spares": list(plan.pool.spares),
        "assignments": [list(a) for a in plan.pool.assignments],
        "quarantined": list(plan.quarantined),
        "fault_counts": list(plan.fault_counts),
    }
    return hashlib.sha256(json.dumps(doc, sort_keys=True).encode()).hexdigest()[:16]


# ----------------------------------------------------------- coordinators
class HostTimeoutError(RuntimeError):
    """A peer host failed to publish within the bounded retry budget.

    Typed — carrying the missing ``host_id`` — so the fleet layer can
    convert the silent peer into a ``with_host_fault`` event (survivors
    re-fold and keep serving) instead of inheriting an opaque hang.
    """

    def __init__(self, host_id: int, message: Optional[str] = None):
        super().__init__(message or f"host {host_id} timed out")
        self.host_id = int(host_id)


class LocalCoordinator:
    """The trivial single-host transport (exchange = identity)."""

    num_hosts = 1
    host_id = 0

    def exchange(self, payload: str) -> List[str]:
        return [payload]


class EventChannel:
    """Per-step event agreement over a coordinator.

    Each host publishes the transitions it *locally* observed this step;
    every host receives the union and applies the canonical merge order.
    ``log`` accumulates the agreed history — the fleet's event log.
    """

    def __init__(self, coordinator):
        self.coordinator = coordinator
        self.log: List[FleetEvent] = []
        self._seq = 0

    def _stamp(self, step: int, local_events: Sequence[Sequence]) -> List[FleetEvent]:
        stamped = []
        for ev in local_events:
            host = self.coordinator.host_id
            stamped.append(FleetEvent.from_engine(step, host, self._seq, ev))
            self._seq += 1
        return stamped

    def _merge_payloads(
        self, payloads: Sequence[Optional[str]]
    ) -> Tuple[FleetEvent, ...]:
        # None slots are peers the coordinator marked dead — their
        # history is already folded; nothing new can arrive from them.
        logs = [
            tuple(FleetEvent.from_wire(w) for w in json.loads(p))
            for p in payloads
            if p is not None
        ]
        merged = merge_event_logs(*logs)
        self.log.extend(merged)
        return merged

    def exchange(
        self, step: int, local_events: Sequence[Sequence]
    ) -> Tuple[FleetEvent, ...]:
        """Agree on this step's events (call once per step, every host)."""
        stamped = self._stamp(step, local_events)
        payload = json.dumps([e.to_wire() for e in stamped])
        return self._merge_payloads(self.coordinator.exchange(payload))

    def exchange_many(
        self, step_events: Mapping[int, Sequence[Sequence]]
    ) -> Tuple[FleetEvent, ...]:
        """One exchange covering several steps (the late-event flush
        after a workload drains)."""
        stamped: List[FleetEvent] = []
        for step in sorted(step_events):
            stamped.extend(self._stamp(step, step_events[step]))
        payload = json.dumps([e.to_wire() for e in stamped])
        return self._merge_payloads(self.coordinator.exchange(payload))
