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
  * ``KVCoordinator`` — the transport between processes: an all-to-all
    string exchange over the ``torch.distributed`` ``TCPStore`` that
    ``initialize_runtime`` opens (through ``StoreClient``), with bounded,
    jittered retries and a typed ``HostTimeoutError`` for a silent peer;
    ``LocalCoordinator`` is the trivial single-process instance.

``HostTopology`` names the device→host partition and ``HostView`` extends
``FleetMeshView`` with per-host masks and global→local device index
translation, so ``launch.sharding.shard_bounds`` can partition a global
batch while each host executes only its owned slice.

``initialize_runtime`` wraps ``torch.distributed.init_process_group`` over
a ``TCPStore`` served by rank 0, with the collective backend an explicit
argument: ``gloo`` for CPU tensors (and for several ranks sharing one
card, which NCCL refuses), ``nccl`` when each rank owns its own card.
"""
from __future__ import annotations

import hashlib
import json
import random
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.routing import FleetPlan
from repro_torch.launch.mesh import FleetMeshView, Mesh, _mesh, cuda_devices
from repro_torch.launch.sharding import shard_bounds
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.logging import get_logger, set_host
from repro_torch.viscosity.lang import HW, SW

log = get_logger("launch.distributed")

# Event kinds, mirroring the FleetPlan transitions (plus host loss, which
# expands to one with_host_fault transition over the host's device block).
STAGE = "stage"
DEVICE = "device"
RECOVER = "recover"
HOST = "host"
EVENT_KINDS = (STAGE, DEVICE, RECOVER, HOST)


# --------------------------------------------------------------- runtime
@dataclass(frozen=True)
class DistributedRuntime:
    """What ``initialize_runtime`` established for this process."""

    num_processes: int
    process_id: int
    coordinator_address: Optional[str] = None
    backend: Optional[str] = None


#: the store the process group was opened over (``KVCoordinator``'s
#: default client); set by ``initialize_runtime``, process-wide as the
#: process group itself is
_STORE = None


def _split_address(address: str) -> Tuple[str, int]:
    host, sep, port = address.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"coordinator address must be 'host:port', got "
                         f"{address!r}")
    return host, int(port)


def initialize_runtime(
    coordinator_address: Optional[str] = None,
    num_processes: int = 1,
    process_id: int = 0,
    *,
    backend: Optional[str] = None,
    timeout_s: float = 300.0,
) -> DistributedRuntime:
    """Wrap ``torch.distributed.init_process_group`` for the fleet runtime.

    Rank 0 serves a ``TCPStore`` at ``coordinator_address`` ("host:port")
    and every rank joins the process group over it; the same store carries
    ``KVCoordinator``'s exchanges.  ``backend`` is the collective backend
    and has no default: ``gloo`` for CPU tensors, ``nccl`` when each rank
    owns its own card (NCCL refuses a GPU that two ranks share, so ranks
    on one card use ``gloo`` on CPU tensors).  ``num_processes <= 1`` with
    no coordinator address is the single-process no-op, so the same entry
    point serves tests and real launches.  ``timeout_s`` bounds the
    rendezvous and the store's blocking calls.
    """
    global _STORE
    set_host(process_id)
    if num_processes <= 1 and coordinator_address is None:
        return DistributedRuntime(num_processes=1, process_id=0)
    if backend is None:
        raise ValueError("initialize_runtime needs an explicit backend: "
                         "'gloo' (CPU tensors, or ranks sharing one card) "
                         "or 'nccl' (one card per rank)")
    if coordinator_address is None:
        raise ValueError(f"{num_processes} processes need a coordinator "
                         "address 'host:port'")
    host, port = _split_address(coordinator_address)
    timeout = timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, port, num_processes, process_id == 0,
                          timeout=timeout)
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id, timeout=timeout)
    _STORE = store
    return DistributedRuntime(
        num_processes=dist.get_world_size(),
        process_id=dist.get_rank(),
        coordinator_address=coordinator_address,
        backend=backend,
    )


def shutdown_runtime() -> None:
    """Leave the process group ``initialize_runtime`` opened (a no-op
    when none is open).  Rank 0 serves the store, so every rank's last
    exchange must be done before rank 0 shuts down: end with one
    ``KVCoordinator.exchange`` on every rank, then call this."""
    global _STORE
    if dist.is_initialized():
        dist.destroy_process_group()
    _STORE = None


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

    @classmethod
    def current(cls, devices_per_host: Optional[int] = None) -> "HostTopology":
        """The topology of the initialized ``torch.distributed`` runtime:
        one host per rank.  ``devices_per_host`` defaults to the process's
        CUDA device count; without a card it must be given."""
        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized; call "
                               "initialize_runtime() first")
        if devices_per_host is None:
            devices_per_host = torch.cuda.device_count()
            if devices_per_host < 1:
                raise RuntimeError(
                    "this process sees no CUDA device: pass "
                    "devices_per_host explicitly")
        return cls(num_hosts=dist.get_world_size(),
                   devices_per_host=devices_per_host,
                   host_id=dist.get_rank())

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

    def local_submesh(self, axes: Sequence[str] = ("data",),
                      devices=None) -> Mesh:
        """1-D mesh over this host's serving devices only."""
        devs = self.local_serving_devices(devices)
        if not devs:
            raise RuntimeError(
                f"host {self.topology.host_id} has no serving devices "
                f"(quarantined={self.quarantined})")
        return _mesh((len(devs),), tuple(axes), devices=devs)

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


_CLIENT_ERRORS: Optional[Tuple[type, ...]] = None


def coordination_client_errors() -> Tuple[type, ...]:
    """Error types the store client raises (timeouts, disconnects,
    missing keys).  Probed lazily because the taxonomy varies across torch
    versions; ``RuntimeError`` is the floor every known client satisfies
    (``DistStoreError`` and ``DistNetworkError`` derive from it where they
    exist).  This is the *only* exception set coordination code may catch
    broadly — anything outside it is a genuine bug and must propagate."""
    global _CLIENT_ERRORS
    if _CLIENT_ERRORS is None:
        errs: List[type] = [RuntimeError]
        for name in ("DistStoreError", "DistNetworkError"):
            err = getattr(dist, name, None)
            if isinstance(err, type) and issubclass(err, Exception):
                errs.append(err)
        _CLIENT_ERRORS = tuple(dict.fromkeys(errs))
    return _CLIENT_ERRORS


class StoreClient:
    """A ``torch.distributed`` store behind the key-value client interface
    ``KVCoordinator`` speaks (the reference's coordination-service
    client): set, a get that blocks at most ``timeout_ms``, delete.  A get
    first waits on the key with the attempt's budget, because the store's
    own ``get`` of a missing key blocks for the store's whole timeout."""

    def __init__(self, store):
        self.store = store

    def key_value_set(self, key: str, value: str) -> None:
        self.store.set(key, value)

    def blocking_key_value_get(self, key: str, timeout_ms: int) -> str:
        self.store.wait([key], timedelta(milliseconds=max(int(timeout_ms),
                                                          1)))
        return self.store.get(key).decode()

    def key_value_delete(self, key: str) -> None:
        self.store.delete_key(key)


class LocalCoordinator:
    """The trivial single-host transport (exchange = identity)."""

    num_hosts = 1
    host_id = 0

    def exchange(self, payload: str) -> List[str]:
        return [payload]


class KVCoordinator:
    """All-to-all string exchange over the runtime's key-value store.

    The transport is ``initialize_runtime``'s ``TCPStore`` (through
    ``StoreClient``), so fleet coordination never depends on device
    collectives.  Every call advances a round counter shared by
    construction (hosts make the same deterministic sequence of
    exchanges), giving each exchange a fresh key under ``namespace``,
    which keeps them apart from the process group's own keys in the same
    store.  ``client`` may be any object with ``StoreClient``'s three
    methods (the chaos layer's ``StallingKVClient``).
    """

    def __init__(
        self,
        num_hosts: Optional[int] = None,
        host_id: Optional[int] = None,
        *,
        client=None,
        timeout_ms: int = 120_000,
        attempt_timeout_ms: int = 5_000,
        max_attempts: int = 6,
        backoff_base_s: float = 0.05,
        backoff_factor: float = 2.0,
        namespace: str = "fleet",
    ):
        if (num_hosts is None or host_id is None or client is None) and (
                _STORE is None or not dist.is_initialized()):
            raise RuntimeError(
                "torch.distributed is not initialized; call "
                "initialize_runtime() first"
            )
        self.num_hosts = dist.get_world_size() if num_hosts is None \
            else num_hosts
        self.host_id = dist.get_rank() if host_id is None else host_id
        if client is None:
            client = StoreClient(_STORE)
        if max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {max_attempts}")
        self._client = client
        self._timeout_ms = timeout_ms
        self._attempt_timeout_ms = attempt_timeout_ms
        self._max_attempts = max_attempts
        self._backoff_base_s = backoff_base_s
        self._backoff_factor = backoff_factor
        self._namespace = namespace
        self._round = 0
        self._dead: set = set()

    def mark_dead(self, host: int) -> None:
        """Stop waiting on ``host``: the fleet layer calls this after it
        converted the peer's ``HostTimeoutError`` into a host-fault
        event.  The dead peer's slot in every later exchange is ``None``
        (consumers skip it) — the survivors keep lockstep rounds without
        re-paying the retry budget each step."""
        self._dead.add(int(host))

    def _get_with_retry(self, key: str, peer: int, round_idx: int) -> str:
        """Bounded retries with jittered exponential backoff under the
        overall ``timeout_ms`` deadline.  A peer that never publishes
        surfaces as a typed ``HostTimeoutError(host_id)`` after at most
        ``max_attempts`` short gets — not one opaque 120 s block."""
        deadline = time.monotonic() + self._timeout_ms / 1000.0
        # Deterministically seeded jitter: distinct per (round, peer,
        # self) so hosts don't thundering-herd the store in sync.
        rng = random.Random(round_idx * 1009 + peer * 31 + self.host_id)
        last: Optional[BaseException] = None
        attempts = 0
        for attempt in range(self._max_attempts):
            remaining_ms = int((deadline - time.monotonic()) * 1000)
            if remaining_ms <= 0:
                break
            attempts += 1
            budget = min(self._attempt_timeout_ms, remaining_ms)
            try:
                return self._client.blocking_key_value_get(f"{key}/{peer}", budget)
            except coordination_client_errors() as e:
                last = e
                obs_metrics.inc("kv_retries_total", op="get")
                obs_metrics.set_gauge("coord_attempt_timeout_seconds",
                                      budget / 1000.0, host=str(peer))
                if attempt + 1 >= self._max_attempts:
                    break
                backoff = min(
                    self._backoff_base_s * self._backoff_factor**attempt,
                    max(0.0, deadline - time.monotonic()),
                )
                if backoff > 0:
                    time.sleep(backoff * (0.5 + rng.random()))
        obs_metrics.inc("coord_timeouts_total", host=str(peer))
        log.warning("host_timeout", host=peer, round=round_idx,
                    attempts=attempts)
        raise HostTimeoutError(
            peer,
            f"host {peer} did not publish round {round_idx} within "
            f"{attempts} attempt(s) (budget {self._max_attempts} x "
            f"{self._attempt_timeout_ms} ms, deadline {self._timeout_ms} ms)",
        ) from last

    def exchange(self, payload: str) -> List[Optional[str]]:
        r = self._round
        self._round += 1
        key = f"{self._namespace}/x{r}"
        self._client.key_value_set(f"{key}/{self.host_id}", payload)
        out: List[Optional[str]] = []
        for h in range(self.num_hosts):
            if h == self.host_id:
                out.append(payload)
            elif h in self._dead:
                out.append(None)
            else:
                out.append(self._get_with_retry(key, h, r))
        # Garbage-collect this host's key from two rounds back: rounds
        # are lockstep (every host makes the same exchange sequence), so
        # a peer still reading round r-1 has finished r-2 entirely —
        # deleting r-2 can never race a reader.  Without this the
        # store accumulates one key per host per step
        # for the life of the runtime.  Cleanup is best-effort, but only
        # for the *client's* error taxonomy — anything else is a real
        # bug and propagates.
        if r >= 2 and hasattr(self._client, "key_value_delete"):
            try:
                self._client.key_value_delete(
                    f"{self._namespace}/x{r - 2}/{self.host_id}"
                )
            except coordination_client_errors() as e:
                log.debug("kv_gc_failed", round=r - 2, error=str(e))
        return out


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
