"""Fault-aware continuous-batching serve engine (paper §III at traffic scale).

Port of the reference's ``serve/engine.py``: the single-device engine and
the fleet layer above it.
Requests arrive over time with their own prompt lengths and token budgets;
the engine keeps a fixed pool of decode slots, prefills each admitted
request into a free slot, runs one decode step across all slots per tick,
and evicts finished sequences so their slots take new traffic.

Two failover modes mirror the paper's two mechanisms:

  * ``RECOMPILE`` (queue reconfiguration): the model is built per
    RoutingPlan in a Dispatcher; a fault yields a new plan and one
    rebuild, after which in-flight decodes continue rerouted.
  * ``RESIDENT`` (hot-spare residency): one model is built with
    ResidentRoute handles that read a host-side health mask on every
    call; failover flips a bit and rebuilds nothing.  The resident
    prefill is resident too.

The slot batch is written out (the reference vmaps a B=1 decode): the
pool is one cache with the slot axis at dim 1 of every leaf (KV
(L, slots, Smax, Hkv, Dh); for the hybrid family also the Mamba2 conv
tails and SSM states; for the SSM family the RWKV-6 token shifts and WKV
states instead of KV), and a decode tick is one
``decode_step`` over every slot.  Plain ops in decode run per slot, so on
the SW route the served tokens are bit-identical to the single-request
``reference_decode`` (the reference's contract); the HW SwiGLU kernel
takes all slots in one launch.  Weights are cast to the compute dtype once,
when the engine is built.

The fleet layer (paper §II Fig. 2, §V Fig. 8) stacks on the same engine:
``FleetServeEngine`` runs one slot pool per logical *device*, every device
consulting its own ``RoutingPlan`` out of a shared ``FleetPlan``.  The pools
share one pair of Dispatchers, the cast weights and the route-free shape
model (``ServeEngine(template=...)``): the weights are held once per fleet,
each pool keeps its own cache.  All pools of one ``FleetServeEngine`` live
on one ``torch.device``.  In RESIDENT mode the pools also share the resident
model's host health list, and each pool writes its own mask into it just
before each prefill or tick (calls are sequential on one host), so every
device routes on its own health bits through one model.  A faulted
device's work migrates to a hot spare when one is free (its in-flight slots
drain and re-admit; greedy decode re-decodes the same tokens); otherwise
the device degrades in place like the single-device engine.

Multi-host mode (``FleetConfig.topology`` + a coordinator) is the
reference's deterministic replication: every host runs the same scheduling
loop, executes only its own device block and keeps ``_ShadowWorker``
bookkeeping twins for the rest (slot choice, budgets and eviction order
never depend on token values); fleet-health events are agreed through
``launch.distributed.EventChannel``, and ``merge_completions`` resolves
each host's placeholder completions against the owning host's tokens.
"""
from __future__ import annotations

import collections
import json
import time
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.datacenter import DegradationModel
from repro_torch.core.fault import FaultState
from repro_torch.core.oobleck import Dispatcher
from repro_torch.core.routing import FleetPlan, RoutingPlan, rung_occupancy
from repro_torch.device import resolve_device
from repro_torch.launch.distributed import (EventChannel, HostTimeoutError,
                                            HostTopology, fleet_fingerprint)
from repro_torch.models import build_model, compute_params
from repro_torch.obs import metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.train.runner import model_stage_names
from repro_torch.viscosity import REGISTRY, SW, lanefault

# Failover modes (paper §III: queue reconfiguration vs hot-spare residency).
RECOMPILE = "recompile"
RESIDENT = "resident"

@dataclass(frozen=True)
class Request:
    """One serving request: a prompt, a token budget, an arrival time
    (measured in engine steps, so workloads are deterministic).

    Open-loop traffic adds two optional fields: ``arrival_time`` is the
    request's arrival on the *virtual clock* (seconds; the admission
    front end releases it to the engine when the clock reaches it — the
    step-based ``arrival`` stays the engine's own admission gate), and
    ``deadline`` is the per-request SLO on the same clock (the front end
    schedules EDF on it and evicts expired work)."""
    rid: int
    prompt: Any                      # (P,) int32 array-like
    max_new_tokens: int
    arrival: int = 0
    arrival_time: Optional[float] = None   # virtual-clock seconds
    deadline: Optional[float] = None       # virtual-clock SLO deadline


@dataclass
class Completion:
    rid: int
    tokens: np.ndarray               # (max_new_tokens,) int32
    prompt_len: int
    arrival: int
    admitted_step: int
    finished_step: int
    latency_s: float                 # wall: queue-eligible -> last token
    device: int = -1                 # fleet device that decoded it
    placeholder: bool = False        # True: decoded on a remote host —
    #                                  merge_completions fills in tokens
    # SLO fields (virtual-clock seconds once a Frontend ran the workload;
    # wall seconds when the engine ran bare).  ``expired`` completions
    # were evicted at their deadline with only the tokens decoded so far.
    queue_wait_s: float = 0.0        # arrival/eligible -> admission
    ttft_s: float = 0.0              # arrival/eligible -> first token
    deadline: Optional[float] = None
    deadline_met: bool = True
    expired: bool = False


@dataclass
class _Slot:
    rid: int
    prompt_len: int
    arrival: int
    remaining: int
    out: List[int]
    admitted_step: int
    eligible_wall: float
    req: Optional[Request] = None    # original request (fleet drain/requeue)


@dataclass
class ServeConfig:
    max_len: int = 256               # KV capacity per slot (prompt + new)
    max_slots: int = 4               # concurrent sequences per decode tick
    hw_route: str = SW               # healthy-stage target (HW on real TPUs)
    failover: str = RECOMPILE        # RECOMPILE | RESIDENT


def validate_requests(requests: Sequence[Request], max_len: int):
    """Request sanity shared by every engine front door.

    Every rejection names the offending request id and field, so a bad
    request in a 10k-request open-loop workload is findable from the
    message alone."""
    seen = set()
    for r in requests:
        if r.rid in seen:
            raise ValueError(f"request {r.rid}: duplicate request id "
                             f"(field 'rid')")
        seen.add(r.rid)
        if len(r.prompt) < 1:
            raise ValueError(f"request {r.rid}: field 'prompt' must be "
                             f"non-empty")
        if r.max_new_tokens < 1:
            raise ValueError(f"request {r.rid}: field 'max_new_tokens' "
                             f"must be >= 1, got {r.max_new_tokens}")
        if len(r.prompt) + r.max_new_tokens > max_len:
            raise ValueError(
                f"request {r.rid}: fields 'prompt' ({len(r.prompt)}) + "
                f"'max_new_tokens' ({r.max_new_tokens}) exceed max_len "
                f"{max_len}")
        if r.arrival < 0:
            raise ValueError(f"request {r.rid}: field 'arrival' must be "
                             f">= 0, got {r.arrival}")
        if r.arrival_time is not None and not r.arrival_time >= 0:
            raise ValueError(f"request {r.rid}: field 'arrival_time' must "
                             f"be >= 0, got {r.arrival_time}")
        if r.deadline is not None:
            if not r.deadline >= 0:
                raise ValueError(f"request {r.rid}: field 'deadline' must "
                                 f"be >= 0, got {r.deadline}")
            t0 = r.arrival_time if r.arrival_time is not None else 0.0
            if r.deadline <= t0:
                raise ValueError(
                    f"request {r.rid}: field 'deadline' ({r.deadline}) "
                    f"must be after field 'arrival_time' ({t0}) — the "
                    f"request would expire before it arrives")


class _SlotPool:
    """Slot bookkeeping shared by the real engine and its shadow twins.

    Everything here is value-independent: slot choice (lowest free),
    eviction (budget exhausted), drain order (youngest first) — so a
    remote host replaying only this bookkeeping stays in lockstep with
    the host actually decoding.  Subclasses set ``scfg``, ``placeholder``
    and ``device_index`` and call ``_init_pool``.
    """

    placeholder = False              # shadow pools emit placeholder
    device_index = -1                # completions; fleet sets the index

    def _init_pool(self):
        self._slots: List[Optional[_Slot]] = [None] * self.scfg.max_slots
        self.capacity = self.scfg.max_slots   # admission ceiling

    def occupancy(self) -> int:
        return sum(sl is not None for sl in self._slots)

    def has_free_slot(self) -> bool:
        return (self.occupancy() < self.capacity
                and any(sl is None for sl in self._slots))

    def free_slots(self) -> int:
        """Admissions this pool can take right now (capacity- and
        physical-slot-limited) — the admission front end sizes its EDF
        batch with this."""
        free = sum(sl is None for sl in self._slots)
        return max(0, min(self.capacity - self.occupancy(), free))

    def active_slots(self) -> List[int]:
        return [i for i, sl in enumerate(self._slots) if sl is not None]

    def drain(self) -> List[Request]:
        """Evict every in-flight sequence and hand back the original
        requests for re-admission elsewhere (fleet migration).  Partial
        outputs are discarded — greedy decode makes the re-decoded tokens
        bit-identical to an uninterrupted run."""
        drained = [sl.req for sl in self._slots
                   if sl is not None and sl.req is not None]
        for i in range(len(self._slots)):
            self._slots[i] = None
        return drained

    def drain_excess(self) -> List[Request]:
        """Evict just enough in-flight sequences to fit a reduced
        capacity (fleet degradation), youngest first — the least
        re-decoded work is thrown away."""
        excess = self.occupancy() - self.capacity
        if excess <= 0:
            return []
        victims = sorted(self.active_slots(),
                         key=lambda i: len(self._slots[i].out))[:excess]
        out = [self._slots[i].req for i in victims
               if self._slots[i].req is not None]
        for i in victims:
            self._slots[i] = None
        return out

    def _finish(self, i: int, step: int, completions: Dict[int,
                                                           "Completion"],
                *, expired: bool = False):
        sl = self._slots[i]
        completions[sl.rid] = Completion(
            rid=sl.rid,
            tokens=np.asarray(() if self.placeholder else sl.out, np.int32),
            prompt_len=sl.prompt_len, arrival=sl.arrival,
            admitted_step=sl.admitted_step, finished_step=step,
            latency_s=time.perf_counter() - sl.eligible_wall,
            device=self.device_index, placeholder=self.placeholder,
            deadline=(sl.req.deadline if sl.req is not None else None),
            deadline_met=not expired, expired=expired)
        self._slots[i] = None

    def evict_rid(self, rid: int, step: int,
                  completions: Dict[int, "Completion"]) -> bool:
        """Deadline-expiry eviction: free the slot holding ``rid`` *now*
        and emit an expired Completion carrying whatever tokens were
        already decoded.  Returns False when ``rid`` holds no slot here.
        Value-independent (slot lookup by rid only), so shadow twins
        replay it in lockstep."""
        for i, sl in enumerate(self._slots):
            if sl is not None and sl.rid == rid:
                self._finish(i, step, completions, expired=True)
                return True
        return False


class ServeEngine(_SlotPool):
    """Continuous-batching engine; all routing flows through RoutingPlan.

    ``device=None`` runs on the card (``cuda``); without CUDA it raises.
    Tests pass ``device="cpu"``.  ``params`` may live anywhere and in the
    param dtype: the engine moves them to its device and casts weights to
    the compute dtype once, here (``models.compute_params``).
    ``classifier`` (a ``core.fault.FaultClassifier``) sends each
    ``observe_fault`` through probation.

    Fleet workers pass ``dispatchers`` (one shared build cache) and
    ``template`` (the fleet's first engine): they share its device, its
    cast weights, its route-free shape model and its resident health
    list, and keep only their own pool state (``params`` is then
    unused)."""

    def __init__(self, cfg: ModelConfig, params, scfg: ServeConfig, *,
                 device=None, classifier=None,
                 dispatchers: Optional[Tuple[Dispatcher, Dispatcher]] = None,
                 template: Optional["ServeEngine"] = None):
        if scfg.failover not in (RECOMPILE, RESIDENT):
            raise ValueError(f"unknown failover mode {scfg.failover!r}; "
                             f"expected {RECOMPILE!r} or {RESIDENT!r}")
        self.cfg = cfg
        self.scfg = scfg
        self.classifier = classifier   # core.fault.FaultClassifier | None
        self.fault_state = FaultState()
        self.stage_names = model_stage_names(cfg)
        if template is not None:
            self.device = template.device
            self._shape_model = template._shape_model
            self.params = template.params
            self._health = template._health
        else:
            self.device = resolve_device(device)
            self._shape_model = build_model(cfg)   # route-free: cache shapes
            self.params = compute_params(
                params, self._shape_model.compute_dtype, device=self.device)
            # Host-side health bits of the resident model: ResidentRoutes
            # read them on every call, so flipping one reroutes without a
            # rebuild.  Fleet workers share this list; each writes its own
            # mask into it before each call (``_model``).
            self._health: List[bool] = [True] * len(self.stage_names)
        if dispatchers is None:
            self._prefill = Dispatcher(self._build)
            self._decode = Dispatcher(self._build)
        else:                        # fleet workers share one build cache
            self._prefill, self._decode = dispatchers
        self.reset_pool()

    # --------------------------------------------------------- pool state
    def reset_pool(self):
        """Fresh slot pool: no admitted sequences, full capacity."""
        S = self.scfg.max_slots
        self._caches = self._shape_model.init_cache(S, self.scfg.max_len,
                                                    device=self.device)
        self._toks = torch.zeros((S, 1), dtype=torch.long,
                                 device=self.device)
        self._tvec: List[int] = [0] * S
        self._init_pool()

    # ------------------------------------------------------------- plans
    def plan(self) -> RoutingPlan:
        """RoutingPlan for the current fault state: healthy stages take the
        deployment target; quarantined stages walk the degradation ladder
        when a lane map is known, else drop to the SW fallback."""
        base = RoutingPlan.from_signature(
            self.fault_state.signature(self.stage_names),
            healthy=self.scfg.hw_route)
        return lanefault.degraded_plan(
            base, self.fault_state.counts(self.stage_names)
        ).validate(registry=REGISTRY)

    def _decode_key(self) -> RoutingPlan:
        if self.scfg.failover == RESIDENT:
            # One resident model, keyed by the all-healthy plan; the host
            # health mask does the rerouting per call.
            return RoutingPlan.for_stages(self.stage_names,
                                          target=self.scfg.hw_route)
        return self.plan()

    def health_mask(self) -> List[bool]:
        return [not self.fault_state.is_faulty(s) for s in self.stage_names]

    def inject_fault(self, stage: str):
        if stage not in self.stage_names:
            raise ValueError(f"unknown stage {stage!r}; this model's stages:"
                             f" {self.stage_names}")
        self.fault_state.mark(stage, 0, kind="injected")

    def observe_fault(self, stage: str, *, step: int = 0) -> bool:
        """Route one detection through the probation classifier (when the
        engine has one).  The stage is marked first — probation must not
        race new work onto the suspect path — then its canary re-executes
        under the classifier's backoff budget.  A transient verdict
        (canary went clean) clears the mark within this call, so the next
        ``plan()`` (and the resident health mask) keeps the HW route with
        no rebuild; persistent keeps the mark and the degradation ladder
        walks exactly as an ``inject_fault`` would.  Returns True when
        transient."""
        if stage not in self.stage_names:
            raise ValueError(f"unknown stage {stage!r}; this model's stages:"
                             f" {self.stage_names}")
        self.fault_state.mark(stage, 0, kind="detected", step=step)
        if self.classifier is None:
            return False
        res = self.classifier.classify(stage, replica=0, step=step,
                                       state=self.fault_state)
        if res.transient:
            self.fault_state.clear(stage, 0, step=step)
            return True
        return False

    # ------------------------------------------------------------ builds
    def _build(self, plan: RoutingPlan):
        """One "compile": the model under ``plan``.  Resident mode builds it
        with ResidentRoute handles over the shared host health mask."""
        if self.scfg.failover == RESIDENT:
            return build_model(self.cfg, routes=plan.resident_routes(
                self._health, self.stage_names))
        return build_model(self.cfg, routes=plan)

    def _model(self, dispatcher: Dispatcher):
        """The model for this engine's next call.  RESIDENT: write this
        engine's health mask into the (possibly fleet-shared) host list the
        resident model reads, right before the call."""
        model = dispatcher.get(self._decode_key())
        if self.scfg.failover == RESIDENT:
            self._health[:] = self.health_mask()
        return model

    def _validate(self, requests: Sequence[Request]):
        validate_requests(requests, self.scfg.max_len)

    # --------------------------------------------------------- admission
    def admit(self, req: Request, step: int, eligible_wall: float,
              completions: Dict[int, Completion]) -> int:
        """Prefill ``req`` into the lowest free slot (caller checks
        ``has_free_slot``); single-token requests complete immediately.
        Returns the number of tokens emitted (always 1)."""
        i = next(idx for idx, sl in enumerate(self._slots) if sl is None)
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                 device=self.device)[None]
        P = prompt.shape[1]
        # The slot's cache lane, as views of the pool, emptied for the
        # newcomer; prefill writes it in place.
        model = self._model(self._prefill)
        lane = model.clear_lane(model.cache_lane(self._caches, i))
        logits, _ = model.prefill(self.params, {"tokens": prompt,
                                                "cache": lane})
        first = logits[:, -1].argmax(-1)                   # (1,)
        self._toks[i] = first
        self._tvec[i] = P
        self._slots[i] = _Slot(rid=req.rid, prompt_len=len(req.prompt),
                               arrival=req.arrival,
                               remaining=req.max_new_tokens - 1,
                               out=[int(first[0])], admitted_step=step,
                               eligible_wall=eligible_wall, req=req)
        if self._slots[i].remaining == 0:         # single-token request
            self._finish(i, step, completions)
        return 1

    # ------------------------------------------------------------- ticks
    def decode_tick(self, step: int,
                    completions: Dict[int, Completion]) -> Dict[str, Any]:
        """One decode step across the pool; appends a token to every
        active slot, evicts finished sequences.  Returns per-tick metrics
        (``active`` = 0 means the pool was idle: no decode ran)."""
        active = self.active_slots()
        if not active:
            return {"active": 0, "dt": 0.0, "key": None, "tokens": 0}
        key = self._decode_key()
        model = self._model(self._decode)
        t0 = time.perf_counter()
        logits, _ = model.decode_step(self.params, self._caches, self._toks,
                                      self._tvec)
        nxt = logits[:, -1].argmax(-1)                      # (S,)
        nxt_host = nxt.tolist()                             # waits for it
        dt = time.perf_counter() - t0
        metrics.observe("serve_decode_tick_seconds", dt)
        self._toks = nxt[:, None]
        for i in active:
            self._tvec[i] += 1
            sl = self._slots[i]
            sl.out.append(int(nxt_host[i]))
            sl.remaining -= 1
            if sl.remaining == 0:                 # evict finished
                self._finish(i, step, completions)
        return {"active": len(active), "dt": dt, "key": key,
                "tokens": len(active)}

    # -------------------------------------------------------------- run
    def session(self) -> "EngineSession":
        """Open a streaming serve session (resets the slot pool)."""
        return EngineSession(self)

    def serve(self, requests: Sequence[Request], *,
              fault_at_step: Optional[Tuple[int, str]] = None
              ) -> Tuple[Dict[int, Completion], Dict[str, Any]]:
        """Run a workload to completion (closed-loop wrapper over the
        session API).  ``fault_at_step=(k, stage)`` quarantines ``stage``
        just before engine step ``k``.  Returns ({rid: Completion},
        stats)."""
        self._validate(requests)
        sess = self.session()
        for r in sorted(requests, key=lambda r: (r.arrival, r.rid)):
            sess.submit(r, _validated=True)
        while sess.pending():
            if fault_at_step is not None and \
                    sess.step_count == fault_at_step[0]:
                self.inject_fault(fault_at_step[1])
            sess.step()
        stats = sess.close()
        return {c.rid: c for c in sess.poll()}, stats

    def generate(self, prompts, n_new: int, *,
                 fault_at_step: Optional[Tuple[int, str]] = None
                 ) -> Tuple[np.ndarray, Dict[str, Any]]:
        """Fixed-batch wrapper: every row of ``prompts`` (B, P) arrives at
        step 0 and decodes ``n_new`` tokens; returns (B, n_new) tokens."""
        prompts = np.asarray(prompts)
        B = prompts.shape[0]
        if B > self.scfg.max_slots:
            raise ValueError(f"batch {B} exceeds max_slots "
                             f"{self.scfg.max_slots}")
        reqs = [Request(rid=i, prompt=prompts[i], max_new_tokens=n_new)
                for i in range(B)]
        completions, stats = self.serve(reqs, fault_at_step=fault_at_step)
        return np.stack([completions[i].tokens for i in range(B)]), stats


# ==========================================================================
# Fleet layer (paper §II Fig. 2, §V Fig. 8)
# ==========================================================================
@dataclass
class FleetConfig:
    """Fleet shape + degradation policy for ``FleetServeEngine``.

    ``degradation[k]`` is the relative capacity of a device carrying ``k``
    fallback-routed stages (the paper's VFA throughput curve); ``None``
    keeps every serving device at full slot capacity.  Capacity is
    quantized to whole slots (``capacity_for``) — the fleet harness uses
    the same quantization on the analytic side, so measured-vs-analytic
    comparisons are slot-exact.

    ``topology`` partitions the devices across hosts (multi-host mode):
    with ``topology.host_id`` set, this process executes only its own
    device block and shadows the rest; ``host_id=None`` keeps everything
    local while still enabling host-indexed events (single-process
    emulation, the benches' ``--hosts`` mode).

    ``model`` upgrades the scalar curve to a ``DegradationModel``: a
    device whose plan routes stages through the DEGRADED family is
    charged those stages' per-rung partial factors instead of full curve
    steps (pass the device's RoutingPlan to ``capacity_for``)."""

    n_devices: int = 2
    n_spares: int = 0
    degradation: Optional[Sequence[float]] = None
    topology: Optional[HostTopology] = None
    model: Optional[DegradationModel] = None

    def capacity_for(self, n_faults: int, max_slots: int,
                     plan: Optional[RoutingPlan] = None) -> int:
        if self.model is not None:
            rungs = (DegradationModel.rungs_of(plan)
                     if plan is not None else ())
            return max(0, int(self.model.slot_cap(max_slots, n_faults,
                                                  rungs)))
        if self.degradation is None:
            return max_slots
        deg = list(self.degradation)
        f = deg[min(n_faults, len(deg) - 1)]
        return max(0, int(round(max_slots * f)))


class _ShadowWorker(_SlotPool):
    """Bookkeeping twin of a remote host's ``ServeEngine`` slot pool.

    Replays the value-independent half of the pool — admission into the
    lowest free slot, one budget decrement per tick, eviction at zero —
    so this host's scheduler stays in lockstep with the host actually
    decoding.  Completions it emits are placeholders (no tokens);
    ``merge_completions`` resolves them against the owning host."""

    placeholder = True

    def __init__(self, scfg: ServeConfig):
        self.scfg = scfg
        self.fault_state = FaultState()
        self.reset_pool()

    def reset_pool(self):
        self._init_pool()

    def admit(self, req: Request, step: int, eligible_wall: float,
              completions: Dict[int, Completion]) -> int:
        i = next(idx for idx, sl in enumerate(self._slots) if sl is None)
        self._slots[i] = _Slot(rid=req.rid, prompt_len=len(req.prompt),
                               arrival=req.arrival,
                               remaining=req.max_new_tokens - 1,
                               out=[0], admitted_step=step,
                               eligible_wall=eligible_wall, req=req)
        if self._slots[i].remaining == 0:         # single-token request
            self._finish(i, step, completions)
        return 1

    def decode_tick(self, step: int,
                    completions: Dict[int, Completion]) -> Dict[str, Any]:
        active = self.active_slots()
        if not active:
            return {"active": 0, "dt": 0.0, "key": None, "tokens": 0}
        for i in active:
            sl = self._slots[i]
            sl.out.append(0)         # keeps drain_excess age order exact
            sl.remaining -= 1
            if sl.remaining == 0:
                self._finish(i, step, completions)
        return {"active": len(active), "dt": 0.0, "key": None,
                "tokens": len(active)}


def merge_completions(coordinator, completions: Dict[int, Completion]
                      ) -> Dict[int, Completion]:
    """All-to-all exchange of locally decoded completions: every host
    publishes its real (non-placeholder) completions and resolves its
    placeholders against the owning hosts'.  Loud error if any request
    ends up with no real tokens anywhere — a dropped request can never
    masquerade as a merge artifact."""
    local = [[c.rid, np.asarray(c.tokens).tolist(), c.prompt_len,
              c.arrival, c.admitted_step, c.finished_step, c.latency_s,
              c.device, c.queue_wait_s, c.ttft_s, c.deadline,
              c.deadline_met, c.expired]
             for c in completions.values() if not c.placeholder]
    payloads = coordinator.exchange(json.dumps(local))
    merged = dict(completions)
    for host, payload in enumerate(payloads):
        if host == coordinator.host_id or payload is None:
            continue             # None: a peer marked dead mid-run
        for rid, toks, plen, arr, astep, fstep, lat, dev, qw, ttft, \
                dl, dmet, exp in json.loads(payload):
            merged[rid] = Completion(
                rid=rid, tokens=np.asarray(toks, np.int32),
                prompt_len=plen, arrival=arr, admitted_step=astep,
                finished_step=fstep, latency_s=lat, device=dev,
                queue_wait_s=qw, ttft_s=ttft, deadline=dl,
                deadline_met=dmet, expired=exp)
    unresolved = sorted(r for r, c in merged.items() if c.placeholder)
    if unresolved:
        raise RuntimeError(f"no host decoded request(s) {unresolved}: "
                           "the fleet schedules desynced across hosts")
    return merged


class FleetServeEngine:
    """Device-indexed serve fleet: one slot pool per device, all consulting
    a shared ``FleetPlan``.

    Admission scans the serving devices in index order and places the
    queue head on the first device with free capacity; a quarantined
    device's pool drains and its requests re-admit (on its hot spare when
    the pool has one — Fig. 8 — otherwise on whatever capacity survives).
    The per-device pools share one Dispatcher pair, so devices with equal
    RoutingPlans share one model build, and one copy of the cast weights
    (the first pool is the others' ``template``).

    ``device=None`` puts every pool on the card (``cuda``); without CUDA
    it raises.  Tests pass ``device="cpu"``.
    """

    def __init__(self, cfg: ModelConfig, params, scfg: ServeConfig,
                 fcfg: FleetConfig, *, coordinator=None, classifier=None,
                 watchdog=None, device=None):
        if fcfg.n_devices < 1:
            raise ValueError(f"fleet needs >= 1 device, got {fcfg.n_devices}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.scfg = scfg
        self.fcfg = fcfg
        self.classifier = classifier   # core.fault.FaultClassifier | None
        self.watchdog = watchdog       # core.fault.StragglerWatchdog | None
        self._suspected: set = set()   # devices under watchdog suspicion
        self._pending_suspects: List[Tuple] = []   # resolve next step
        self.topology = fcfg.topology
        if self.topology is not None and \
                self.topology.n_devices != fcfg.n_devices:
            raise ValueError(
                f"topology covers {self.topology.n_devices} device(s), "
                f"fleet has {fcfg.n_devices}")
        self.coordinator = coordinator
        self.channel: Optional[EventChannel] = None
        if coordinator is not None and coordinator.num_hosts > 1:
            if self.topology is None or self.topology.host_id is None:
                raise ValueError("a multi-host coordinator needs "
                                 "FleetConfig.topology with host_id set")
            if coordinator.host_id != self.topology.host_id:
                raise ValueError(
                    f"coordinator is host {coordinator.host_id} but the "
                    f"topology claims host {self.topology.host_id}")
            self.channel = EventChannel(coordinator)
        self.stage_names = model_stage_names(cfg)
        self.fleet = FleetPlan.healthy(fcfg.n_devices, self.stage_names,
                                       target=scfg.hw_route,
                                       n_spares=fcfg.n_spares)
        # Real slot pools for this host's device block, bookkeeping
        # shadows for everyone else's (single-host: everything is real).
        self.workers: List[_SlotPool] = []
        shared: Optional[Tuple[Dispatcher, Dispatcher]] = None
        template: Optional[ServeEngine] = None
        for d in range(fcfg.n_devices):
            if self.topology is None or self.topology.is_local(d):
                w = ServeEngine(cfg, params, scfg, device=self.device,
                                dispatchers=shared, template=template)
                if shared is None:
                    shared = (w._prefill, w._decode)
                if template is None:
                    template = w
            else:
                w = _ShadowWorker(scfg)
            w.device_index = d
            self.workers.append(w)
        self._prefill, self._decode = shared if shared else (None, None)
        self.params = template.params if template is not None else params
        self.event_log: List[dict] = []
        self._sync_capacity()

    # ----------------------------------------------------- fleet health
    def _sync_capacity(self):
        serving = set(self.fleet.serving())
        for d, w in enumerate(self.workers):
            if d in serving:
                w.capacity = self.fcfg.capacity_for(
                    self.fleet.n_faults(d), self.scfg.max_slots,
                    plan=self.fleet.plans[d])
            else:
                w.capacity = 0
        for rung, n in rung_occupancy(self.fleet).items():
            metrics.set_gauge("fleet_rung_devices", n, rung=rung)

    def _apply(self, event: Tuple, step: int, *,
               strict: bool = True) -> List[Request]:
        """Apply one fault event to the FleetPlan; returns requests drained
        from newly-quarantined devices (for re-admission).

        ``strict=False`` (merged multi-host logs) tolerates transitions
        that no longer apply — two hosts reporting the same device fault
        must converge, not desync — recording them as dropped."""
        kind, device = event[0], event[1]
        if kind not in ("stage", "device", "host", "recover"):
            raise ValueError(f"unknown fleet event kind {kind!r}")
        if kind == "stage" and event[2] not in self.stage_names:
            raise ValueError(f"unknown stage {event[2]!r}; this model's "
                             f"stages: {self.stage_names}")
        if kind == "host" and self.topology is None:
            raise ValueError("host events need FleetConfig.topology")
        before = set(self.fleet.quarantined)
        try:
            if kind == "stage":
                self.fleet = self.fleet.with_stage_fault(device, event[2])
                self.workers[device].fault_state.mark(event[2], 0,
                                                      kind="injected")
            elif kind == "device":
                self.fleet = self.fleet.with_device_fault(device)
            elif kind == "host":
                self.fleet = self.fleet.with_host_fault(
                    self.topology.devices_of(device))
            else:                    # recover
                spare = self.fleet.pool.spare_for(device)
                stage = event[2] if len(event) > 2 else ""
                if stage:
                    # Stage-scoped (probation verdict: transient) — undo
                    # exactly one rung; other faults on the device stay.
                    self.fleet = self.fleet.with_stage_recovery(
                        device, stage, target=self.scfg.hw_route)
                    self.workers[device].fault_state.clear(stage, 0,
                                                           step=step)
                else:                # full repair: fresh hardware
                    self.fleet = self.fleet.with_recovery(
                        device, self.stage_names, target=self.scfg.hw_route)
                    self.workers[device].fault_state = FaultState()
                self._suspected.discard(device)
                if spare is not None and \
                        device not in self.fleet.quarantined:
                    # spare returns to the idle pool; its slots re-admit
                    drained = self.workers[spare].drain()  # on the
                    self.event_log.append({"step": step, "event": event,
                                           "drained": len(drained)})
                    self._sync_capacity()  # recovered device
                    return drained
        except ValueError:
            if strict:
                raise
            self.event_log.append({"step": step, "event": event,
                                   "dropped": True})
            return []
        newly_gone = set(self.fleet.quarantined) - before
        drained: List[Request] = []
        for d in sorted(newly_gone):
            drained.extend(self.workers[d].drain())
        self.event_log.append({"step": step, "event": event,
                               "drained": len(drained)})
        obs_trace.emit(step, name=f"fleet:{kind}", device=device,
                       stage=event[2] if kind in ("stage", "recover")
                       and len(event) > 2 else "",
                       drained=len(drained))
        self._sync_capacity()
        return drained

    # ---------------------------------------------- probation & watchdog
    def _probe(self, device: int, stage: str, step: int) -> List[Tuple]:
        """Probate one detection into the event tuples every host folds.
        Transient -> the ("stage", d, s) / ("recover", d, s) pair: the
        rung down AND back up both ride the ordered log, so probation
        state agrees fleet-wide.  Persistent -> the fault alone, and the
        ladder walks exactly as before.  Without a classifier every
        detection is persistent (the pre-probation behavior)."""
        if self.classifier is None:
            return [("stage", device, stage)]
        res = self.classifier.classify(
            stage, replica=device, step=step,
            state=self.workers[device].fault_state)
        if res.transient:
            return [("stage", device, stage), ("recover", device, stage)]
        return [("stage", device, stage)]

    def _resolve_suspect(self, device: int, step: int) -> List[Tuple]:
        """A watchdog suspicion names a device, not a stage: canary every
        stage there and probate the failing ones.  An all-clean suspicion
        (transient straggle — contention, GC pause) clears with a log
        entry and no routing change."""
        out: List[Tuple] = []
        if self.classifier is not None:
            for s in self.classifier.checker.stages:
                if not self.classifier.checker.check_stage(s):
                    out.extend(self._probe(device, s.name, step))
        if not out:
            self.workers[device].fault_state.note(
                "<watchdog>", device, kind="suspected_cleared", step=step)
        self._suspected.discard(device)
        return out

    def _watchdog_tick(self, device: int, tick: Mapping, step: int):
        """Feed one real decode tick to the straggler watchdog; newly
        flagged devices get a ``suspected`` fault-log entry and a pending
        suspect event the next session step resolves through the
        classifier."""
        wd = self.watchdog
        if wd is None or not tick["active"]:
            return
        if self.workers[device].placeholder:
            return                   # shadows don't decode: dt is fake
        wd.record(device, tick["dt"])
        for d in wd.stragglers():
            if d in self._suspected:
                continue
            self._suspected.add(d)
            self.workers[d].fault_state.note(
                "<watchdog>", d, kind="suspected", step=step)
            self._pending_suspects.append(("suspect", d))

    # convenience wrappers (usable between serve() calls or via events)
    def inject_stage_fault(self, device: int, stage: str):
        return self._apply(("stage", device, stage), step=-1)

    def inject_device_fault(self, device: int):
        return self._apply(("device", device), step=-1)

    def recover(self, device: int):
        return self._apply(("recover", device), step=-1)

    # -------------------------------------------------------------- run
    def session(self) -> "FleetSession":
        """Open a streaming serve session across the fleet (resets every
        slot pool).  Same submit/step/poll/close surface as the
        single-device ``ServeEngine.session`` — ``step`` additionally
        takes this step's fault events."""
        return FleetSession(self)

    def serve(self, requests: Sequence[Request], *,
              events: Optional[Mapping[int, Sequence[Tuple]]] = None
              ) -> Tuple[Dict[int, Completion], Dict[str, Any]]:
        """Run a workload to completion across the fleet (closed-loop
        wrapper over the streaming session API — completions are
        bit-identical to driving ``session()`` by hand).

        ``events[k]`` is a list of fault events applied just before engine
        step ``k``: ``("stage", device, stage_name)``,
        ``("device", device)``, ``("host", host)``, or
        ``("recover", device)``.  No request is ever dropped: draining
        re-queues at the front, and completions are bit-identical to the
        healthy single-device reference (greedy decode + Viscosity
        equivalence).

        With a multi-host coordinator, ``events`` holds only this host's
        *locally observed* events; each step every host publishes its
        slice through the shared event log and applies the canonical
        merged order, so all hosts fold the same transitions over the
        same FleetPlan.  Completions are merged across hosts before
        returning.
        """
        validate_requests(requests, self.scfg.max_len)
        events = dict(events or {})
        sess = self.session()
        for r in sorted(requests, key=lambda r: (r.arrival, r.rid)):
            sess.submit(r, _validated=True)
        while sess.pending():
            sess.step(events.pop(sess.step_count, ()))
        stats = sess.close(late_events=events)
        return {c.rid: c for c in sess.poll()}, stats


# ==========================================================================
# Streaming session API (the one serve front door; ROADMAP "open-loop
# traffic").  ``ServeEngine.serve`` / ``ServeEngine.generate`` /
# ``FleetServeEngine.serve`` are thin closed-loop wrappers over these.
# ==========================================================================
class ServeSession:
    """Streaming serve session: ``submit`` requests at any time (open-loop
    admission), ``step`` the engine one tick, ``poll`` completions
    finished since the last poll, ``close`` for the final stats.

    Built entirely on the value-independent ``_SlotPool`` primitives, so
    one session implementation serves both the single-device engine and
    the fleet (and the fleet's multi-host deterministic replication keeps
    working: scheduling never depends on token values or wall time).
    ``cancel`` is deadline-expiry eviction — it frees a queued or
    in-flight request immediately, emitting an expired Completion with
    whatever tokens were already decoded.
    """

    def __init__(self, engine):
        self.engine = engine
        self.scfg = engine.scfg
        self._queue: collections.deque = collections.deque()
        self._rids: set = set()
        self._eligible_wall: Dict[int, float] = {}
        self._completions: Dict[int, Completion] = {}
        self._delivered: set = set()
        self.step_count = 0
        self.closed = False
        self.stats: Dict[str, Any] = {}

    # -------------------------------------------------------- admission
    def submit(self, req: Request, *, _validated: bool = False) -> None:
        """Queue one request.  ``req.arrival`` is the earliest engine
        step it may be admitted; requests submitted mid-session join the
        live queue (open-loop traffic).  Admission from the queue is
        FIFO in submission order once arrivals gate open — an SLO-aware
        caller (``serve.frontend.Frontend``) orders its submissions."""
        if self.closed:
            raise RuntimeError("session is closed")
        if not _validated:
            validate_requests([req], self.scfg.max_len)
        if req.rid in self._rids:
            raise ValueError(f"request {req.rid}: duplicate request id "
                             f"(field 'rid') in this session")
        self._rids.add(req.rid)
        self._queue.append(req)

    def pending(self) -> bool:
        """True while any submitted request is queued or in flight."""
        return bool(self._queue) or self._occupancy() > 0

    def poll(self) -> List[Completion]:
        """Completions finished since the last poll (ascending rid)."""
        out = [c for r, c in sorted(self._completions.items())
               if r not in self._delivered]
        self._delivered.update(c.rid for c in out)
        return out

    def cancel(self, rid: int) -> bool:
        """Deadline-expiry eviction: abort a queued or in-flight request,
        freeing its slot for work that can still meet its SLO.  Emits an
        expired Completion (partial tokens if it was decoding).  Returns
        False when ``rid`` is not live in this session."""
        for i, r in enumerate(self._queue):
            if r.rid == rid:
                del self._queue[i]
                now = time.perf_counter()
                self._completions[rid] = Completion(
                    rid=rid, tokens=np.asarray((), np.int32),
                    prompt_len=len(r.prompt), arrival=r.arrival,
                    admitted_step=-1, finished_step=self.step_count,
                    latency_s=now - self._eligible_wall.get(rid, now),
                    deadline=r.deadline, deadline_met=False, expired=True)
                return True
        return self._evict(rid)

    # hooks ------------------------------------------------------------
    def _occupancy(self) -> int:
        raise NotImplementedError

    def _evict(self, rid: int) -> bool:
        raise NotImplementedError

    def free_slots(self) -> int:
        raise NotImplementedError

    def _mark_eligible(self, now: float):
        for r in self._queue:
            if r.arrival <= self.step_count and \
                    r.rid not in self._eligible_wall:
                self._eligible_wall[r.rid] = now


class EngineSession(ServeSession):
    """Streaming session over one ``ServeEngine`` slot pool."""

    def __init__(self, engine: "ServeEngine"):
        super().__init__(engine)
        engine.reset_pool()
        self._decode_keys: set = set()
        self._prefill0 = engine._prefill.compiles
        self.stats = {"step_times": [], "occupancy": [],
                      "admitted": 0, "steps": 0}

    def _occupancy(self) -> int:
        return self.engine.occupancy()

    def free_slots(self) -> int:
        return self.engine.free_slots()

    def _evict(self, rid: int) -> bool:
        return self.engine.evict_rid(rid, self.step_count,
                                     self._completions)

    def step(self, events: Sequence[Tuple] = ()) -> Dict[str, Any]:
        """One engine step: admit arrived requests into free slots, then
        one batched decode tick.  Returns the tick metrics (``active`` =
        0 means the pool idled waiting on future arrivals)."""
        if events:
            raise ValueError("single-engine sessions take no fleet "
                             "events; use ServeEngine.inject_fault (or "
                             "serve's fault_at_step)")
        eng, step = self.engine, self.step_count
        now = time.perf_counter()
        self._mark_eligible(now)
        # admission: arrived requests claim free slots (join)
        while (eng.has_free_slot() and self._queue
               and self._queue[0].arrival <= step):
            req = self._queue.popleft()
            eng.admit(req, step, self._eligible_wall.get(req.rid, now),
                      self._completions)
            self.stats["admitted"] += 1
        tick = eng.decode_tick(step, self._completions)
        self.step_count += 1
        if tick["active"]:
            self._decode_keys.add(tick["key"])
            self.stats["step_times"].append(tick["dt"])
            self.stats["occupancy"].append(tick["active"])
        return tick

    def close(self) -> Dict[str, Any]:
        if self.closed:
            return self.stats
        self.closed = True
        eng, s = self.engine, self.stats
        s["steps"] = self.step_count
        s["recompiles"] = max(0, len(self._decode_keys) - 1)
        s["decode_compiles"] = eng._decode.compiles
        s["prefill_compiles"] = eng._prefill.compiles - self._prefill0
        return s


class FleetSession(ServeSession):
    """Streaming session across a ``FleetServeEngine``'s per-device slot
    pools.  ``step(events)`` additionally folds this step's fault events
    (and, multi-host, the canonical merged event log) before admission —
    drained requests from newly-quarantined devices re-queue at the
    front, so no request is ever dropped."""

    def __init__(self, engine: "FleetServeEngine"):
        super().__init__(engine)
        for w in engine.workers:
            w.reset_pool()
        engine._sync_capacity()
        self._prefill0 = engine._prefill.compiles if engine._prefill else 0
        self._decode0 = engine._decode.compiles if engine._decode else 0
        self.stats = {"admitted": 0, "steps": 0, "requeued": 0,
                      "per_step_tokens": [], "occupancy": [], "capacity": [],
                      "per_device_tokens": [0] * engine.fcfg.n_devices}

    def _occupancy(self) -> int:
        return sum(w.occupancy() for w in self.engine.workers)

    def free_slots(self) -> int:
        return sum(self.engine.workers[d].free_slots()
                   for d in self.engine.fleet.serving())

    def _evict(self, rid: int) -> bool:
        for w in self.engine.workers:
            if w.evict_rid(rid, self.step_count, self._completions):
                return True
        return False

    def _exchange_guarded(self, exchange_fn, local_events: List[Tuple]):
        """Run one channel exchange, converting a peer's typed
        ``HostTimeoutError`` into a ``("host", host_id)`` event: the dead
        peer is marked on the coordinator (its future payload slots turn
        ``None``) and the exchange retries with the host-fault appended,
        so the survivors re-fold and keep serving instead of inheriting
        the hang.  Deterministic across survivors because the KV store is
        shared — a silent peer is silent for every reader.  Coordinators
        without ``mark_dead`` (or a fleet with no surviving peer) get the
        error raised through."""
        eng = self.engine
        for _ in range(max(1, eng.coordinator.num_hosts)):
            try:
                return exchange_fn()
            except HostTimeoutError as exc:
                if not hasattr(eng.coordinator, "mark_dead"):
                    raise
                eng.coordinator.mark_dead(exc.host_id)
                local_events.append(("host", exc.host_id))
                self.stats.setdefault("host_timeouts", []).append(
                    {"step": self.step_count, "host": exc.host_id})
        raise HostTimeoutError(
            eng.coordinator.host_id,
            "every peer exhausted its retry budget; no fleet left to "
            "agree with")

    def step(self, events: Sequence[Tuple] = ()) -> Dict[str, Any]:
        """One fleet step: fold fault events, drain/re-queue, admit
        across the serving devices' pools, one decode tick per device."""
        eng, step = self.engine, self.step_count
        s = self.stats
        step_tokens = 0
        # ("suspect", device[, stage]) tuples — watchdog suspicions from
        # the previous tick plus any caller-injected ones — resolve
        # through the probation classifier BEFORE the exchange: only the
        # verdict (the fault / fault+recover pair) enters the shared log.
        pend, eng._pending_suspects = eng._pending_suspects, []
        step_events: List[Tuple] = []
        for ev in list(pend) + list(events):
            if ev and ev[0] == "suspect":
                d = int(ev[1])
                if len(ev) > 2 and ev[2]:
                    step_events.extend(eng._probe(d, ev[2], step))
                else:
                    step_events.extend(eng._resolve_suspect(d, step))
            else:
                step_events.append(tuple(ev))
        if eng.channel is not None:
            # one shared ordered log: publish the locally observed
            # slice, apply the canonical merge — every host folds the
            # same transitions in the same order
            local = list(step_events)
            merged = self._exchange_guarded(
                lambda: eng.channel.exchange(step, list(local)), local)
            step_events = [e.engine_tuple() for e in merged]
        drained: List[Request] = []
        for ev in step_events:
            drained.extend(eng._apply(ev, step,
                                      strict=eng.channel is None))
        if step_events:
            # degradation shrank some pools: drain the overflow too,
            # so capacity changes take effect this step, not after the
            # old residents happen to finish
            for d in eng.fleet.serving():
                drained.extend(eng.workers[d].drain_excess())
        if drained:
            s["requeued"] += len(drained)
            self._queue.extendleft(sorted(drained,
                                          key=lambda r: (r.arrival, r.rid),
                                          reverse=True))
        now = time.perf_counter()
        self._mark_eligible(now)
        # admission: queue head goes to the first device with capacity
        serving = eng.fleet.serving()
        for d in serving:
            w = eng.workers[d]
            while (w.has_free_slot() and self._queue
                   and self._queue[0].arrival <= step):
                req = self._queue.popleft()
                step_tokens += w.admit(
                    req, step, self._eligible_wall.get(req.rid, now),
                    self._completions)
                s["admitted"] += 1
                s["per_device_tokens"][d] += 1
        occupancy = 0
        for d in serving:
            tick = eng.workers[d].decode_tick(step, self._completions)
            eng._watchdog_tick(d, tick, step)
            occupancy += tick["active"]
            step_tokens += tick["tokens"]
            s["per_device_tokens"][d] += tick["tokens"]
        s["per_step_tokens"].append(step_tokens)
        s["occupancy"].append(occupancy)
        s["capacity"].append(sum(eng.workers[d].capacity for d in serving))
        self.step_count += 1
        if self.step_count > 100_000:
            raise RuntimeError("fleet serve did not converge (queue "
                               f"{len(self._queue)}, occupancy "
                               f"{occupancy})")
        return {"active": occupancy, "dt": 0.0, "key": None,
                "tokens": step_tokens}

    def close(self, *, late_events: Optional[Mapping[int, Sequence[Tuple]]]
              = None) -> Dict[str, Any]:
        """Finalize: apply events scheduled past the drain point (a
        recovery at step 40 must not be silently lost because the
        workload finished at 35), then — multi-host — merge completions
        across hosts.  Poll *after* close in multi-host mode, so
        placeholders are resolved."""
        if self.closed:
            return self.stats
        self.closed = True
        eng, s = self.engine, self.stats
        late_events = dict(late_events or {})
        if eng.channel is not None:
            extra: List[Tuple] = []

            def _do():
                ev_map = {k: list(v) for k, v in late_events.items()}
                if extra:
                    ev_map[self.step_count] = (
                        list(ev_map.get(self.step_count, ())) + list(extra))
                return eng.channel.exchange_many(ev_map)

            late = self._exchange_guarded(_do, extra)
            for e in late:
                eng._apply(e.engine_tuple(), step=e.step, strict=False)
            s["late_events"] = len(late)
        else:
            for k in sorted(late_events):
                for ev in late_events[k]:
                    eng._apply(ev, step=k)
            s["late_events"] = sum(len(v) for v in late_events.values())
        s["steps"] = self.step_count
        s["decode_compiles"] = (eng._decode.compiles - self._decode0
                                if eng._decode else 0)
        s["prefill_compiles"] = (eng._prefill.compiles - self._prefill0
                                 if eng._prefill else 0)
        s["quarantined"] = list(eng.fleet.quarantined)
        s["spares_in_service"] = list(eng.fleet.pool.in_service())
        if eng.channel is not None:
            # merged result + cross-host plan agreement witness
            s["fleet_fingerprint"] = fleet_fingerprint(eng.fleet)
            ph = {r for r, c in self._completions.items()
                  if c.placeholder}
            self._completions = merge_completions(eng.coordinator,
                                                  self._completions)
            # placeholders polled mid-run re-deliver resolved: a
            # streaming caller's post-close poll() gets the real tokens
            self._delivered -= ph
        else:
            # host-partitioned but uncoordinated (shadow-bookkeeping
            # mode): remote completions are placeholders with no tokens.
            # Legitimate for schedule tests — but never silent, so a
            # forgotten coordinator cannot read as empty decodes.
            unresolved = sorted(r for r, c in self._completions.items()
                                if c.placeholder)
            s["unresolved_placeholders"] = unresolved
            if unresolved:
                warnings.warn(
                    f"FleetServeEngine returned {len(unresolved)} "
                    "placeholder completion(s) decoded on remote shadow "
                    "devices; pass a coordinator to merge real tokens "
                    "across hosts", stacklevel=2)
        return s


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (one convention for every latency report)."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q))]


def reference_decode(cfg: ModelConfig, params, prompt, n_new: int, *,
                     max_len: int, routes: Optional[RoutingPlan] = None
                     ) -> np.ndarray:
    """Single-request greedy decode straight on the model — no slots, no
    engine — on the device the params live on.  The per-request oracle the
    batching engine must match bit for bit on the SW route."""
    model = build_model(cfg, routes=routes)
    device = params["embed"]["table"].device
    params = compute_params(params, model.compute_dtype, device=device)
    tokens = torch.as_tensor(np.asarray(prompt, np.int64),
                             device=device)[None]
    P = tokens.shape[1]
    cache = model.init_cache(1, max_len, device=device)
    logits, cache = model.prefill(params, {"tokens": tokens, "cache": cache})
    tok = logits[:, -1].argmax(-1)[:, None]
    out = [int(tok[0, 0])]
    for i in range(n_new - 1):
        logits, cache = model.decode_step(params, cache, tok, P + i)
        tok = logits[:, -1].argmax(-1)[:, None]
        out.append(int(tok[0, 0]))
    return np.asarray(out, np.int32)
