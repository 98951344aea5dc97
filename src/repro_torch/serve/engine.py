"""Fault-aware continuous-batching serve engine (paper §III at traffic scale).

Port of the single-device part of the reference's ``serve/engine.py``.
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

The slot batch is written out (the reference vmaps a B=1 decode): the KV
pool is one (L, slots, Smax, Hkv, Dh) cache, and a decode tick is one
``decode_step`` over every slot.  Plain ops in decode run per slot, so on
the SW route the served tokens are bit-identical to the single-request
``reference_decode`` (the reference's contract); the HW SwiGLU kernel
takes all slots in one launch.  Weights are cast to the compute dtype once,
when the engine is built.  The fleet engine (``FleetServeEngine``,
``_ShadowWorker``, ``merge_completions``) waits for the fleet slice.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.fault import FaultState
from repro_torch.core.oobleck import Dispatcher
from repro_torch.core.routing import RoutingPlan
from repro_torch.device import resolve_device
from repro_torch.models import build_model, compute_params
from repro_torch.obs import metrics
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
    """Slot bookkeeping, value-independent: slot choice (lowest free) and
    eviction (budget exhausted) never depend on token values, so the
    fleet slice's shadow twins can replay it.  Subclasses set ``scfg``
    and call ``_init_pool``; the drain primitives wait for the fleet."""

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

    def _finish(self, i: int, step: int, completions: Dict[int,
                                                           "Completion"],
                *, expired: bool = False):
        sl = self._slots[i]
        completions[sl.rid] = Completion(
            rid=sl.rid,
            tokens=np.asarray(sl.out, np.int32),
            prompt_len=sl.prompt_len, arrival=sl.arrival,
            admitted_step=sl.admitted_step, finished_step=step,
            latency_s=time.perf_counter() - sl.eligible_wall,
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
    the compute dtype once, here (``models.compute_params``)."""

    def __init__(self, cfg: ModelConfig, params, scfg: ServeConfig, *,
                 device=None):
        if scfg.failover not in (RECOMPILE, RESIDENT):
            raise ValueError(f"unknown failover mode {scfg.failover!r}; "
                             f"expected {RECOMPILE!r} or {RESIDENT!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.scfg = scfg
        self._shape_model = build_model(cfg)   # route-free: cache shapes
        self.params = compute_params(params, self._shape_model.compute_dtype,
                                     device=self.device)
        self.fault_state = FaultState()
        self.stage_names = model_stage_names(cfg)
        # Host-side health bits of the resident model: ResidentRoutes read
        # them on every call, so flipping one reroutes without a rebuild.
        self._health: List[bool] = [True] * len(self.stage_names)
        self._prefill = Dispatcher(self._build)
        self._decode = Dispatcher(self._build)
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
        """Record one detection: the stage is marked and the ladder walks
        as an ``inject_fault`` would.  Returns True when the fault was
        transient, which takes the probation classifier (not ported yet),
        so always False here."""
        if stage not in self.stage_names:
            raise ValueError(f"unknown stage {stage!r}; this model's stages:"
                             f" {self.stage_names}")
        self.fault_state.mark(stage, 0, kind="detected", step=step)
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
        # The slot's KV lane, as views of the pool, emptied for the
        # newcomer; prefill writes it in place.
        lane = {k: c[:, i:i + 1] for k, c in self._caches.items()}
        lane["k"].zero_()
        lane["v"].zero_()
        lane["pos"].fill_(-1)
        logits, _ = self._model(self._prefill).prefill(
            self.params, {"tokens": prompt, "cache": lane})
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


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (one convention for every latency report)."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q))]


def synthetic_workload(vocab_size: int, n_requests: int, rng, *,
                       min_prompt: int = 4, max_prompt: int = 20,
                       min_new: int = 3, max_new: int = 10,
                       arrival_every: int = 2, per_arrival: int = 1
                       ) -> List[Request]:
    """Staggered random workload: ``n_requests`` requests with uniform
    prompt lengths in [min_prompt, max_prompt] and budgets in [min_new,
    max_new], ``per_arrival`` at a time every ``arrival_every`` engine
    steps.  Same draw order as the reference's ``ClosedLoop`` workload
    (prompt size, prompt tokens, budget), so one rng state gives the same
    requests in both packages."""
    reqs = []
    for i in range(n_requests):
        plen = int(rng.integers(min_prompt, max_prompt + 1))
        prompt = rng.integers(0, vocab_size, size=plen).astype(np.int32)
        budget = int(rng.integers(min_new, max_new + 1))
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=budget,
                            arrival=(i // per_arrival) * arrival_every))
    return sorted(reqs, key=lambda r: (r.arrival, r.rid))


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
