"""Drive seeded chaos schedules through live fleets (the port's
``chaos/campaign.py``).

Three harnesses, one report shape:

- ``serve_campaign``  -- a ``FleetServeEngine`` under open-loop traffic
  (``serve.frontend`` virtual clock), the schedule injected mid-run via
  the session event path.  Stage faults are *value-level*: the
  probation classifier's canary genuinely fails because a ``LaneFault``
  is armed around each canary probe (see :class:`ChaosCanary`), so the
  transient/persistent verdict is earned, not scripted.
- ``train_campaign``  -- a data-parallel ``FleetTrainRunner`` with
  probation and checksummed checkpoints; transient guard trips
  re-execute, device losses migrate, host losses restore-then-continue.
- ``coordinator_campaign`` -- a ``KVCoordinator`` against a stalling
  fake store client: a silent peer must surface as a typed
  ``HostTimeoutError`` after bounded retries (MTTR is the wall time to
  that error, nowhere near the 120 s overall deadline).

``run_campaign`` composes all three plus a deterministic
measured-vs-DegradationModel closure scenario and rolls the invariant
verdicts up into one telemetry snapshot (``python -m
repro_torch.obs.report`` renders it).

Every campaign that runs a model takes ``device=`` (default: the card)
and the serving ones ``hw_route=``: the reference's INTERPRET (the
kernels' blocked algorithms) by default, so the CPU tests match the
reference; ``hw_route=HW`` on the card launches the Hopper kernels.  The
train campaign runs the SW route, the only one that trains.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import optim
from repro_torch.chaos import invariants as inv
from repro_torch.chaos.schedule import (COORD_STALL, DEVICE_LOSS, HOST_LOSS,
                                        LANE_FAULT, PERSISTENT_STAGE,
                                        SERVE_KINDS, SPARE_EXHAUSTION,
                                        TRAIN_KINDS, TRANSIENT_STAGE,
                                        ChaosEvent, draw_schedule,
                                        horizon_of)
from repro_torch.configs import get_config
from repro_torch.core.datacenter import DegradationModel
from repro_torch.core.fault import (CanaryChecker, FaultClassifier,
                                    ProbationPolicy)
from repro_torch.core.routing import FleetPlan
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.device import DeviceLike
from repro_torch.launch.distributed import (FleetEvent, HostTimeoutError,
                                            HostTopology, KVCoordinator,
                                            fleet_fingerprint, replay_log)
from repro_torch.models import build_model
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import (BLOCK, RECOMPILE, RESIDENT, FleetConfig,
                               FleetServeEngine, Frontend, FrontendConfig,
                               LengthModel, Poisson, ServeConfig)
from repro_torch.train import TrainConfig
from repro_torch.train.runner import (FleetTrainConfig, FleetTrainRunner,
                                      canary_stages, model_stage_names)
from repro_torch.viscosity import INTERPRET, lanefault
from repro_torch.viscosity.lanefault import STUCK, LaneFault

ARCH = "qwen1.5-4b"
#: the reference's healthy lowering (the kernels' blocked algorithms), so
#: reroutes and rungs are *real* route changes (interpret -> DEGRADED /
#: SW); the card passes ``hw_route=HW``
HW_ROUTE = INTERPRET
MAX_LEN = 48
SLOTS = 3
STEP_TIME_S = 0.05
N_DEVICES = 4
N_SPARES = 2

#: minor-axis lane width of each kernel family's *canary* port
#: (``train.runner.canary_stages``) -- a LaneFault only applies where
#: widths match, so chaos injections must use these, and the canary
#: width differing from the serving width is what keeps probe-time
#: injections from ever touching production compute
CANARY_WIDTHS = {"flash_attention": 32, "swiglu_mlp": 64,
                 "mamba2_ssd": 16, "rwkv6_wkv": 16}


def canary_fault(stage_name: str, *, lane: int = 1,
                 value: float = 7.5) -> LaneFault:
    """A stuck-lane fault sized to the stage family's canary width."""
    width = CANARY_WIDTHS.get(stage_name)
    if width is None:
        raise ValueError(f"no canary width for stage {stage_name!r}; "
                         f"known: {sorted(CANARY_WIDTHS)}")
    return LaneFault(kind=STUCK, lanes=(lane % width,), width=width,
                     value=value)


class ChaosCanary:
    """Canary checker with campaign-controlled value-level faults.

    The injection registry is process-global and keyed by stage *name*,
    so a fault armed for the whole run would corrupt production compute
    wherever canary and serving widths collide.  This wrapper arms the
    ``LaneFault`` only around each canary probe: detection is genuinely
    value-level -- the canary's HW lane really is stuck against the SW
    oracle -- while serving kernels never observe the injection.

    ``fails=N`` models a transient upset: the fault clears itself after
    N failing probes (probation then finds a clean canary -> HW route
    restored).  ``fails=None`` is a hard fault: every probe fails until
    the ladder routes the stage away.  Repeated ``arm`` calls *queue*,
    and a probation episode's successive probes drain the queue in
    order -- so never stack a second spec behind a transient on the same
    stage (the episode's later probes would hit it and earn a spurious
    persistent verdict).
    """

    def __init__(self, checker: CanaryChecker):
        self.checker = checker
        # name -> FIFO of [fault, fails-left]; head is the live fault
        self._faults: Dict[str, List[list]] = {}

    @property
    def stages(self):
        return self.checker.stages

    def arm(self, stage_name: str, fault: LaneFault, *,
            fails: Optional[int] = None):
        self._faults.setdefault(stage_name, []).append([fault, fails])

    def disarm(self, stage_name: str):
        self._faults.pop(stage_name, None)

    def armed(self) -> List[str]:
        return sorted(self._faults)

    def check_stage(self, stage) -> bool:
        queue = self._faults.get(stage.name)
        if not queue:
            return self.checker.check_stage(stage)
        fault, fails = queue[0]
        lanefault.set_injection(stage.name, fault)
        try:
            ok = self.checker.check_stage(stage)
        finally:
            lanefault.clear_injection(stage.name)
        if not ok and fails is not None:
            queue[0][1] = fails - 1
            if queue[0][1] <= 0:
                queue.pop(0)
                if not queue:
                    self._faults.pop(stage.name, None)
        return ok


def _classifier(cfg, *, retries: int = 3, device: DeviceLike = None,
                hw_route: str = HW_ROUTE) -> FaultClassifier:
    canary = ChaosCanary(CanaryChecker(canary_stages(cfg, device=device),
                                       route_hw=hw_route))
    # virtual-clock campaigns never wall-sleep between probes
    return FaultClassifier(canary,
                           ProbationPolicy(retries=retries,
                                           backoff_base_s=0.0),
                           sleep=lambda _s: None)


def _lengths(cfg) -> LengthModel:
    return LengthModel(vocab_size=cfg.vocab_size, min_prompt=6,
                       max_prompt=12, min_new=4, max_new=9,
                       dist="pareto", alpha=1.8, clamp_len=MAX_LEN)


def _schedule_row(ev: ChaosEvent) -> Dict:
    return {"step": ev.step, "kind": ev.kind, "device": ev.device,
            "host": ev.host, "stage": ev.stage,
            "devices": list(ev.devices)}


def _replay_fingerprint(eng: FleetServeEngine) -> str:
    """Fingerprint of the healthy plan re-folded over the engine's own
    applied event log -- what any host replaying the agreed log would
    compute."""
    evs = [FleetEvent.from_engine(e["step"], 0, i, tuple(e["event"]))
           for i, e in enumerate(eng.event_log) if not e.get("dropped")]
    plan = FleetPlan.healthy(eng.fcfg.n_devices, eng.stage_names,
                             target=eng.scfg.hw_route,
                             n_spares=eng.fcfg.n_spares)
    replayed, _dropped = replay_log(plan, evs, eng.stage_names,
                                    target=eng.scfg.hw_route,
                                    topology=eng.topology)
    return fleet_fingerprint(replayed)


def _settle_steps(capacity: Sequence[int], step: int, stop: int) -> int:
    """Steps from ``step`` until the fleet capacity trace stops moving
    (bounded by ``stop``): the plan-change MTTR window."""
    lo = min(step, max(len(capacity) - 1, 0))
    hi = min(stop, len(capacity))
    last = 0
    for j in range(lo + 1, hi):
        if capacity[j] != capacity[j - 1]:
            last = j - lo
    return max(last, 1)


def serve_campaign(seed: int, *, failover: str = RESIDENT,
                   n_events: int = 7, n_requests: int = 60,
                   params=None, cfg=None, device: DeviceLike = None,
                   hw_route: str = HW_ROUTE) -> Dict:
    """Soak one serve fleet under saturating open-loop traffic while the
    schedule fires; returns the invariant verdict, per-event MTTR, and
    the run's traffic stats.  The fleet and its canaries run on
    ``device`` (default: the card) with ``hw_route`` as the healthy
    lowering."""
    lanefault.reset()
    cfg = cfg if cfg is not None else get_config(ARCH).reduced()
    if params is None:
        params = build_model(cfg).init(seed, device=device)
    names = model_stage_names(cfg)
    schedule = draw_schedule(seed, n_events=n_events, n_devices=N_DEVICES,
                             stage_names=names, n_spares=N_SPARES,
                             kinds=SERVE_KINDS)
    clf = _classifier(cfg, device=device, hw_route=hw_route)
    canary: ChaosCanary = clf.checker
    scfg = ServeConfig(max_len=MAX_LEN, max_slots=SLOTS,
                       hw_route=hw_route, failover=failover)
    fcfg = FleetConfig(n_devices=N_DEVICES, n_spares=N_SPARES,
                       model=DegradationModel())
    eng = FleetServeEngine(cfg, params, scfg, fcfg, classifier=clf,
                           device=device)

    events: Dict[int, List[Tuple]] = {}
    expected: List[Tuple[int, Tuple]] = []
    transients: List[ChaosEvent] = []
    stalls: List[ChaosEvent] = []
    persistent_keys: set = set()
    armed: set = set()
    try:
        for ev in schedule:
            if ev.kind == TRANSIENT_STAGE:
                # arm at most once per stage: the first episode consumes
                # the spec, later suspects on the stage probe clean (an
                # instant-transient verdict) -- stacking specs would make
                # one episode's probes eat the next event's fault
                if ev.stage not in armed:
                    canary.arm(ev.stage, canary_fault(ev.stage), fails=1)
                    armed.add(ev.stage)
                events.setdefault(ev.step, []).append(
                    ("suspect", ev.device, ev.stage))
                expected += [(ev.step, ("stage", ev.device, ev.stage)),
                             (ev.step, ("recover", ev.device, ev.stage))]
                transients.append(ev)
            elif ev.kind in (PERSISTENT_STAGE, LANE_FAULT):
                fault = canary_fault(ev.stage)
                canary.arm(ev.stage, fault, fails=None)
                if ev.kind == LANE_FAULT:
                    # localized fault: the ladder's DEGRADED rungs apply
                    lanefault.known_map(ev.stage, fault, base=hw_route)
                events.setdefault(ev.step, []).append(
                    ("suspect", ev.device, ev.stage))
                expected.append((ev.step, ("stage", ev.device, ev.stage)))
                persistent_keys.add(ev.stage)
            elif ev.kind == DEVICE_LOSS:
                events.setdefault(ev.step, []).append(("device", ev.device))
                expected.append((ev.step, ("device", ev.device)))
            elif ev.kind == SPARE_EXHAUSTION:
                for d in ev.devices:
                    events.setdefault(ev.step, []).append(("device", d))
                    expected.append((ev.step, ("device", d)))
            elif ev.kind == HOST_LOSS:
                events.setdefault(ev.step, []).append(("host", ev.host))
                expected.append((ev.step, ("host", ev.host)))
            elif ev.kind == COORD_STALL:
                # drilled after the traffic run (the coordinator is not
                # on the serve data path); the engine sees nothing
                stalls.append(ev)

        # saturating, deadline-free arrivals: the soak measures survival
        # and capacity accounting, not tails (the traffic layer times those)
        wl = Poisson(n_requests=n_requests, rate=40.0, lengths=_lengths(cfg))
        reqs = wl.build(seed)
        fe = Frontend(eng, FrontendConfig(step_time_s=STEP_TIME_S,
                                          max_queue=2 * n_requests,
                                          shed=BLOCK))
        comps, stats = fe.run(reqs, events=events)
    finally:
        lanefault.reset()

    # coordinator-stall drills ride alongside the traffic run, so the
    # KV-retry spike lands in this campaign's telemetry scope
    drills = {ev.step: _stall_drill(f"serve-{ev.step}") for ev in stalls}

    # ---------------------------------------------------------- metrics
    applied = {(e["step"], tuple(e["event"])) for e in eng.event_log
               if not e.get("dropped")}
    missing = [x for x in expected if x not in applied]
    capacity = stats["engine"]["capacity"]
    logs = [w.fault_state.log for w in eng.workers
            if hasattr(w, "fault_state")]
    mttrs: List[Dict] = []
    for ev in schedule:
        if ev.kind == TRANSIENT_STAGE:
            # one probation_retry note per probe attempt (the clean
            # closing probe included), so the count IS the attempt count
            attempts = sum(1 for log in logs for e in log
                           if e.get("kind") == "probation_retry"
                           and e.get("stage") == ev.stage
                           and e.get("step") == ev.step)
            mttr = max(attempts, 1) * STEP_TIME_S
        elif ev.kind == COORD_STALL:
            # wall time to the typed HostTimeoutError, not a step count
            mttr = drills[ev.step]["mttr_s"]
        else:
            nxt = min((e.step for e in schedule if e.step > ev.step),
                      default=len(capacity))
            mttr = _settle_steps(capacity, ev.step, nxt) * STEP_TIME_S
        mttrs.append({"step": ev.step, "kind": ev.kind,
                      "stage": ev.stage, "device": ev.device,
                      "mttr_s": round(mttr, 4)})

    residual_check = [ev for ev in transients
                      if ev.stage not in persistent_keys]
    reports = [
        inv.check_no_dropped(reqs, comps),
        inv.check_fingerprints([fleet_fingerprint(eng.fleet),
                                _replay_fingerprint(eng)]),
        inv.check_ladder(eng.fleet, names, healthy=hw_route),
        inv.check_transients(eng.fleet, residual_check, logs),
        {"invariant": "events_applied", "ok": not missing,
         "expected": len(expected), "missing": missing,
         "detail": f"{len(missing)} scheduled event(s) never applied: "
                   f"{missing[:4]}"},
    ]
    if stalls:
        bad = [x for d in drills.values() for x in d["details"]]
        reports.append({"invariant": "coordinator_stall",
                        "ok": not bad, "n_stalls": len(stalls),
                        "detail": "; ".join(bad)
                                  or "typed timeout + isolation"})
    for m in mttrs:
        obs_metrics.observe("mttr_seconds", m["mttr_s"])
    return {
        "failover": failover,
        "seed": seed,
        "n_events": len(schedule),
        "schedule": [_schedule_row(e) for e in schedule],
        "invariants": inv.verdict(reports),
        "mttr": mttrs,
        "mttr_summary": inv.mttr_summary(mttrs),
        "traffic": {
            "requests": len(reqs),
            "completed": stats["completed"],
            "expired": stats["expired"],
            "requeued": stats["engine"]["requeued"],
            "throughput_tok_s": round(stats["throughput_tok_s"], 2),
            "virtual_time_s": round(stats["virtual_time_s"], 2),
        },
        "quarantined": list(eng.fleet.quarantined),
    }


def closure_scenario(seed: int, *, failover: str = RESIDENT,
                     n_requests: int = 40, params=None,
                     cfg=None, device: DeviceLike = None,
                     hw_route: str = HW_ROUTE) -> Dict:
    """Deterministic measured-vs-DegradationModel closure: under
    saturating load, a mid-run device loss must shrink measured
    tokens/step by the same ratio as the engine's analytic capacity
    trace (slot-quantized DegradationModel), within 15%."""
    cfg = cfg if cfg is not None else get_config(ARCH).reduced()
    if params is None:
        params = build_model(cfg).init(seed, device=device)
    fault_step = 12
    scfg = ServeConfig(max_len=MAX_LEN, max_slots=SLOTS,
                       hw_route=hw_route, failover=failover)
    fcfg = FleetConfig(n_devices=2, n_spares=0, model=DegradationModel())
    eng = FleetServeEngine(cfg, params, scfg, fcfg, device=device)
    wl = Poisson(n_requests=n_requests, rate=60.0, lengths=_lengths(cfg))
    reqs = wl.build(seed)
    fe = Frontend(eng, FrontendConfig(step_time_s=STEP_TIME_S,
                                      max_queue=2 * n_requests,
                                      shed=BLOCK))
    comps, stats = fe.run(reqs,
                          events={fault_step: [("device", 0)]})
    pst = stats["engine"]["per_step_tokens"]
    cap = stats["engine"]["capacity"]

    def window(xs, lo, hi):
        w = xs[lo:hi]
        return float(np.mean(w)) if w else 0.0

    h_lo, h_hi = 4, fault_step
    f_lo = fault_step + 2
    f_hi = min(f_lo + 20, int(0.8 * len(pst)))
    measured = window(pst, f_lo, f_hi) / max(window(pst, h_lo, h_hi), 1e-9)
    analytic = window(cap, f_lo, f_hi) / max(window(cap, h_lo, h_hi), 1e-9)
    obs_metrics.set_gauge("closure_ratio", measured, source="measured")
    obs_metrics.set_gauge("closure_ratio", analytic, source="analytic")
    report = inv.check_closure(measured, analytic)
    report["dropped"] = inv.check_no_dropped(reqs, comps)["missing"]
    report["ok"] = report["ok"] and not report["dropped"]
    return report


def train_campaign(seed: int, *, n_events: int = 4,
                   ckpt_dir: Optional[str] = None,
                   device: DeviceLike = None) -> Dict:
    """Soak the data-parallel fleet train loop: transient guard trips
    probate and re-execute, device losses quarantine-and-migrate, host
    losses restore the latest checkpoint onto the survivor mesh.  The
    reduced config trains on ``device`` (default: the card) on the SW
    route, the only one with a backward."""
    from repro_torch.viscosity.lang import SW

    cfg = get_config(ARCH).reduced()
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, batch=8,
                                  seq_len=16))
    names = model_stage_names(cfg)
    topo = HostTopology(num_hosts=2, devices_per_host=2)
    schedule = draw_schedule(seed + 101, n_events=n_events, n_devices=4,
                             stage_names=names, n_spares=1, topology=topo,
                             kinds=TRAIN_KINDS, start=2, min_gap=2,
                             max_gap=4, min_serving=2)
    steps = horizon_of(schedule, settle=3)
    transient = {e.step: e.device for e in schedule
                 if e.kind == TRANSIENT_STAGE}
    poison = {e.step: e.device for e in schedule if e.kind == DEVICE_LOSS}
    host_loss = {e.step: e.host for e in schedule if e.kind == HOST_LOSS}
    stalls = [e for e in schedule if e.kind == COORD_STALL]
    tcfg = TrainConfig(steps=steps, hw_route=SW, probation_retries=2,
                       ckpt_every=2, ckpt_dir=ckpt_dir)
    r = FleetTrainRunner(
        cfg, optim.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=200),
        tcfg, data, FleetTrainConfig(n_devices=4, n_spares=1,
                                     topology=topo), device=device)
    params, opt = r.init_state()
    r.run(params, opt, steps=steps, transient=dict(transient),
          poison=dict(poison), host_loss=dict(host_loss))
    drills = {e.step: _stall_drill(f"train-{e.step}") for e in stalls}

    live = fleet_fingerprint(r.fleet)
    healthy = FleetPlan.healthy(4, names, target=tcfg.hw_route, n_spares=1)
    replayed, _ = replay_log(healthy, r.fleet_log, names,
                             target=tcfg.hw_route, topology=topo)
    kinds = [e.get("kind") for e in r.fault_state.log]
    n_recovered = kinds.count("transient_recovered")
    mean_dt = float(np.mean([h["dt"] for h in r.history])) if r.history \
        else 0.0
    mttrs: List[Dict] = []
    for ev in schedule:
        if ev.kind == TRANSIENT_STAGE:
            attempts = sum(1 for e in r.fault_state.log
                           if e.get("kind") == "probation_retry"
                           and e.get("step") == ev.step)
            mttr = max(attempts, 1) * mean_dt
        elif ev.kind == HOST_LOSS and ckpt_dir:
            # rewind cost: re-run from the restored checkpoint step
            rewind = max(ev.step % tcfg.ckpt_every, 1)
            mttr = (rewind + 1) * mean_dt
        elif ev.kind == COORD_STALL:
            mttr = drills[ev.step]["mttr_s"]
        else:
            mttr = mean_dt
        mttrs.append({"step": ev.step, "kind": ev.kind,
                      "device": ev.device, "mttr_s": round(mttr, 4)})
    reports = [
        {"invariant": "finite_loss",
         "ok": bool(r.history) and all(np.isfinite(h["loss"])
                                       for h in r.history),
         "steps": len(r.history),
         "detail": "non-finite loss in history"},
        inv.check_fingerprints([live, fleet_fingerprint(replayed)]),
        {"invariant": "transients", "ok": n_recovered >= len(transient),
         "expected": len(transient), "recovered": n_recovered,
         "detail": f"{n_recovered}/{len(transient)} transient guard "
                   f"trips recovered without quarantine"},
    ]
    if host_loss and ckpt_dir:
        reports.append(
            {"invariant": "checkpoint_restored",
             "ok": "checkpoint_restored" in kinds,
             "detail": "host loss did not restore a checkpoint"})
    if stalls:
        bad = [x for d in drills.values() for x in d["details"]]
        reports.append({"invariant": "coordinator_stall",
                        "ok": not bad, "n_stalls": len(stalls),
                        "detail": "; ".join(bad)
                                  or "typed timeout + isolation"})
    for m in mttrs:
        obs_metrics.observe("mttr_seconds", m["mttr_s"])
    return {
        "seed": seed,
        "n_events": len(schedule),
        "schedule": [_schedule_row(e) for e in schedule],
        "invariants": inv.verdict(reports),
        "mttr": mttrs,
        "mttr_summary": inv.mttr_summary(mttrs),
        "guard_trips": r.guard_trips,
        "quarantined": list(r.fleet.quarantined),
        "steps": len(r.history),
    }


class StallingKVClient:
    """Fake key-value store client (``launch.distributed.StoreClient``'s
    three methods) whose ``stalled`` hosts never publish: every get for
    their keys burns its timeout and raises (the client-error taxonomy
    the retry path catches).  ``stall_s`` stands
    in for the attempt timeout so tests stay fast."""

    def __init__(self, stalled: Sequence[int] = (), *,
                 stall_s: float = 0.001):
        self.store: Dict[str, str] = {}
        self.stalled = {int(h) for h in stalled}
        self.stall_s = stall_s
        self.gets = 0
        self.deletes: List[str] = []

    def key_value_set(self, key: str, value: str):
        self.store[key] = value

    def blocking_key_value_get(self, key: str, timeout_ms: int) -> str:
        self.gets += 1
        host = int(key.rsplit("/", 1)[1])
        if host not in self.stalled and key in self.store:
            return self.store[key]
        time.sleep(min(self.stall_s, timeout_ms / 1000.0))
        raise RuntimeError(f"BlockingKeyValueGet timed out for {key}")

    def key_value_delete(self, key: str):
        self.deletes.append(key)
        self.store.pop(key, None)


def _stall_drill(tag, *, max_attempts: int = 4) -> Dict:
    """One coordinator-stall drill: host 1 never publishes, so the
    exchange must surface a typed ``HostTimeoutError(1)`` within the
    bounded retry budget, and after ``mark_dead`` the survivor's next
    exchange proceeds with ``None`` in the dead slot.  The bounded
    retries land in ``kv_retries_total`` / ``coord_timeouts_total`` (the
    KV-retry spike a scheduled ``coord_stall`` makes visible in the
    campaign snapshot); wall time to the typed error is the MTTR."""
    client = StallingKVClient(stalled=[1])
    coord = KVCoordinator(num_hosts=2, host_id=0, client=client,
                          timeout_ms=2_000, attempt_timeout_ms=10,
                          max_attempts=max_attempts,
                          backoff_base_s=0.001)
    details: List[str] = []
    t0 = time.perf_counter()
    try:
        coord.exchange(f"stall-{tag}")
        mttr = time.perf_counter() - t0
        details.append(f"stall {tag}: exchange succeeded unexpectedly")
    except HostTimeoutError as e:
        mttr = time.perf_counter() - t0
        if e.host_id != 1:
            details.append(f"stall {tag}: wrong host_id {e.host_id}")
    if client.gets > max_attempts:
        details.append(f"stall {tag}: {client.gets} gets > budget "
                       f"{max_attempts}")
    coord.mark_dead(1)
    after = coord.exchange(f"post-{tag}")
    if after[0] != f"post-{tag}" or after[1] is not None:
        details.append(f"stall {tag}: post-mark_dead exchange {after}")
    return {"ok": not details, "details": details,
            "mttr_s": round(mttr, 4), "gets": client.gets}


def coordinator_campaign(n_stalls: int = 2, *,
                         max_attempts: int = 4) -> Dict:
    """Coordinator-stall drills: a silent peer must surface as a typed
    ``HostTimeoutError(host_id)`` after bounded retries, and after
    ``mark_dead`` the survivors' exchanges proceed with ``None`` in the
    dead slot."""
    mttrs: List[Dict] = []
    details: List[str] = []
    for i in range(n_stalls):
        d = _stall_drill(i, max_attempts=max_attempts)
        details += d["details"]
        mttrs.append({"step": i, "kind": COORD_STALL,
                      "mttr_s": d["mttr_s"]})
    for m in mttrs:
        obs_metrics.observe("mttr_seconds", m["mttr_s"])
    report = {"invariant": "coordinator_stall", "ok": not details,
              "detail": "; ".join(details) or "typed timeout + isolation",
              "n_stalls": n_stalls}
    return {"n_events": n_stalls,
            "invariants": inv.verdict([report]),
            "mttr": mttrs,
            "mttr_summary": inv.mttr_summary(mttrs)}


def run_campaign(seed: int = 0, *, smoke: bool = False,
                 ckpt_dir: Optional[str] = None,
                 raise_on_failure: bool = False, cfg=None, params=None,
                 device: DeviceLike = None,
                 hw_route: str = HW_ROUTE) -> Dict:
    """The full soak: serve campaigns in both failover modes, the train
    campaign, coordinator stalls, and the deterministic closure check.
    Default sizing lands >= 20 randomized fault events.  ``cfg`` and
    ``params`` (default: the reduced config, weights from ``seed``) serve
    the serve and closure campaigns on ``device`` and ``hw_route``; the
    train campaign keeps its own reduced config on ``device``."""
    serve_events = 3 if smoke else 7
    train_events = 2 if smoke else 4
    n_stalls = 1 if smoke else 2
    n_requests = 30 if smoke else 60
    # one campaign = one registry + one tracer: every layer's telemetry
    # scopes into a single snapshot, sectioned by label_scope
    reg = obs_metrics.Registry()
    tracer = obs_trace.Tracer(origin=0)
    with obs_metrics.use(reg), obs_trace.use(tracer):
        cfg = cfg if cfg is not None else get_config(ARCH).reduced()
        if params is None:
            params = build_model(cfg).init(seed, device=device)
        serve = {}
        for mode in (RECOMPILE, RESIDENT):
            with obs_metrics.label_scope(section=f"serve_{mode}"):
                serve[mode] = serve_campaign(
                    seed, failover=mode, n_events=serve_events,
                    n_requests=n_requests, params=params, cfg=cfg,
                    device=device, hw_route=hw_route)
        with obs_metrics.label_scope(section="train"):
            train = train_campaign(seed, n_events=train_events,
                                   ckpt_dir=ckpt_dir, device=device)
        with obs_metrics.label_scope(section="coordinator"):
            coordinator = coordinator_campaign(n_stalls)
        with obs_metrics.label_scope(section="closure"):
            closure = closure_scenario(seed,
                                       n_requests=24 if smoke else 40,
                                       params=params, cfg=cfg,
                                       device=device, hw_route=hw_route)
    sections = [serve[RECOMPILE]["invariants"],
                serve[RESIDENT]["invariants"],
                train["invariants"], coordinator["invariants"]]
    all_ok = all(s["ok"] for s in sections) and closure["ok"]
    events_total = (sum(s["n_events"] for s in serve.values())
                    + train["n_events"] + coordinator["n_events"])
    out = {
        "seed": seed,
        "smoke": smoke,
        "events_total": events_total,
        "serve": serve,
        "train": train,
        "coordinator": coordinator,
        "closure": closure,
        "invariants": {"ok": all_ok,
                       "failed": [f for s in sections
                                  for f in s.get("failed", [])]
                       + ([] if closure["ok"] else ["closure"])},
        "telemetry": {"metrics": reg.snapshot(),
                      "trace": [e.to_wire() for e in tracer.events]},
    }
    if raise_on_failure and not all_ok:
        raise inv.InvariantViolation(
            [r for s in sections for r in s.get("reports", [])
             if not r.get("ok")] + ([] if closure["ok"] else [closure]))
    return out
