"""Async admission front end over the streaming serve sessions.

A copy of the reference's ``serve/frontend.py``: the loop, the policies and
the virtual-clock stamps are the same, so one workload gives the same
virtual-clock fields in both packages.

``Frontend`` is the open-loop half of the serve stack: it runs a
*virtual-clock* event loop (one engine step = ``step_time_s`` virtual
seconds) that releases each request to the engine when the clock reaches
its ``arrival_time``, holds released-but-unadmitted work in a bounded
admission queue with a shedding policy, orders admissions EDF on
per-request deadlines, and evicts expired work — queued *and* in-flight
(``ServeSession.cancel`` frees the slot immediately) — so a request that
can no longer meet its SLO never starves one that can.

Virtual time makes the whole loop deterministic: scheduling depends only
on step indices, never on wall-clock timings, so a traffic scenario
(arrivals × faults × policies) replays bit-identically — including
across the fleet engine's multi-host deterministic replication, whose
contract is exactly that scheduling is value- and wall-time-independent.

Time conventions (``t = step * step_time_s``): a request released and
admitted at step ``k`` was admitted at clock ``k*dt``; its first token
(the prefill argmax) exists by ``(k+1)*dt``; a sequence finishing at
step ``f`` finished at ``(f+1)*dt``.  Expiry is checked at the top of
each step: ``clock > deadline`` evicts.

Works over both engines through the one session API
(``ServeEngine.session`` / ``FleetServeEngine.session``); fleet fault
events are threaded per-step exactly as in ``FleetServeEngine.serve``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import (Any, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch.obs import metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.engine import (Completion, FleetServeEngine, Request,
                                percentile, validate_requests)

# shedding policies for a full admission queue
BLOCK = "block"                      # backpressure: delay further releases
REJECT = "reject"                    # drop the incoming request
SHED_LATEST = "latest_deadline"      # drop whoever can wait longest

# admission orders
EDF = "edf"                          # earliest deadline first
FIFO = "fifo"                        # release order

_POLICIES = (BLOCK, REJECT, SHED_LATEST)
_ORDERS = (EDF, FIFO)


@dataclass(frozen=True)
class FrontendConfig:
    """Virtual-clock admission policy.

    ``step_time_s`` converts engine steps to virtual seconds — calibrate
    it to a measured per-tick decode time to make virtual latencies
    physical.  ``max_queue`` bounds the released-but-unadmitted queue;
    ``shed`` picks what happens when it is full.  ``expire`` turns on
    deadline-expiry eviction (queued and in-flight).
    ``default_slack_s`` assigns a deadline to open-loop requests that
    arrived without one (None: such requests never expire)."""

    step_time_s: float = 0.05
    max_queue: int = 64
    shed: str = BLOCK
    order: str = EDF
    expire: bool = True
    default_slack_s: Optional[float] = None
    max_steps: int = 200_000

    def __post_init__(self):
        if self.shed not in _POLICIES:
            raise ValueError(f"unknown shed policy {self.shed!r}; "
                             f"expected one of {_POLICIES}")
        if self.order not in _ORDERS:
            raise ValueError(f"unknown admission order {self.order!r}; "
                             f"expected one of {_ORDERS}")
        if self.step_time_s <= 0:
            raise ValueError(f"step_time_s must be > 0, got "
                             f"{self.step_time_s}")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got "
                             f"{self.max_queue}")


class Frontend:
    """Admission front end over one engine (single-device or fleet)."""

    def __init__(self, engine, cfg: Optional[FrontendConfig] = None):
        self.engine = engine
        self.cfg = cfg or FrontendConfig()

    # ------------------------------------------------------------ run
    def run(self, requests: Sequence[Request], *,
            events: Optional[Mapping[int, Sequence[Tuple]]] = None,
            fault_at_step: Optional[Tuple[int, str]] = None
            ) -> Tuple[Dict[int, Completion], Dict[str, Any]]:
        """Drive the workload through the virtual-clock loop.

        ``events`` (fleet engines) / ``fault_at_step`` (single-device)
        inject faults mid-run exactly as the engines' own ``serve``.
        Returns ({rid: Completion}, stats); completions carry
        virtual-clock ``queue_wait_s`` / ``ttft_s`` / ``latency_s`` and
        their ``deadline_met`` verdicts, so goodput is a filter away.
        """
        cfg = self.cfg
        validate_requests(requests, self.engine.scfg.max_len)
        is_fleet = isinstance(self.engine, FleetServeEngine)
        if events and not is_fleet:
            raise ValueError("events= is the fleet fault interface; "
                             "single-device engines take fault_at_step=")
        if fault_at_step is not None and is_fleet:
            raise ValueError("fault_at_step= is the single-device fault "
                             "interface; fleet engines take events=")
        events = dict(events or {})
        dt = cfg.step_time_s

        # arrivals in time order; requests without arrival_time arrive
        # at t=0 (a closed-loop list open-loops degenerately)
        def t_of(r: Request) -> float:
            return r.arrival_time if r.arrival_time is not None else 0.0

        def deadline_of(r: Request) -> Optional[float]:
            if r.deadline is not None:
                return r.deadline
            if cfg.default_slack_s is not None:
                return t_of(r) + cfg.default_slack_s
            return None

        pending: List[Request] = sorted(requests,
                                        key=lambda r: (t_of(r), r.rid))
        queue: List[Request] = []    # released, not yet admitted
        sess = self.engine.session()
        completions: Dict[int, Completion] = {}
        meta: Dict[int, Request] = {r.rid: r for r in requests}
        live: set = set()            # submitted to the engine, not done
        stats: Dict[str, Any] = {
            "released": 0, "submitted": 0,
            "shed": [], "expired_queued": [], "expired_in_flight": [],
            "queue_depth": [],
        }

        def shed(r: Request, clock: float, kind: str):
            stats[kind].append(r.rid)
            if kind == "shed":
                metrics.inc("serve_shed_total")
            else:
                metrics.inc("serve_evicted_total",
                            where=kind.replace("expired_", ""))
            obs_trace.emit(int(round(clock / dt)), name=kind, rid=r.rid)
            completions[r.rid] = Completion(
                rid=r.rid, tokens=np.asarray((), np.int32),
                prompt_len=len(r.prompt), arrival=r.arrival,
                admitted_step=-1, finished_step=-1,
                latency_s=max(0.0, clock - t_of(r)),
                queue_wait_s=max(0.0, clock - t_of(r)), ttft_s=0.0,
                deadline=deadline_of(r), deadline_met=False,
                expired=True)

        step = 0
        while pending or queue or sess.pending():
            clock = step * dt
            if fault_at_step is not None and step == fault_at_step[0]:
                self.engine.inject_fault(fault_at_step[1])
            # ---- release arrivals whose time has come -------------
            while pending and t_of(pending[0]) <= clock:
                if len(queue) >= cfg.max_queue:
                    if cfg.shed == BLOCK:
                        break        # backpressure the source
                    if cfg.shed == REJECT:
                        shed(pending.pop(0), clock, "shed")
                        continue
                    # SHED_LATEST: whoever can wait longest goes —
                    # no-deadline requests can wait forever
                    pool = queue + [pending[0]]
                    keys = [(deadline_of(r) is None,
                             deadline_of(r) or 0.0, r.rid)
                            for r in pool]
                    j = keys.index(max(keys))
                    victim = pool[j]
                    if j == len(queue):
                        pending.pop(0)
                    else:
                        del queue[j]
                        queue.append(pending.pop(0))
                    shed(victim, clock, "shed")
                    continue
                r = pending.pop(0)
                stats["released"] += 1
                metrics.inc("serve_released_total")
                queue.append(r)
            # ---- deadline expiry (queued, then in-flight) ---------
            if cfg.expire:
                for j in range(len(queue) - 1, -1, -1):
                    d = deadline_of(queue[j])
                    if d is not None and clock > d:
                        shed(queue[j], clock, "expired_queued")
                        del queue[j]
                for rid in sorted(live):
                    d = deadline_of(meta[rid])
                    if d is not None and clock > d:
                        sess.cancel(rid)   # frees the slot this step
                        stats["expired_in_flight"].append(rid)
                        metrics.inc("serve_evicted_total",
                                    where="in_flight")
                        obs_trace.emit(step, kind=obs_trace.SPAN_END,
                                       name=f"req:{rid}", expired=True)
                        live.discard(rid)
            # ---- EDF admission into free engine slots -------------
            if cfg.order == EDF:
                queue.sort(key=lambda r: (
                    deadline_of(r) is None, deadline_of(r) or 0.0,
                    t_of(r), r.rid))
            k = min(sess.free_slots(), len(queue))
            for r in queue[:k]:
                # arrival=step: the engine's own gate opens now
                sess.submit(dataclasses.replace(r, arrival=step),
                            _validated=True)
                live.add(r.rid)
                stats["submitted"] += 1
                metrics.inc("serve_admitted_total")
                obs_trace.emit(step, kind=obs_trace.SPAN_START,
                               name=f"req:{r.rid}",
                               prompt_len=len(r.prompt))
            del queue[:k]
            stats["queue_depth"].append(len(queue))
            metrics.set_gauge("serve_queue_depth", len(queue))
            # ---- one engine tick ----------------------------------
            if is_fleet:
                sess.step(events.pop(step, ()))
            else:
                sess.step()
            for c in sess.poll():
                completions[c.rid] = c
                live.discard(c.rid)
                obs_trace.emit(step, kind=obs_trace.SPAN_END,
                               name=f"req:{c.rid}",
                               tokens=len(c.tokens))
            step += 1
            if step > cfg.max_steps:
                raise RuntimeError(
                    f"frontend did not converge in {cfg.max_steps} "
                    f"steps (pending {len(pending)}, queue "
                    f"{len(queue)}, in-flight {len(live)})")

        engine_stats = (sess.close(late_events=events) if is_fleet
                        else sess.close())
        for c in sess.poll():        # multi-host: post-close merge
            completions[c.rid] = c
        self._stamp_virtual_times(completions, meta, deadline_of, dt)
        stats["virtual_time_s"] = step * dt
        stats["steps"] = step
        stats["engine"] = engine_stats
        stats.update(summarize(completions, step * dt))
        metrics.set_gauge("serve_virtual_time_seconds", step * dt)
        return completions, stats

    # ------------------------------------------------- virtual stamps
    def _stamp_virtual_times(self, completions, meta, deadline_of, dt):
        """Rewrite wall timings with virtual-clock ones (Completion
        documents this switch): queue wait, TTFT, end-to-end latency,
        and the deadline verdict."""
        for rid, c in completions.items():
            r = meta.get(rid)
            if r is None or c.admitted_step < 0:
                continue             # shed/expired-queued: stamped at shed
            t0 = r.arrival_time if r.arrival_time is not None else 0.0
            c.queue_wait_s = max(0.0, c.admitted_step * dt - t0)
            c.ttft_s = max(0.0, (c.admitted_step + 1) * dt - t0)
            finish = (c.finished_step + 1) * dt
            c.latency_s = max(0.0, finish - t0)
            c.deadline = deadline_of(r)
            c.deadline_met = (not c.expired
                              and (c.deadline is None
                                   or finish <= c.deadline))


def summarize(completions: Mapping[int, Completion],
              virtual_time_s: float) -> Dict[str, Any]:
    """Goodput / tail-latency rollup over a finished run.  *Goodput*
    counts only tokens of completions that met their deadline — the
    paper's constant-aggregate-throughput claim is only interesting if
    it holds for work that was still useful."""
    done = [c for c in completions.values() if not c.expired]
    good = [c for c in done if c.deadline_met]
    lat = sorted(c.latency_s for c in good)
    ttft = sorted(c.ttft_s for c in good)
    span = max(virtual_time_s, 1e-9)
    # Telemetry mirror: obs.report.goodput_summary reproduces the
    # goodput/throughput values below exactly from these counters (same
    # integer token sums, same division by the virtual-time gauge).
    metrics.inc("serve_completed_total", len(done))
    metrics.inc("serve_deadline_met_total", len(good))
    metrics.inc("serve_expired_total",
                sum(c.expired for c in completions.values()))
    metrics.inc("serve_goodput_tokens_total",
                sum(len(c.tokens) for c in good))
    metrics.inc("serve_tokens_total",
                sum(len(c.tokens) for c in completions.values()))
    for c in good:
        metrics.observe("serve_latency_seconds", c.latency_s)
        metrics.observe("serve_ttft_seconds", c.ttft_s)
    return {
        "completed": len(done),
        "deadline_met": len(good),
        "expired": sum(c.expired for c in completions.values()),
        "goodput_tokens": sum(len(c.tokens) for c in good),
        "goodput_tok_s": sum(len(c.tokens) for c in good) / span,
        "throughput_tok_s": sum(len(c.tokens)
                                for c in completions.values()) / span,
        "p50_latency_s": percentile(lat, 0.50) if lat else 0.0,
        "p99_latency_s": percentile(lat, 0.99) if lat else 0.0,
        "p50_ttft_s": percentile(ttft, 0.50) if ttft else 0.0,
        "p99_ttft_s": percentile(ttft, 0.99) if ttft else 0.0,
    }
