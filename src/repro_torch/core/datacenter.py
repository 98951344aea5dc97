"""Data-center fleet models (paper §II, Fig. 2; §V-G cost evaluation).

A copy of the reference's ``core/datacenter.py`` (numpy only), so the same
seed draws the same Monte-Carlo trace in both packages.

Fixed-size model: N chips, T ticks, per-tick per-chip fault probability p.
  * SFA (single-fault accelerator): first fault -> chip replaced.
  * VFA (variable-fault accelerator): dies after ``max_faults`` faults;
    intermediate faults multiply chip throughput by the degradation curve
    (derived from the latency model's throughput_factor, e.g. the FFT case
    study gives [1.0, 0.38, ...]).

Both a vectorized Monte-Carlo simulation and closed-form expectations are
provided; Fig. 2's claims are asserted against the analytic curves in
tests (MC agrees within sampling error).

Fixed-throughput model (§II, §V-G): chips needed to restore the fleet's
aggregate throughput scale linearly with per-fault performance retention.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.viscosity.lang import (DEGRADED_REDUCED, DEGRADED_REMAP,
                                  DEGRADED_TARGETS)


@dataclass(frozen=True)
class DegradationModel:
    """VFA degradation refined to per-(stage, rung) partial throughput.

    The scalar curve (``curve[k]`` = relative throughput with k SW-
    quarantined faults) stays the coarse backbone, but a fault absorbed by
    the DEGRADED route family costs a *partial* factor instead of a full
    curve step: a remapped stage runs the kernel at full width plus an
    oracle patch (mild overhead), a reduced-width stage loses lanes
    proportionally.  ``factor`` composes the two: rung-absorbed faults are
    removed from the curve index (remap absorbs 1 fault, reduced-width 2 —
    its ladder position) and charged their per-stage partial factor
    instead.  With no rungs this reduces exactly to the legacy scalar
    model, so existing Fig. 2 curves are unchanged.
    """

    curve: Tuple[float, ...] = (1.0, 0.38, 0.19)
    # ((stage, rung), factor) overrides; rung is a DEGRADED target string.
    partial: Tuple[Tuple[Tuple[str, str], float], ...] = ()
    remap_default: float = 0.85
    reduced_default: float = 0.6

    # Ladder position of each rung = faults it has absorbed.
    RUNG_WEIGHTS = {DEGRADED_REMAP: 1, DEGRADED_REDUCED: 2}

    def __post_init__(self):
        object.__setattr__(self, "curve", tuple(self.curve))
        object.__setattr__(self, "partial",
                           tuple(sorted((tuple(k), float(v))
                                        for k, v in self.partial)))
        for (_, rung), _f in self.partial:
            if rung not in DEGRADED_TARGETS:
                raise ValueError(f"partial factor names unknown rung "
                                 f"{rung!r}; expected {DEGRADED_TARGETS}")

    def partial_factor(self, stage: str, rung: str) -> float:
        for (s, r), f in self.partial:
            if s == stage and r == rung:
                return f
        return (self.remap_default if rung == DEGRADED_REMAP
                else self.reduced_default)

    def factor(self, n_faults: int,
               rungs: Sequence[Tuple[str, str]] = ()) -> float:
        """Relative throughput of a device with ``n_faults`` total faults
        of which ``rungs`` (stage, DEGRADED-target) pairs are absorbed by
        the ladder; the remainder are full SW quarantines on the curve."""
        absorbed = sum(self.RUNG_WEIGHTS.get(r, 0) for _, r in rungs)
        k_sw = max(0, int(n_faults) - absorbed)
        f = self.curve[min(k_sw, len(self.curve) - 1)]
        for s, r in rungs:
            f *= self.partial_factor(s, r)
        return f

    def slot_cap(self, slots_per_device: int, n_faults: int,
                 rungs: Sequence[Tuple[str, str]] = ()) -> int:
        """Serve-engine slot quantization of ``factor`` (same rounding as
        the legacy scalar path, so the analytic twin stays slot-exact)."""
        return round(slots_per_device * self.factor(n_faults, rungs))

    @staticmethod
    def rungs_of(plan) -> Tuple[Tuple[str, str], ...]:
        """The (stage, rung) pairs a RoutingPlan currently assigns to the
        DEGRADED family (the ``rungs`` argument ``factor`` expects)."""
        return tuple((s, t) for s, t in plan.assignments
                     if t in DEGRADED_TARGETS)


@dataclass
class FleetResult:
    replacements: float
    throughput: float          # mean aggregate throughput / max possible
    faults_total: float
    # (tick, chip) fault events in draw order — the Monte-Carlo trace the
    # FleetHarness replays through the real engines (record_trace=True).
    trace: Tuple[Tuple[int, int], ...] = ()


# ------------------------------------------------------------ Monte Carlo
def simulate_fleet(n_chips: int, ticks: int, p_fault: float, *,
                   mode: str = "vfa", max_faults: int = 3,
                   degradation: Sequence[float] = (1.0, 0.38, 0.19),
                   replace_failed: bool = True, seed: int = 0,
                   record_trace: bool = False,
                   ) -> FleetResult:
    """Vectorized fleet simulation.

    degradation[k] = relative throughput with k faults (k < max_faults);
    at ``max_faults`` the chip fails (throughput 0) and is replaced.
    SFA is the special case max_faults=1.
    """
    if mode == "sfa":
        max_faults = 1
    rng = np.random.default_rng(seed)
    deg = np.asarray(list(degradation)[:max_faults], np.float64)
    assert deg.shape[0] == max_faults
    faults = np.zeros(n_chips, np.int64)
    replacements = 0
    faults_total = 0
    tp_acc = 0.0
    trace: List[Tuple[int, int]] = []
    for t in range(ticks):
        hit = rng.random(n_chips) < p_fault
        faults_total += int(hit.sum())
        if record_trace:
            trace.extend((t, int(c)) for c in np.flatnonzero(hit))
        faults = faults + hit
        dead = faults >= max_faults
        n_dead = int(dead.sum())
        if n_dead and replace_failed:
            replacements += n_dead
            faults[dead] = 0
        elif n_dead:
            faults[dead] = max_faults  # pin
        tp_acc += float(deg[np.minimum(faults, max_faults - 1)].sum())
    return FleetResult(replacements=float(replacements),
                       throughput=tp_acc / (ticks * n_chips),
                       faults_total=float(faults_total),
                       trace=tuple(trace))


# ---------------------------------------------------------------- analytic
def expected_replacements(n_chips: int, ticks: int, p: float,
                          max_faults: int = 3) -> float:
    """Renewal-process expectation of chip replacements over the horizon.

    A chip is replaced each time it accumulates ``max_faults`` faults; fault
    arrivals are Bernoulli(p) per tick.  Expected replacements per chip =
    E[floor(Binomial(T, p) / max_faults)] (faults carry across replacement
    boundaries only within a chip's own renewal chain, which this floor
    captures exactly for memoryless Bernoulli arrivals).
    """
    mean = ticks * p
    if mean > 50 * max_faults:   # deep-normal regime: floor(X/k) ~ X/k
        return n_chips * mean / max_faults
    # exact-ish: sum over Poisson-approximated fault counts
    from math import exp, log
    lam = -ticks * np.log1p(-p) if p < 1 else float("inf")
    total = 0.0
    kmax = int(lam + 12 * np.sqrt(lam) + 3 * max_faults + 10)
    logp = -lam
    for k in range(kmax + 1):
        if k > 0:
            logp += log(lam) - log(k)
        total += (k // max_faults) * exp(logp)
    return n_chips * total


def expected_throughput(ticks: int, p: float, *, max_faults: int = 3,
                        degradation: Sequence[float] = (1.0, 0.38, 0.19),
                        ) -> float:
    """Mean relative throughput of one chip over the horizon (replacement
    resets; Markov chain over fault-count states 0..max_faults-1)."""
    deg = list(degradation)[:max_faults]
    state = np.zeros(max_faults)
    state[0] = 1.0
    tp = 0.0
    M = np.zeros((max_faults, max_faults))
    for i in range(max_faults):
        M[i, i] += 1 - p
        j = i + 1
        M[(j if j < max_faults else 0), i] += p   # overflow -> replaced (new)
    for _ in range(ticks):
        tp += float(np.dot(deg, state))
        state = M @ state
    return tp / ticks


# ------------------------------------------------- fixed-throughput model
def chips_to_buy(n_faulted: int, retention: float) -> float:
    """§II: chips bought to restore throughput when ``n_faulted`` chips each
    retain ``retention`` of their performance.  SFA: retention=0 -> buy all.
    Linear in (1 - retention), as the paper states."""
    return n_faulted * (1.0 - retention)


# ------------------------------------------------ trace -> fleet scenario
@dataclass
class TraceReplay:
    """One Monte-Carlo fault trace turned into an executable fleet
    scenario: per-engine-step fault events plus the analytic per-tick
    capacity curve they imply."""

    events: Dict[int, List[Tuple]]        # engine step -> fleet events
    capacity: np.ndarray                  # (ticks,) analytic fleet capacity
    healthy_capacity: float               # capacity with zero faults
    n_dropped: int                        # trace faults on already-dead HW

    @property
    def mean_ratio(self) -> float:
        """Mean aggregate throughput relative to the healthy fleet — the
        analytic VFA degradation prediction for this trace."""
        return float(np.mean(self.capacity) / self.healthy_capacity)


def replay_trace(trace: Sequence[Tuple[int, int]], *, n_workers: int,
                 ticks: int, stage_names: Sequence[str],
                 degradation: Sequence[float] = (1.0, 0.38, 0.19),
                 max_faults: int = 3, n_spares: int = 0,
                 slots_per_device: int = 1,
                 steps_per_tick: int = 1,
                 n_hosts: int = 1,
                 host_loss: Optional[Mapping[int, int]] = None,
                 model: Optional[DegradationModel] = None,
                 lane_mapped: Sequence[str] = ()
                 ) -> TraceReplay:
    """Mirror of the FleetPlan transition semantics over a fault trace.

    A fault on a serving device migrates its work to a free hot spare
    (paper Fig. 8) before anything degrades; with the pool dry, fault k
    quarantines ``stage_names[k]`` in place (VFA degradation); at
    ``max_faults`` the device dies.  Returns both the engine event
    schedule and the analytic capacity curve in *slots* (quantized the
    same way ``FleetConfig.capacity_for`` quantizes the serve engine),
    so measured-vs-analytic comparisons are slot-exact.

    With a ``model`` (DegradationModel) and ``lane_mapped`` stages the
    mirror walks the same degradation ladder ``FleetPlan.with_stage_fault``
    walks: repeated faults land on an already-degraded lane-mapped stage
    first (remap -> reduced width -> SW oracle), each rung charged its
    partial factor instead of a full curve step; unmapped stages quarantine
    binarily as before.  Device death still triggers at ``max_faults``
    total faults.

    ``n_hosts`` adds the multi-host axis: the ``n_workers + n_spares``
    devices partition into contiguous per-host blocks (must divide
    evenly) and ``host_loss[tick] = host`` drops a whole block at that
    tick — mirroring ``FleetPlan.with_host_fault``: serving devices
    migrate to free spares *outside* the block, the block's idle spares
    leave the pool, everything else is lost capacity.  The emitted
    ``("host", h)`` event replays through ``FleetServeEngine`` with a
    matching ``HostTopology``, so the analytic twin and the measured
    engine fold the same event log.
    """
    deg = list(degradation)
    if model is None and max_faults > len(stage_names) + 1:
        # Ladder runs absorb several faults on one stage, so the one-
        # stage-per-fault headroom guard only applies to the binary path.
        raise ValueError(
            f"max_faults={max_faults} needs at least {max_faults - 1} "
            f"stages to quarantine one per fault before device death; "
            f"model has {len(stage_names)}: {list(stage_names)}")
    lane_mapped = tuple(lane_mapped)
    n_rungs = len(DegradationModel.RUNG_WEIGHTS) + 1   # remap/reduced/SW
    n_devices = n_workers + n_spares
    if n_hosts < 1 or n_devices % n_hosts:
        raise ValueError(f"{n_devices} device(s) do not partition into "
                         f"{n_hosts} equal host block(s)")
    per_host = n_devices // n_hosts
    host_loss = dict(host_loss or {})
    for h in host_loss.values():
        if not 0 <= h < n_hosts:
            raise ValueError(f"host {h} out of range for {n_hosts} "
                             f"host(s)")

    def slot_cap(k: int) -> float:
        return round(slots_per_device * deg[min(k, len(deg) - 1)])

    faults = {d: 0 for d in range(n_devices)}     # fallback stages per dev
    scounts: Dict[int, Dict[str, int]] = {d: {} for d in range(n_devices)}

    def _pick(c: int) -> str:
        """Stage the next fault on device ``c`` hits — mirrors the engine:
        an already-degraded lane-mapped stage keeps absorbing faults until
        its ladder bottoms out at SW, then the next untouched stage."""
        if model is not None:
            for s in stage_names:
                if s in lane_mapped and 0 < scounts[c].get(s, 0) < n_rungs:
                    return s
            for s in stage_names:
                if scounts[c].get(s, 0) == 0:
                    return s
            return stage_names[-1]
        return stage_names[min(faults[c], len(stage_names) - 1)]

    def _rungs(c: int) -> Tuple[Tuple[str, str], ...]:
        """(stage, rung) pairs currently DEGRADED on device ``c`` (counts
        past the ladder are full SW quarantines, not rungs)."""
        out = []
        for s, k in sorted(scounts[c].items()):
            if s in lane_mapped and 0 < k < n_rungs:
                out.append((s, (DEGRADED_REMAP, DEGRADED_REDUCED)[k - 1]))
        return tuple(out)

    def device_cap(d: int) -> float:
        if model is not None:
            return model.slot_cap(slots_per_device, faults[d], _rungs(d))
        return slot_cap(faults[d])

    serving = set(range(n_workers))
    free_spares = list(range(n_workers, n_devices))
    dead: set = set()
    events: Dict[int, List[Tuple]] = {}
    capacity = np.zeros(ticks)
    n_dropped = 0
    by_tick: Dict[int, List[int]] = {}
    for t, c in trace:
        by_tick.setdefault(t, []).append(c)
    for t in range(ticks):
        if t in host_loss:
            h = host_loss[t]
            block = set(range(h * per_host, (h + 1) * per_host))
            events.setdefault(t * steps_per_tick, []).append(("host", h))
            for d in sorted(block & serving):
                off_host = [s for s in free_spares if s not in block]
                serving.discard(d)
                if off_host:                  # migrate outside the block
                    free_spares.remove(off_host[0])
                    serving.add(off_host[0])
                else:
                    dead.add(d)
            free_spares = [s for s in free_spares if s not in block]
            dead |= block - serving
        for c in by_tick.get(t, ()):
            if c >= n_devices or c not in serving:
                n_dropped += 1            # fault on quarantined/dead HW
                continue
            step = t * steps_per_tick
            if free_spares:               # migrate before degrading
                spare = free_spares.pop(0)
                serving.discard(c)
                serving.add(spare)
                stage = _pick(c)
                events.setdefault(step, []).append(("stage", c, stage))
                scounts[c][stage] = scounts[c].get(stage, 0) + 1
                faults[c] += 1
            elif faults[c] + 1 >= max_faults:
                serving.discard(c)
                dead.add(c)
                events.setdefault(step, []).append(("device", c))
            else:
                stage = _pick(c)
                events.setdefault(step, []).append(("stage", c, stage))
                scounts[c][stage] = scounts[c].get(stage, 0) + 1
                faults[c] += 1
        capacity[t] = sum(device_cap(d) for d in serving)
    healthy_slot = (model.slot_cap(slots_per_device, 0) if model is not None
                    else slot_cap(0))
    return TraceReplay(events=events, capacity=capacity,
                       healthy_capacity=float(n_workers * healthy_slot),
                       n_dropped=n_dropped)


class FleetHarness:
    """Close the loop on Fig. 2 / Fig. 8: replay a ``simulate_fleet``
    Monte-Carlo fault trace through the *real* serve engine and compare
    measured aggregate throughput against the analytic VFA degradation
    curve, while every completion stays bit-identical to the healthy
    single-device reference.

    The engine is passed in (built by the caller from ``repro_torch.serve``), so
    the analytic layer never imports the serving stack.  Throughput is
    measured as decoded tokens per engine step over the fault horizon,
    normalized by a healthy run of the same workload — the same ratio the
    analytic capacity curve predicts.

    ``num_hosts`` is the fleet's host axis: with a host-partitioned
    engine (``FleetConfig.topology``) and a ``replay_trace(n_hosts=...)``
    schedule, the same event log — including whole-host losses — replays
    through both the measured and the analytic side.
    """

    def __init__(self, engine, replay: TraceReplay, *, horizon: int,
                 num_hosts: int = 1):
        self.engine = engine
        self.replay = replay
        self.horizon = horizon
        self.num_hosts = num_hosts

    def _mean_tokens(self, stats) -> float:
        per_step = stats["per_step_tokens"][:self.horizon]
        if len(per_step) < self.horizon:
            raise ValueError(
                f"engine finished after {len(per_step)} steps, before the "
                f"{self.horizon}-step fault horizon — the measured and "
                "analytic windows would not match; use a longer / more "
                "saturated workload")
        return float(np.mean(per_step))

    def run(self, requests) -> Dict[str, Any]:
        healthy_done, healthy_stats = self.engine.serve(requests)
        healthy_tps = self._mean_tokens(healthy_stats)
        faulted_done, faulted_stats = self.engine.serve(
            requests, events=self.replay.events)
        measured = self._mean_tokens(faulted_stats) / healthy_tps
        analytic = self.replay.mean_ratio
        return {
            "num_hosts": self.num_hosts,
            "measured_ratio": measured,
            "analytic_ratio": analytic,
            "rel_err": abs(measured - analytic) / analytic,
            "healthy_tokens_per_step": healthy_tps,
            "faulted_tokens_per_step": self._mean_tokens(faulted_stats),
            "requeued": faulted_stats["requeued"],
            "quarantined": faulted_stats["quarantined"],
            "spares_in_service": faulted_stats["spares_in_service"],
            "completions": (healthy_done, faulted_done),
            "stats": (healthy_stats, faulted_stats),
        }


def fig2_sweep(fault_rates: Sequence[float], *, n_chips: int = 10_000,
               ticks: int = 1460, max_faults: int = 3,
               degradation: Sequence[float] = (1.0, 0.38, 0.19),
               monte_carlo: bool = False, seed: int = 0):
    """Reproduces Fig. 2(a,b): returns rows of
    (rate, sfa_repl, vfa_repl, sfa_tp, vfa_tp)."""
    rows = []
    for p in fault_rates:
        if monte_carlo:
            sfa = simulate_fleet(n_chips, ticks, p, mode="sfa", seed=seed)
            vfa = simulate_fleet(n_chips, ticks, p, mode="vfa",
                                 max_faults=max_faults,
                                 degradation=degradation, seed=seed)
            rows.append((p, sfa.replacements, vfa.replacements,
                         sfa.throughput, vfa.throughput))
        else:
            rows.append((
                p,
                expected_replacements(n_chips, ticks, p, 1),
                expected_replacements(n_chips, ticks, p, max_faults),
                expected_throughput(ticks, p, max_faults=1,
                                    degradation=(1.0,)),
                expected_throughput(ticks, p, max_faults=max_faults,
                                    degradation=degradation),
            ))
    return rows
