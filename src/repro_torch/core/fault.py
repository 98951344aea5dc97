"""Fault model, detection, and injection (paper §III-A; detection pluggable).

Port of the reference's ``core/fault.py``.  Fault granularity mirrors the
paper: a *non-transient* fault quarantines one (stage, replica) — the
runtime must stop using the optimized path for that stage there.
``FaultSignature`` is the frozen stage->route map that keys a build (the
Cohort 2-bit queue config).  ``FaultState`` logs with logical
``(step, origin, seq)`` stamps, never wall-clock time.

Detectors (any can drive the runtime; "Oobleck does not dictate a
particular method of fault detection"):
  * CanaryChecker  — runs each stage's HW path against its SW oracle on
    deterministic canaries; compares via the Fig.-4 checksum kernel
    (``kernels.checksum.checksum_tree``: the Hopper kernel on CUDA
    tensors; bit-exact detection of integer/stuck-at faults) when the
    stage's ``tol`` is 0, else by the largest absolute difference.
  * StepGuard      — NaN/Inf validity predicates on step outputs.
  * StragglerWatchdog — robust-quantile step-time outlier detection.

Injection: ``FaultInjector`` corrupts a stage's HW path deterministically
(bitflip / stuck-at-zero / gain error) to emulate a datapath defect.
``FaultClassifier`` splits transient from persistent detections by
probation re-execution of the stage's canary.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import (Callable, Dict, FrozenSet, Iterable, List, Mapping,
                    Optional, Sequence, Tuple)

import numpy as np
import torch

from repro_torch.core.stage import Stage
from repro_torch.kernels.checksum import checksum_tree
from repro_torch.obs import metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.logging import get_logger
from repro_torch.viscosity import lanefault
from repro_torch.viscosity.lang import HW, SW, tree_leaves, tree_map

log = get_logger("core.fault")

OK = "ok"
FAULT = "fault"

# Probation verdicts (FaultClassifier).  A detection enters *probation*:
# the stage's canary is re-executed on the same replica under exponential
# backoff, and the verdict decides which ladder the runtime walks —
# ``transient_recovered`` restores the HW route, ``persistent`` proceeds
# HW -> DEGRADED -> SW as before.  ``intermittent_promoted`` marks a
# clean probe overridden by the frequency threshold: the stage kept
# flapping transient, so it is treated as persistent anyway.
TRANSIENT_RECOVERED = "transient_recovered"
PERSISTENT = "persistent"
INTERMITTENT_PROMOTED = "intermittent_promoted"

# Errors a detector may legitimately *interpret as a fault* when a stage's
# HW path raises them (numeric/shape breakage of the kind a defective
# datapath produces).  Anything else propagates.
EXPECTED_STAGE_ERRORS = (ValueError, TypeError, ArithmeticError)


@dataclass(frozen=True)
class FaultSignature:
    """Frozen stage -> route map. Healthy stages route HW, faulty SW."""
    routes: Tuple[Tuple[str, str], ...] = ()

    @staticmethod
    def healthy(stage_names: Sequence[str] = ()) -> "FaultSignature":
        return FaultSignature(tuple((s, HW) for s in stage_names))

    def as_dict(self) -> Dict[str, str]:
        return dict(self.routes)

    def with_fault(self, stage: str) -> "FaultSignature":
        d = self.as_dict()
        d[stage] = SW
        return FaultSignature(tuple(sorted(d.items())))

    def faulty(self) -> FrozenSet[str]:
        return frozenset(s for s, r in self.routes if r != HW)

    def n_faults(self) -> int:
        return len(self.faulty())


def _log_key(entry: Mapping) -> Tuple[int, str, int]:
    """Total order over fault-log entries: (step, origin, seq).  Logical —
    no wall clock anywhere, so two runs that observe the same events in any
    interleaving produce identical merged logs."""
    return (int(entry.get("step", 0)), str(entry.get("origin", "")),
            int(entry.get("seq", 0)))


class FaultState:
    """Mutable fleet-side health registry: (stage, replica) -> status.

    Log entries carry **logical stamps** ``(step, origin, seq)`` — the same
    total order FleetEvent uses — never wall-clock time: a fault log must
    be a deterministic function of the event sequence, reproducible across
    replays and identical across replicas that saw the same events.
    """

    def __init__(self, origin: str = "local"):
        self._bad: Dict[Tuple[str, int], str] = {}
        self._counts: Dict[Tuple[str, int], int] = {}
        self.log: List[dict] = []
        self.origin = origin
        self._seq = 0

    def _stamp(self, step: int) -> Dict:
        self._seq += 1
        return {"step": int(step), "origin": self.origin, "seq": self._seq}

    def mark(self, stage: str, replica: int = 0, kind: str = "detected",
             step: int = 0) -> dict:
        self._bad[(stage, replica)] = FAULT
        self._counts[(stage, replica)] = self.count(stage, replica) + 1
        entry = {"stage": stage, "replica": replica, "kind": kind,
                 **self._stamp(step)}
        self.log.append(entry)
        metrics.inc("fault_events_total", kind=kind, stage=stage)
        return entry

    def note(self, stage: str, replica: int = 0, kind: str = "note",
             step: int = 0) -> dict:
        """Log-only event (no quarantine, no fault count) with the same
        deterministic stamp — e.g. a nan-guard trip the runner handles."""
        entry = {"stage": stage, "replica": replica, "kind": kind,
                 **self._stamp(step)}
        self.log.append(entry)
        metrics.inc("fault_events_total", kind=kind, stage=stage)
        return entry

    def observe(self, entry: Mapping) -> dict:
        """Fold one remote replica's log entry into this registry (marks
        the (stage, replica) and appends the entry verbatim — the remote
        origin/seq stamp is preserved so merged logs dedup exactly)."""
        e = dict(entry)
        self._bad[(e["stage"], e.get("replica", 0))] = FAULT
        self._counts[(e["stage"], e.get("replica", 0))] = (
            self.count(e["stage"], e.get("replica", 0)) + 1)
        self.log.append(e)
        return e

    def clear(self, stage: str, replica: int = 0,
              kind: str = TRANSIENT_RECOVERED, step: int = 0) -> dict:
        """Undo exactly one ``mark`` on (stage, replica): the probation
        verdict came back transient, so the fault count steps back down one
        rung and — when that was the only outstanding fault — the
        quarantine lifts.  Logged with the same deterministic stamp so the
        recovery replays identically on every host."""
        key = (stage, replica)
        n = self.count(stage, replica)
        if n <= 1:
            self._counts.pop(key, None)
            self._bad.pop(key, None)
        else:
            self._counts[key] = n - 1
        entry = {"stage": stage, "replica": replica, "kind": kind,
                 **self._stamp(step)}
        self.log.append(entry)
        metrics.inc("fault_events_total", kind=kind, stage=stage)
        return entry

    def is_faulty(self, stage: str, replica: int = 0) -> bool:
        return self._bad.get((stage, replica)) == FAULT

    def count(self, stage: str, replica: int = 0) -> int:
        """Faults accumulated on one (stage, replica) — the degradation-
        ladder rung index."""
        return self._counts.get((stage, replica), 0)

    def counts(self, stage_names: Optional[Iterable[str]] = None,
               replica: int = 0) -> Dict[str, int]:
        """Per-stage fault counts for ``replica`` (the input to
        ``lanefault.degraded_plan``)."""
        if stage_names is not None:
            return {s: self.count(s, replica) for s in stage_names}
        return {s: c for (s, r), c in sorted(self._counts.items())
                if r == replica}

    def signature(self, stage_names: Sequence[str], replica: int = 0
                  ) -> FaultSignature:
        sig = FaultSignature.healthy(stage_names)
        for s in stage_names:
            if self.is_faulty(s, replica):
                sig = sig.with_fault(s)
        return sig

    def n_faults(self, replica: int = 0) -> int:
        return sum(1 for (s, r), v in self._bad.items()
                   if r == replica and v == FAULT)

    @staticmethod
    def merge_logs(*logs: Sequence[Mapping]) -> List[dict]:
        """Deterministic union of per-replica logs: sorted by the logical
        (step, origin, seq) stamp, deduplicated on it.  Any interleaving of
        the same events merges to the identical list."""
        seen, out = set(), []
        for e in sorted((dict(e) for lg in logs for e in lg), key=_log_key):
            k = _log_key(e)
            if k not in seen:
                seen.add(k)
                out.append(e)
        return out


# ------------------------------------------------------------- probation
@dataclass(frozen=True)
class ProbationPolicy:
    """Retry budget for probation re-execution (the cheap recovery rung
    *before* any capacity is surrendered).  ``retries`` canary re-runs,
    exponentially backed off from ``backoff_base_s`` by ``backoff_factor``
    and capped at ``max_backoff_s``.  The default base of 0 keeps tests
    and virtual-clock runs wall-time free; production sets a real base."""

    retries: int = 3
    backoff_base_s: float = 0.0
    backoff_factor: float = 2.0
    max_backoff_s: float = 1.0

    def __post_init__(self):
        if self.retries < 1:
            raise ValueError(f"retries must be >= 1, got {self.retries}")
        if self.backoff_base_s < 0 or self.max_backoff_s < 0:
            raise ValueError("backoff must be >= 0")
        if self.backoff_factor < 1.0:
            raise ValueError(f"backoff_factor must be >= 1, got "
                             f"{self.backoff_factor}")

    def backoff_schedule(self) -> Tuple[float, ...]:
        """Seconds to wait before each retry attempt (deterministic)."""
        return tuple(min(self.max_backoff_s,
                         self.backoff_base_s * self.backoff_factor ** i)
                     for i in range(self.retries))


@dataclass(frozen=True)
class IntermittentPolicy:
    """Frequency threshold for promoting a *flapping* stage to persistent:
    when one (stage, replica) collects ``threshold`` transient verdicts
    within the trailing ``window_steps`` engine steps, the next clean
    probe is overridden — recurring upsets on the same silicon are a
    defect signature, not noise."""

    threshold: int = 3
    window_steps: int = 20

    def __post_init__(self):
        if self.threshold < 2:
            raise ValueError(f"threshold must be >= 2, got "
                             f"{self.threshold}")
        if self.window_steps < 1:
            raise ValueError(f"window_steps must be >= 1, got "
                             f"{self.window_steps}")


@dataclass(frozen=True)
class ProbationResult:
    """Outcome of one probation: ``transient`` when the canary went clean
    within the retry budget (at re-run ``attempts``), else persistent.
    ``promoted`` marks the intermittent override.  ``backoff_s`` is the
    total back-off actually scheduled."""

    stage: str
    replica: int
    transient: bool
    attempts: int
    backoff_s: float
    promoted: bool = False

    @property
    def verdict(self) -> str:
        if self.promoted:
            return INTERMITTENT_PROMOTED
        return TRANSIENT_RECOVERED if self.transient else PERSISTENT


class FaultClassifier:
    """Transient-vs-persistent probation over a detection.

    On a detection, the stage's canary is re-executed on the same replica
    up to ``policy.retries`` times with exponential backoff: a clean canary
    means the upset did not persist — the caller restores the HW route and
    the log records ``transient_recovered``; all-red means a real defect —
    the caller walks the HW -> DEGRADED -> SW ladder.

    ``sleep`` is injectable (tests pass a recorder; the default zero-base
    policy never waits)."""

    def __init__(self, checker: "CanaryChecker",
                 policy: Optional[ProbationPolicy] = None, *,
                 intermittent: Optional[IntermittentPolicy] = None,
                 sleep: Optional[Callable[[float], None]] = None):
        self.checker = checker
        self.policy = policy or ProbationPolicy()
        self.intermittent = intermittent
        # (stage, replica) -> steps of recent transient verdicts
        self._transients: Dict[Tuple[str, int], List[int]] = {}
        self._sleep = sleep if sleep is not None else time.sleep

    def _flapping(self, stage: str, replica: int, step: int) -> bool:
        """Record one transient verdict and report whether it crosses
        the intermittent-promotion frequency threshold."""
        metrics.inc("probation_transients_total", stage=stage)
        if self.intermittent is None:
            return False
        key = (stage, replica)
        lo = step - self.intermittent.window_steps
        recent = [s for s in self._transients.get(key, ()) if s >= lo]
        recent.append(step)
        self._transients[key] = recent
        return len(recent) >= self.intermittent.threshold

    def _stage_named(self, name: str) -> Optional[Stage]:
        for s in self.checker.stages:
            if s.name == name:
                return s
        return None

    def _verdict(self, res: ProbationResult, step: int,
                 state: Optional[FaultState]) -> ProbationResult:
        """Count, trace, log and note one verdict."""
        metrics.inc("probation_verdicts_total", verdict=res.verdict)
        attempts = {} if res.promoted else {"attempts": res.attempts}
        obs_trace.emit(step, name="probation", stage=res.stage,
                       replica=res.replica, verdict=res.verdict, **attempts)
        if res.promoted:
            log.warning("intermittent fault promoted to persistent",
                        stage=res.stage, replica=res.replica, step=step,
                        window=self.intermittent.window_steps,
                        threshold=self.intermittent.threshold)
        if state is not None:
            state.note(res.stage, res.replica, kind=res.verdict, step=step)
        return res

    def probate(self, probe: Callable[[], bool], *, stage: str,
                replica: int = 0, step: int = 0,
                state: Optional[FaultState] = None) -> ProbationResult:
        """Core retry loop over an arbitrary health probe (True = clean).
        ``classify`` wraps the stage canary in this."""
        waited = 0.0
        attempts = 0
        for backoff in self.policy.backoff_schedule():
            if backoff > 0:
                self._sleep(backoff)
            waited += backoff
            attempts += 1
            clean = bool(probe())
            if state is not None:
                state.note(stage, replica, kind="probation_retry", step=step)
            if clean:
                # a clean probe on a stage that keeps flapping: the
                # frequency threshold promotes it to persistent
                promoted = self._flapping(stage, replica, step)
                return self._verdict(ProbationResult(
                    stage=stage, replica=replica, transient=not promoted,
                    attempts=attempts, backoff_s=waited, promoted=promoted),
                    step, state)
        return self._verdict(ProbationResult(
            stage=stage, replica=replica, transient=False,
            attempts=attempts, backoff_s=waited), step, state)

    def classify(self, stage_name: str, *, replica: int = 0, step: int = 0,
                 state: Optional[FaultState] = None) -> ProbationResult:
        """Probate ``stage_name`` by re-running its canary.  Unknown stages
        (not in the checker's list) cannot be probed — treated persistent,
        the safe direction."""
        s = self._stage_named(stage_name)
        if s is None:
            log.warning("probation: no canary stage; treating the "
                        "fault as persistent", stage=stage_name)
            if state is not None:
                state.note(stage_name, replica, kind=PERSISTENT, step=step)
            return ProbationResult(stage=stage_name, replica=replica,
                                   transient=False, attempts=0,
                                   backoff_s=0.0)
        return self.probate(lambda: self.checker.check_stage(s),
                            stage=stage_name, replica=replica, step=step,
                            state=state)


# ------------------------------------------------------------- injection
class InjectionNoOpError(RuntimeError):
    """An injected corruption left the output bit-identical to the clean
    run (a bitflip of a zero element, stuck-zero on an already-zero lane):
    a detection test would pass because nothing was ever wrong.  Raised
    eagerly so the harness knows the experiment is invalid, not green."""


def _inexact(x) -> bool:
    return isinstance(x, torch.Tensor) and (x.is_floating_point()
                                            or x.is_complex())


@dataclass
class FaultInjector:
    """Wraps a stage's HW path with a deterministic corruption."""
    kind: str = "bitflip"     # bitflip | stuck_zero | gain
    magnitude: float = 1e-2

    def _corrupt(self, x):
        if not _inexact(x):                   # floats AND complex
            return x
        if self.kind == "stuck_zero":
            if x.dim() == 0:
                return x * 0
            x = x.clone()
            x[..., 0] = 0
            return x
        if self.kind == "gain":
            return x * (1.0 + self.magnitude)
        # bitflip: corrupt one fixed element.  Sign-flip alone is a silent
        # no-op on a zero element, so zeros flip to ``magnitude`` instead.
        flat = x.reshape(-1).clone()
        i = flat.shape[0] // 2
        v = flat[i]
        flat[i] = torch.where(v == 0, torch.tensor(self.magnitude,
                                                   dtype=x.dtype,
                                                   device=x.device), -v)
        return flat.reshape(x.shape)

    def corrupt(self, out):
        return tree_map(self._corrupt, out)

    def wrap(self, fn: Callable) -> Callable:
        def bad(*a, **kw):
            clean = fn(*a, **kw)
            out = self.corrupt(clean)
            same = all(torch.equal(c, o) if isinstance(c, torch.Tensor)
                       else c == o
                       for c, o in zip(tree_leaves(clean), tree_leaves(out)))
            if same:
                raise InjectionNoOpError(
                    f"{self.kind!r} injection left the output bit-identical "
                    "to the clean run (zero-valued target?); the experiment "
                    "would be vacuous")
            return out
        return bad


def inject(stage: Stage, kind: str = "bitflip",
           magnitude: float = 1e-2) -> Stage:
    inj = FaultInjector(kind=kind, magnitude=magnitude)
    return Stage(name=stage.name, spec=None, hw=inj.wrap(stage.hw),
                 sw=stage.sw, ports=stage.ports, tol=stage.tol,
                 device=stage.device)


# -------------------------------------------------------------- detectors
def _host32(x: torch.Tensor) -> np.ndarray:
    """A leaf on the host in 32 bits: float32, or complex64 kept whole."""
    x = x.detach()
    return (x.to(torch.complex64) if x.is_complex()
            else x.to(torch.float32)).cpu().numpy()


class CanaryChecker:
    """Per-stage HW-vs-SW canary compare (checksum or max difference).

    With ``localize=True`` a failing sweep additionally diffs the two
    lowerings lane-by-lane and, when the mismatch is confined to a strict
    subset of output lanes, registers a ``LaneFault`` map
    (``lanefault.set_map``) — unlocking the DEGRADED route family for
    that stage instead of a binary drop to the SW oracle.

    Complex leaves are compared by the modulus of their difference (the
    reference's float32 cast keeps only the real part).
    """

    def __init__(self, stages: Sequence[Stage], *, seed: int = 0,
                 route_hw: str = HW, localize: bool = False):
        self.stages = list(stages)
        self.seed = seed
        self.route_hw = route_hw
        self.auto_localize = localize

    def _run_both(self, stage: Stage):
        args = stage.canary_inputs(self.seed)
        return (stage.run(*args, route=self.route_hw),
                stage.run(*args, route=SW))

    @staticmethod
    def max_diff(a: torch.Tensor, b: torch.Tensor) -> float:
        """max |a - b| in 32 bits (inf when ``a`` is not finite)."""
        if not bool(torch.isfinite(a).all()):
            return float("inf")
        if a.is_complex() or b.is_complex():
            d = a.to(torch.complex64) - b.to(torch.complex64)
        else:
            d = a.to(torch.float32) - b.to(torch.float32)
        return float(d.abs().max()) if d.numel() else 0.0

    def check_stage(self, stage: Stage) -> bool:
        """True = healthy."""
        try:
            hw_out, sw_out = self._run_both(stage)
        except EXPECTED_STAGE_ERRORS as e:
            # Numeric/shape breakage on the HW path is itself the fault
            # signal; anything unexpected re-raises.
            log.warning("canary: stage raised; treating as a fault",
                        stage=stage.name, error=type(e).__name__,
                        detail=e)
            return False
        if stage.tol == 0.0:
            return checksum_tree(hw_out) == checksum_tree(sw_out)
        return all(self.max_diff(a, b) <= stage.tol
                   for a, b in zip(tree_leaves(hw_out), tree_leaves(sw_out)))

    def localize(self, stage: Stage) -> Optional[lanefault.LaneFault]:
        """Lane-level localization: diff HW vs SW on the canary inputs and
        return a LaneFault when the mismatch is confined to a strict subset
        of the output's lane (minor) axis; None when the fault is not
        lane-shaped (whole-tile breakage -> binary SW quarantine)."""
        try:
            hw_out, sw_out = self._run_both(stage)
        except EXPECTED_STAGE_ERRORS as e:
            log.warning("canary: localize raised; not lane-shaped",
                        stage=stage.name, error=type(e).__name__,
                        detail=e)
            return None
        for a, b in zip(tree_leaves(hw_out), tree_leaves(sw_out)):
            if (not _inexact(a) or a.dim() < 1 or a.shape != b.shape):
                continue
            width = a.shape[-1]
            if width < 2:
                continue
            af = _host32(a).reshape(-1, width)
            bf = _host32(b).reshape(-1, width)
            diff = np.abs(af - bf)
            diff = np.where(np.isnan(diff), np.inf, diff)
            per_lane = diff.max(axis=0)
            bad = np.flatnonzero(per_lane > stage.tol)
            if bad.size == 0 or bad.size >= width:
                continue
            lanes = tuple(int(i) for i in bad)
            kind, value, gain = self._classify(af.real, bf.real, lanes)
            return lanefault.LaneFault(kind=kind, lanes=lanes, width=width,
                                       value=value, gain=gain)
        return None

    @staticmethod
    def _classify(hw: np.ndarray, sw: np.ndarray, lanes: Tuple[int, ...]):
        """Best-effort fault taxonomy from the observed lane values (only
        lanes/width drive routing; the kind is diagnostic)."""
        col = hw[:, lanes[0]]
        ref = sw[:, lanes[0]]
        if np.allclose(col, 0.0):
            return lanefault.DROPPED_MAC, 1.5, 1.25
        if col.size > 1 and np.allclose(col, col[0]):
            return lanefault.STUCK, float(col[0]), 1.25
        denom = np.where(np.abs(ref) > 1e-6, ref, 1.0)
        ratio = np.where(np.abs(ref) > 1e-6, col / denom, np.nan)
        g = float(np.nanmedian(ratio)) if np.isfinite(
            np.nanmedian(ratio)) else 1.25
        return lanefault.GAIN, 1.5, g

    def sweep(self, state: FaultState, replica: int = 0,
              step: int = 0) -> List[str]:
        found = []
        for s in self.stages:
            if not self.check_stage(s):
                kind = "canary"
                if self.auto_localize:
                    f = self.localize(s)
                    if f is not None:
                        lanefault.set_map(s.name, f, base=self.route_hw)
                        kind = "canary_localized"
                state.mark(s.name, replica, kind=kind, step=step)
                found.append(s.name)
        return found


class StepGuard:
    """NaN/Inf guard over step outputs (loss, grads)."""

    @staticmethod
    def ok(tree) -> bool:
        return all(bool(torch.isfinite(leaf).all())
                   for leaf in tree_leaves(tree)
                   if isinstance(leaf, torch.Tensor)
                   and leaf.is_floating_point())


class StragglerWatchdog:
    """Flags replicas whose step time exceeds median * threshold."""

    def __init__(self, threshold: float = 2.0, window: int = 32):
        self.threshold = threshold
        self.window = window
        self.times: Dict[int, List[float]] = {}

    def record(self, replica: int, dt: float):
        self.times.setdefault(replica, []).append(dt)
        self.times[replica] = self.times[replica][-self.window:]

    def stragglers(self) -> List[int]:
        if not self.times:
            return []
        med = {r: float(np.median(v)) for r, v in self.times.items()}
        fleet_med = float(np.median(list(med.values())))
        if fleet_med <= 0:
            return []
        return [r for r, m in med.items() if m > self.threshold * fleet_med]
