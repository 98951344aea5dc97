"""Fault state (paper §III-A): the frozen signature and the health registry.

Port of the reference's ``FaultSignature`` and ``FaultState``
(``core/fault.py``).  ``FaultState`` logs with logical
``(step, origin, seq)`` stamps, never wall-clock time.  The detectors
(``CanaryChecker`` needs the checksum kernel), ``FaultClassifier`` with its
probation policies, ``FaultInjector``, ``StepGuard`` and
``StragglerWatchdog`` are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import (Dict, FrozenSet, Iterable, List, Mapping, Optional,
                    Sequence, Tuple)

from repro_torch.obs import metrics
from repro_torch.viscosity.lang import HW, SW

OK = "ok"
FAULT = "fault"

# The probation verdict ``FaultState.clear`` logs by default.
TRANSIENT_RECOVERED = "transient_recovered"


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
