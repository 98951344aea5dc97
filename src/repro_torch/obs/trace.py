"""Logical-clock trace spans.

A copy of the reference package's ``obs/trace.py`` (standard library
only), so the port's traces merge and serialize as the reference's do.

A trace is an ordered log of :class:`TraceEvent` records keyed by the
same ``(step, origin, seq)`` logical clock the FleetEvent log and
``FaultState`` stamps already use: ``step`` is the engine step the
event belongs to, ``origin`` the emitting host, ``seq`` a per-origin
monotone counter.  Merging traces from different hosts is the same
sorted-dedup union the event log property-tests — so the merged,
serialized trace is **byte-identical regardless of arrival
interleaving** (:func:`merge` + :func:`to_jsonl`).

Span lifecycle (per request)::

    admit                submit              ...ticks...      complete
    span_start ──────────▶ annot ──────────────▶ annot ──────▶ span_end
    (frontend release)    (engine slot)        (decode_tick)  (poll)

plus out-of-band annotations for faults, probation episodes and
ladder-rung transitions.  :func:`spans_of` pairs ``span_start`` /
``span_end`` events by name; detect→recover pairs are how the MTTR
histogram in ``obs.metrics`` is derived.
"""
from __future__ import annotations

import json
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import (Any, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

SPAN_START = "span_start"
SPAN_END = "span_end"
ANNOT = "annot"
_KINDS = (SPAN_START, SPAN_END, ANNOT)


@dataclass(frozen=True, order=True)
class TraceEvent:
    """One trace record.  Ordering/equality is the logical-clock total
    order first — exactly the FleetEvent merge contract."""
    step: int
    origin: int
    seq: int
    kind: str = ANNOT
    name: str = ""
    attrs: Tuple[Tuple[str, Any], ...] = field(default_factory=tuple)

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown trace kind {self.kind!r}; one "
                             f"of {_KINDS}")

    def to_wire(self) -> Dict[str, Any]:
        return {"step": self.step, "origin": self.origin,
                "seq": self.seq, "kind": self.kind, "name": self.name,
                "attrs": dict(self.attrs)}

    @staticmethod
    def from_wire(doc: Dict[str, Any]) -> "TraceEvent":
        return TraceEvent(step=int(doc["step"]),
                          origin=int(doc["origin"]),
                          seq=int(doc["seq"]), kind=str(doc["kind"]),
                          name=str(doc.get("name", "")),
                          attrs=_freeze(doc.get("attrs", {})))


def _freeze(attrs: Dict[str, Any]) -> Tuple[Tuple[str, Any], ...]:
    out = []
    for k in sorted(attrs):
        v = attrs[k]
        if not isinstance(v, (str, int, float, bool, type(None))):
            v = str(v)
        out.append((str(k), v))
    return tuple(out)


class Tracer:
    """Per-origin emitter: stamps every event with the next ``seq`` so
    intra-host emission order is total, like ``FaultState._stamp``."""

    def __init__(self, origin: int = 0):
        self.origin = int(origin)
        self.seq = 0
        self.events: List[TraceEvent] = []

    def emit(self, step: int, kind: str = ANNOT, name: str = "",
             **attrs) -> TraceEvent:
        ev = TraceEvent(step=int(step), origin=self.origin,
                        seq=self.seq, kind=kind, name=name,
                        attrs=_freeze(attrs))
        self.seq += 1
        self.events.append(ev)
        return ev

    def span_start(self, step: int, name: str, **attrs) -> TraceEvent:
        return self.emit(step, SPAN_START, name, **attrs)

    def span_end(self, step: int, name: str, **attrs) -> TraceEvent:
        return self.emit(step, SPAN_END, name, **attrs)

    def annotate(self, step: int, name: str, **attrs) -> TraceEvent:
        return self.emit(step, ANNOT, name, **attrs)


# ------------------------------------------------------------- merging
def merge(*logs: Iterable[TraceEvent]) -> Tuple[TraceEvent, ...]:
    """Sorted-dedup union over any number of (partial, overlapping)
    per-host logs — same algebra as ``merge_event_logs`` /
    ``FaultState.merge_logs``, so the result is one value no matter how
    the inputs were interleaved or duplicated in transit."""
    seen: Dict[Tuple[int, int, int], TraceEvent] = {}
    for log in logs:
        for ev in log:
            seen.setdefault((ev.step, ev.origin, ev.seq), ev)
    return tuple(seen[k] for k in sorted(seen))


def to_jsonl(events: Sequence[TraceEvent]) -> str:
    """Canonical serialization (sorted keys, no spaces): the byte-
    identity surface the 2-host merge contract is asserted on."""
    return "".join(json.dumps(ev.to_wire(), sort_keys=True,
                              separators=(",", ":")) + "\n"
                   for ev in events)


def from_jsonl(text: str) -> Tuple[TraceEvent, ...]:
    return tuple(TraceEvent.from_wire(json.loads(line))
                 for line in text.splitlines() if line.strip())


def from_fleet_log(events, origin_attr: str = "origin"
                   ) -> Tuple[TraceEvent, ...]:
    """Lift a ``launch.distributed.FleetEvent`` log into trace
    annotations (``fleet:<kind>``) so fault history and request spans
    merge into one ordered trace."""
    out = []
    for ev in events:
        out.append(TraceEvent(
            step=ev.step, origin=ev.origin, seq=ev.seq, kind=ANNOT,
            name=f"fleet:{ev.kind}",
            attrs=_freeze({"device": ev.device, "stage": ev.stage})))
    return tuple(out)


# --------------------------------------------------------------- spans
@dataclass(frozen=True)
class Span:
    """A paired ``span_start``/``span_end`` (``end`` is None while
    open).  ``steps`` is the logical duration — multiply by the run's
    ``step_time_s`` for virtual seconds."""
    name: str
    start: TraceEvent
    end: Optional[TraceEvent] = None

    @property
    def steps(self) -> Optional[int]:
        return None if self.end is None else self.end.step - \
            self.start.step


def spans_of(events: Sequence[TraceEvent]) -> Tuple[Span, ...]:
    """Pair starts with the first matching-name end at or after them
    (logical-clock order).  Unmatched starts yield open spans."""
    open_by_name: Dict[str, List[TraceEvent]] = {}
    spans: List[Span] = []
    for ev in sorted(events):
        if ev.kind == SPAN_START:
            open_by_name.setdefault(ev.name, []).append(ev)
        elif ev.kind == SPAN_END:
            stack = open_by_name.get(ev.name)
            if stack:
                spans.append(Span(ev.name, stack.pop(0), ev))
            else:
                spans.append(Span(ev.name, ev, ev))
    for name in sorted(open_by_name):
        for start in open_by_name[name]:
            spans.append(Span(name, start))
    spans.sort(key=lambda s: (s.start.step, s.start.origin,
                              s.start.seq))
    return tuple(spans)


# ------------------------------------------------------- active tracer
_tracer_stack: List[Tracer] = []


def current() -> Optional[Tracer]:
    return _tracer_stack[-1] if _tracer_stack else None


@contextmanager
def use(tracer: Tracer) -> Iterator[Tracer]:
    """Install ``tracer`` as the destination for module-level
    :func:`emit` calls (instrumented code stays tracer-agnostic; with
    no tracer installed, emission is a no-op)."""
    _tracer_stack.append(tracer)
    try:
        yield tracer
    finally:
        _tracer_stack.pop()


def emit(step: int, kind: str = ANNOT, name: str = "", **attrs) -> None:
    if _tracer_stack:
        _tracer_stack[-1].emit(step, kind, name, **attrs)
