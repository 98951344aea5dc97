"""Process-local typed metrics registry.

A copy of the reference package's ``obs/metrics.py`` (standard library
only), so the port records the same families under the same names.

Three metric kinds — Counter (monotone float), Gauge (last-write
float), Histogram (fixed log-spaced buckets + exact count/sum/min/max)
— organized into *families* declared once in :data:`SCHEMA` (name →
kind, help, label names).  Instrumented code calls the module-level
``inc`` / ``set_gauge`` / ``observe`` helpers, which write into the
*active* registry (a stack managed by :func:`use`), so a bench or chaos
campaign can scope one run's telemetry into one snapshot without
threading a registry handle through every layer.

Determinism contract: families and samples serialize sorted, bucket
edges are fixed constants, and histograms keep exact ``sum`` (in
observation order), ``min`` and ``max`` — so any statistic a harness
previously computed from its private counters (MTTR mean/max, goodput
= tokens/virtual-time) is reproducible *exactly* from the snapshot.
Two seeded runs performing the same observations produce byte-identical
JSONL snapshots (wall-clock-valued families excepted, by nature).

Label plumbing: families may declare a ``section`` label (or any
other); :func:`label_scope` pushes default label values that apply to
every sample recorded inside the scope, which is how one campaign
snapshot keeps per-section MTTR/goodput separable without the serve
stack knowing it runs inside a campaign.
"""
from __future__ import annotations

import json
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"


def log_buckets(lo: float, hi: float, n: int) -> Tuple[float, ...]:
    """``n`` log-spaced upper bucket bounds from ``lo`` to ``hi``
    inclusive — deterministic (pure ``**``, edges rounded to 9
    significant digits so snapshots are platform-stable)."""
    if not (lo > 0 and hi > lo and n >= 2):
        raise ValueError(f"need 0 < lo < hi and n >= 2; got "
                         f"lo={lo}, hi={hi}, n={n}")
    ratio = hi / lo
    return tuple(float(f"{lo * ratio ** (i / (n - 1)):.9g}")
                 for i in range(n))


#: default edges: 100us .. 1000s — covers a decode tick, a compile, and
#: a chaos-campaign MTTR window on one ladder
DEFAULT_BUCKETS = log_buckets(1e-4, 1e3, 15)

#: the metric name schema (documented in ARCHITECTURE.md):
#: name -> (kind, help, label names)
SCHEMA: Dict[str, Tuple[str, str, Tuple[str, ...]]] = {
    # dispatcher
    "dispatch_cache_hits_total": (
        COUNTER, "plan-keyed compile cache hits", ("key",)),
    "dispatch_cache_misses_total": (
        COUNTER, "plan-keyed compile cache misses (one compile each)",
        ("key",)),
    "dispatch_compile_seconds": (
        HISTOGRAM, "compile wall time per compile_key", ("key",)),
    # serve: admission front end + engine
    "serve_queue_depth": (
        GAUGE, "released-but-unadmitted requests", ("section",)),
    "serve_released_total": (
        COUNTER, "requests released by the virtual clock", ("section",)),
    "serve_admitted_total": (
        COUNTER, "requests admitted into engine slots", ("section",)),
    "serve_shed_total": (
        COUNTER, "requests shed by the admission policy", ("section",)),
    "serve_evicted_total": (
        COUNTER, "deadline-expiry evictions", ("section", "where")),
    "serve_decode_tick_seconds": (
        HISTOGRAM, "wall time of one engine decode tick", ("section",)),
    "serve_ttft_seconds": (
        HISTOGRAM, "virtual time to first token (deadline-met only)",
        ("section",)),
    "serve_latency_seconds": (
        HISTOGRAM, "virtual end-to-end latency (deadline-met only)",
        ("section",)),
    "serve_completed_total": (
        COUNTER, "completions (non-expired)", ("section",)),
    "serve_deadline_met_total": (
        COUNTER, "completions that met their deadline", ("section",)),
    "serve_expired_total": (
        COUNTER, "requests expired (queued or in flight)", ("section",)),
    "serve_goodput_tokens_total": (
        COUNTER, "tokens of deadline-met completions", ("section",)),
    "serve_tokens_total": (
        COUNTER, "tokens of all completions", ("section",)),
    "serve_virtual_time_seconds": (
        GAUGE, "virtual-clock span of the run", ("section",)),
    # fault / routing
    "fault_events_total": (
        COUNTER, "fault-log entries by kind", ("kind", "stage")),
    "fleet_rung_devices": (
        GAUGE, "degradation-ladder occupancy: serving (device, stage) "
               "assignments per rung, plus quarantined/spare devices",
        ("rung",)),
    "probation_verdicts_total": (
        COUNTER, "probation outcomes", ("verdict",)),
    "probation_transients_total": (
        COUNTER, "transient verdicts per stage (feeds intermittent "
                 "promotion)", ("stage",)),
    "mttr_seconds": (
        HISTOGRAM, "per-event recovery time (detect -> recover); "
                   "per-kind detail lives in the trace annotations",
        ("section",)),
    # train
    "train_step_seconds": (
        HISTOGRAM, "train step wall time", ()),
    "ckpt_save_seconds": (
        HISTOGRAM, "checkpoint save wall time", ()),
    "ckpt_restore_seconds": (
        HISTOGRAM, "checkpoint restore wall time", ()),
    # multi-host coordination
    "kv_retries_total": (
        COUNTER, "coordination-service KV get retries", ("op",)),
    "coord_timeouts_total": (
        COUNTER, "peers surfaced as HostTimeoutError", ("host",)),
    "coord_attempt_timeout_seconds": (
        GAUGE, "per-host KV attempt timeout in force", ("host",)),
    # degradation-model closure (campaign sets, report renders)
    "closure_ratio": (
        GAUGE, "post-fault/healthy throughput ratio", ("source",)),
}


class _Hist:
    __slots__ = ("buckets", "counts", "count", "sum", "min", "max")

    def __init__(self, buckets: Tuple[float, ...]):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)   # +1: +Inf overflow
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float):
        v = float(v)
        i = 0
        for i, edge in enumerate(self.buckets):
            if v <= edge:
                break
        else:
            i = len(self.buckets)
        self.counts[i] += 1
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)


class Family:
    """One declared metric family; ``samples`` maps a label-value tuple
    to a float (counter/gauge) or a :class:`_Hist`."""

    def __init__(self, name: str, kind: str, help: str,
                 labels: Tuple[str, ...] = (),
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        if kind not in (COUNTER, GAUGE, HISTOGRAM):
            raise ValueError(f"unknown metric kind {kind!r}")
        self.name = name
        self.kind = kind
        self.help = help
        self.labels = tuple(labels)
        self.buckets = tuple(buckets)
        self.samples: Dict[Tuple[str, ...], Any] = {}

    def _child(self, key: Tuple[str, ...]):
        if key not in self.samples:
            self.samples[key] = (_Hist(self.buckets)
                                 if self.kind == HISTOGRAM else 0.0)
        return self.samples[key]


class Registry:
    """A set of metric families.  Unknown names resolve through
    :data:`SCHEMA` (lazy declaration); ad-hoc families can be declared
    explicitly with :meth:`declare`."""

    def __init__(self):
        self.families: Dict[str, Family] = {}

    # ------------------------------------------------------ declaration
    def declare(self, name: str, kind: str, help: str = "",
                labels: Tuple[str, ...] = (),
                buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Family:
        fam = self.families.get(name)
        if fam is not None:
            if fam.kind != kind:
                raise ValueError(f"family {name!r} already declared as "
                                 f"{fam.kind}, not {kind}")
            return fam
        fam = Family(name, kind, help, labels, buckets)
        self.families[name] = fam
        return fam

    def _resolve(self, name: str, kind: str) -> Family:
        fam = self.families.get(name)
        if fam is None:
            spec = SCHEMA.get(name)
            if spec is None:
                raise KeyError(
                    f"metric family {name!r} is not in obs.metrics.SCHEMA; "
                    f"declare() it or add it to the schema")
            fam = self.declare(name, spec[0], spec[1], spec[2])
        if fam.kind != kind:
            raise TypeError(f"{name!r} is a {fam.kind}, not a {kind}")
        return fam

    def _key(self, fam: Family, labels: Mapping[str, str]
             ) -> Tuple[str, ...]:
        scope = _label_stack[-1] if _label_stack else {}
        return tuple(str(labels.get(k, scope.get(k, "")))
                     for k in fam.labels)

    # ------------------------------------------------------- recording
    def inc(self, name: str, v: float = 1.0, **labels):
        fam = self._resolve(name, COUNTER)
        key = self._key(fam, labels)
        fam.samples[key] = fam._child(key) + float(v)

    def set_gauge(self, name: str, v: float, **labels):
        fam = self._resolve(name, GAUGE)
        key = self._key(fam, labels)
        fam._child(key)
        fam.samples[key] = float(v)

    def observe(self, name: str, v: float, **labels):
        fam = self._resolve(name, HISTOGRAM)
        fam._child(self._key(fam, labels)).observe(v)

    # ---------------------------------------------------- serialization
    def snapshot(self) -> Dict[str, Any]:
        """Deterministic dict form: families sorted by name, samples by
        label values; histograms carry exact count/sum/min/max plus
        per-bucket counts."""
        fams: List[Dict[str, Any]] = []
        for name in sorted(self.families):
            fam = self.families[name]
            samples = []
            for key in sorted(fam.samples):
                row: Dict[str, Any] = {
                    "labels": dict(zip(fam.labels, key))}
                child = fam.samples[key]
                if fam.kind == HISTOGRAM:
                    row.update(count=child.count, sum=child.sum,
                               min=child.min, max=child.max,
                               bucket_counts=list(child.counts))
                else:
                    row["value"] = child
                samples.append(row)
            doc: Dict[str, Any] = {"name": name, "type": fam.kind,
                                   "help": fam.help,
                                   "labels": list(fam.labels),
                                   "samples": samples}
            if fam.kind == HISTOGRAM:
                doc["buckets"] = list(fam.buckets)
            fams.append(doc)
        return {"schema": "repro.metrics.v1", "families": fams}

    def to_jsonl(self) -> str:
        """One canonical-JSON line per family (sorted keys, no spaces)
        — byte-identical across runs that recorded the same values."""
        snap = self.snapshot()
        return "".join(json.dumps(f, sort_keys=True,
                                  separators=(",", ":")) + "\n"
                       for f in snap["families"])

    def to_prometheus(self) -> str:
        """Prometheus text exposition format.  Histograms add the
        non-standard ``_min``/``_max`` gauges the exact-reproduction
        contract needs."""
        out: List[str] = []
        for name in sorted(self.families):
            fam = self.families[name]
            out.append(f"# HELP {name} {fam.help}")
            out.append(f"# TYPE {name} {fam.kind}")
            for key in sorted(fam.samples):
                child = fam.samples[key]
                if fam.kind != HISTOGRAM:
                    out.append(f"{name}{_labelstr(fam.labels, key)} "
                               f"{_fmt(child)}")
                    continue
                cum = 0
                for edge, n in zip(fam.buckets, child.counts):
                    cum += n
                    out.append(
                        f"{name}_bucket"
                        f"{_labelstr(fam.labels + ('le',), key + (_fmt(edge),))}"
                        f" {cum}")
                cum += child.counts[-1]
                out.append(f"{name}_bucket"
                           f"{_labelstr(fam.labels + ('le',), key + ('+Inf',))}"
                           f" {cum}")
                out.append(f"{name}_sum{_labelstr(fam.labels, key)} "
                           f"{_fmt(child.sum)}")
                out.append(f"{name}_count{_labelstr(fam.labels, key)} "
                           f"{child.count}")
                if child.count:
                    out.append(f"{name}_min{_labelstr(fam.labels, key)} "
                               f"{_fmt(child.min)}")
                    out.append(f"{name}_max{_labelstr(fam.labels, key)} "
                               f"{_fmt(child.max)}")
        return "\n".join(out) + ("\n" if out else "")


def _fmt(v: float) -> str:
    """Shortest exact round-trip float rendering (``repr``) — the
    byte-determinism anchor for both text formats."""
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def _labelstr(names: Tuple[str, ...], values: Tuple[str, ...]) -> str:
    if not names:
        return ""
    pairs = ",".join(f'{k}="{_escape(v)}"'
                     for k, v in zip(names, values))
    return "{" + pairs + "}"


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"') \
                 .replace("\n", r"\n")


# ------------------------------------------------------- active registry
_registry_stack: List[Registry] = [Registry()]
_label_stack: List[Dict[str, str]] = []
_disabled = 0


def registry() -> Registry:
    """The registry module-level helpers write into (innermost
    :func:`use` scope; a process-global default otherwise)."""
    return _registry_stack[-1]


@contextmanager
def use(reg: Registry) -> Iterator[Registry]:
    """Scope all telemetry inside the block into ``reg`` — one bench
    run / chaos campaign = one snapshot."""
    _registry_stack.append(reg)
    try:
        yield reg
    finally:
        _registry_stack.pop()


@contextmanager
def label_scope(**labels) -> Iterator[None]:
    """Default label values for every sample recorded in the block
    (only labels a family declares apply to it)."""
    merged = dict(_label_stack[-1]) if _label_stack else {}
    merged.update({k: str(v) for k, v in labels.items()})
    _label_stack.append(merged)
    try:
        yield
    finally:
        _label_stack.pop()


@contextmanager
def disabled() -> Iterator[None]:
    """Turn the module-level helpers into immediate no-ops (the
    telemetry-overhead guard measures against this)."""
    global _disabled
    _disabled += 1
    try:
        yield
    finally:
        _disabled -= 1


def inc(name: str, v: float = 1.0, **labels):
    if not _disabled:
        _registry_stack[-1].inc(name, v, **labels)


def set_gauge(name: str, v: float, **labels):
    if not _disabled:
        _registry_stack[-1].set_gauge(name, v, **labels)


def observe(name: str, v: float, **labels):
    if not _disabled:
        _registry_stack[-1].observe(name, v, **labels)
