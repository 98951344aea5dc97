"""Fleet-health reporter over a metrics+trace snapshot.

A copy of the reference package's ``obs/report.py`` (standard library
only) over the port's ``obs.trace``, so both packages render one
snapshot the same way.

Reads the deterministic snapshot ``obs.metrics.Registry.snapshot()``
produces (plus, optionally, a merged trace) and renders the rollup:
ladder-rung occupancy vs the ``DegradationModel`` story, per-section
MTTR (mean/max — *exactly* the numbers the chaos campaigns compute from
their per-event records, because histograms keep exact sum/min/max in
observation order), and per-section goodput (*exactly*
``serve.frontend.summarize``'s value, because ``goodput_tok_s =
goodput_tokens_total / max(virtual_time, 1e-9)`` is the same division
over the same operands).

``python -m repro_torch.obs.report snapshot.json`` pretty-prints the
health report for a snapshot file: either the bare metrics snapshot or
the ``{"metrics": ..., "trace": ...}`` wrapper (``chaos.run_campaign``'s
``"telemetry"`` entry, written as JSON).
"""
from __future__ import annotations

import json
import sys
from typing import Any, Dict, List, Mapping, Optional, Sequence

from repro_torch.obs import trace as _trace


# ------------------------------------------------------ snapshot access
def family(snap: Mapping, name: str) -> Optional[Dict]:
    for fam in snap.get("families", ()):
        if fam.get("name") == name:
            return fam
    return None


def families(snap: Mapping) -> List[str]:
    """Sorted family names present (what a family-coverage check
    compares)."""
    return sorted(f.get("name", "") for f in snap.get("families", ()))


def _match(sample: Mapping, labels: Mapping[str, str]) -> bool:
    have = sample.get("labels", {})
    return all(have.get(k) == str(v) for k, v in labels.items())


def counter_value(snap: Mapping, name: str, **labels) -> float:
    fam = family(snap, name)
    if fam is None:
        return 0.0
    return sum(s["value"] for s in fam["samples"] if _match(s, labels))


def gauge_value(snap: Mapping, name: str, default: float = 0.0,
                **labels) -> float:
    fam = family(snap, name)
    if fam is None:
        return default
    vals = [s["value"] for s in fam["samples"] if _match(s, labels)]
    return vals[-1] if vals else default


def hist_stats(snap: Mapping, name: str, **labels) -> Dict[str, Any]:
    """count/sum/min/max for the single histogram child matching
    ``labels`` (exact-reproduction accessor: refuses to merge children,
    whose float sums would not reassociate exactly)."""
    fam = family(snap, name)
    empty = {"count": 0, "sum": 0.0, "min": None, "max": None}
    if fam is None:
        return empty
    rows = [s for s in fam["samples"] if _match(s, labels)]
    if not rows:
        return empty
    if len(rows) > 1:
        raise ValueError(
            f"{name}{dict(labels)} matches {len(rows)} histogram "
            f"children; narrow the labels (exact stats do not merge)")
    r = rows[0]
    return {"count": r["count"], "sum": r["sum"], "min": r["min"],
            "max": r["max"]}


def label_values(snap: Mapping, name: str, label: str) -> List[str]:
    fam = family(snap, name)
    if fam is None:
        return []
    return sorted({s.get("labels", {}).get(label, "")
                   for s in fam["samples"]})


# ------------------------------------------------- derived statistics
def mttr_summary(snap: Mapping, *, section: str = ""
                 ) -> Optional[Dict[str, Any]]:
    """``{"n", "mean_s", "max_s"}`` with the same arithmetic and
    rounding as ``chaos.invariants.mttr_summary`` over the per-event
    records — reproduced from the ``mttr_seconds`` histogram alone."""
    st = hist_stats(snap, "mttr_seconds", section=section)
    if not st["count"]:
        return None
    return {"n": st["count"],
            "mean_s": round(st["sum"] / st["count"], 4),
            "max_s": round(st["max"], 4)}


def goodput_summary(snap: Mapping, *, section: str = ""
                    ) -> Dict[str, Any]:
    """The counters half of ``serve.frontend.summarize`` — goodput /
    throughput are bit-equal to the in-run values (same division over
    the same operands)."""
    span = max(gauge_value(snap, "serve_virtual_time_seconds",
                           section=section), 1e-9)

    def c(name: str) -> float:
        return counter_value(snap, name, section=section)

    return {
        "completed": int(c("serve_completed_total")),
        "deadline_met": int(c("serve_deadline_met_total")),
        "expired": int(c("serve_expired_total")),
        "goodput_tokens": int(c("serve_goodput_tokens_total")),
        "goodput_tok_s": c("serve_goodput_tokens_total") / span,
        "throughput_tok_s": c("serve_tokens_total") / span,
        "virtual_time_s": gauge_value(snap, "serve_virtual_time_seconds",
                                      section=section),
        "admitted": int(c("serve_admitted_total")),
        "shed": int(c("serve_shed_total")),
    }


def rung_occupancy(snap: Mapping) -> Dict[str, int]:
    fam = family(snap, "fleet_rung_devices")
    if fam is None:
        return {}
    return {s["labels"].get("rung", ""): int(s["value"])
            for s in fam["samples"]}


def closure(snap: Mapping, *, tol: float = 0.15
            ) -> Optional[Dict[str, Any]]:
    """Measured-vs-DegradationModel throughput-ratio comparison (the
    gauges ``chaos.campaign.closure_scenario`` records)."""
    fam = family(snap, "closure_ratio")
    if fam is None or not fam["samples"]:
        return None
    measured = gauge_value(snap, "closure_ratio", source="measured")
    analytic = gauge_value(snap, "closure_ratio", source="analytic")
    rel_err = abs(measured - analytic) / max(abs(analytic), 1e-9)
    return {"measured_ratio": round(measured, 4),
            "analytic_ratio": round(analytic, 4),
            "rel_err": round(rel_err, 4), "ok": rel_err <= tol,
            "tol": tol}


def kv_retry_totals(snap: Mapping) -> Dict[str, float]:
    fam = family(snap, "kv_retries_total")
    if fam is None:
        return {}
    return {s["labels"].get("op", ""): s["value"]
            for s in fam["samples"]}


# ------------------------------------------------------- health rollup
def fleet_health(snap: Mapping,
                 trace_events: Sequence[_trace.TraceEvent] = ()
                 ) -> Dict[str, Any]:
    """The full health document: one dict, one schema, consumed by the
    benches and the CI telemetry smoke step."""
    fault_fam = family(snap, "fault_events_total") or {"samples": []}
    verdict_fam = family(snap, "probation_verdicts_total") \
        or {"samples": []}
    sections = sorted(set(label_values(snap, "mttr_seconds", "section")
                          + label_values(snap,
                                         "serve_virtual_time_seconds",
                                         "section")) - {""})
    spans = _trace.spans_of(trace_events) if trace_events else ()
    return {
        "schema": "repro.health.v1",
        "families": families(snap),
        "rungs": rung_occupancy(snap),
        "faults": {
            f'{s["labels"].get("kind", "")}:{s["labels"].get("stage", "")}':
                int(s["value"]) for s in fault_fam["samples"]},
        "probation": {s["labels"].get("verdict", ""): int(s["value"])
                      for s in verdict_fam["samples"]},
        "mttr": {sec: mttr_summary(snap, section=sec)
                 for sec in sections
                 if mttr_summary(snap, section=sec) is not None},
        "serve": {sec: goodput_summary(snap, section=sec)
                  for sec in sections
                  if gauge_value(snap, "serve_virtual_time_seconds",
                                 section=sec) > 0.0},
        "dispatch": {
            "hits": int(counter_value(snap, "dispatch_cache_hits_total")),
            "misses": int(counter_value(snap,
                                        "dispatch_cache_misses_total")),
        },
        "coordination": {
            "kv_retries": kv_retry_totals(snap),
            "timeouts": int(counter_value(snap, "coord_timeouts_total")),
        },
        "closure": closure(snap),
        "trace": {"events": len(trace_events),
                  "spans": len(spans),
                  "open_spans": sum(1 for s in spans if s.end is None)},
    }


def render(health: Mapping) -> str:
    """Human-readable fleet-health text block."""
    out: List[str] = ["== fleet health =="]
    if health.get("rungs"):
        occ = " ".join(f"{k}={v}"
                       for k, v in sorted(health["rungs"].items()))
        out.append(f"ladder      {occ}")
    if health.get("probation"):
        out.append("probation   " + " ".join(
            f"{k}={v}" for k, v in sorted(health["probation"].items())))
    for sec, m in sorted(health.get("mttr", {}).items()):
        out.append(f"mttr[{sec}]  n={m['n']} mean={m['mean_s']}s "
                   f"max={m['max_s']}s")
    for sec, g in sorted(health.get("serve", {}).items()):
        out.append(f"serve[{sec}]  goodput={g['goodput_tok_s']:.2f}tok/s "
                   f"met={g['deadline_met']}/{g['completed']} "
                   f"expired={g['expired']}")
    d = health.get("dispatch", {})
    out.append(f"dispatch    hits={d.get('hits', 0)} "
               f"misses={d.get('misses', 0)}")
    c = health.get("coordination", {})
    retries = sum(c.get("kv_retries", {}).values())
    out.append(f"coord       kv_retries={int(retries)} "
               f"timeouts={c.get('timeouts', 0)}")
    if health.get("closure"):
        cl = health["closure"]
        out.append(f"closure     measured={cl['measured_ratio']} "
                   f"analytic={cl['analytic_ratio']} "
                   f"rel_err={cl['rel_err']} ok={cl['ok']}")
    t = health.get("trace", {})
    if t.get("events"):
        out.append(f"trace       events={t['events']} "
                   f"spans={t['spans']} open={t['open_spans']}")
    return "\n".join(out) + "\n"


def load_snapshot(path: str) -> Dict[str, Any]:
    """Read a telemetry file: either a bare metrics snapshot or the
    ``{"metrics": ..., "trace": "<jsonl>" or [wire, ...]}`` wrapper
    (``chaos.run_campaign``'s telemetry); returns ``{"metrics": snap, "trace": (events,)}``."""
    with open(path) as f:
        doc = json.load(f)
    if "families" in doc:
        return {"metrics": doc, "trace": ()}
    tr = doc.get("trace", "")
    events = _trace.from_jsonl(tr) if isinstance(tr, str) else \
        tuple(_trace.TraceEvent.from_wire(e) for e in tr)
    return {"metrics": doc.get("metrics", {"families": []}),
            "trace": events}


def main(argv: Sequence[str] = ()) -> int:
    argv = list(argv) or sys.argv[1:]
    if not argv:
        sys.stdout.write("usage: python -m repro_torch.obs.report "
                         "<telemetry.json> [--json]\n")
        return 2
    doc = load_snapshot(argv[0])
    health = fleet_health(doc["metrics"], doc["trace"])
    if "--json" in argv[1:]:
        sys.stdout.write(json.dumps(health, indent=2, sort_keys=True)
                         + "\n")
    else:
        sys.stdout.write(render(health))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
