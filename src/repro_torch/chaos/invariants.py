"""Post-campaign invariant checkers.

Port of the reference's ``chaos/invariants.py`` over the port's
``lanefault`` registry.

Each checker returns a report dict with ``ok: bool`` plus the evidence
it judged, so a failing campaign explains itself; ``verdict`` rolls a
set of reports up and (optionally) raises :class:`InvariantViolation`
listing every failure at once.  The invariants are the paper's
fault-tolerance contract, checked over *randomized* schedules instead
of hand-picked ones:

- **no_dropped**  -- every admitted request either completes or expires
  against its own deadline; none vanish (§II constant-aggregate-
  throughput is vacuous if work is silently shed).
- **fingerprints** -- the live ``FleetPlan`` equals the plan replayed
  from the agreed event log: every host folding that log lands on the
  same fingerprint, so routing never desyncs.
- **ladder**      -- persistent faults sit on the rung the degradation
  ladder prescribes (DEGRADED for lane-mapped stages, binary fallback
  otherwise; quarantine only via migration/loss).
- **transients**  -- probation returned every transient fault to the HW
  route with zero residual quarantines or stage-fault counts.
- **closure**     -- measured post-fault throughput ratio matches the
  DegradationModel analytic ratio within tolerance (default 15%).
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

from repro_torch.viscosity import lanefault


class InvariantViolation(AssertionError):
    """A chaos invariant failed; ``.reports`` holds every failing
    checker's evidence."""

    def __init__(self, reports: Sequence[Mapping]):
        self.reports = tuple(reports)
        lines = [f"- {r.get('invariant', '?')}: {r.get('detail', r)}"
                 for r in reports]
        super().__init__("chaos invariant(s) failed:\n" + "\n".join(lines))


def check_no_dropped(requests, completions: Mapping[int, object]) -> Dict:
    """Every request has a completion; 'expired' is an allowed verdict
    (the request's own deadline), disappearance is not."""
    missing = sorted(r.rid for r in requests if r.rid not in completions)
    return {"invariant": "no_dropped", "ok": not missing,
            "requests": len(list(requests)), "missing": missing,
            "detail": f"{len(missing)} request(s) vanished: {missing[:8]}"}


def check_fingerprints(fingerprints: Sequence[str]) -> Dict:
    """All hosts/replicas agreed on the same FleetPlan digest."""
    uniq = sorted(set(fingerprints))
    return {"invariant": "fingerprints", "ok": len(uniq) <= 1,
            "fingerprints": list(fingerprints),
            "detail": f"{len(uniq)} distinct fingerprint(s): {uniq}"}


def check_ladder(fleet, stage_names: Sequence[str], *,
                 healthy: Optional[str] = None) -> Dict:
    """Every *serving* device's routed target matches what its recorded
    per-stage fault count prescribes: ``rung_for(n)`` when the stage has
    a registered lane map, off the ``healthy`` route otherwise."""
    wrong: List[Dict] = []
    for d in fleet.serving():
        plan = fleet.plans[d]
        for s in stage_names:
            n = fleet.stage_fault_count(d, s)
            if n < 1:
                continue
            got = plan.target_for(s)
            if lanefault.fault_map(s) is not None:
                want = lanefault.rung_for(n)
                if got != want:
                    wrong.append({"device": d, "stage": s, "count": n,
                                  "got": got, "want": want})
            elif healthy is not None and got == healthy:
                wrong.append({"device": d, "stage": s, "count": n,
                              "got": got, "want": "a fallback route"})
    return {"invariant": "ladder", "ok": not wrong, "wrong": wrong,
            "detail": f"{len(wrong)} mis-rung stage route(s): {wrong[:4]}"}


def check_transients(fleet, transient_events, fault_logs:
                     Sequence[Sequence[Mapping]]) -> Dict:
    """Transient faults must leave no trace on the plan: zero residual
    stage-fault count at their (device, stage) and a
    ``transient_recovered`` entry in some fault log for the stage."""
    recovered = {(e.get("stage"), e.get("kind")) for log in fault_logs
                 for e in log}
    residual: List[Dict] = []
    unlogged: List[Dict] = []
    for ev in transient_events:
        if fleet is not None and \
                fleet.stage_fault_count(ev.device, ev.stage) > 0:
            residual.append({"device": ev.device, "stage": ev.stage,
                             "step": ev.step})
        if (ev.stage, "transient_recovered") not in recovered:
            unlogged.append({"device": ev.device, "stage": ev.stage,
                             "step": ev.step})
    ok = not residual and not unlogged
    return {"invariant": "transients", "ok": ok, "residual": residual,
            "unlogged": unlogged,
            "detail": f"{len(residual)} residual fault(s), "
                      f"{len(unlogged)} without a transient_recovered "
                      f"log entry"}


def check_closure(measured_ratio: float, analytic_ratio: float,
                  *, tol: float = 0.15) -> Dict:
    """Measured-vs-DegradationModel throughput-ratio closure."""
    rel_err = abs(measured_ratio - analytic_ratio) / \
        max(abs(analytic_ratio), 1e-9)
    return {"invariant": "closure", "ok": rel_err <= tol,
            "measured_ratio": round(float(measured_ratio), 4),
            "analytic_ratio": round(float(analytic_ratio), 4),
            "rel_err": round(float(rel_err), 4), "tol": tol,
            "detail": f"rel_err {rel_err:.4f} > tol {tol}"}


def verdict(reports: Sequence[Mapping], *,
            raise_on_failure: bool = False) -> Dict:
    """Roll reports up; optionally raise InvariantViolation on any
    failure (benches do -- a broken invariant can never ride a green
    run)."""
    failed = [r for r in reports if not r.get("ok")]
    out = {"ok": not failed, "checked": len(list(reports)),
           "failed": [r.get("invariant") for r in failed],
           "reports": list(reports)}
    if failed and raise_on_failure:
        raise InvariantViolation(failed)
    return out


def mttr_summary(mttrs: Sequence[Mapping]) -> Optional[Dict]:
    """Mean/max recovery time over per-event MTTR records."""
    vals = [float(m["mttr_s"]) for m in mttrs if m.get("mttr_s")
            is not None]
    if not vals:
        return None
    return {"n": len(vals), "mean_s": round(sum(vals) / len(vals), 4),
            "max_s": round(max(vals), 4)}
