"""The port's chaos layer on the CPU, against the reference.

* ``draw_schedule`` draws the reference's schedule for every seed, kind
  set, fleet shape and topology tried (hypothesis), wedges included.
* Each invariant checker, ``verdict`` and ``mttr_summary`` return the
  reference's reports on the same inputs.
* ``serve_campaign`` (RESIDENT, the smoke sizing of 3 events and 30
  requests, route INTERPRET) against one run of the reference's on
  converted weights: every key but telemetry, token values and the
  coordinator drill's wall-clock MTTR is equal (the schedule, the event
  outcomes, fingerprints, virtual-time MTTR, completed / expired /
  requeued counts).  Every invariant is green in both failover modes.
  (``closure_scenario``, ``train_campaign`` and the coordinator drills:
  ``test_torch_chaos_campaigns.py``.)
* ``obs.report`` renders one snapshot as the reference's does, and
  ``run_campaign``'s telemetry, written to a file, renders through the
  CLI's ``main`` with the campaigns' own MTTR and goodput.
"""
import copy
import dataclasses
import json
import types

import jax
import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

from repro.chaos import campaign as ref_campaign
from repro.chaos import invariants as ref_inv
from repro.chaos import schedule as ref_schedule
from repro.configs import get_config as ref_get_config
from repro.core.routing import FleetPlan as RefFleetPlan
from repro.launch.distributed import HostTopology as RefHostTopology
from repro.models import build_model as ref_build_model
from repro.obs import metrics as ref_metrics
from repro.obs import report as ref_report
from repro.viscosity import lanefault as ref_lanefault

from repro_torch.chaos import invariants as inv, schedule
from repro_torch.chaos.campaign import run_campaign, serve_campaign
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.routing import FleetPlan
from repro_torch.launch.distributed import HostTopology
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import report as obs_report
from repro_torch.serve import RECOMPILE, RESIDENT
from repro_torch.viscosity import lanefault
from repro_torch.viscosity.lanefault import STUCK, LaneFault
from _torch_threads import one_torch_thread  # noqa: F401

STAGES = ["flash_attention", "swiglu_mlp"]
#: seed 1's smoke schedules: a lane fault, a transient and a coordinator
#: stall in the serve campaign; a device loss and a host loss in training
SEED = 1
SMOKE = dict(n_events=3, n_requests=30)


@pytest.fixture(scope="module")
def setup():
    rcfg = ref_get_config("qwen1.5-4b").reduced()
    jparams = ref_build_model(rcfg).init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    return rcfg, jparams, get_config("qwen1.5-4b-smoke"), \
        params_from_jax(np_params, device="cpu")


# --------------------------------------------------------------- schedule
def _draw(mod, topo_cls, kw):
    kw = dict(kw)
    if kw.pop("hosts"):
        kw["topology"] = topo_cls(2, kw["n_devices"] // 2)
    try:
        return [dataclasses.astuple(e) for e in mod.draw_schedule(**kw)]
    except (RuntimeError, ValueError) as e:      # a wedged or invalid draw
        return f"{type(e).__name__}: {e}"


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 10_000), n_events=st.integers(0, 9),
       n_devices=st.sampled_from([2, 4, 6]), n_spares=st.integers(0, 2),
       kinds=st.sampled_from(["serve", "train", "all"]),
       hosts=st.booleans(), min_serving=st.integers(1, 2))
def test_draw_schedule_matches_reference(seed, n_events, n_devices,
                                         n_spares, kinds, hosts,
                                         min_serving):
    kw = dict(seed=seed, n_events=n_events, n_devices=n_devices,
              stage_names=STAGES, n_spares=n_spares, hosts=hosts,
              min_serving=min_serving)
    got = _draw(schedule, HostTopology,
                dict(kw, kinds={"serve": schedule.SERVE_KINDS,
                                "train": schedule.TRAIN_KINDS,
                                "all": schedule.ALL_KINDS}[kinds]))
    want = _draw(ref_schedule, RefHostTopology,
                 dict(kw, kinds={"serve": ref_schedule.SERVE_KINDS,
                                 "train": ref_schedule.TRAIN_KINDS,
                                 "all": ref_schedule.ALL_KINDS}[kinds]))
    assert got == want
    if isinstance(got, list):
        evs = [schedule.ChaosEvent(*e) for e in got]
        assert schedule.horizon_of(evs, settle=5) == \
            ref_schedule.horizon_of([ref_schedule.ChaosEvent(*e)
                                     for e in got], settle=5)


def test_schedule_taxonomy_and_validation_match_reference():
    for name in ("ALL_KINDS", "SERVE_KINDS", "TRAIN_KINDS"):
        assert getattr(schedule, name) == getattr(ref_schedule, name)
    with pytest.raises(ValueError):
        schedule.draw_schedule(0, n_events=-1, n_devices=2,
                               stage_names=STAGES)
    with pytest.raises(ValueError):
        schedule.draw_schedule(0, n_events=1, n_devices=2, stage_names=[])
    with pytest.raises(ValueError):
        schedule.ChaosEvent(step=0, kind="meteor_strike")


# ------------------------------------------------------------- invariants
def _plans(mod_plan, fault_stage, lane_stage):
    plan = mod_plan.healthy(3, STAGES, target="interpret", n_spares=0)
    plan = plan.with_stage_fault(0, fault_stage, "sw")
    plan = plan.with_stage_fault(1, lane_stage, "sw")
    return plan


@pytest.mark.parametrize("lane_stage", ["flash_attention", "swiglu_mlp"])
def test_invariant_checkers_match_reference(lane_stage):
    reqs = [types.SimpleNamespace(rid=r) for r in range(5)]
    comps = {0: 1, 2: 1, 3: 1}
    fault = LaneFault(kind=STUCK, lanes=(1,), width=64, value=7.5)
    got, want = [], []
    for mod, plan_cls, lf, out in ((inv, FleetPlan, lanefault, got),
                                   (ref_inv, RefFleetPlan, ref_lanefault,
                                    want)):
        lf.reset()
        try:
            fleet = _plans(plan_cls, "swiglu_mlp", lane_stage)
            out.append(mod.check_ladder(fleet, STAGES, healthy="interpret"))
            lf.known_map(lane_stage, fault, base="interpret")
            # the map is registered after the binary fallback: that
            # stage now sits on the wrong rung
            out.append(mod.check_ladder(fleet, STAGES, healthy="interpret"))
            out.append(mod.check_ladder(fleet, STAGES, healthy="sw"))
            evs = [schedule.ChaosEvent(step=4, kind="transient_stage",
                                       device=0, stage="swiglu_mlp"),
                   schedule.ChaosEvent(step=6, kind="transient_stage",
                                       device=2, stage="flash_attention")]
            logs = [[{"stage": "flash_attention",
                      "kind": "transient_recovered"}], []]
            out.append(mod.check_transients(fleet, evs, logs))
            out.append(mod.check_transients(None, evs[1:], logs))
        finally:
            lf.reset()
        out.append(mod.check_no_dropped(reqs, comps))
        out.append(mod.check_no_dropped(reqs[:1], comps))
        out.append(mod.check_fingerprints(["ab", "ab"]))
        out.append(mod.check_fingerprints(["ab", "cd", "ab"]))
        out.append(mod.check_closure(0.4966, 0.5))
        out.append(mod.check_closure(0.3, 0.5, tol=0.1))
        out.append(mod.verdict(out[:4]))
        out.append(mod.mttr_summary([{"mttr_s": 0.05}, {"mttr_s": None},
                                     {"mttr_s": 0.1234567}]))
        out.append(mod.mttr_summary([]))
        with pytest.raises(AssertionError) as ei:
            mod.verdict(out[:6], raise_on_failure=True)
        out.append((type(ei.value).__name__, str(ei.value),
                    ei.value.reports))
    assert got == want
    assert got[0]["ok"] and not got[2]["ok"]   # both verdicts compared


# -------------------------------------------------------------- campaigns
def _scrub_mttr(res):
    """Drop the coordinator drills' wall-clock MTTR (and what folds it)."""
    res = copy.deepcopy(res)
    wall = False
    for m in res.get("mttr", ()):
        if m["kind"] == schedule.COORD_STALL:
            m.pop("mttr_s")
            wall = True
    if wall and res.get("mttr_summary"):
        res["mttr_summary"] = {"n": res["mttr_summary"]["n"]}
    return res


@pytest.fixture(scope="module")
def serve_runs(setup):
    rcfg, jparams, cfg, tparams = setup
    reg = obs_metrics.Registry()
    with obs_metrics.use(reg), \
            obs_metrics.label_scope(section="serve_resident"):
        got = serve_campaign(SEED, failover=RESIDENT, params=tparams,
                             cfg=cfg, device="cpu", **SMOKE)
    with ref_metrics.use(ref_metrics.Registry()):
        want = ref_campaign.serve_campaign(SEED, failover=RESIDENT,
                                           params=jparams, cfg=rcfg,
                                           **SMOKE)
    return got, want, reg.snapshot()


def test_serve_campaign_matches_reference(serve_runs):
    got, want, _ = serve_runs
    assert got["invariants"]["ok"], got["invariants"]["reports"]
    assert [e["kind"] for e in got["schedule"]] == \
        ["lane_fault", "transient_stage", "coord_stall"]
    assert got["traffic"]["completed"] == got["traffic"]["requests"] == 30
    assert got["traffic"]["requeued"] > 0
    assert _scrub_mttr(got) == _scrub_mttr(want)
    for m in got["mttr"]:
        if m["kind"] == schedule.COORD_STALL:
            assert 0 < m["mttr_s"] < 5.0        # bounded, not a 120 s block
    assert lanefault.injection("swiglu_mlp") is None      # cleaned up
    assert lanefault.fault_map("swiglu_mlp") is None


def test_serve_telemetry_reproduces_the_campaign(serve_runs):
    """The run's snapshot reproduces the campaign's own MTTR and goodput
    summaries exactly, and the reference's reporter renders the port's
    snapshot as the port's does."""
    got, _, snap = serve_runs
    assert obs_report.mttr_summary(snap, section="serve_resident") == \
        got["mttr_summary"]
    g = obs_report.goodput_summary(snap, section="serve_resident")
    assert (g["completed"], g["expired"]) == \
        (got["traffic"]["completed"], got["traffic"]["expired"])
    assert round(g["throughput_tok_s"], 2) == \
        got["traffic"]["throughput_tok_s"]
    assert round(g["virtual_time_s"], 2) == got["traffic"]["virtual_time_s"]
    assert obs_report.counter_value(snap, "kv_retries_total", op="get") > 0
    assert obs_report.counter_value(snap, "coord_timeouts_total",
                                    host="1") > 0
    health = obs_report.fleet_health(snap)
    assert health == ref_report.fleet_health(snap)
    assert obs_report.render(health) == ref_report.render(health)
    assert obs_report.families(snap) == ref_report.families(snap)


def test_serve_campaign_recompile_invariants_green(setup):
    _, _, cfg, tparams = setup
    r = serve_campaign(SEED, failover=RECOMPILE, params=tparams, cfg=cfg,
                       device="cpu", **SMOKE)
    assert r["invariants"]["ok"], r["invariants"]["reports"]
    assert r["traffic"]["completed"] == r["traffic"]["requests"]


def test_run_campaign_snapshot_renders_through_the_cli(tmp_path, capsys):
    """``run_campaign``'s telemetry written as JSON and rendered by the
    CLI's ``main`` (``python -m repro_torch.obs.report``): the per-section
    MTTR and goodput lines carry the campaigns' own summaries, and the
    reference's CLI renders the same file alike."""
    res = run_campaign(SEED, smoke=True, ckpt_dir=str(tmp_path / "ck"),
                       device="cpu")
    assert res["invariants"] == {"ok": True, "failed": []}
    assert res["events_total"] == 3 + 3 + 2 + 1
    path = tmp_path / "telemetry.json"
    path.write_text(json.dumps(res["telemetry"]))
    text = {}
    for mod in (obs_report, ref_report):
        assert mod.main([str(path)]) == 0
        text[mod.__name__] = capsys.readouterr().out
    assert text["repro_torch.obs.report"] == text["repro.obs.report"]
    health = obs_report.fleet_health(
        res["telemetry"]["metrics"],
        obs_report.load_snapshot(str(path))["trace"])
    sections = {"serve_recompile": res["serve"][RECOMPILE],
                "serve_resident": res["serve"][RESIDENT],
                "train": res["train"], "coordinator": res["coordinator"]}
    for sec, part in sections.items():
        m = part["mttr_summary"]
        assert health["mttr"][sec] == m
        assert (f"mttr[{sec}]  n={m['n']} mean={m['mean_s']}s "
                f"max={m['max_s']}s") in text["repro_torch.obs.report"]
    for mode in (RECOMPILE, RESIDENT):
        g, t = health["serve"][f"serve_{mode}"], res["serve"][mode]["traffic"]
        assert round(g["throughput_tok_s"], 2) == t["throughput_tok_s"]
        assert f"serve[serve_{mode}]  goodput={g['goodput_tok_s']:.2f}" \
            in text["repro_torch.obs.report"]
    assert health["closure"]["measured_ratio"] == \
        res["closure"]["measured_ratio"]
    assert health["trace"]["events"] == len(res["telemetry"]["trace"])
