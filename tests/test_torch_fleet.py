"""The port's fleet layer on the CPU, against the reference.

* Scheduling parity with no model involved: the same ``FleetPlan`` /
  ``SparePool`` transitions, ``rung_occupancy``, ``fleet_fingerprint``
  strings, merged and replayed event logs, ``shard_bounds``, the mesh and
  host views, and the ``core.datacenter`` models (``DegradationModel``,
  ``simulate_fleet``, ``replay_trace``, the analytic expectations, the
  Fig. 2 sweep) give the same values in both packages.
* The reference's 8-scenario x 2-mode matrix on the port's SW route:
  nothing dropped, every completion bit-identical to the port's
  ``reference_decode``.
* Against the reference ``FleetServeEngine`` on the same converted f32
  params: equal scheduling (admission and finish steps, devices, tokens
  per step, requeues, the event log) and equal tokens, where a differing
  token must sit on a near-tie of the reference's logits (top-2 gap below
  the f32 tolerance 2e-5), as in ``test_torch_serve.py``.
* ``FleetHarness``: the measured ratio equals the reference's and lies
  within 15% of the analytic one.
* RESIDENT fleets share one decode model, and each device routes on its
  own health bits: with a stage fault on device 1 only, device 0's calls
  run the kernel route's wrapper and device 1's the SW oracle.
* Two hosts emulated in one process (two engines, one thread each, over
  an in-memory coordinator) merge to the single-host run's completions.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import datacenter as ref_dc
from repro.core.routing import FleetPlan as RefFleetPlan
from repro.core.routing import SparePool as RefSparePool
from repro.core.routing import rung_occupancy as ref_rung_occupancy
from repro.launch import distributed as ref_dist
from repro.launch.mesh import FleetMeshView as RefMeshView
from repro.launch.sharding import shard_bounds as ref_shard_bounds
from repro.models import build_model as ref_build_model
from repro.serve import FleetConfig as RefFleetConfig
from repro.serve import FleetServeEngine as RefFleetServeEngine
from repro.serve import ServeConfig as RefServeConfig
from repro.viscosity import lanefault as ref_lanefault

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import datacenter as dc
from repro_torch.core.routing import FleetPlan, SparePool, rung_occupancy
from repro_torch.kernels.swiglu import ops as swiglu_ops
from repro_torch.launch import distributed as dist
from repro_torch.launch.mesh import FleetMeshView
from repro_torch.launch.sharding import shard_bounds
from repro_torch.serve import (RECOMPILE, RESIDENT, FleetConfig,
                               FleetServeEngine, Request, ServeConfig,
                               reference_decode, synthetic_workload)
from repro_torch.serve.engine import _ShadowWorker
from repro_torch.viscosity import HW, INTERPRET, SW, lanefault
from _torch_threads import one_torch_thread  # noqa: F401

ARCH = "qwen1.5-4b-smoke"
STAGES = ["flash_attention", "swiglu_mlp"]
MAX_LEN = 48
LOGITS_TOL = 2e-5

# The reference's scenario matrix (tests/test_fleet_scenarios.py): name ->
# (fleet kwargs, events).  Devices: workers 0..n-2, spare = last.
SCENARIOS = {
    "single_fault": (dict(), {3: [("stage", 0, "flash_attention")]}),
    "burst_two_same_step": (dict(), {3: [("stage", 0, "flash_attention"),
                                         ("stage", 1, "swiglu_mlp")]}),
    "fault_then_recover": (dict(), {2: [("stage", 0, "flash_attention")],
                                    6: [("recover", 0)]}),
    "fault_on_spare": (dict(), {2: [("stage", 0, "flash_attention")],
                                5: [("stage", 2, "swiglu_mlp")]}),
    "spares_exhausted": (dict(), {2: [("stage", 0, "flash_attention")],
                                  4: [("stage", 1, "flash_attention")],
                                  6: [("stage", 1, "swiglu_mlp")]}),
    "device_loss_with_spare": (dict(), {3: [("device", 0)]}),
    "device_loss_no_spare": (dict(n_spares=0, n_devices=2),
                             {3: [("device", 1)]}),
    "multi_wave": (dict(), {2: [("stage", 0, "flash_attention")],
                            5: [("device", 1)],
                            8: [("recover", 0)]}),
}


@pytest.fixture(scope="module")
def setup():
    params = ref_build_model(ref_get_config(ARCH)).init(
        jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    cfg = get_config(ARCH)
    tparams = params_from_jax(np_params, device="cpu")
    reqs = _workload(cfg.vocab_size)
    refs = {r.rid: reference_decode(cfg, tparams, r.prompt,
                                    r.max_new_tokens, max_len=MAX_LEN)
            for r in reqs}
    return cfg, np_params, tparams, reqs, refs


def _workload(vocab, n=8, seed=0):
    return synthetic_workload(vocab, n, np.random.default_rng(seed),
                              min_prompt=6, max_prompt=8, min_new=4,
                              max_new=7, arrival_every=1, per_arrival=2)


def _events(events):
    return {k: list(v) for k, v in events.items()}


# ------------------------------------------------- plan algebra (no model)
def _plan_state(fp, fingerprint):
    return ([(p.assignments, p.default) for p in fp.plans], fp.pool.spares,
            fp.pool.assignments, fp.quarantined, fp.fault_counts,
            fp.stage_faults, fp.serving(), fp.device_mask(), fp.pool.free(),
            fp.pool.in_service(), fp.compile_key(), fingerprint(fp))


def _apply_op(fp, op, topo_devices):
    kind, d, stage = op
    if kind == "stage":
        return fp.with_stage_fault(d, stage)
    if kind == "device":
        return fp.with_device_fault(d)
    if kind == "host":
        return fp.with_host_fault(topo_devices(d))
    if kind == "stage_recover":
        return fp.with_stage_recovery(d, stage, target=HW)
    return fp.with_recovery(d, STAGES, target=HW)


@pytest.mark.parametrize("seed", range(4))
def test_fleet_plan_transitions_match_reference(seed):
    """A random walk of transitions over a 6-device fleet with two spares,
    with a lane map on one stage (the DEGRADED ladder): after every step
    both packages hold the same plan (or both refuse the transition), the
    same occupancy and the same fingerprint string."""
    rng = np.random.default_rng(seed)
    lf = dict(kind="dropped_mac", lanes=(1, 5), width=32)
    lanefault.set_map("flash_attention", lanefault.LaneFault(**lf), base=SW)
    ref_lanefault.set_map("flash_attention", ref_lanefault.LaneFault(**lf),
                          base=SW)
    topo, rtopo = dist.HostTopology(3, 2), ref_dist.HostTopology(3, 2)
    try:
        fp = FleetPlan.healthy(6, STAGES, target=HW, n_spares=2)
        rfp = RefFleetPlan.healthy(6, STAGES, target=HW, n_spares=2)
        kinds = ["stage", "stage", "stage", "device", "host",
                 "stage_recover", "recover"]
        refused = 0
        for _ in range(24):
            op = (kinds[rng.integers(len(kinds))], int(rng.integers(6)),
                  STAGES[rng.integers(2)])
            if op[0] == "host":
                op = ("host", int(rng.integers(3)), "")
            try:
                want = _apply_op(rfp, op, rtopo.devices_of)
            except (ValueError, KeyError) as e:
                with pytest.raises(type(e)):
                    _apply_op(fp, op, topo.devices_of)
                refused += 1
                continue
            fp, rfp = _apply_op(fp, op, topo.devices_of), want
            assert _plan_state(fp, dist.fleet_fingerprint) == \
                _plan_state(rfp, ref_dist.fleet_fingerprint), op
            assert rung_occupancy(fp) == ref_rung_occupancy(rfp)
            assert fp == FleetPlan(fp.plans, fp.pool, fp.quarantined,
                                   fp.fault_counts, fp.stage_faults)
            assert hash(fp) == hash(FleetPlan(
                fp.plans, fp.pool, fp.quarantined, fp.fault_counts,
                fp.stage_faults))
        assert refused < 24
    finally:
        lanefault.reset()
        ref_lanefault.reset()


def test_spare_pool_matches_reference():
    pool, rpool = SparePool((5, 3, 4)), RefSparePool((5, 3, 4))
    for dev, exclude in ((0, ()), (1, (4,)), (2, ()), (6, ())):
        (pool, got), (rpool, want) = (pool.assign(dev, exclude),
                                      rpool.assign(dev, exclude))
        assert got == want
        assert (pool.spares, pool.assignments, pool.free(),
                pool.in_service()) == (rpool.spares, rpool.assignments,
                                       rpool.free(), rpool.in_service())
    assert pool.spare_for(1) == rpool.spare_for(1) == 5
    assert pool.release(1).assignments == rpool.release(1).assignments
    with pytest.raises(ValueError):
        SparePool(spares=(3,), assignments=((0, 3), (1, 3)))
    with pytest.raises(ValueError):
        SparePool(spares=(3,), assignments=((0, 7),))


def test_event_logs_merge_and_replay_like_reference():
    """The property test's event multiset, split across two host logs in
    reverse order: the same canonical merge, the same final plan (by
    fingerprint) and the same dropped events; the wire form round-trips."""
    wire = [(2, 0, 0, "stage", 0, STAGES[0]), (2, 1, 0, "device", 1, ""),
            (4, 0, 1, "stage", 2, STAGES[1]), (4, 1, 1, "host", 1, ""),
            (5, 0, 2, "recover", 0, ""), (6, 1, 2, "device", 3, ""),
            (6, 1, 3, "device", 3, "")]
    out = []
    for mod, target in ((dist, INTERPRET), (ref_dist, INTERPRET)):
        events = [mod.FleetEvent(*w) for w in wire]
        merged = mod.merge_event_logs(events[4:][::-1], events[:4])
        assert merged == mod.merge_event_logs(events)
        assert tuple(mod.FleetEvent.from_wire(e.to_wire())
                     for e in merged) == merged
        plan_cls = FleetPlan if mod is dist else RefFleetPlan
        base = plan_cls.healthy(6, STAGES, target=target, n_spares=2)
        plan, dropped = mod.replay_log(
            base, events[::-1], STAGES, target=target,
            topology=mod.HostTopology(num_hosts=3, devices_per_host=2))
        out.append(([e.to_wire() for e in merged],
                    [e.engine_tuple() for e in merged],
                    mod.fleet_fingerprint(plan),
                    [e.to_wire() for e in dropped]))
    assert out[0] == out[1]
    assert out[0][3]                          # a duplicate was dropped
    with pytest.raises(ValueError):
        dist.FleetEvent(0, 0, 0, "melted", 1)
    with pytest.raises(ValueError):
        dist.FleetEvent(0, 0, 0, "stage", 1)


@pytest.mark.parametrize("n_items", [0, 7, 9, 16])
def test_shard_bounds_and_views_match_reference(n_items):
    fp = FleetPlan.healthy(4, STAGES, n_spares=1).with_device_fault(0)
    rfp = RefFleetPlan.healthy(4, STAGES, n_spares=1).with_device_fault(0)
    mask = fp.device_mask()
    assert mask == rfp.device_mask() == (False, True, True, True)
    for owned in (None, (0, 1), (2, 3)):
        assert shard_bounds(n_items, mask, owned=owned) == \
            ref_shard_bounds(n_items, mask, owned=owned)
    view, rview = FleetMeshView.from_plan(fp), RefMeshView.from_plan(rfp)
    assert dataclasses.astuple(view) == dataclasses.astuple(rview)
    assert view.serving() == rview.serving()
    devs = [torch.device("cpu", i) for i in range(4)]
    assert view.serving_devices(devs) == devs[1:]
    with pytest.raises(RuntimeError, match="short"):
        view.serving_devices(devs[:3])
    for host_id in (None, 0, 1):
        hv = dist.HostView.of(fp, dist.HostTopology(2, 2, host_id=host_id))
        rhv = ref_dist.HostView.of(rfp, ref_dist.HostTopology(
            2, 2, host_id=host_id))
        assert (hv.host_mask(0), hv.host_mask(1), hv.serving_on(1),
                hv.hosts_serving(), hv.local_serving(),
                hv.shard_bounds(n_items)) == \
            (rhv.host_mask(0), rhv.host_mask(1), rhv.serving_on(1),
             rhv.hosts_serving(), rhv.local_serving(),
             rhv.shard_bounds(n_items))
    # a partitioned host maps its block onto its own device slots
    h1 = dist.HostView.of(FleetPlan.healthy(4, STAGES),
                          dist.HostTopology(2, 2, host_id=1))
    assert h1.local_serving_devices(devs[:2]) == devs[:2]
    with pytest.raises(RuntimeError, match="short"):
        h1.local_serving_devices(devs[:1])


# ------------------------------------------------ datacenter (no model)
def test_datacenter_models_match_reference():
    mc = [m.simulate_fleet(300, 200, 0.01, mode=mode, seed=3, max_faults=3,
                           replace_failed=repl, record_trace=True)
          for m in (dc, ref_dc)
          for mode, repl in (("vfa", True), ("sfa", True), ("vfa", False))]
    assert [dataclasses.astuple(r) for r in mc[:3]] == \
        [dataclasses.astuple(r) for r in mc[3:]]
    for args in ((1000, 1460, 1e-4, 3), (100, 50, 0.2, 2),
                 (10, 10_000, 0.5, 3)):
        assert dc.expected_replacements(*args) == \
            ref_dc.expected_replacements(*args)
    assert dc.expected_throughput(500, 1e-3) == \
        ref_dc.expected_throughput(500, 1e-3)
    assert dc.chips_to_buy(100, 2 / 3) == ref_dc.chips_to_buy(100, 2 / 3)
    for mc_flag in (False, True):
        assert dc.fig2_sweep([1e-3, 1e-5], n_chips=500, ticks=300,
                             monte_carlo=mc_flag) == \
            ref_dc.fig2_sweep([1e-3, 1e-5], n_chips=500, ticks=300,
                              monte_carlo=mc_flag)
    model, rmodel = (dc.DegradationModel(partial=((("flash_attention",
                                                    "degraded_remap"), 0.9),)),
                     ref_dc.DegradationModel(partial=((("flash_attention",
                                                        "degraded_remap"),
                                                       0.9),)))
    rungs = (("flash_attention", "degraded_remap"),
             ("swiglu_mlp", "degraded_reduced"))
    for k in range(5):
        for r in (rungs[:0], rungs[:1], rungs):
            assert model.factor(k, r) == rmodel.factor(k, r)
            assert model.slot_cap(4, k, r) == rmodel.slot_cap(4, k, r)
    plan = FleetPlan.healthy(1, STAGES).plans[0].with_target(
        "swiglu_mlp", "degraded_reduced")
    assert dc.DegradationModel.rungs_of(plan) == (("swiglu_mlp",
                                                   "degraded_reduced"),)
    trace = dc.simulate_fleet(4, 60, 0.05, seed=2, record_trace=True).trace
    assert len(trace) >= 4
    for kw in (dict(n_spares=1, slots_per_device=4),
               dict(n_spares=0, slots_per_device=4, max_faults=3,
                    lane_mapped=("flash_attention",)),
               dict(n_spares=1, slots_per_device=2, n_hosts=2,
                    host_loss={20: 0})):
        if "lane_mapped" in kw:
            a = dc.replay_trace(trace, n_workers=3, ticks=60,
                                stage_names=STAGES, model=model, **kw)
            b = ref_dc.replay_trace(trace, n_workers=3, ticks=60,
                                    stage_names=STAGES, model=rmodel, **kw)
        else:
            a = dc.replay_trace(trace, n_workers=3, ticks=60,
                                stage_names=STAGES, **kw)
            b = ref_dc.replay_trace(trace, n_workers=3, ticks=60,
                                    stage_names=STAGES, **kw)
        assert a.events == b.events and a.n_dropped == b.n_dropped
        assert a.capacity.tolist() == b.capacity.tolist()
        assert a.mean_ratio == b.mean_ratio
        assert a.healthy_capacity == b.healthy_capacity


# ------------------------------------------------------ scenario matrix
@pytest.mark.parametrize("mode", [RECOMPILE, RESIDENT])
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scenario_no_drops_bit_identical(setup, scenario, mode):
    """Every multi-fault sequence of the reference's matrix, in both
    failover modes, on the SW route: nothing dropped, every completion
    bit-identical to the port's single-request ``reference_decode``."""
    cfg, _, params, reqs, refs = setup
    fleet_kw, events = SCENARIOS[scenario]
    fcfg = FleetConfig(**dict(dict(n_devices=3, n_spares=1), **fleet_kw))
    eng = FleetServeEngine(cfg, params, ServeConfig(
        max_len=MAX_LEN, max_slots=2, hw_route=SW, failover=mode), fcfg,
        device="cpu")
    done, stats = eng.serve(reqs, events=_events(events))
    assert sorted(done) == sorted(r.rid for r in reqs)     # no drops
    for r in reqs:
        np.testing.assert_array_equal(done[r.rid].tokens, refs[r.rid])
        assert 0 <= done[r.rid].device < fcfg.n_devices
    if scenario == "single_fault":
        assert stats["quarantined"] == [0]
        assert stats["spares_in_service"] == [2]
    if scenario == "fault_then_recover":
        assert eng.fleet.pool.free() == (2,) and eng.fleet.quarantined == ()
    if mode == RESIDENT:
        assert eng._decode.compiles == 1
    # one copy of the weights, one cache pool per device
    assert all(w.params is eng.params for w in eng.workers)
    assert len({id(w._caches["k"]) for w in eng.workers}) == len(eng.workers)


# --------------------------------------------- against the JAX fleet
def _ref_top2_gap(cfg, params, prompt, tokens, j):
    """The reference model's top-2 logit gap at completion step ``j``,
    teacher-forced on the reference's own tokens."""
    model = ref_build_model(cfg)
    P = len(prompt)
    logits, cache = model.prefill(params, {
        "tokens": jnp.asarray(prompt, jnp.int32)[None],
        "cache": model.init_cache(1, MAX_LEN)})
    for i in range(j):
        logits, cache = model.decode_step(
            params, cache, jnp.asarray([[tokens[i]]], jnp.int32),
            jnp.int32(P + i))
    top = np.sort(np.asarray(logits[0, -1], np.float32))[-2:]
    return float(top[1] - top[0])


@pytest.mark.parametrize("scenario", ["fault_on_spare", "multi_wave"])
def test_scheduling_and_tokens_match_the_jax_fleet(setup, scenario):
    cfg, np_params, _, reqs, _ = setup
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    rcfg32 = dataclasses.replace(ref_get_config(ARCH), dtype="float32")
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    _, events = SCENARIOS[scenario]
    ref = RefFleetServeEngine(rcfg32, jparams, RefServeConfig(
        max_len=MAX_LEN, max_slots=2, hw_route=SW),
        RefFleetConfig(n_devices=3, n_spares=1))
    ref_done, ref_stats = ref.serve(reqs, events=_events(events))
    eng = FleetServeEngine(cfg32, params_from_jax(np_params, device="cpu"),
                           ServeConfig(max_len=MAX_LEN, max_slots=2,
                                       hw_route=SW),
                           FleetConfig(n_devices=3, n_spares=1),
                           device="cpu")
    done, stats = eng.serve(reqs, events=_events(events))
    assert stats["requeued"] > 0
    for key in ("per_step_tokens", "requeued", "occupancy", "capacity",
                "per_device_tokens", "admitted", "steps", "quarantined",
                "spares_in_service", "late_events"):
        assert stats[key] == ref_stats[key], key
    assert eng.event_log == ref.event_log
    assert dist.fleet_fingerprint(eng.fleet) == \
        ref_dist.fleet_fingerprint(ref.fleet)
    assert sorted(done) == sorted(ref_done)
    for r in reqs:
        got, want = done[r.rid], ref_done[r.rid]
        assert (got.admitted_step, got.finished_step, got.device,
                got.placeholder) == (want.admitted_step, want.finished_step,
                                     want.device, want.placeholder)
        diff = np.flatnonzero(got.tokens != want.tokens)
        if diff.size:
            gap = _ref_top2_gap(rcfg32, jparams, r.prompt, want.tokens,
                                diff[0])
            assert gap < LOGITS_TOL, (r.rid, diff[0], gap)


def test_fleet_harness_matches_reference_and_analytic(setup):
    """A Monte-Carlo fault trace replayed through both packages' fleets:
    the measured ratio (tokens per step, faulted over healthy) is the
    reference's exactly (scheduling is value-independent) and within 15%
    of the analytic VFA curve; no request is dropped."""
    cfg, np_params, params, _, _ = setup
    slots, horizon, deg = 4, 12, (1.0, 0.38, 0.19)
    mc = dc.simulate_fleet(3, horizon, 0.08, degradation=deg,
                           replace_failed=False, seed=1, record_trace=True)
    assert mc.trace, "seed must produce at least one fault"
    out = []
    for mod, eng in (
            (dc, FleetServeEngine(
                cfg, params, ServeConfig(max_len=32, max_slots=slots),
                FleetConfig(n_devices=3, degradation=deg), device="cpu")),
            (ref_dc, RefFleetServeEngine(
                ref_get_config(ARCH),
                jax.tree_util.tree_map(jnp.asarray, np_params),
                RefServeConfig(max_len=32, max_slots=slots),
                RefFleetConfig(n_devices=3, degradation=deg)))):
        rep = mod.replay_trace(mc.trace, n_workers=3, ticks=horizon,
                               stage_names=STAGES, degradation=deg,
                               slots_per_device=slots)
        rng = np.random.default_rng(1)
        reqs = [Request(rid=i, prompt=rng.integers(
            0, cfg.vocab_size, size=8).astype(np.int32), max_new_tokens=6)
            for i in range(3 * slots * horizon * 3 // (2 * 6))]
        res = mod.FleetHarness(eng, rep, horizon=horizon).run(reqs)
        assert sorted(res["completions"][1]) == [r.rid for r in reqs]
        out.append(res)
    got, want = out
    assert got["analytic_ratio"] == want["analytic_ratio"] < 1.0
    assert got["measured_ratio"] == want["measured_ratio"]
    assert got["requeued"] == want["requeued"]
    assert got["rel_err"] <= 0.15, got["rel_err"]


# ------------------------------------------- RESIDENT: one shared model
def test_resident_fleet_routes_each_device_on_its_own_mask(setup,
                                                           monkeypatch):
    """One resident decode model serves every device, and each device's
    calls read its own health bits: with ``swiglu_mlp`` faulted on device
    1 only (no spare), every one of device 0's prefills and ticks runs the
    kernel route's wrapper and none of device 1's does.  The tokens equal
    a RECOMPILE fleet's on the same scenario."""
    cfg, _, params, reqs, _ = setup
    calls = {}
    current = [None]
    real = swiglu_ops.swiglu_fused

    def counted(*a, **kw):
        calls[current[0]] = calls.get(current[0], 0) + 1
        return real(*a, **kw)
    monkeypatch.setattr(swiglu_ops, "swiglu_fused", counted)

    served = {}
    for mode in (RECOMPILE, RESIDENT):
        calls.clear()
        eng = FleetServeEngine(cfg, params, ServeConfig(
            max_len=MAX_LEN, max_slots=2, hw_route=HW, failover=mode),
            FleetConfig(n_devices=2, n_spares=0), device="cpu")
        runs = {0: 0, 1: 0}
        for d, w in enumerate(eng.workers):
            for name in ("admit", "decode_tick"):
                def wrapped(*a, _f=getattr(w, name), _d=d, **kw):
                    current[0] = _d
                    res = _f(*a, **kw)
                    if isinstance(res, int) or res["active"]:
                        runs[_d] += 1        # one model call: prefill/tick
                    current[0] = None
                    return res
                setattr(w, name, wrapped)
        eng.inject_stage_fault(1, "swiglu_mlp")
        assert eng.fleet.serving() == (0, 1)          # degraded in place
        done, stats = eng.serve(reqs)
        assert sorted(done) == sorted(r.rid for r in reqs)
        assert runs[0] > 0 and runs[1] > 0
        served[mode] = {r: done[r].tokens.tolist() for r in done}
        assert calls == {0: runs[0] * cfg.num_layers}, (mode, calls, runs)
        if mode == RESIDENT:
            assert stats["decode_compiles"] == 1
            assert eng._prefill.compiles == 1
            assert eng.workers[0]._health is eng.workers[1]._health
    assert served[RECOMPILE] == served[RESIDENT]


# ------------------------------------------- two hosts in one process
class _Board:
    """In-memory all-to-all exchange for hosts run as threads."""

    def __init__(self, n):
        self.n = n
        self.rounds = {}
        self.lock = threading.Lock()
        self.barrier = threading.Barrier(n, timeout=120)


class _MemCoordinator:
    def __init__(self, board, host_id):
        self.board, self.host_id, self.num_hosts = board, host_id, board.n
        self._round = 0

    def exchange(self, payload):
        r, b = self._round, self.board
        self._round += 1
        with b.lock:
            b.rounds.setdefault(r, [None] * b.n)[self.host_id] = payload
        b.barrier.wait()
        return list(b.rounds[r])


def test_two_hosts_in_one_process_merge_to_the_single_host_run(setup):
    """Host 0 owns workers 0 and 1, host 1 worker 2 and the spare 3; only
    host 0 observes the fault of device 0, which the shared event log
    carries to host 1, whose spare takes the work.  The merged completions
    equal the single-host run's, field for field."""
    cfg, _, params, _, refs = setup
    reqs = _workload(cfg.vocab_size, n=6)
    events = {3: [("device", 0)]}
    scfg = ServeConfig(max_len=MAX_LEN, max_slots=2)
    single = FleetServeEngine(cfg, params, scfg, FleetConfig(
        n_devices=4, n_spares=1, topology=dist.HostTopology(2, 2)),
        device="cpu")
    want, want_stats = single.serve(reqs, events=_events(events))
    board = _Board(2)
    results, errors = {}, []

    def host(h):
        try:
            eng = FleetServeEngine(cfg, params, scfg, FleetConfig(
                n_devices=4, n_spares=1,
                topology=dist.HostTopology(2, 2, host_id=h)),
                coordinator=_MemCoordinator(board, h), device="cpu")
            assert [isinstance(w, _ShadowWorker) for w in eng.workers] == \
                [d // 2 != h for d in range(4)]
            results[h] = eng.serve(reqs, events=_events(events) if h == 0
                                   else {})
        except Exception as e:           # noqa: BLE001 - re-raised below
            errors.append(e)
            board.barrier.abort()

    threads = [threading.Thread(target=host, args=(h,)) for h in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    if errors:
        raise errors[0]
    assert not any(t.is_alive() for t in threads)
    assert set(results) == {0, 1}
    assert want_stats["requeued"] > 0
    for h, (done, stats) in results.items():
        assert stats["fleet_fingerprint"] == \
            dist.fleet_fingerprint(single.fleet)
        assert stats["per_step_tokens"] == want_stats["per_step_tokens"]
        assert sorted(done) == sorted(want)
        for rid, c in done.items():
            w = want[rid]
            assert not c.placeholder
            assert (c.device, c.admitted_step, c.finished_step) == \
                (w.device, w.admitted_step, w.finished_step)
            np.testing.assert_array_equal(c.tokens, w.tokens)
            np.testing.assert_array_equal(c.tokens, refs[rid])
    assert any(c.device == 3 for c in want.values())   # the spare served
