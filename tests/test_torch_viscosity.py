"""Viscosity layer of the port against the reference: route strings, lane
faults, the degradation ladder, fault state and plan-keyed dispatch.
Integer/boolean results must be equal; float corruption is compared
exactly (both apply the same float32 arithmetic to the same values)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.kernels.flash_attention  # noqa: F401  (registers ops)
import repro.kernels.swiglu  # noqa: F401
from repro.core import fault as ref_fault
from repro.core import routing as ref_routing
from repro.viscosity import lanefault as ref_lf
from repro.viscosity import lang as ref_lang

import repro_torch.kernels.flash_attention  # noqa: F401  (registers ops)
import repro_torch.kernels.swiglu  # noqa: F401
from repro_torch.core import fault as pt_fault
from repro_torch.core import routing as pt_routing
from repro_torch.core.oobleck import Dispatcher
from repro_torch.viscosity import lanefault as pt_lf
from repro_torch.viscosity import lang as pt_lang

STAGES = ["flash_attention", "swiglu_mlp"]


@pytest.fixture(autouse=True)
def _clean_registries():
    ref_lf.reset()
    pt_lf.reset()
    yield
    ref_lf.reset()
    pt_lf.reset()


def test_route_strings_equal():
    for name in ("HW", "SW", "INTERPRET", "DEGRADED_REMAP",
                 "DEGRADED_REDUCED", "DEGRADED_TARGETS"):
        assert getattr(pt_lang, name) == getattr(ref_lang, name)
    assert pt_lf.KINDS == ref_lf.KINDS and pt_lf.RUNGS == ref_lf.RUNGS
    assert pt_routing.TARGETS == ref_routing.TARGETS


@pytest.mark.parametrize("kind", ["stuck", "dropped_mac", "gain"])
@pytest.mark.parametrize("shape", [(3, 16), (2, 5, 16), (4, 15)])
def test_lane_fault_apply_matches(kind, shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    args = dict(kind=kind, lanes=(1, 7, 7, 14), width=16, value=-2.5,
                gain=0.75)
    rf, pf = ref_lf.LaneFault(**args), pt_lf.LaneFault(**args)
    assert rf.lanes == pf.lanes and rf.survivors() == pf.survivors()
    want = np.asarray(rf.apply(jnp.asarray(x)))
    got = pf.apply(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        pf.lane_mask(torch.from_numpy(x)).numpy(),
        np.asarray(rf.lane_mask(jnp.asarray(x))))
    ints = torch.arange(16)                    # non-float: identity
    assert pf.apply(ints) is ints


@pytest.mark.parametrize("bad", [dict(kind="melted", lanes=(0,), width=4),
                                 dict(kind="stuck", lanes=(), width=4),
                                 dict(kind="stuck", lanes=(4,), width=4),
                                 dict(kind="stuck", lanes=(0, 1), width=2),
                                 dict(kind="stuck", lanes=(0,), width=1)])
def test_lane_fault_validation_matches(bad):
    with pytest.raises(ValueError):
        ref_lf.LaneFault(**bad)
    with pytest.raises(ValueError):
        pt_lf.LaneFault(**bad)


def test_rung_for_and_degraded_plan_match():
    for n in range(1, 6):
        assert pt_lf.rung_for(n) == ref_lf.rung_for(n)
    for lf in (ref_lf, pt_lf):
        with pytest.raises(ValueError):
            lf.rung_for(0)
    fault = dict(kind="stuck", lanes=(2,), width=8)
    for counts in ({"swiglu_mlp": 1}, {"swiglu_mlp": 2, "flash_attention": 1},
                   {"swiglu_mlp": 3, "flash_attention": 5}):
        ref_plan = ref_routing.RoutingPlan.for_stages(STAGES, "hw")
        pt_plan = pt_routing.RoutingPlan.for_stages(STAGES, "hw")
        with ref_lf.known_map("swiglu_mlp", ref_lf.LaneFault(**fault)), \
                pt_lf.known_map("swiglu_mlp", pt_lf.LaneFault(**fault)):
            want = ref_lf.degraded_plan(ref_plan, counts)
            got = pt_lf.degraded_plan(pt_plan, counts)
        assert got.assignments == want.assignments


def test_plan_validation_matches():
    for routing, lang_reg in ((ref_routing, ref_lang.REGISTRY),
                              (pt_routing, pt_lang.REGISTRY)):
        plan = routing.RoutingPlan.make({"swiglu_mlp": "degraded_remap"})
        with pytest.raises(ValueError, match="no lane map"):
            plan.validate(registry=lang_reg)
        with pytest.raises(ValueError, match="unknown viscosity op"):
            routing.RoutingPlan.make({"nope": "hw"}).validate(
                registry=lang_reg)
        with pytest.raises(ValueError, match="unknown lowering target"):
            routing.RoutingPlan.make({"swiglu_mlp": "fpga"})
    a = pt_routing.RoutingPlan.make({"b": "sw", "a": "hw"})
    b = pt_routing.RoutingPlan.make({"a": "hw", "b": "sw"})
    assert a == b and hash(a) == hash(b)


def test_plan_fallback_stages_and_resolve_match():
    """``fallback_stages`` and ``resolve`` (the reference's
    ``tests/test_oobleck.py`` plan case, over both packages)."""
    plans = []
    for routing, fault in ((ref_routing, ref_fault), (pt_routing, pt_fault)):
        sig = fault.FaultSignature.healthy(["s0", "s1", "s2"]).with_fault(
            "s1")
        plan = routing.RoutingPlan.from_signature(sig, healthy="interpret")
        assert plan.fallback_stages() == ("s1",)
        assert plan.with_fault("s2").fallback_stages() == ("s1", "s2")
        assert plan.fallback_stages("interpret") == ("s0", "s2")
        plans.append(plan)
    assert plans[0].assignments == plans[1].assignments
    # resolve(spec) == spec.lower(target_for(spec.name)), every target
    spec = pt_lang.OpSpec(name="toy", ref=lambda x: x + 1,
                          kernel=lambda x: x + 2)
    ref_spec = ref_lang.OpSpec(name="toy", ref=lambda x: x + 1,
                               kernel=lambda x: x + 2)
    for target in ("hw", "sw"):
        got = pt_routing.RoutingPlan.make({"toy": target}).resolve(spec)
        want = ref_routing.RoutingPlan.make({"toy": target}).resolve(
            ref_spec)
        assert got(0) == want(0) == spec.lower(target)(0) == \
            (2 if target == "hw" else 1)
    with pytest.raises(KeyError, match="not in routing plan"):
        pt_routing.RoutingPlan.make({"other": "hw"}).resolve(spec)


def test_fault_state_matches():
    rs, ps = ref_fault.FaultState(), pt_fault.FaultState()
    for st in (rs, ps):
        st.mark("swiglu_mlp", step=3)
        st.mark("swiglu_mlp", step=4)
        st.note("flash_attention", step=4)
        st.clear("swiglu_mlp", step=5)
    assert ps.log == rs.log
    assert ps.counts(STAGES) == rs.counts(STAGES)
    assert ps.signature(STAGES).routes == rs.signature(STAGES).routes
    assert pt_fault.FaultState.merge_logs(ps.log, ps.log[::-1]) == \
        ref_fault.FaultState.merge_logs(rs.log, rs.log[::-1])


def test_dispatcher_counts_builds_and_evicts():
    builds = []
    d = Dispatcher(lambda key: builds.append(key) or (lambda: key),
                   capacity=2)
    for key in ("a", "b", "a", "c", "b"):
        assert d(key) == key
    assert builds == ["a", "b", "c", "b"] and d.compiles == 4
    assert d.cached_keys() == ["c", "b"]


def test_resident_route_reads_host_bit_per_call():
    spec = pt_lang.OpSpec(name="toy", ref=lambda x: x + 1,
                          kernel=lambda x: x + 2)
    mask = [True]
    plan = pt_routing.RoutingPlan.make({"toy": "hw"})
    fn = spec.lower(plan.resident_routes(mask, ["toy"])["toy"])
    assert fn(0) == 2
    mask[0] = False                # failover: no rebuild of ``fn``
    assert fn(0) == 1
    sw_plan = pt_routing.RoutingPlan.make({"toy": "sw"})
    assert spec.lower(sw_plan.resident_routes(mask, ["toy"])["toy"]) \
        is spec.ref
