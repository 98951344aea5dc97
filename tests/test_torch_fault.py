"""The port's detection layer against the reference's.

* Probation: the same probe sequences through the reference's and the
  port's ``FaultClassifier`` give the same verdicts, the same fault logs,
  the same metrics snapshot and the same trace (the reference's own tests
  in ``tests/test_chaos.py`` restated: transient and persistent verdicts,
  intermittent promotion and its window, the backoff schedule).
* ``FaultInjector`` kinds, ``InjectionNoOpError``, ``StepGuard`` and
  ``StragglerWatchdog`` on the same numpy inputs.
* ``CanaryChecker`` on the reduced qwen, zamba2 and rwkv6 canary stages,
  fed the reference's canary inputs (``jax.random`` cannot be reproduced
  in torch): ``check_stage`` verdicts, ``localize`` lane maps and the
  ``sweep`` with ``localize=True`` equal the reference's, healthy and
  under each lane-fault kind.  The reference draws the SSD canary from
  N(0, 1), outside the scan's domain (dt < 0, A > 0), where it flags its
  own healthy stage (ROADMAP, "Known failure in the reference"); both
  packages get that draw mapped into the domain instead (dt = softplus,
  A = -sigmoid in (-1, 0), so a chunk's decay stays inside e^88, past
  which the reference's ``ssd_chunked`` gives NaN, ROADMAP queue 3).  The
  port's own canaries pass healthy and fail under every kind.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.fault as R
from repro.configs import get_config as ref_get_config
from repro.obs import metrics as ref_metrics
from repro.obs import trace as ref_trace
from repro.train.runner import canary_stages as ref_canary_stages
from repro.viscosity import INTERPRET as REF_INTERPRET
from repro.viscosity import lanefault as ref_lanefault

import repro_torch.core.fault as P
from repro_torch.chaos import ChaosCanary, canary_fault
from repro_torch.configs import get_config
from repro_torch.core.stage import Port
from repro_torch.obs import metrics
from repro_torch.obs import trace
from repro_torch.train.runner import canary_stages
from repro_torch.viscosity import HW, lanefault
from repro_torch.viscosity.lanefault import KINDS, LaneFault

ARCHS = ["qwen1.5-4b-smoke", "zamba2-1.2b-smoke", "rwkv6-1.6b-smoke"]
STAGES = ["flash_attention", "swiglu_mlp", "mamba2_ssd", "rwkv6_wkv"]


def _both(probes, *, policy=None, intermittent=None, schedule=()):
    """Run the same probation episodes through both packages; return
    (verdicts, state logs, metrics JSONL, trace JSONL) per package."""
    out = []
    for M, met, tr in ((R, ref_metrics, ref_trace), (P, metrics, trace)):
        waits = []
        clf = M.FaultClassifier(
            None, M.ProbationPolicy(**(policy or {})), sleep=waits.append,
            intermittent=(None if intermittent is None
                          else M.IntermittentPolicy(**intermittent)))
        state = M.FaultState()
        reg, tracer = met.Registry(), tr.Tracer()
        verdicts = []
        with met.use(reg), tr.use(tracer):
            for (stage, replica, step), seq in zip(schedule, probes):
                it = iter(seq)
                res = clf.probate(lambda: next(it), stage=stage,
                                  replica=replica, step=step, state=state)
                verdicts.append((res.verdict, res.transient, res.attempts,
                                 res.backoff_s, res.promoted))
        out.append((verdicts, state.log, reg.to_jsonl(),
                    tr.to_jsonl(tracer.events), waits))
    return out


class _SpyChecker:
    def __init__(self, names):
        self.stages = [P.Stage(n, sw=lambda x: x, device="cpu")
                       for n in names]

    def check_stage(self, stage):
        return lanefault.injection(stage.name) is None


def test_chaos_canary_arms_only_around_probe():
    canary = ChaosCanary(_SpyChecker(["s0"]))
    stage = canary.stages[0]
    fault = LaneFault("stuck", (1,), 8, value=3.0)
    canary.arm("s0", fault, fails=1)
    assert canary.check_stage(stage) is False      # armed during the probe
    assert lanefault.injection("s0") is None       # never outside it
    assert canary.check_stage(stage) is True       # transient: consumed
    assert canary.armed() == []
    canary.arm("s0", fault, fails=None)            # hard fault
    assert not canary.check_stage(stage)
    assert not canary.check_stage(stage)           # still failing
    canary.disarm("s0")
    assert canary.check_stage(stage) is True
    with pytest.raises(ValueError, match="no canary width"):
        canary_fault("checksum")


def test_probation_transient_and_persistent_verdicts():
    ref, port = _both([[False, True], [False, False, False]],
                      policy=dict(retries=3),
                      schedule=[("x", 1, 5), ("x", 0, 0)])
    assert port == ref
    verdicts, log = port[0], port[1]
    assert verdicts[0][:3] == (P.TRANSIENT_RECOVERED, True, 2)
    assert verdicts[1][:3] == (P.PERSISTENT, False, 3)
    assert [e["kind"] for e in log][:3] == \
        ["probation_retry", "probation_retry", P.TRANSIENT_RECOVERED]
    assert port[4] == []                           # zero-base never sleeps


@pytest.mark.parametrize("window,steps,want", [
    (5, (0, 3, 3), [P.TRANSIENT_RECOVERED, P.INTERMITTENT_PROMOTED,
                    P.TRANSIENT_RECOVERED]),       # replica 2 keeps its own
    (3, (0, 10, 20), [P.TRANSIENT_RECOVERED] * 3),  # the window expires
])
def test_intermittent_promotion_and_window(window, steps, want):
    sched = [("x", 1, steps[0]), ("x", 1, steps[1]),
             ("x", 2 if window == 5 else 1, steps[2])]
    ref, port = _both([[True]] * 3, intermittent=dict(threshold=2,
                                                      window_steps=window),
                      schedule=sched)
    assert port == ref
    assert [v[0] for v in port[0]] == want


def test_intermittent_promotion_under_chaos_schedule():
    sched = [("flash_attention", 0, s) for s in (2, 5, 8)]
    ref, port = _both([[True]] * 3, policy=dict(retries=2),
                      intermittent=dict(threshold=3, window_steps=10),
                      schedule=sched)
    assert port == ref
    assert [v[0] for v in port[0]] == [P.TRANSIENT_RECOVERED,
                                       P.TRANSIENT_RECOVERED,
                                       P.INTERMITTENT_PROMOTED]
    assert '"verdict":"intermittent_promoted"' in port[2]


def test_probation_backoff_schedule_capped():
    pol = dict(retries=4, backoff_base_s=0.25, backoff_factor=2.0,
               max_backoff_s=0.6)
    assert P.ProbationPolicy(**pol).backoff_schedule() == \
        R.ProbationPolicy(**pol).backoff_schedule() == (0.25, 0.5, 0.6, 0.6)
    ref, port = _both([[False] * 4], policy=pol, schedule=[("x", 0, 0)])
    assert port == ref and port[4] == [0.25, 0.5, 0.6, 0.6]
    for bad in (dict(retries=0), dict(backoff_factor=0.5),
                dict(backoff_base_s=-1.0)):
        with pytest.raises(ValueError):
            P.ProbationPolicy(**bad)
    with pytest.raises(ValueError):
        P.IntermittentPolicy(threshold=1)


@pytest.mark.parametrize("kind", ["bitflip", "stuck_zero", "gain"])
def test_injector_kinds_match_reference(rng, kind):
    x = rng.normal(size=(3, 5)).astype(np.float32)
    xi = np.arange(6, dtype=np.int32)
    want = R.FaultInjector(kind, 0.25).corrupt(
        {"a": jnp.asarray(x), "b": (jnp.asarray(xi),)})
    got = P.FaultInjector(kind, 0.25).corrupt(
        {"a": torch.from_numpy(x), "b": (torch.from_numpy(xi),)})
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
    np.testing.assert_array_equal(got["b"][0].numpy(), xi)   # ints untouched
    # a complex leaf is corrupted too
    c = torch.ones(4, dtype=torch.complex64)
    assert not torch.equal(P.FaultInjector(kind, 0.25).corrupt(c), c)


def test_injection_no_op_raises_and_inject_keeps_the_stage():
    zeros = P.FaultInjector("stuck_zero").wrap(lambda: torch.zeros(4, 2))
    with pytest.raises(P.InjectionNoOpError):
        zeros()
    # a bitflip of a zero element flips it to ``magnitude``, not -0
    flip = P.FaultInjector("bitflip", 0.5).wrap(lambda: torch.zeros(4))
    assert flip()[2] == 0.5
    stage = P.Stage("s", hw=lambda x: x + 1, sw=lambda x: x + 1,
                    device="cpu", tol=0.0)
    bad = P.inject(stage, kind="gain", magnitude=1.0)
    assert (bad.name, bad.tol, bad.device) == ("s", 0.0, stage.device)
    assert float(bad.run(torch.ones(()))) == 4.0
    assert float(bad.run(torch.ones(()), route="sw")) == 2.0


def test_step_guard_and_straggler_watchdog_match_reference():
    trees = [{"loss": np.float32(1.0), "g": (np.ones(3, np.float32),)},
             {"loss": np.float32(np.nan)},
             {"g": [np.array([1.0, np.inf], np.float32)],
              "n": np.array([3], np.int32)}]
    for tr in trees:
        want = R.StepGuard.ok(jax.tree_util.tree_map(jnp.asarray, tr))
        got = P.StepGuard.ok({k: (type(v)(torch.as_tensor(a) for a in v)
                                  if isinstance(v, (list, tuple))
                                  else torch.as_tensor(v))
                              for k, v in tr.items()})
        assert got == want
    wr, wp = R.StragglerWatchdog(2.0, 4), P.StragglerWatchdog(2.0, 4)
    for replica, dt in [(0, 1.0), (1, 1.1), (2, 5.0), (0, 1.2), (2, 4.0),
                        (1, 0.9), (3, 1.0), (0, 9.0), (0, 1.0)]:
        wr.record(replica, dt)
        wp.record(replica, dt)
        assert wp.stragglers() == wr.stragglers()
    assert wp.stragglers() == [2]


# ----------------------------------------------------------- canaries
@pytest.fixture(scope="module")
def canaries():
    """Per stage name: (reference stage, port stage, port stage with its
    own draws); the first two get the same float32 numpy canaries."""
    out = {}
    for arch in ARCHS:
        for rs, ps, own in zip(ref_canary_stages(ref_get_config(arch)),
                               canary_stages(get_config(arch), device="cpu"),
                               canary_stages(get_config(arch), device="cpu")):
            if rs.name in out:
                continue
            args = [np.asarray(a) for a in rs.canary_inputs(0)]
            if rs.name == "mamba2_ssd":
                x, dt, A, B, C = (torch.from_numpy(a.copy()) for a in args)
                assert (dt < 0).any() and (A > 0).any()   # off the domain
                args = [t.numpy() for t in (
                    x * 0.5, torch.nn.functional.softplus(dt),
                    -torch.sigmoid(A), B * 8 ** -0.5, C * 8 ** -0.5)]
            rs.canary_inputs = (lambda seed, a=args:
                                tuple(jnp.asarray(x) for x in a))
            ps.canary_inputs = (lambda seed, a=args:
                                tuple(torch.from_numpy(x.copy()) for x in a))
            out[rs.name] = (rs, ps, own)
    assert sorted(out) == sorted(STAGES)
    return out


def _run_once(chk):
    """check_stage and localize of one case share one HW and SW run."""
    run, memo = chk._run_both, []

    def cached(stage):
        if not memo:
            memo.append(run(stage))
        return memo[0]
    chk._run_both = cached
    return chk


def _ref_fault(f):
    return None if f is None else ref_lanefault.LaneFault(
        f.kind, f.lanes, f.width, f.value, f.gain)


def _as_tuple(f):
    return None if f is None else (f.kind, f.lanes, f.width, f.value, f.gain)


@pytest.mark.parametrize("kind", [None, *KINDS])
@pytest.mark.parametrize("name", STAGES)
def test_check_stage_and_localize_match_reference(canaries, name, kind):
    rs, ps, _ = canaries[name]
    width = {"flash_attention": 32, "swiglu_mlp": 64}.get(name, 16)
    fault = None if kind is None else LaneFault(kind, (1, 5), width,
                                                value=7.5)
    ref_chk = _run_once(R.CanaryChecker([rs], route_hw=REF_INTERPRET))
    chk = _run_once(P.CanaryChecker([ps], route_hw=HW))
    try:
        if fault is not None:
            ref_lanefault.set_injection(name, _ref_fault(fault))
            lanefault.set_injection(name, fault)
        want = (ref_chk.check_stage(rs), _as_tuple(ref_chk.localize(rs)))
        got = (chk.check_stage(ps), _as_tuple(chk.localize(ps)))
    finally:
        ref_lanefault.reset()
        lanefault.reset()
    assert got[0] == want[0] == (kind is None)
    if kind is None:
        assert got[1] is None and want[1] is None
    else:   # the classified stuck value / gain come from float32 data
        assert got[1][:3] == want[1][:3] == (kind, (1, 5), width)
        np.testing.assert_allclose(got[1][3:], want[1][3:], rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_sweep_localizes_like_the_reference(canaries, arch):
    names = [s.name for s in ref_canary_stages(ref_get_config(arch))]
    target = names[-1]
    width = {"flash_attention": 32, "swiglu_mlp": 64}.get(target, 16)
    fault = LaneFault("gain", (3,), width, gain=2.0)
    ref_state, state = R.FaultState(), P.FaultState()
    try:
        ref_lanefault.set_injection(target, _ref_fault(fault))
        lanefault.set_injection(target, fault)
        want = R.CanaryChecker([canaries[n][0] for n in names],
                               route_hw=REF_INTERPRET,
                               localize=True).sweep(ref_state, step=7)
        got = P.CanaryChecker([canaries[n][1] for n in names], route_hw=HW,
                              localize=True).sweep(state, step=7)
        maps = (_as_tuple(ref_lanefault.fault_map(target)),
                _as_tuple(lanefault.fault_map(target)))
        bases = (ref_lanefault.map_base(target), lanefault.map_base(target))
    finally:
        ref_lanefault.reset()
        lanefault.reset()
    assert got == want and state.log == ref_state.log
    assert target in got
    assert maps[1][:3] == maps[0][:3] == ("gain", (3,), width)
    np.testing.assert_allclose(maps[1][3:], maps[0][3:], rtol=1e-5)
    assert bases == (REF_INTERPRET, HW)


@pytest.mark.parametrize("name", STAGES)
def test_own_canaries_pass_healthy_and_fail_every_kind(canaries, name):
    stage = canaries[name][2]
    args = stage.canary_inputs(0)
    assert all(a.device.type == "cpu" for a in args)
    # the same canary bytes for the same seed, others for another seed
    assert all(torch.equal(a, b) for a, b in zip(args,
                                                  stage.canary_inputs(0)))
    assert not torch.equal(args[0], stage.canary_inputs(1)[0])
    canary = ChaosCanary(P.CanaryChecker([stage], route_hw=HW))
    assert canary.check_stage(stage)
    for kind in KINDS:
        f = canary_fault(name)
        canary.arm(name, LaneFault(kind, f.lanes, f.width, value=f.value),
                   fails=1)
        assert not canary.check_stage(stage), kind
        assert lanefault.injection(name) is None    # armed only in a probe
        assert canary.armed() == []
    assert canary.check_stage(stage)


def test_unknown_stage_is_persistent_and_errors_count_as_faults():
    state = P.FaultState()
    clf = P.FaultClassifier(P.CanaryChecker([]))
    res = clf.classify("nope", state=state)
    assert res.verdict == P.PERSISTENT and res.attempts == 0
    assert state.log[-1]["kind"] == P.PERSISTENT

    def boom(x):
        raise ValueError("datapath")
    stage = P.Stage("s", hw=boom, sw=lambda x: x, device="cpu",
                    ports=(Port((2,), torch.float32),))
    assert P.CanaryChecker([stage]).check_stage(stage) is False
    assert P.CanaryChecker([stage]).localize(stage) is None

    def bug(x):
        raise KeyError("a genuine bug propagates")
    stage.hw = bug
    with pytest.raises(KeyError):
        P.CanaryChecker([stage]).check_stage(stage)
