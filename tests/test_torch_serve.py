"""The port's continuous-batching ServeEngine on the CPU.

* SW route: completions are bit-identical to the port's single-request
  ``reference_decode``, with staggered admission and slot reuse, and with a
  mid-stream fault in either failover mode (the reference's contract).
* A stage fault mid-stream on the kernel route is one rebuild in RECOMPILE
  mode and none in RESIDENT mode, and the two modes serve the same tokens.
* A detection observed with a probation classifier (``observe_fault``):
  a transient episode returns True, clears the mark within the call and
  builds nothing; a persistent one keeps the mark and plans exactly as
  ``inject_fault``; SW-route tokens stay bit-identical to
  ``reference_decode`` through a transient episode.  The same transient
  and persistent detections through the reference engine's classifier
  and the port's give the same return values, fault logs, health masks
  and plans.
* On the same converted params and workload in float32, the port serves
  the reference JAX engine's tokens.  Where a token differs, the test
  requires the reference's own top-2 logit gap at that step to be below
  the float32 logits tolerance (2e-5): a near-tie, not a defect.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.chaos import ChaosCanary as RefChaosCanary
from repro.chaos.campaign import canary_fault as ref_canary_fault
from repro.configs import get_config as ref_get_config
from repro.core.fault import CanaryChecker as RefCanaryChecker
from repro.core.fault import FaultClassifier as RefFaultClassifier
from repro.models import build_model as ref_build_model
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServeEngine as RefServeEngine
from repro.serve import synthetic_workload as ref_workload
from repro.train.runner import canary_stages as ref_canary_stages
from repro.viscosity import INTERPRET as REF_INTERPRET

from repro_torch.chaos import ChaosCanary, canary_fault
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.fault import (PERSISTENT, TRANSIENT_RECOVERED,
                                    CanaryChecker, FaultClassifier)
from repro_torch.serve import (RECOMPILE, RESIDENT, ServeConfig, ServeEngine,
                               reference_decode, synthetic_workload)
from repro_torch.train.runner import canary_stages
from repro_torch.viscosity import HW, SW

ARCH = "qwen1.5-4b-smoke"
LOGITS_TOL = 2e-5


@pytest.fixture(scope="module")
def setup():
    params = ref_build_model(ref_get_config(ARCH)).init(
        jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    return get_config(ARCH), np_params, params_from_jax(np_params,
                                                        device="cpu")


def _workload(cfg, n, seed, **kw):
    kw = dict(dict(max_prompt=19, max_new=9, arrival_every=2,
                   per_arrival=2), **kw)
    return synthetic_workload(cfg.vocab_size, n, np.random.default_rng(seed),
                              **kw)


def test_workload_draws_match_reference(setup):
    cfg = setup[0]
    got = _workload(cfg, 6, 4)
    want = ref_workload(cfg.vocab_size, 6, np.random.default_rng(4),
                        max_prompt=19, max_new=9, arrival_every=2,
                        per_arrival=2)
    assert [(r.rid, r.arrival, r.max_new_tokens, list(r.prompt))
            for r in got] == [(r.rid, r.arrival, r.max_new_tokens,
                               list(r.prompt)) for r in want]


def test_staggered_slot_reuse_bit_identical_to_reference_decode(setup):
    cfg, _, params = setup
    reqs = _workload(cfg, 8, 1, arrival_every=3)
    eng = ServeEngine(cfg, params, ServeConfig(max_len=32, max_slots=3),
                      device="cpu")
    done, stats = eng.serve(reqs)
    assert sorted(done) == sorted(r.rid for r in reqs)
    assert stats["admitted"] == 8 and max(stats["occupancy"]) <= 3
    assert stats["steps"] > max(r.arrival for r in reqs)
    for r in reqs:
        assert done[r.rid].admitted_step >= r.arrival
        ref = reference_decode(cfg, params, r.prompt, r.max_new_tokens,
                               max_len=32)
        np.testing.assert_array_equal(done[r.rid].tokens, ref)


@pytest.mark.parametrize("mode", [RECOMPILE, RESIDENT])
def test_sw_fault_mid_decode_bit_identical(setup, mode):
    cfg, _, params = setup
    reqs = _workload(cfg, 6, 2)
    eng = ServeEngine(cfg, params, ServeConfig(max_len=32, max_slots=3,
                                               failover=mode), device="cpu")
    done, _ = eng.serve(reqs, fault_at_step=(4, "flash_attention"))
    assert eng.fault_state.is_faulty("flash_attention")
    for r in reqs:
        np.testing.assert_array_equal(
            done[r.rid].tokens,
            reference_decode(cfg, params, r.prompt, r.max_new_tokens,
                             max_len=32))


@pytest.mark.parametrize("stage", ["flash_attention", "swiglu_mlp"])
def test_kernel_route_fault_recompiles_once_or_never(setup, stage):
    cfg, _, params = setup
    reqs = _workload(cfg, 4, 3, max_new=7)
    served = {}
    for mode in (RECOMPILE, RESIDENT):
        eng = ServeEngine(cfg, params, ServeConfig(
            max_len=32, max_slots=2, hw_route=HW, failover=mode),
            device="cpu")
        done, stats = eng.serve(reqs, fault_at_step=(3, stage))
        assert len(done) == len(reqs)
        if mode == RECOMPILE:
            assert stats["recompiles"] == 1 and stats["decode_compiles"] == 2
        else:
            assert stats["recompiles"] == 0 and stats["decode_compiles"] == 1
            assert stats["prefill_compiles"] == 1
        served[mode] = {r.rid: done[r.rid].tokens.tolist() for r in reqs}
    assert served[RECOMPILE] == served[RESIDENT]


def _ref_top2_gap(cfg, params, prompt, tokens, j):
    """The reference model's top-2 logit gap at completion step ``j``,
    teacher-forced on the reference's own tokens."""
    model = ref_build_model(cfg)
    P = len(prompt)
    logits, cache = model.prefill(params, {
        "tokens": jnp.asarray(prompt, jnp.int32)[None],
        "cache": model.init_cache(1, 32)})
    for i in range(j):
        logits, cache = model.decode_step(
            params, cache, jnp.asarray([[tokens[i]]], jnp.int32),
            jnp.int32(P + i))
    top = np.sort(np.asarray(logits[0, -1], np.float32))[-2:]
    return float(top[1] - top[0])


def test_f32_tokens_match_the_jax_engine(setup):
    cfg, np_params, _ = setup
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    rcfg32 = dataclasses.replace(ref_get_config(ARCH), dtype="float32")
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    reqs = _workload(cfg, 4, 5)
    ref_reqs = ref_workload(cfg.vocab_size, 4, np.random.default_rng(5),
                            max_prompt=19, max_new=9, arrival_every=2,
                            per_arrival=2)
    ref_done, _ = RefServeEngine(rcfg32, jparams, RefServeConfig(
        max_len=32, max_slots=2, hw_route=SW)).serve(ref_reqs)
    done, _ = ServeEngine(cfg32, params_from_jax(np_params, device="cpu"),
                          ServeConfig(max_len=32, max_slots=2, hw_route=SW),
                          device="cpu").serve(reqs)
    for r in reqs:
        got, want = done[r.rid].tokens, ref_done[r.rid].tokens
        diff = np.flatnonzero(got != want)
        if diff.size:
            gap = _ref_top2_gap(rcfg32, jparams, r.prompt, want, diff[0])
            assert gap < LOGITS_TOL, (r.rid, diff[0], gap)


def test_generate_and_observe_fault(setup):
    """The fixed-batch wrapper is deterministic, and a detection observed
    mid-stream (no probation classifier: always persistent) reroutes the
    stage like an injected fault without changing SW tokens."""
    cfg, _, params = setup
    prompts = np.random.default_rng(6).integers(0, cfg.vocab_size,
                                                size=(3, 10))
    eng = ServeEngine(cfg, params, ServeConfig(max_len=32), device="cpu")
    toks1, _ = eng.generate(prompts, 6)
    toks2, _ = eng.generate(prompts, 6)
    assert toks1.shape == (3, 6)
    np.testing.assert_array_equal(toks1, toks2)
    assert eng.observe_fault("swiglu_mlp", step=2) is False
    assert eng.fault_state.is_faulty("swiglu_mlp")
    assert eng.fault_state.log[-1]["kind"] == "detected"
    np.testing.assert_array_equal(eng.generate(prompts, 6)[0], toks1)
    with pytest.raises(ValueError, match="unknown stage"):
        eng.observe_fault("rwkv6_wkv")


def _classified_engine(cfg, params, **scfg):
    canary = ChaosCanary(CanaryChecker(canary_stages(cfg, device="cpu"),
                                       route_hw=HW))
    return canary, ServeEngine(cfg, params, ServeConfig(max_len=32, **scfg),
                               device="cpu",
                               classifier=FaultClassifier(canary))


@pytest.mark.parametrize("mode", [RECOMPILE, RESIDENT])
def test_observe_fault_probation_transient_then_persistent(setup, mode):
    cfg, _, params = setup
    stage = "swiglu_mlp"
    canary, eng = _classified_engine(cfg, params, max_slots=2, hw_route=HW,
                                     failover=mode)
    reqs = _workload(cfg, 4, 3, max_new=7)
    sess = eng.session()
    for r in reqs:
        sess.submit(r)
    healthy_plan = eng.plan()
    while sess.pending():
        if sess.step_count == 2:             # a transient upset
            builds = (eng._prefill.compiles, eng._decode.compiles)
            canary.arm(stage, canary_fault(stage), fails=1)
            assert eng.observe_fault(stage, step=2) is True
            assert not eng.fault_state.is_faulty(stage)
            assert eng.plan() == healthy_plan
            assert eng.health_mask() == [True, True]
            assert [e["kind"] for e in eng.fault_state.log] == [
                "detected", "probation_retry", "probation_retry",
                TRANSIENT_RECOVERED, TRANSIENT_RECOVERED]
        if sess.step_count == 3:             # ... built nothing
            assert (eng._prefill.compiles, eng._decode.compiles) == builds
        if sess.step_count == 4:             # a hard fault
            canary.arm(stage, canary_fault(stage), fails=None)
            assert eng.observe_fault(stage, step=4) is False
            assert eng.fault_state.is_faulty(stage)
            assert eng.fault_state.log[-1]["kind"] == PERSISTENT
            twin = ServeEngine(cfg, params, eng.scfg, device="cpu")
            twin.inject_fault(stage)
            assert eng.plan() == twin.plan()
            assert eng.health_mask() == twin.health_mask() == [True, False]
            canary.disarm(stage)
        sess.step()
    stats = sess.close()
    assert len(sess.poll()) == len(reqs)
    assert stats["recompiles"] == (1 if mode == RECOMPILE else 0)


def test_sw_tokens_bit_identical_through_a_transient_episode(setup):
    cfg, _, params = setup
    canary, eng = _classified_engine(cfg, params, max_slots=3)
    reqs = _workload(cfg, 5, 9)
    sess = eng.session()
    for r in reqs:
        sess.submit(r)
    while sess.pending():
        if sess.step_count == 2:
            canary.arm("flash_attention", canary_fault("flash_attention"),
                       fails=2)
            assert eng.observe_fault("flash_attention", step=2) is True
        sess.step()
    sess.close()
    done = {c.rid: c for c in sess.poll()}
    for r in reqs:
        np.testing.assert_array_equal(
            done[r.rid].tokens,
            reference_decode(cfg, params, r.prompt, r.max_new_tokens,
                             max_len=32))


def test_observe_fault_probation_matches_the_jax_engine(setup):
    """Both engines get the same detections, their canaries the same numpy
    inputs and the same armed faults: two transient episodes, then a
    persistent fault.  The reference probes on its INTERPRET route, the
    port on HW; both engines serve HW, so their plans compare as they are."""
    cfg, np_params, params = setup
    rcfg = ref_get_config(ARCH)
    ref_stages = ref_canary_stages(rcfg)
    stages = canary_stages(cfg, device="cpu")
    for rs, ps in zip(ref_stages, stages):
        args = [np.asarray(a) for a in rs.canary_inputs(0)]
        ps.canary_inputs = (lambda seed, a=args:
                            tuple(torch.from_numpy(x.copy()) for x in a))
    ref_canary = RefChaosCanary(RefCanaryChecker(ref_stages,
                                                 route_hw=REF_INTERPRET))
    canary = ChaosCanary(CanaryChecker(stages, route_hw=HW))
    ref_eng = RefServeEngine(rcfg, np_params,
                             RefServeConfig(max_len=32, hw_route=HW),
                             classifier=RefFaultClassifier(ref_canary))
    eng = ServeEngine(cfg, params, ServeConfig(max_len=32, hw_route=HW),
                      device="cpu", classifier=FaultClassifier(canary))
    for stage, step, fails in [("swiglu_mlp", 2, 1),
                               ("flash_attention", 3, 2),
                               ("swiglu_mlp", 4, None)]:
        ref_canary.arm(stage, ref_canary_fault(stage), fails=fails)
        canary.arm(stage, canary_fault(stage), fails=fails)
        want = ref_eng.observe_fault(stage, step=step)
        got = eng.observe_fault(stage, step=step)
        assert got == want == (fails is not None), stage
        assert eng.fault_state.log == ref_eng.fault_state.log
        assert eng.health_mask() == np.asarray(ref_eng.health_mask()).tolist()
        assert ((eng.plan().assignments, eng.plan().default)
                == (ref_eng.plan().assignments, ref_eng.plan().default))
    assert eng.health_mask() == [True, False]
    assert eng.fault_state.log[-1]["kind"] == PERSISTENT
