"""The port's open-loop traffic, admission front end and serving CLI on the
CPU, against the reference.

* Every generator draws the reference's requests from the same seed
  (prompts, budgets, step arrivals, virtual-clock arrivals, deadlines).
* ``Frontend`` over the port's fleet and over the reference's, with every
  shedding policy and admission order, on one flash-crowd workload with
  deadlines and a mid-run stage fault: equal virtual-clock fields per
  request (queue wait, time to first token, latency, deadline verdict,
  expiry, admission and finish steps, device, token count), equal
  front-end stats and equal ``summarize()`` output.  Token values are not
  compared here (``test_torch_fleet.py`` holds them); the front end's
  scheduling never reads them.
* ``python -m repro_torch.launch.serve --device cpu --verify`` exits 0.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import repro.serve as ref_serve
from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.serve import traffic as ref_traffic

import repro_torch.serve as serve
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.serve import traffic
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen1.5-4b-smoke"
PLEN = 6                             # one prompt length: one reference jit
DT = 0.05
FAULT_STEP = 6


def _requests(mod, name, seed):
    """Workload ``name`` built with package ``mod``'s generators."""
    lm = mod.LengthModel(vocab_size=331, min_prompt=3, max_prompt=17,
                         min_new=2, max_new=9)
    pareto = mod.LengthModel(vocab_size=331, min_prompt=4, max_prompt=40,
                             min_new=2, max_new=30, dist="pareto",
                             alpha=1.2, clamp_len=48)
    if name == "closed_loop":
        return mod.ClosedLoop(n_requests=11, arrival_every=3, per_arrival=2,
                              lengths=lm).build(seed)
    if name == "poisson":
        return mod.Poisson(n_requests=30, rate=12.0, lengths=lm,
                           slack_s=0.5, slack_per_token_s=0.02).build(seed)
    if name == "diurnal":
        return mod.Diurnal(n_requests=30, base_rate=2.0, peak_rate=25.0,
                           period_s=5.0, lengths=lm).build(seed)
    if name == "flash_crowd":
        return mod.FlashCrowd(n_requests=30, base_rate=4.0,
                              burst_factor=10.0, burst_start_s=1.0,
                              burst_dur_s=1.0, lengths=lm,
                              rid_base=100).build(
            np.random.default_rng(seed))
    if name == "pareto":
        return mod.Poisson(n_requests=40, rate=5.0, lengths=pareto,
                           slack_s=1.0).build(seed)
    if name == "with_deadlines":
        return mod.with_deadlines(
            mod.Diurnal(n_requests=12, lengths=lm).build(seed)
            + mod.ClosedLoop(n_requests=3, lengths=lm,
                             rid_base=50).build(seed),
            slack_s=0.3, slack_per_token_s=0.01)
    assert name == "synthetic_workload"
    return mod.synthetic_workload(331, 17, np.random.default_rng(seed),
                                  max_prompt=19, max_new=9, per_arrival=2)


def _fields(reqs):
    return [(r.rid, r.arrival, r.arrival_time, r.deadline, r.max_new_tokens,
             np.asarray(r.prompt).tolist()) for r in reqs]


@pytest.mark.parametrize("name", ["closed_loop", "poisson", "diurnal",
                                  "flash_crowd", "pareto", "with_deadlines",
                                  "synthetic_workload"])
def test_generators_draw_the_reference_requests(name):
    for seed in (0, 7):
        got = _requests(traffic, name, seed)
        assert _fields(got) == _fields(_requests(ref_traffic, name, seed))
        assert all(isinstance(r, serve.Request) for r in got)
    rng, ref_rng = np.random.default_rng(3), np.random.default_rng(3)
    assert [traffic.bounded_pareto(rng, 2, 500, 1.1) for _ in range(50)] \
        == [ref_traffic.bounded_pareto(ref_rng, 2, 500, 1.1)
            for _ in range(50)]


# ------------------------------------------------------------ front end
@pytest.fixture(scope="module")
def fleets():
    """A 3-device fleet (one hot spare) in each package, on the same f32
    params, reused by every case (sessions reset the pools; each case
    ends with the faulted device recovered)."""
    rcfg = dataclasses.replace(ref_get_config(ARCH), dtype="float32")
    params = ref_build_model(rcfg).init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    cfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    fcfg = dict(n_devices=3, n_spares=1, degradation=(1.0, 0.5))
    port = serve.FleetServeEngine(
        cfg, params_from_jax(np_params, device="cpu"),
        serve.ServeConfig(max_len=32, max_slots=2),
        serve.FleetConfig(**fcfg), device="cpu")
    ref = ref_serve.FleetServeEngine(
        rcfg, jax.tree_util.tree_map(jnp.asarray, np_params),
        ref_serve.ServeConfig(max_len=32, max_slots=2),
        ref_serve.FleetConfig(**fcfg))
    return cfg, port, ref


def _frontend_run(mod, eng, vocab, shed, order):
    lm = mod.LengthModel(vocab_size=vocab, min_prompt=PLEN,
                         max_prompt=PLEN, min_new=3, max_new=10)
    reqs = mod.FlashCrowd(n_requests=16, base_rate=6.0, burst_factor=8.0,
                          burst_start_s=0.2, burst_dur_s=0.5, lengths=lm,
                          slack_s=0.25, slack_per_token_s=0.03).build(4)
    # two requests without a deadline: they can wait forever
    reqs = reqs[:-2] + [dataclasses.replace(r, deadline=None)
                        for r in reqs[-2:]]
    comps, stats = mod.Frontend(eng, mod.FrontendConfig(
        step_time_s=DT, max_queue=3, shed=shed, order=order)).run(
        reqs, events={FAULT_STEP: [("stage", 0, "flash_attention")]})
    eng.recover(0)
    return reqs, comps, stats


@pytest.mark.parametrize("order", ["edf", "fifo"])
@pytest.mark.parametrize("shed", ["block", "reject", "latest_deadline"])
def test_frontend_virtual_clock_matches_reference(fleets, shed, order):
    cfg, port, ref = fleets
    reqs, comps, stats = _frontend_run(serve, port, cfg.vocab_size, shed,
                                       order)
    _, rcomps, rstats = _frontend_run(ref_serve, ref, cfg.vocab_size, shed,
                                      order)
    assert sorted(comps) == sorted(rcomps) == sorted(r.rid for r in reqs)
    for rid, c in comps.items():
        rc = rcomps[rid]
        assert (c.queue_wait_s, c.ttft_s, c.latency_s, c.deadline,
                c.deadline_met, c.expired, c.admitted_step, c.finished_step,
                c.device, len(c.tokens)) == \
            (rc.queue_wait_s, rc.ttft_s, rc.latency_s, rc.deadline,
             rc.deadline_met, rc.expired, rc.admitted_step,
             rc.finished_step, rc.device, len(rc.tokens)), rid
    for key in ("released", "submitted", "shed", "expired_queued",
                "expired_in_flight", "queue_depth", "virtual_time_s",
                "steps", "completed", "deadline_met", "expired",
                "goodput_tokens", "goodput_tok_s", "throughput_tok_s",
                "p50_latency_s", "p99_latency_s", "p50_ttft_s",
                "p99_ttft_s"):
        assert stats[key] == rstats[key], key
    for key in ("requeued", "per_step_tokens", "capacity", "quarantined",
                "spares_in_service", "per_device_tokens"):
        assert stats["engine"][key] == rstats["engine"][key], key
    assert serve.summarize(comps, stats["virtual_time_s"]) == \
        ref_serve.summarize(rcomps, rstats["virtual_time_s"])
    # the workload exercises what the policy decides: the fault requeued
    # work, deadlines expired, and a full queue shed (or blocked)
    assert stats["engine"]["requeued"] > 0
    assert stats["expired"] > 0 and stats["deadline_met"] > 0
    assert (stats["shed"] == []) == (shed == "block")
    # no request that did not expire is dropped
    assert all(len(c.tokens) == r.max_new_tokens
               for r in reqs for c in [comps[r.rid]] if not c.expired)


# ------------------------------------------------------------------ CLI
def test_serve_cli_verifies_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--verify", "--requests", "4", "--prompt-len", "12",
         "--new-tokens", "6", "--fault-at", "3", "--failover", "resident"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "served requests=4/4" in res.stdout
    assert "bit-identical-to-reference-decode" in res.stdout
