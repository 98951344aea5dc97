"""The port's training layer against the reference, on the CPU.

Parity: at each served architecture's reduced config in float32, the
reference's params (``params_from_jax``) and the same SyntheticLM batches
(B = 4, S = 64, as the reference's ``tests/test_train.py``) go through
``jax.value_and_grad`` + the reference's AdamW and through the port's
``value_and_grad`` + in-place AdamW.  Tolerances: the step-0 loss to 1e-5
relative; every grad leaf to 1e-4 of that leaf's largest reference
magnitude (float32 rounding in other summation orders; rwkv6-1.6b's random
init is ill-conditioned, so rounding at the last bit of its activations
moves its grads the most, and its margin is the narrowest); three steps'
losses to 1e-4 relative, at the reference's fleet-training optimizer
settings (lr 1e-3, tests/test_fleet_scenarios.py): Adam's first step moves
every element by about lr whatever its grad's size, so an element whose
grad is at rounding level may step either way, and the loss gap grows
with lr.  The measured margins print with ``-s``.  In bf16 (the default
compute dtype) every activation is rounded to 8 significant bits at other
points in the two frameworks: qwen1.5-4b's five losses agree to 2e-2.

Then the reference's training behaviours (``tests/test_train.py``), its
fleet-training cases (``tests/test_fleet_scenarios.py``), the forward-only
guard on every non-SW lowering, activation checkpointing, and the CLI.
"""
import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.configs import get_config as ref_get_config
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticLM as RefSyntheticLM
from repro.models import build_model as ref_build_model

from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.routing import RoutingPlan
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.kernels.flash_attention.ops import ATTENTION
from repro_torch.kernels.swiglu.ops import SWIGLU
from repro_torch.launch import train as train_cli
from repro_torch.launch.distributed import HostTopology
from repro_torch.launch.sharding import shard_bounds
from repro_torch.models import build_model
from repro_torch.train import TrainConfig, TrainRunner
from repro_torch.train.runner import (FleetTrainConfig, FleetTrainRunner,
                                      value_and_grad)
from repro_torch.viscosity import (DEGRADED_REDUCED, DEGRADED_REMAP, HW,
                                   INTERPRET, SW, lanefault)
from repro_torch.viscosity.lanefault import LaneFault
from _torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["qwen1.5-4b", "zamba2-1.2b", "rwkv6-1.6b"]
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=20)
CFG = get_config("qwen1.5-4b").reduced()
GUARD = "forward-only"


@pytest.fixture(scope="module")
def reference():
    """Per (arch, dtype): the reference's reduced config, its params as
    numpy and its jitted value_and_grad and AdamW update."""
    cache = {}

    def get(arch, dtype):
        if (arch, dtype) not in cache:
            cfg = dataclasses.replace(ref_get_config(arch).reduced(),
                                      dtype=dtype)
            model = ref_build_model(cfg)
            params = model.init(jax.random.PRNGKey(0))
            cache[arch, dtype] = dict(
                cfg=cfg, params=params,
                host=jax.tree_util.tree_map(np.asarray, params),
                vg=jax.jit(jax.value_and_grad(model.forward, has_aux=True)),
                update=jax.jit(lambda g, s, p: ref_optim.update(
                    ref_optim.AdamWConfig(**OCFG), g, s, p)))
        return cache[arch, dtype]
    return get


def _batches(cfg, n, B=4, S=64):
    data = RefSyntheticLM(RefDataConfig(vocab_size=cfg.vocab_size, batch=B,
                                        seq_len=S))
    return [data.batch_at(i) for i in range(n)]


def _port(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _train_both(ref, pcfg, batches, on_step0=None):
    """Losses of len(batches) steps in each package, from the same params."""
    rp, model = ref["params"], build_model(pcfg)
    rs = ref_optim.init(rp)
    p = params_from_jax(ref["host"], device="cpu")
    s = optim.init(p)
    ocfg = optim.AdamWConfig(**OCFG)
    ref_losses, losses = [], []
    for i, b in enumerate(batches):
        (rl, _), rg = ref["vg"](rp, {k: jnp.asarray(v) for k, v in b.items()})
        (pl, _), pg = value_and_grad(model.forward, p,
                                     {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        if i == 0 and on_step0 is not None:
            on_step0(rl, rg, pl, pg)
        rp, rs, _ = ref["update"](rg, rs, rp)
        p, s, _ = optim.update(ocfg, pg, s, p)
        ref_losses.append(float(rl))
        losses.append(float(pl))
    return np.array(ref_losses), np.array(losses)


@pytest.mark.parametrize("arch", ARCHS)
def test_step0_grads_and_three_steps_match_reference(arch, reference):
    ref = reference(arch, "float32")
    pcfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    checked = {}

    def step0(rl, rg, pl, pg):
        assert float(pl) == pytest.approx(float(rl), rel=1e-5)
        for path, g in jax.tree_util.tree_flatten_with_path(rg)[0]:
            g, got = np.asarray(g), _port(pg, path)
            assert got.shape == g.shape and got.dtype == torch.float32
            rel = np.abs(got.numpy() - g).max() / np.abs(g).max()
            assert rel <= 1e-4, (jax.tree_util.keystr(path), rel)
            checked[jax.tree_util.keystr(path)] = rel
    want, got = _train_both(ref, pcfg, _batches(ref["cfg"], 3), step0)
    assert len(checked) == len(jax.tree_util.tree_leaves(ref["params"]))
    worst = max(checked, key=checked.get)
    print(f"{arch}-smoke float32: step-0 grads worst leaf {worst} at "
          f"{checked[worst]:.3e} of its largest magnitude; losses "
          f"reference {want.tolist()} port {got.tolist()} relative gaps "
          f"{(np.abs(got - want) / np.abs(want)).tolist()}")
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_bf16_qwen_five_losses_match_reference(reference):
    ref = reference("qwen1.5-4b", "bfloat16")
    want, got = _train_both(ref, get_config("qwen1.5-4b").reduced(),
                            _batches(ref["cfg"], 5))
    margins = np.abs(got - want) / np.abs(want)
    print(f"bf16 qwen1.5-4b-smoke losses: reference {want.tolist()} port "
          f"{got.tolist()} relative gaps {margins.tolist()}")
    assert margins.max() <= 2e-2


# ------------------------------------------ tests/test_train.py, restated
def _runner(tmp, steps=40, **kw):
    data = SyntheticLM(DataConfig(vocab_size=CFG.vocab_size, batch=4,
                                  seq_len=64))
    ocfg = optim.AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=200)
    tcfg = TrainConfig(steps=steps, ckpt_every=10, ckpt_dir=str(tmp), **kw)
    return TrainRunner(CFG, ocfg, tcfg, data, device="cpu")


def test_train_loss_decreases(tmp_path):
    r = _runner(tmp_path, steps=60)
    r.run(*r.init_state())
    losses = [h["loss"] for h in r.history]
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.2
    assert {"xent", "tokens", "loss", "grad_norm", "lr", "step", "dt",
            "n_faults", "compiles"} <= set(r.history[-1])


def test_train_fault_reroutes_and_training_continues(tmp_path):
    r = _runner(tmp_path, steps=10)
    params, opt, err = r.run(*r.init_state())
    assert r.dispatcher.compiles == 1
    r.inject_fault("flash_attention")
    params, opt, err = r.run(params, opt, err, start_step=10, steps=10)
    # the healthy target IS the SW oracle: the quarantine does not change
    # the RoutingPlan, so plan-keyed dispatch dedupes it to no new build
    assert r.dispatcher.compiles == 1
    assert r.plan() == r.dispatcher.cached_keys()[-1]
    assert r.signature().faulty() == {"flash_attention"}
    assert all(np.isfinite(h["loss"]) for h in r.history)


def test_train_fault_reconfigures_when_routes_differ(tmp_path):
    r = _runner(tmp_path, steps=1, hw_route="interpret")
    plan_h = r.plan()
    r.inject_fault("flash_attention")
    plan_f = r.plan()
    assert plan_h != plan_f
    assert plan_f.target_for("flash_attention") == "sw"
    assert plan_f.target_for("swiglu_mlp") == "interpret"


def test_train_fault_does_not_change_loss_values(tmp_path):
    r = _runner(tmp_path, steps=5)
    params, opt, err = r.run(*r.init_state())
    batch = r.data.device_batch(99, device="cpu")

    def copies():          # the step updates its inputs in place
        return copy.deepcopy(params), copy.deepcopy(opt), err

    loss_h = float(r.dispatcher.get(r.plan())(*copies(), batch)[-1]["loss"])
    r.inject_fault("swiglu_mlp")
    loss_f = float(r.dispatcher.get(r.plan())(*copies(), batch)[-1]["loss"])
    assert loss_h == pytest.approx(loss_f, abs=1e-3)


def test_train_nan_guard_restores_checkpoint(tmp_path):
    r = _runner(tmp_path, steps=20)
    params, opt, err = r.run(*r.init_state())    # ckpts at 10, 20
    bad = copy.deepcopy(params)                  # simulated SDC
    bad["embed"]["table"][0, 0] = float("nan")
    r.run(bad, opt, err, start_step=20, steps=5)
    assert r.guard_trips >= 1
    assert r.history[-1]["step"] == 24
    assert np.isfinite(r.history[-1]["loss"])
    assert [e["kind"] for e in r.fault_state.log] == ["nan_guard"]


def test_train_compression_error_feedback_converges(tmp_path):
    r = _runner(tmp_path, steps=40, compression=True)
    r.run(*r.init_state())
    losses = [h["loss"] for h in r.history]
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.15


# ------------------------- tests/test_fleet_scenarios.py fleet training
def _fleet(batch, tcfg, fcfg):
    data = SyntheticLM(DataConfig(vocab_size=CFG.vocab_size, batch=batch,
                                  seq_len=16))
    return FleetTrainRunner(
        CFG, optim.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20),
        tcfg, data, fcfg, device="cpu")


def test_fleet_train_runner_detect_quarantine_migrate():
    r = _fleet(8, TrainConfig(steps=6, hw_route=SW),
               FleetTrainConfig(n_devices=3, n_spares=1))
    params, opt = r.run(*r.init_state(), steps=2)
    assert all(np.isfinite(h["loss"]) for h in r.history)
    assert r.history[-1]["n_serving"] == 2        # spare idle while healthy
    assert r.dispatcher.compiles == 1             # both shards: one plan
    params, opt = r.run(params, opt, steps=2, poison={0: 1})
    assert r.guard_trips == 1
    assert 1 in r.fleet.quarantined               # detected & quarantined
    assert 2 in r.fleet.serving()                 # migrated to the spare
    assert all(np.isfinite(h["loss"]) for h in r.history)
    assert r.dispatcher.compiles == 1             # reroute, no new plan


def test_fleet_train_transient_recovers_under_probation():
    r = _fleet(8, TrainConfig(steps=3, hw_route=SW, probation_retries=2),
               FleetTrainConfig(n_devices=3, n_spares=1))
    r.run(*r.init_state(), steps=3, transient={1: 0})
    assert r.guard_trips == 1 and r.fleet.quarantined == ()
    assert [h["step"] for h in r.history] == [0, 1, 2]
    assert "transient_recovered" in [e["kind"] for e in r.fault_state.log]


def test_fleet_train_stage_fault_reroutes_one_shard():
    r = _fleet(6, TrainConfig(steps=4, hw_route=SW),
               FleetTrainConfig(n_devices=2, n_spares=0))
    params, opt = r.run(*r.init_state(), steps=1)
    assert r.dispatcher.compiles == 1
    r.inject_stage_fault(0, "flash_attention")
    params, opt = r.run(params, opt, steps=1)
    assert r.dispatcher.compiles == 1             # SW->SW: plan unchanged
    assert r.fleet.n_faults(0) == 1 and r.fleet.n_faults(1) == 0
    assert all(np.isfinite(h["loss"]) for h in r.history)
    # distinct healthy/fallback targets: exactly the faulted shard reroutes
    r2 = _fleet(6, TrainConfig(steps=4, hw_route=INTERPRET),
                FleetTrainConfig(n_devices=2, n_spares=0))
    r2.inject_stage_fault(0, "flash_attention")
    assert r2.fleet.plan_for(0) != r2.fleet.plan_for(1)
    assert r2.fleet.plans[0].target_for("flash_attention") == SW
    assert r2.fleet.plans[1].target_for("flash_attention") == INTERPRET


def test_fleet_train_host_dropout_refolds_mesh(tmp_path):
    topo = HostTopology(num_hosts=2, devices_per_host=2)
    r = _fleet(8, TrainConfig(steps=4, hw_route=SW),
               FleetTrainConfig(n_devices=4, n_spares=1, topology=topo))
    params, opt = r.run(*r.init_state(), steps=3, host_loss={1: 0})
    assert r.history[0]["n_serving"] == 3 and r.history[0]["hosts_serving"] == 2
    assert all(h["n_serving"] == 2 for h in r.history[1:])
    assert all(h["hosts_serving"] == 1 for h in r.history[1:])
    assert set(r.fleet.quarantined) == {0, 1}
    assert r.fleet.pool.spare_for(0) == 3
    assert all(np.isfinite(h["loss"]) for h in r.history)
    assert [(e.kind, e.device) for e in r.fleet_log] == [("host", 0)]
    assert set(shard_bounds(8, r.fleet.device_mask())) == {2, 3}
    # with checkpoints the host loss restores the latest and continues
    r = _fleet(8, TrainConfig(steps=4, ckpt_every=2, ckpt_dir=str(tmp_path),
                              hw_route=SW),
               FleetTrainConfig(n_devices=4, n_spares=1, topology=topo))
    r.run(*r.init_state(), steps=4, host_loss={3: 0})
    assert [h["step"] for h in r.history] == [0, 1, 2, 2, 3]
    assert "checkpoint_restored" in [e["kind"] for e in r.fault_state.log]
    assert "fingerprint" in r.ckpt.extra(4)
    assert all(np.isfinite(h["loss"]) for h in r.history)


# ------------------------------------------------- the forward-only guard
def _swiglu_args(requires_grad):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 32, generator=g)
    ws = [torch.randn(s, generator=g) * 0.2 for s in ((32, 64), (32, 64),
                                                       (64, 32))]
    if requires_grad:
        for w in ws:
            w.requires_grad_()
    return (x, *ws)


def _attn_args(requires_grad):
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, 16, 2, 32, generator=g) for _ in range(3))
    return q, k, v.requires_grad_(requires_grad)


@pytest.mark.parametrize("spec,args", [(SWIGLU, _swiglu_args),
                                       (ATTENTION, _attn_args)])
def test_non_sw_lowerings_refuse_autograd(spec, args):
    lanefault.reset()
    fault = LaneFault("stuck", (1,), 32)
    with lanefault.known_map(spec.name, fault, base=INTERPRET):
        for target in (HW, INTERPRET, DEGRADED_REMAP, DEGRADED_REDUCED):
            with pytest.raises(RuntimeError, match=GUARD) as e:
                spec.lower(target)(*args(True))
            assert spec.name in str(e.value) and "'sw'" in str(e.value)
            spec.lower(target)(*args(False))       # serving: unchanged
            with torch.no_grad():
                spec.lower(target)(*args(True))
    # a resident route resolving to HW refuses; failed over to SW it trains
    mask = [True]
    fn = spec.lower(RoutingPlan.make({spec.name: HW}).resident_routes(
        mask, [spec.name])[spec.name])
    with pytest.raises(RuntimeError, match=GUARD):
        fn(*args(True))
    mask[0] = False
    fn(*args(True)).float().sum().backward()
    assert spec.lower(SW)(*args(True)).requires_grad


def test_trainer_on_a_kernel_route_fails_on_its_first_step(tmp_path):
    r = _runner(tmp_path, steps=2, hw_route=INTERPRET)
    with pytest.raises(RuntimeError, match="'flash_attention'.*" + GUARD):
        r.run(*r.init_state())
    r.inject_fault("flash_attention")               # attention on SW now
    with pytest.raises(RuntimeError, match="'swiglu_mlp'.*" + GUARD):
        r.run(*r.init_state())
    assert r.history == []


# --------------------------------------------------- activation checkpoints
@pytest.mark.parametrize("arch,policy", [("qwen1.5-4b", "full"),
                                         ("qwen1.5-4b", "dots"),
                                         ("qwen1.5-4b", "collectives"),
                                         ("zamba2-1.2b", "full")])
def test_remat_policies_keep_the_gradients(arch, policy):
    base = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    params = build_model(base).init(0, device="cpu")
    batch = SyntheticLM(DataConfig(vocab_size=base.vocab_size, batch=2,
                                   seq_len=32)).device_batch(0, device="cpu")
    (l0, _), g0 = value_and_grad(build_model(base).forward, params, batch)
    remat = dataclasses.replace(base, remat=True, remat_policy=policy)
    (l1, _), g1 = value_and_grad(build_model(remat).forward, params, batch)
    assert torch.equal(l0, l1)
    for a, b in zip(jax.tree_util.tree_leaves(g0),
                    jax.tree_util.tree_leaves(g1)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------------- CLI
def test_train_cli_on_the_cpu(capsys):
    train_cli.main(["--device", "cpu", "--steps", "4", "--batch", "2",
                    "--seq", "16", "--canary-every", "2",
                    "--inject-fault-at", "1"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last) == {"final_loss", "compiles", "fault_log"}
    assert np.isfinite(last["final_loss"]) and last["compiles"] == 1
    assert [e["stage"] for e in last["fault_log"]] == ["flash_attention"]
    with pytest.raises(RuntimeError, match=GUARD):
        train_cli.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                        "--seq", "16", "--hw-route", "hw"])
