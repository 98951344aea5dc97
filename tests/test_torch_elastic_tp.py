"""The elastic re-shard drill on the tensor-parallel runtime against the
reference's, on the CPU.

The reference's ``examples/elastic_train.py`` runs its ``jit_step`` over
a (2, 4) ("data", "model") mesh of eight forced host devices for 10 steps
from ``model.init(PRNGKey(0))`` (the reduced gemma3-1b), re-shards its
params and optimiser state onto the (1, 4) mesh of the survivors and runs
10 more (a subprocess: the flag must precede jax's start).  The port's
``examples_torch/elastic_train.py`` runs the same drill as eight gloo
rank processes from those params (``params_from_jax``).  Both drills
compute in float32 here (the examples' bfloat16 rounds every activation
to 8 bits at other points in the two frameworks, a gap larger than the
drill's training moves its loss), so the training parity tolerance is
``test_torch_train.py``'s float32 one: the 20 losses to 1e-4 relative.
The final params, gathered whole, hold each leaf's change from the
initial params to that of the reference within ``DELTA_REL`` of its
largest change: this is what a frozen, half-batch or wrong update cannot
pass.  Each survivor's restored shards are bit-identical to those it
held, and the optimiser's count is 10 at the restore and 20 at the end.
"""
import importlib.util
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch.convert import params_from_jax
from _torch_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "..")
DTYPE = "float32"
# ``test_torch_train.py``'s float32 training tolerance
LOSS_RTOL = 1e-4
# each leaf's change over the 20 steps against the reference's, relative
# to its largest change: Adam steps an element by about lr whatever its
# grad's size, so one whose grad is at rounding level may step either way
# (measured 1.4e-3, the attention's wq); a frozen update reads 1.0
DELTA_REL = 1e-2

REF_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import dataclasses, importlib.util, json, pickle, sys
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    spec = importlib.util.spec_from_file_location("ref_elastic", sys.argv[1])
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    from repro import optim
    from repro.launch.partition import params_pspecs
    cfg = dataclasses.replace(ex.get_config("gemma3-1b").reduced(),
                              dtype=sys.argv[4])
    model = ex.build_model(cfg)
    ocfg = optim.AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=100)
    data = ex.SyntheticLM(ex.DataConfig(vocab_size=cfg.vocab_size, batch=8,
                                        seq_len=32))
    fleet = ex.FleetPlan.healthy(8, ex.model_stage_names(cfg))
    mesh1 = ex.FleetMeshView.from_plan(fleet).submesh(("data", "model"),
                                                      model=4)
    losses = []
    with mesh1:
        params = model.init(jax.random.PRNGKey(0))
        with open(sys.argv[2], "wb") as f:
            pickle.dump(jax.tree_util.tree_map(np.asarray, params), f)
        step1, p_sh1 = ex.jit_step(model, ocfg, mesh1, params)
        params = jax.device_put(params, p_sh1)
        opt = optim.init(params)
        for s in range(10):
            params, opt, loss = step1(params, opt, data.device_batch(s))
            losses.append(float(loss))
    for d in (4, 5, 6, 7):
        fleet = fleet.with_device_fault(d)
    mesh2 = ex.FleetMeshView.from_plan(fleet).submesh(("data", "model"),
                                                      model=4)
    with mesh2:
        p_sh2 = jax.tree_util.tree_map(lambda s: NamedSharding(mesh2, s),
                                       params_pspecs(params, mesh2))
        params = jax.device_put(params, p_sh2)
        opt = optim.AdamWState(
            count=jax.device_put(opt.count, NamedSharding(mesh2, P())),
            mu=jax.device_put(opt.mu, p_sh2), nu=jax.device_put(opt.nu, p_sh2))
        step2, _ = ex.jit_step(model, ocfg, mesh2, params)
        for s in range(10, 20):
            params, opt, loss = step2(params, opt, data.device_batch(s))
            losses.append(float(loss))
    with open(sys.argv[3], "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, params), f)
    print(json.dumps({"losses": losses, "mesh": [list(mesh1.devices.shape),
                      list(mesh2.devices.shape)], "count": int(opt.count)}))
""")


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    """The reference's drill (a subprocess) and, meanwhile, the port's
    from the same ``init(PRNGKey(0))``, drawn here on one device; the
    reference's own draw is held equal to it."""
    import jax
    from repro.configs import get_config as ref_get_config
    from repro.models import build_model as ref_build_model
    tmp = tmp_path_factory.mktemp("elastic")
    init, final = tmp / "init.pkl", tmp / "final.pkl"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT,
         os.path.join(ROOT, "examples", "elastic_train.py"), str(init),
         str(final), DTYPE],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        cfg = ref_get_config("gemma3-1b").reduced()
        host = jax.tree_util.tree_map(np.asarray, ref_build_model(cfg).init(
            jax.random.PRNGKey(0)))
        spec = importlib.util.spec_from_file_location(
            "port_elastic", os.path.join(ROOT, "examples_torch",
                                         "elastic_train.py"))
        ex = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(ex)
        port = ex.main(device="cpu", dtype=DTYPE,
                       params=params_from_jax(host, device="cpu"))
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    ref = json.loads(out.strip().splitlines()[-1])
    with open(init, "rb") as f:
        ref_init = pickle.load(f)
    for a, b in zip(jax.tree_util.tree_leaves(ref_init),
                    jax.tree_util.tree_leaves(host)):
        assert np.array_equal(a, b)
    with open(final, "rb") as f:
        ref["params"] = params_from_jax(pickle.load(f), device="cpu")
    ref["init"] = params_from_jax(host, device="cpu")
    return ref, port


def test_losses_match_the_reference_jit_step(drills):
    ref, port = drills
    assert ref["mesh"] == port["mesh"] == [[2, 4], [1, 4]]
    got = port["losses"][0] + port["losses"][1]
    assert len(got) == len(ref["losses"]) == 20
    gaps = np.abs(np.subtract(got, ref["losses"])) / np.abs(ref["losses"])
    print(f"elastic drill float32 losses: reference {ref['losses']} port "
          f"{got} relative gaps, worst {gaps.max():.3e}: {gaps.tolist()}")
    np.testing.assert_allclose(got, ref["losses"], rtol=LOSS_RTOL)


def test_each_leaf_moves_as_the_reference_jit_step_moves_it(drills):
    """The final params' change from the initial ones, leaf for leaf, as
    the reference's (the losses alone move little over 20 steps)."""
    import torch
    from repro_torch.launch import partition
    ref, port = drills
    init = partition.flatten(ref["init"])
    want = partition.flatten(ref["params"])
    got = partition.flatten(port["params"])
    assert set(got) == set(want) == set(init)
    worst = {}
    for path, w in want.items():
        d_want = (w - init[path]).double()
        d_got = (got[path] - init[path]).double()
        assert float(d_want.abs().max()) > 0, path
        worst[path] = float((d_got - d_want).abs().max()
                            / d_want.abs().max())
    top = max(worst, key=worst.get)
    print(f"elastic drill float32 params: worst leaf {top} at "
          f"{worst[top]:.3e} of its largest change: {worst}")
    assert max(worst.values()) <= DELTA_REL, worst
    assert all(t.dtype == torch.float32 for t in got.values())


def test_survivors_restore_their_shards_and_the_count(drills):
    ref, port = drills
    assert port["ranks"] == [8, 4]
    assert port["restored_bit_identical"] == [True] * 4
    assert port["restored_count"] == 10
    assert port["opt_count"] == ref["count"] == 20
