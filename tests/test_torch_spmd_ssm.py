"""The tensor-parallel runtime (``launch/spmd.py``) on the hybrid
(zamba2-1.2b) and SSM (rwkv6-1.6b) families, across two gloo processes on
the CPU, against the unsharded port and the reference.

One (1, 2) ("data", "model") mesh, one process per rank
(``_torch_spmd_worker.py``), on the reference's float32 params
(``params_from_jax``; the norm scales and RWKV-6's ``u`` drawn as the
models' parity tests draw them, so slicing them is exercised) cut by
``partition.shard_tree`` with the Mamba2 component layout:

  * the reduced zamba2-1.2b (16 SSD heads and 4 attention heads, 8 and 2
    a rank; the shared block's MLP columns split) and rwkv6-1.6b (4 WKV
    heads, 2 a rank; the LoRA, ``u`` and the channel-mix on the ``ffn``
    axis) on SW: prefill over a prompt that crosses chunk boundaries,
    four teacher-forced decode steps (each slot on its own), a train
    step's loss and gradients;
  * both on INTERPRET: prefill and decode.

Tolerances: against the unsharded port, 1e-5 of the largest magnitude
(logits, loss) or of each gradient leaf's, but rwkv6-1.6b's gradients
1e-4: its smoke model moves its gradients by 2.8e-4 of a leaf's largest
under one-ulp noise on the params (float32 sums in another order, as the
partial sums are, measured 2.4e-5); against the reference, the
float32 tolerances of ``test_torch_zamba2.py`` and ``test_torch_rwkv6.py``
(gradients 1e-4 of each leaf's largest magnitude, as
``test_torch_train.py``); INTERPRET at the op's 2e-2 against the
unsharded port's INTERPRET.  Then ``launch/tp_serve.py``'s serve over two
ranks with a lane fault on rank 1's scan stage.

Then the reduced zamba2-1.2b once more, over four processes of a
(1, 2, 2) mesh under the ``attn2d`` and ``ep`` variants, whose serving
cache cuts the Mamba2 state otherwise than its params: the same
prefill and decode steps against the unsharded port (1e-5) and the
reference, the ranks' states put together against the unsharded cache,
each decode step's bytes against the dry run's; and, at full width on
meta, every variant mesh's cache specs.
"""
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import partition, tp_serve
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.variants import VARIANTS
from repro_torch.viscosity import INTERPRET, SW
from _torch_threads import one_torch_thread  # noqa: F401
import _torch_spmd_worker as worker
from test_torch_spmd import _close, _flat, _launch, _ref_close

ZAMBA, RWKV = "zamba2-1.2b-smoke", "rwkv6-1.6b-smoke"
# the float32 rows of each model's parity test
TOL = {ZAMBA: (2e-5, 1e-5), RWKV: (5e-5, 2e-5)}
GRAD_REL = 1e-4
SHARD_REL = 1e-5
SHARD_GRAD_REL = {ZAMBA: SHARD_REL, RWKV: GRAD_REL}
OP_TOL = 2e-2
MESH = (1, 2)
# prompts of 24 tokens: two SSD chunks of 16 (the second ragged) and
# three WKV chunks of 8
B, P, T = 3, 24, 4
CASES = {
    "zamba_sw": dict(arch=ZAMBA, route="sw", run=["prefill", "train"]),
    "zamba_interp": dict(arch=ZAMBA, route="interpret", run=["prefill"]),
    "rwkv_sw": dict(arch=RWKV, route="sw", run=["prefill", "train"]),
    "rwkv_interp": dict(arch=RWKV, route="interpret", run=["prefill"]),
}
ARCH_OF = {"zamba": ZAMBA, "rwkv": RWKV}


def _ref_params(arch):
    """The reference's init, with the perturbations of the model's parity
    test (``test_torch_zamba2.py``, ``test_torch_rwkv6.py``)."""
    cfg = dataclasses.replace(ref_get_config(arch), dtype="float32")
    model = ref_build_model(cfg)
    tree = jax.tree_util.tree_map(np.asarray,
                                  model.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    layers = tree["layers"]
    if arch == ZAMBA:
        subs = [layers["ln1"], layers["mix"], tree["shared"]["ln1"],
                tree["shared"]["ln2"]]
    else:
        tm = layers["tm"]
        tm["u"] = rng.normal(size=tm["u"].shape).astype(np.float32)
        subs = [layers["ln1"], layers["ln2"], tm]
    for sub in subs:
        name = next(n for n in ("norm_scale", "ln_scale", "scale")
                    if n in sub)
        sub[name] = (1 + 0.1 * rng.normal(size=sub[name].shape)
                     ).astype(np.float32)
    return cfg, model, tree


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, the unsharded port's (the worker's ``run_case``
    outside ``spmd``) and the reference's model and params."""
    tmp = tmp_path_factory.mktemp("spmd_ssm")
    refs, paths = {}, {}
    for arch in (ZAMBA, RWKV):
        cfg, model, tree = _ref_params(arch)
        paths[arch] = str(tmp / f"{arch}.pt")
        torch.save(params_from_jax(tree, device="cpu"), paths[arch])
        refs[arch] = (cfg, model, jax.tree_util.tree_map(jnp.asarray, tree))
    cases = [{"name": n, "params": paths[c["arch"]], "batch": B,
              "prompt": P, "decode": T, "seed": 5, **c}
             for n, c in CASES.items()]
    ranks = _launch(MESH, cases, tmp)
    one = make_mesh((1, 1), ("data", "model"), devices=[torch.device("cpu")])
    plain = {c["name"]: worker.run_case(c, one, {"data": 0, "model": 0})
             for c in cases}
    return dict(ranks=ranks, plain=plain, refs=refs,
                mesh=make_mesh(MESH, ("data", "model"),
                               devices=[torch.device("cpu")] * 2))


_MEMO = {}


def _ref_serve(arch, refs):
    if arch not in _MEMO:
        cfg, model, params = refs[arch]
        toks = worker._tokens(5, (B, P + T)).numpy().astype(np.int32)
        lg, cache = jax.jit(model.prefill)(params, {
            "tokens": jnp.asarray(toks[:, :P]),
            "cache": model.init_cache(B, P + T)})
        out = {"prefill": lg}
        step = jax.jit(model.decode_step)
        for i in range(T):
            lg, cache = step(params, cache,
                             jnp.asarray(toks[:, P + i:P + i + 1]),
                             jnp.int32(P + i))
            out[f"decode{i}"] = lg
        _MEMO[arch] = out
    return _MEMO[arch]


KEYS = ["prefill"] + [f"decode{i}" for i in range(T)]


@pytest.mark.parametrize("model", ["zamba", "rwkv"])
@pytest.mark.parametrize("key", KEYS)
def test_prefill_and_decode_match_unsharded_and_reference(runs, model, key):
    name = f"{model}_sw"
    got = runs["ranks"][0][name][key]
    assert torch.equal(got, runs["ranks"][1][name][key])
    _close(got, runs["plain"][name][key], SHARD_REL)
    arch = ARCH_OF[model]
    _ref_close(got, _ref_serve(arch, runs["refs"])[key], TOL[arch])


@pytest.mark.parametrize("model", ["zamba", "rwkv"])
@pytest.mark.parametrize("key", KEYS)
def test_interpret_route_holds_the_op_tol(runs, model, key):
    name = f"{model}_interp"
    got = runs["ranks"][0][name][key]
    assert torch.equal(got, runs["ranks"][1][name][key])
    _close(got, runs["plain"][name][key], OP_TOL)


def _ref_train(arch, refs):
    cfg, model, params = refs[arch]
    toks = worker._tokens(6, (B, P)).numpy().astype(np.int32)
    tgt = worker._tokens(7, (B, P)).numpy().astype(np.int32)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        model.forward, has_aux=True))(params, {"tokens": jnp.asarray(toks),
                                               "targets": jnp.asarray(tgt)})
    return loss, jax.tree_util.tree_map(np.asarray, grads)


@pytest.mark.parametrize("model", ["zamba", "rwkv"])
def test_train_step_loss_and_grads(runs, model):
    """The loss on both ranks, and the gradients rebuilt from the shards
    (the packed leaves' by component), equal the unsharded port's and the
    reference's."""
    name, arch = f"{model}_sw", ARCH_OF[model]
    plain = runs["plain"][name]
    for r in runs["ranks"]:
        _close(r[name]["loss"], plain["loss"], SHARD_REL)
    grads = partition.unshard_tree(
        [r[name]["grads"] for r in runs["ranks"]],
        partition.params_pspecs(plain["grads"], runs["mesh"]), runs["mesh"],
        layout=partition.packed_layout(get_config(arch)))
    loss, rgrads = _ref_train(arch, runs["refs"])
    _ref_close(runs["ranks"][0][name]["loss"], loss, TOL[arch])
    ref, want = dict(_flat(rgrads)), dict(_flat(plain["grads"]))
    assert set(ref) == set(want) == set(dict(_flat(grads)))
    for path, g in _flat(grads):
        _close(g, want[path], SHARD_GRAD_REL[arch])
        _close(g, ref[path], GRAD_REL)


@pytest.mark.parametrize("model", ["zamba", "rwkv"])
def test_rank_holds_half_of_every_state_and_gathers_them(runs, model):
    """Each rank's cache is its shard (half the SSM heads and conv
    channels, or half the WKV heads and token-shift widths; zamba2's
    shared-block KV heads too); B and C, the LoRA and the token shifts
    are gathered over "model"."""
    name = f"{model}_sw"
    for r in runs["ranks"]:
        assert r[name]["cache_bytes"] * 2 == \
            runs["plain"][name]["cache_bytes"]
    coll = runs["ranks"][0][name]["collectives"]
    assert any(k.startswith("all-gather|model|float32") for k in coll)
    assert any(k.startswith("all-reduce|model|float32") for k in coll)


@pytest.mark.parametrize("arch,stage", [("zamba2-1.2b", "mamba2_ssd"),
                                        ("rwkv6-1.6b", "rwkv6_wkv")])
def test_lane_fault_on_rank_1s_scan_demotes_it_on_both(arch, stage):
    """Rank 1's canary finds a lane fault on its scan stage at step 3;
    both ranks apply it at step 3, serve the same tokens, and hold the
    unsharded engine's logits before it."""
    spec = tp_serve.TPServeSpec(arch=arch, hw_route=INTERPRET, fault_step=3,
                                fault_rank=1, fault_stage=stage, requests=4,
                                slots=2, dtype="float32")
    assert tp_serve.fault_stage_for(spec.config()) == stage
    with tempfile.TemporaryDirectory() as d:
        ref_path = os.path.join(d, "ref.pt")
        ref = tp_serve.reference_run(spec, "cpu", path=ref_path)
        res = tp_serve.launch_ranks(spec, MESH, device="cpu",
                                    ref_logits=ref_path,
                                    env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert tp_serve.check_agreement(res) == []
    for r in res:
        assert r["fault_applied_step"] == 3
        assert r["routes"][:3] == [INTERPRET] * 3
        assert set(r["routes"][3:]) == {SW}
        before = [rel for rel, c in zip(r["logits_rel"], r["calls"])
                  if c["step"] < 3]
        assert len(before) >= 3 and max(before) <= OP_TOL, r["logits_rel"]
    assert sorted(res[0]["tokens"]) == sorted(ref["tokens"])


# the variants whose Mamba2 state the serving cache cuts otherwise than
# its params, at (1, 2, 2): (the cache's axis, the params', the cache's
# ranks) -- ``attn2d`` the cache over "model_h" (2 ranks), the params over
# ("model_h", "model_f") (4); ``ep`` the cache over ("expert", "tp") (4),
# the params over "tp" (2)
VARIANT_MESH = (1, 2, 2)
MOVES = {"attn2d": ("model_h", ("model_h", "model_f"), 2),
         "ep": (("expert", "tp"), "tp", 4)}


@pytest.fixture(scope="module")
def variant_runs(tmp_path_factory):
    """One launch of four gloo ranks over (1, 2, 2): the reduced
    zamba2-1.2b on SW under each variant of ``MOVES`` (prefill and the
    teacher-forced decode steps, the ranks' recurrent states kept), and
    the unsharded port's run of the same case."""
    tmp = tmp_path_factory.mktemp("spmd_variants")
    cfg, model, tree = _ref_params(ZAMBA)
    path = str(tmp / "zamba.pt")
    torch.save(params_from_jax(tree, device="cpu"), path)
    refs = {ZAMBA: (cfg, model, jax.tree_util.tree_map(jnp.asarray, tree))}
    cases = [{"name": v, "arch": ZAMBA, "route": "sw", "run": ["prefill"],
              "variant": v, "keep_state": True, "params": path, "batch": B,
              "prompt": P, "decode": T, "seed": 5} for v in MOVES]
    ranks = _launch(VARIANT_MESH, cases, tmp)
    one = make_mesh((1, 1), ("data", "model"), devices=[torch.device("cpu")])
    plain = worker.run_case(dict(cases[0], variant=None), one,
                            {"data": 0, "model": 0})
    return ranks, plain, refs


def _dryrun_tick(variant):
    """The dry run's collective bytes by kind for one decode step of the
    same case (f32, B rows, a cache of P + T slots) on one rank of the
    variant's (1, 2, 2) mesh, on meta."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.variants import VARIANTS
    v = VARIANTS[variant]
    rec = dryrun.analyze_cell(
        dataclasses.replace(get_config(ZAMBA), dtype="float32"),
        ShapeSpec("tick", P + T, B, "decode"),
        mesh=make_mesh(VARIANT_MESH, v["mesh_axes"],
                       devices=[torch.device("meta")] * 4),
        rules=v["rules"], axes=v["axes"])
    return rec["collectives"]["bytes_by_kind"]


@pytest.mark.parametrize("variant", list(MOVES))
def test_state_cut_over_another_axis_than_its_params_is_resharded(
        variant_runs, variant, tmp_path):
    """Under ``attn2d`` (the cache coarser than the params) and ``ep``
    (finer, and not inside them) the runtime moves each layer's Mamba2
    state between the two cuts, the packed conv tail by component: on four
    ranks the logits equal the unsharded port's (1e-5 of the largest) and
    the reference's (float32 tolerances), every rank's ``conv`` and
    ``ssm`` leaves put together equal the unsharded cache (1e-5: a wrong
    component order moves x channels into B and C), each decode step moves
    the bytes the dry run counts on meta, and the dry run's reduced
    decode cell under the variant reads ok."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import hillclimb, spmd
    from repro_torch.launch.variants import VARIANTS
    from repro_torch.models import build_model
    ranks, plain, refs = variant_runs
    v, cfg = VARIANTS[variant], get_config(ZAMBA)
    cache_ax, param_ax, m = MOVES[variant]
    for key in KEYS:
        got = ranks[0][variant][key]
        for r in ranks[1:]:
            assert torch.equal(got, r[variant][key]), key
        _close(got, plain[key], SHARD_REL)
        _ref_close(got, _ref_serve(ZAMBA, refs)[key], TOL[ZAMBA])
    mesh = make_mesh(VARIANT_MESH, v["mesh_axes"],
                     devices=[torch.device("cpu")] * 4)
    with spmd.spmd(mesh, v["rules"], v["axes"]):
        assert spmd.state_axes(cfg) == {"ssm": (-3, cache_ax, param_ax),
                                        "conv": (-1, cache_ax, param_ax)}
        _, specs = spmd.cache_specs(build_model(cfg), B, P + T)
    state = partition.unshard_tree(
        [r[variant]["state"] for r in ranks], specs["mamba"], mesh,
        layout=partition.packed_layout(cfg))
    for name, dim in (("conv", -1), ("ssm", -3)):
        want = plain["state"][name]
        assert all(r[variant]["state"][name].shape[dim] * m == want.shape[dim]
                   for r in ranks)
        _close(state[name], want, SHARD_REL)
    stub = _dryrun_tick(variant)
    for r in ranks:
        for step in r[variant]["step_collectives"]:
            assert step["bytes"] == stub, (step["bytes"], stub)
    assert stub["all-gather"] > 0
    shapes = {"decode_32k": dataclasses.replace(
        SHAPES["decode_32k"], seq_len=64, global_batch=16)}
    rec = hillclimb.run_variant("zamba2-1.2b", "decode_32k", variant,
                                out_dir=str(tmp_path), shapes=shapes)
    assert rec["status"] == "ok", rec.get("error") or rec.get("reason")


SERVE_VARIANTS = [n for n, v in VARIANTS.items() if "mesh_axes" in v]


@pytest.mark.parametrize("mesh", ["1x2x2", "own"])
@pytest.mark.parametrize("variant", SERVE_VARIANTS)
def test_cache_specs_accept_every_variant_mesh(variant, mesh):
    """At full width, on (1, 2, 2) and on the variant's own mesh,
    ``cache_specs`` takes zamba2-1.2b's and rwkv6-1.6b's serving caches:
    Mamba2's state is cut over the ``attn`` axis and written by params on
    the ``ssm`` one (moved between them), RWKV-6's WKV heads on the same
    axis as ``wr``'s columns."""
    from repro_torch.launch import spmd
    from repro_torch.models import build_model
    v = VARIANTS[variant]
    shape = VARIANT_MESH if mesh == "1x2x2" else v["mesh_shape"]
    sizes = dict(zip(v["mesh_axes"], shape))
    with spmd.spmd(sizes, v["rules"], v["axes"]):
        for arch in ("zamba2-1.2b", "rwkv6-1.6b"):
            cfg = get_config(arch)
            spmd.check_runtime(cfg)
            spmd.cache_specs(build_model(cfg), 16, 64)
            for name, (_, cache_ax, param_ax) in \
                    spmd.state_axes(cfg).items():
                assert cache_ax == v["axes"]["attn"], name
                assert param_ax == (v["axes"]["attn"] if name == "wkv"
                                    else v["axes"]["ssm"]), name


@pytest.mark.parametrize("arch", [ZAMBA, RWKV])
def test_variant_with_split_axes_runs_a_sharded_train_step(tmp_path, arch):
    """Under ``attn2d`` a block's pieces sit on different axes (RWKV-6's
    heads on "model_h", its LoRA, ``u`` and channel-mix on both axes;
    Mamba2's leaves on both): one rank's train step runs on meta, the
    decay and ``u`` resharded onto the heads' axis."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import hillclimb
    shapes = {"train_4k": dataclasses.replace(SHAPES["train_4k"],
                                              seq_len=32, global_batch=32)}
    rec = hillclimb.run_variant(arch, "train_4k", "attn2d",
                                out_dir=str(tmp_path), shapes=shapes)
    assert rec["status"] == "ok", rec.get("error") or rec.get("reason")
    assert rec["collectives"]["bytes_by_kind"]["all-gather"] > 0
