"""The tensor-parallel runtime (``launch/spmd.py``) across gloo processes
on the CPU, against the unsharded port and the reference.

Each mesh runs once, one process per rank (``_torch_spmd_worker.py``),
on the reference's float32 params (``params_from_jax``) cut by
``partition.shard_tree``:

  * (1, 2) ("data", "model"): the reduced qwen1.5-4b on SW (prefill, four
    teacher-forced decode steps, a train step's loss and gradients) and on
    INTERPRET (prefill and decode); the reduced mixtral-8x7b on SW (its
    single kv head stays replicated while its four query heads split, so
    the GQA map runs on global head indices; its router's columns and its
    experts' d_ff split too, or its experts instead): the train step and
    the teacher-forced logits;
  * (2, 2): the reduced qwen1.5-4b on SW with the batch over "data" and
    the heads over "model".

On both meshes the reduced qwen1.5-4b's gradients then go through one
AdamW update whose clip binds (``clip_norm`` below the gradient norm):
the clip scale comes from the global norm, so the updated params and
moments equal the unsharded update's.

Tolerances: against the unsharded port, 1e-5 of the largest magnitude
(logits, loss) or of each gradient leaf's (float32 sums in another order);
against the reference, the port's parity tolerances (logits and loss
``TOL`` as ``test_torch_zoo.py``, gradients 1e-4 of each leaf's largest
magnitude as ``test_torch_train.py``); the INTERPRET route at the op's
2e-2.  Then ``launch/tp_serve.py``'s serve over two ranks with a lane
fault on rank 1's ``swiglu_mlp`` canary.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.routing import RoutingPlan as RefPlan
from repro.models import build_model as ref_build_model

from repro_torch.convert import params_from_jax
from repro_torch.launch import partition, tp_serve
from repro_torch.launch.mesh import make_mesh
from repro_torch.train.runner import model_stage_names
from repro_torch.viscosity import INTERPRET, SW
from _torch_threads import one_torch_thread  # noqa: F401
import _torch_spmd_worker as worker

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
TOL = (2e-5, 1e-4)
GRAD_REL = 1e-4
SHARD_REL = 1e-5
OP_TOL = 2e-2
B, P, T = 3, 8, 4
# AdamW's default clip, below the reduced qwen's gradient norm (about
# 20): the clip binds.  An eps at the clipped gradient's scale keeps the
# first step m / (sqrt(v) + eps) a smooth function of the gradient; at
# the default 1e-8 it is sign(g), and a leaf whose gradient is zero but
# for rounding (``bk``: softmax ignores a bias shared by every key) steps
# by lr in a direction no two summation orders agree on.
CLIP, ADAM_EPS = 1.0, 1.0
QWEN, MIXTRAL = "qwen1.5-4b-smoke", "mixtral-8x7b-smoke"
CASES = {
    "qwen_sw": dict(arch=QWEN, route="sw", run=["prefill", "train", "update"],
                    clip=CLIP, eps=ADAM_EPS),
    "qwen_interp": dict(arch=QWEN, route="interpret", run=["prefill"]),
    "mixtral_sw": dict(arch=MIXTRAL, route="sw", run=["train", "logits"]),
    # expert parallelism: the experts split over "model", d_ff whole
    "mixtral_ep": dict(arch=MIXTRAL, route="sw", run=["train", "logits"],
                       axes={"attn": "model", "ffn": None, "vocab": "model",
                             "expert": "model", "ssm": "model"}),
}
MESHES = {(1, 2): ("qwen_sw", "qwen_interp", "mixtral_sw", "mixtral_ep"),
          (2, 2): ("qwen_sw",)}
WORKER = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
          "import _torch_spmd_worker as w; sys.exit(w.main(sys.argv[3:]))")


def _ref(arch):
    cfg = dataclasses.replace(ref_get_config(arch), dtype="float32")
    model = ref_build_model(cfg)
    return cfg, model, model.init(jax.random.PRNGKey(0))


def _case(name, path, batch):
    return {"name": name, "params": path, "batch": batch, "prompt": P,
            "decode": T, "seed": 5, **CASES[name]}


def _launch(mesh, cases, out):
    world = int(np.prod(mesh))
    port = tp_serve.free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, SRC, HERE, json.dumps(
            {"rank": r, "world": world, "port": port, "mesh": list(mesh),
             "out": str(out), "cases": cases})],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    errs = []
    for p in procs:
        _, err = p.communicate(timeout=240)
        if p.returncode:
            errs.append(err[-3000:])
    assert not errs, "\n".join(errs)
    return [torch.load(out / f"rank{r}.pt") for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per mesh the ranks' results, the unsharded port's (the worker's
    ``run_case`` outside ``spmd``) and the reference's."""
    tmp = tmp_path_factory.mktemp("spmd")
    refs, paths = {}, {}
    for arch in (QWEN, MIXTRAL):
        cfg, model, params = _ref(arch)
        host = jax.tree_util.tree_map(np.asarray, params)
        paths[arch] = str(tmp / f"{arch}.pt")
        torch.save(params_from_jax(host, device="cpu"), paths[arch])
        refs[arch] = (cfg, model, params)
    one = make_mesh((1, 1), ("data", "model"),
                    devices=[torch.device("cpu")])
    out = {}
    for mesh, names in MESHES.items():
        batch = B * mesh[0]
        cases = [_case(n, paths[CASES[n]["arch"]], batch) for n in names]
        d = tmp / ("x".join(map(str, mesh)))
        d.mkdir()
        ranks = _launch(mesh, cases, d)
        plain = {c["name"]: worker.run_case(c, one, {"data": 0, "model": 0})
                 for c in cases}
        out[mesh] = dict(ranks=ranks, plain=plain, cases=cases,
                         mesh=make_mesh(mesh, ("data", "model"),
                                        devices=[torch.device("cpu")]
                                        * int(np.prod(mesh))))
    out["refs"] = refs
    return out


def _rel(got, want):
    got, want = (np.asarray(t.detach().float() if torch.is_tensor(t) else t,
                            np.float32) for t in (got, want))
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()), float(np.abs(want).max())


def _close(got, want, rel, floor=1e-9):
    d, m = _rel(got, want)
    assert d <= rel * max(m, floor), (d, m)


def _ref_close(got, want, tol=TOL):
    d, m = _rel(got, want)
    assert d <= tol[0] and d <= tol[1] * max(m, 1.0), (d, m)


def _rows(run, name, key):
    """``key`` of case ``name`` over the batch: the model-rank-0 result of
    each data rank, in data order."""
    picked = [r[name][key] for r in run["ranks"] if r["coords"]["model"] == 0]
    return torch.cat(picked) if len(picked) > 1 else picked[0]


_MEMO = {}


def _memo(fn):
    def wrapped(arch, refs, *args):
        key = (fn.__name__, arch) + args
        if key not in _MEMO:
            _MEMO[key] = fn(arch, refs, *args)
        return _MEMO[key]
    return wrapped


@_memo
def _ref_serve(arch, refs, route, batch):
    cfg, model, params = refs[arch]
    if route != "sw":
        model = ref_build_model(cfg, routes=RefPlan.for_stages(
            model_stage_names(cfg), route))
    toks = worker._tokens(5, (batch, P + T)).numpy().astype(np.int32)
    lg, cache = jax.jit(model.prefill)(params, {
        "tokens": jnp.asarray(toks[:, :P]),
        "cache": model.init_cache(batch, P + T)})
    out = {"prefill": lg}
    step = jax.jit(model.decode_step)
    for i in range(T):
        lg, cache = step(params, cache, jnp.asarray(toks[:, P + i:P + i + 1]),
                         jnp.int32(P + i))
        out[f"decode{i}"] = lg
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("key", ["prefill"] + [f"decode{i}" for i in
                                               range(T)])
def test_prefill_and_decode_match_unsharded_and_reference(runs, mesh, key):
    run = runs[mesh]
    got = _rows(run, "qwen_sw", key)
    _close(got, run["plain"]["qwen_sw"][key], SHARD_REL)
    for r in run["ranks"]:           # every model rank gathered the same
        assert torch.equal(r["qwen_sw"][key],
                           [q for q in run["ranks"]
                            if q["coords"]["data"] == r["coords"]["data"]
                            ][0]["qwen_sw"][key])
    want = _ref_serve(QWEN, runs["refs"], "sw", B * mesh[0])[key]
    _ref_close(got, want)


@pytest.mark.parametrize("key", ["prefill"] + [f"decode{i}" for i in
                                               range(T)])
def test_interpret_route_holds_the_op_tol(runs, key):
    run = runs[(1, 2)]
    got = _rows(run, "qwen_interp", key)
    _close(got, run["plain"]["qwen_interp"][key], OP_TOL)
    want = _ref_serve(QWEN, runs["refs"], INTERPRET, B)[key]
    _ref_close(got, want, (OP_TOL, OP_TOL))


@_memo
def _ref_train(arch, refs, batch):
    cfg, model, params = refs[arch]
    toks = worker._tokens(6, (batch, P)).numpy().astype(np.int32)
    tgt = worker._tokens(7, (batch, P)).numpy().astype(np.int32)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        model.forward, has_aux=True))(params, {"tokens": jnp.asarray(toks),
                                               "targets": jnp.asarray(tgt)})
    return loss, metrics, jax.tree_util.tree_map(np.asarray, grads)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (str(k),))
    else:
        yield "/".join(prefix), tree


@pytest.mark.parametrize("mesh,name,arch", [
    ((1, 2), "qwen_sw", QWEN), ((2, 2), "qwen_sw", QWEN),
    ((1, 2), "mixtral_sw", MIXTRAL), ((1, 2), "mixtral_ep", MIXTRAL)])
def test_train_step_loss_and_grads(runs, mesh, name, arch):
    """The loss on every rank, and the gradients rebuilt from the shards,
    equal the unsharded port's and the reference's."""
    run = runs[mesh]
    plain = run["plain"][name]
    for r in run["ranks"]:
        _close(r[name]["loss"], plain["loss"], SHARD_REL)
        for k in plain["metrics"]:
            _close(r[name]["metrics"][k], plain["metrics"][k], SHARD_REL)
    grads = partition.unshard_tree(
        [r[name]["grads"] for r in run["ranks"]],
        partition.params_pspecs(plain["grads"], run["mesh"],
                                CASES[name].get("axes")), run["mesh"])
    loss, metrics, rgrads = _ref_train(arch, runs["refs"], B * mesh[0])
    _ref_close(run["ranks"][0][name]["loss"], loss)
    ref = dict(_flat(rgrads))
    for path, g in _flat(grads):
        _close(g, dict(_flat(plain["grads"]))[path], SHARD_REL)
        _close(g, ref[path], GRAD_REL)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_clipped_update_uses_the_global_norm(runs, mesh):
    """AdamW under ``spmd`` clips by the norm of the whole gradient: each
    sharded leaf's squares summed over the axes it is cut over, each
    replicated leaf's once.  The params and moments rebuilt from the
    shards equal the unsharded update's within 1e-5 of each leaf's largest
    magnitude."""
    run = runs[mesh]
    plain = run["plain"]["qwen_sw"]["update"]
    assert float(plain["grad_norm"]) > 10 * CLIP      # the clip binds
    specs = partition.params_pspecs(plain["params"], run["mesh"])
    for r in run["ranks"]:
        _close(r["qwen_sw"]["update"]["grad_norm"], plain["grad_norm"],
               SHARD_REL)
    for key in ("params", "mu", "nu"):
        got = partition.unshard_tree(
            [r["qwen_sw"]["update"][key] for r in run["ranks"]], specs,
            run["mesh"])
        want = dict(_flat(plain[key]))
        for path, t in _flat(got):
            _close(t, want[path], SHARD_REL)


def test_expert_parallel_logits(runs):
    """The experts split over "model" (the ``ep`` variants' axis): each
    rank dispatches to its own experts only and the outputs sum."""
    run = runs[(1, 2)]
    got = _rows(run, "mixtral_ep", "logits")
    _close(got, run["plain"]["mixtral_ep"]["logits"], SHARD_REL)
    _close(got, run["plain"]["mixtral_sw"]["logits"], SHARD_REL)


def test_mixtral_logits_read_the_replicated_kv_head(runs):
    """mixtral's one kv head is replicated over "model" (kv_heads dropped
    from the rules) while its heads split: each rank's query heads read
    kv head h * Hkv // H = 0 of the gathered K/V."""
    run = runs[(1, 2)]
    rules = partition.rules_for(runs["refs"][MIXTRAL][0], run["mesh"])
    assert rules["kv_heads"] is None and rules["heads"] == "model"
    got = _rows(run, "mixtral_sw", "logits")
    _close(got, run["plain"]["mixtral_sw"]["logits"], SHARD_REL)
    cfg, model, params = runs["refs"][MIXTRAL]
    toks = worker._tokens(8, (B, P)).numpy().astype(np.int32)
    _ref_close(got, jax.jit(model.logits_all)(
        params, {"tokens": jnp.asarray(toks)}))
    coll = run["ranks"][0]["mixtral_sw"]["collectives"]
    assert any(k.startswith("all-gather|model") for k in coll)


def test_sharded_cache_holds_the_ranks_kv_heads(runs):
    """Each rank's cache is its shard: half the kv heads, the positions
    cut along the sequence (``make_cache_pspec_fn``)."""
    run = runs[(1, 2)]
    plain = run["plain"]["qwen_sw"]["cache_bytes"]
    for r in run["ranks"]:
        assert r["qwen_sw"]["cache_bytes"] * 2 == plain


def test_lane_fault_on_one_rank_demotes_the_stage_on_both():
    """Rank 1's canary finds a lane fault at step 3; both ranks apply it
    at step 3 (one RoutingPlan), serve the same tokens, and hold the
    unsharded engine's logits before it."""
    spec = tp_serve.TPServeSpec(arch="qwen1.5-4b", hw_route=INTERPRET,
                                fault_step=3, fault_rank=1, requests=4,
                                slots=2, dtype="float32")
    with tempfile.TemporaryDirectory() as d:
        ref_path = os.path.join(d, "ref.pt")
        ref = tp_serve.reference_run(spec, "cpu", path=ref_path)
        res = tp_serve.launch_ranks(spec, (1, 2), device="cpu",
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


def test_launchers_need_the_card_unless_given_the_cpu(monkeypatch):
    """The tensor-parallel launchers run on the card by default: without
    one (and without ``device="cpu"``) they raise ``resolve_device``'s
    error before starting a rank."""
    from repro_torch.launch import tp_train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp_serve.launch_ranks(tp_serve.TPServeSpec(), (1, 2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tp_train.reference_run(tp_train.TPTrainSpec())
