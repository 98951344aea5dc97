"""ZeRO-1 on the tensor-parallel runtime (``launch/tp_train.py``) against
the reference and the unsharded port, on the CPU.

  * Specs: the reference's dry run lowers and compiles gemma3-1b's
    ``train_4k`` step with ``zero1=True`` over a (2, 4) ("data", "model")
    mesh of eight forced host devices (a subprocess, as
    ``tests/test_sharding_mesh.py``; cut to 2 layers, d_ff 512 and a
    vocab of 4096 as there); the AdamW moments' compiled input shardings
    equal the port's ``partition.zero1_specs`` leaf for leaf.
  * Runtime: the reduced qwen1.5-4b's ZeRO-1 step over gloo ranks
    (``_torch_spmd_worker.py``) on (2, 2) and (2, 1), k = 2 microbatches,
    from the reference's params (``params_from_jax``), under a clip that
    binds (AdamW's eps at the clipped gradient's scale, as
    ``test_torch_spmd.py`` explains): the params and the moments rebuilt
    from the ranks' blocks equal the unsharded port's step within 1e-5 of
    each leaf's largest magnitude, and a rank holds 1/dp of each moment
    leaf the data axes divide.
  * The dry run: the four ZeRO-1 variants (``zero1``, ``hc_a_zero1``,
    ``hc_b_zero1``, ``hc_b_final``) run, and a rank's moment bytes are the
    ZeRO-1 layout's, 1/dp of the same mesh's baseline for every leaf with
    a dim the data axes divide; the data axes move reduce-scatter and
    all-gather bytes instead of all-reduce ones.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model

from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.convert import params_from_jax
from repro_torch.launch import dryrun, hillclimb, partition, tp_serve
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import PartitionSpec, mesh_sizes
from repro_torch.launch.variants import VARIANTS, variant_mesh
from repro_torch.models import build_model, params_specs
from _torch_threads import one_torch_thread  # noqa: F401
import _torch_spmd_worker as worker

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
SHARD_REL = 1e-5
CLIP, ADAM_EPS = 1.0, 1.0
QWEN = "qwen1.5-4b-smoke"
B, P, K = 4, 8, 2
OVERRIDES = {"num_layers": 2, "d_ff": 512, "vocab_size": 4096,
             "loss_chunk": 128}
WORKER = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
          "import _torch_spmd_worker as w; sys.exit(w.main(sys.argv[3:]))")

REF_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import json, sys
    import jax
    from repro.launch.mesh import make_mesh
    from repro.launch import dryrun
    mesh = make_mesh((2, 4), ("data", "model"))
    lowered, _ = dryrun.build_lowered("gemma3-1b", "train_4k", mesh,
                                      overrides=json.loads(sys.argv[1]),
                                      zero1=True)
    args, _ = lowered.compile().input_shardings
    out = {}
    for name in ("mu", "nu"):
        flat = jax.tree_util.tree_flatten_with_path(getattr(args[1], name))[0]
        out[name] = {"/".join(str(k.key) for k in path): list(
            a if a is None or isinstance(a, str) else list(a)
            for a in s.spec) for path, s in flat}
    print(json.dumps(out))
""")


def _norm(spec, nd):
    """A spec as a list of ``nd`` entries (trailing Nones filled; a
    one-name tuple as the name)."""
    out = []
    for a in list(spec) + [None] * (nd - len(spec)):
        if isinstance(a, (tuple, list)):
            a = a[0] if len(a) == 1 else list(a)
        out.append(a)
    return out


def test_moment_specs_equal_the_reference_compiled_shardings():
    env = dict(os.environ, PYTHONPATH=SRC)
    res = subprocess.run([sys.executable, "-c", REF_SCRIPT,
                          json.dumps(OVERRIDES)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = json.loads(res.stdout.strip().splitlines()[-1])
    cfg = dataclasses.replace(get_config("gemma3-1b"), **OVERRIDES)
    p = params_specs(build_model(cfg))
    sizes = {"data": 2, "model": 4}
    zspecs = partition.flatten(partition.zero1_specs(
        partition.params_pspecs(p, sizes), p, sizes))
    flat = partition.flatten(p)
    for name in ("mu", "nu"):
        assert sorted(ref[name]) == sorted(zspecs)
        for path, spec in zspecs.items():
            nd = len(flat[path].shape)
            assert _norm(spec, nd) == _norm(ref[name][path], nd), path
    # every leaf of this tree has a dim the data axes divide
    assert all("data" in tuple(s) for s in zspecs.values())


def test_zero1_spec_leaves_a_leaf_without_a_free_divisible_dim():
    sizes = {"data": 4, "model": 2}
    spec = partition.param_pspec("w1", (3, 6), sizes)      # cols over model
    assert tuple(spec) == (None, "model")
    assert partition.zero1_spec(spec, (3, 6), sizes) == spec
    assert partition.zero1_dim(spec, spec) is None
    z = partition.zero1_spec(spec, (8, 6), sizes)
    assert tuple(z) == ("data", "model") and partition.zero1_dim(spec, z) == 0
    multi = {"pod": 2, "data": 2, "model": 2}
    assert tuple(partition.zero1_spec(PartitionSpec(), (4,),
                                      multi)) == (("pod", "data"),)


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
    """Per mesh the ranks' ZeRO-1 results and the unsharded port's."""
    tmp = tmp_path_factory.mktemp("zero1")
    cfg = dataclasses.replace(ref_get_config(QWEN), dtype="float32")
    params = ref_build_model(cfg).init(jax.random.PRNGKey(0))
    path = str(tmp / "params.pt")
    torch.save(params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                               device="cpu"), path)
    case = {"name": "qwen_zero1", "arch": QWEN, "route": "sw",
            "run": ["zero1"], "params": path, "batch": B, "prompt": P,
            "decode": 0, "seed": 5, "clip": CLIP, "eps": ADAM_EPS, "k": K}
    one = make_mesh((1, 1), ("data", "model"), devices=[torch.device("cpu")])
    out = {"plain": worker.run_case(case, one, {"data": 0, "model": 0})}
    for mesh in ((2, 2), (2, 1)):
        d = tmp / "x".join(map(str, mesh))
        d.mkdir()
        out[mesh] = _launch(mesh, [case], d)
    return out


def _close(got, want, rel=SHARD_REL):
    d = float((got.float() - want.float()).abs().max())
    m = float(want.abs().max())
    assert d <= rel * max(m, 1e-9), (d, m)


@pytest.mark.parametrize("mesh", [(2, 2), (2, 1)])
def test_zero1_step_equals_the_unsharded_update(runs, mesh):
    plain = runs["plain"]["zero1"]
    ranks = [r["qwen_zero1"]["zero1"] for r in runs[mesh]]
    assert float(plain["grad_norm"]) > 10 * CLIP          # the clip binds
    m = make_mesh(mesh, ("data", "model"),
                  devices=[torch.device("cpu")] * int(np.prod(mesh)))
    specs = partition.params_pspecs(plain["params"], m)
    zspecs = partition.zero1_specs(specs, plain["params"], m)
    for r in ranks:
        _close(r["grad_norm"], plain["grad_norm"])
        _close(r["loss"], plain["loss"])
    for key, sp in (("params", specs), ("mu", zspecs), ("nu", zspecs)):
        got = partition.flatten(partition.unshard_tree(
            [r[key] for r in ranks], sp, m))
        for path, want in partition.flatten(plain[key]).items():
            _close(got[path], want)


@pytest.mark.parametrize("mesh", [(2, 2), (2, 1)])
def test_a_rank_holds_its_block_of_the_moments(runs, mesh):
    plain = runs["plain"]["zero1"]
    sizes = dict(zip(("data", "model"), mesh))
    specs = partition.params_pspecs(plain["params"], sizes)
    zspecs = partition.flatten(partition.zero1_specs(specs, plain["params"],
                                                     sizes))
    flat = partition.flatten(specs)
    for r in runs[mesh]:
        mu = partition.flatten(r["qwen_zero1"]["zero1"]["mu"])
        for path, t in partition.flatten(plain["mu"]).items():
            assert tuple(mu[path].shape) == partition.local_shape(
                t.shape, zspecs[path], sizes), path
            whole = int(np.prod(partition.local_shape(t.shape, flat[path],
                                                      sizes)))
            cut = partition.zero1_dim(flat[path], zspecs[path]) is not None
            assert mu[path].numel() * (mesh[0] if cut else 1) == whole, path
        assert r["qwen_zero1"]["zero1"]["moment_bytes"] == 2 * sum(
            x.numel() * 4 for x in mu.values())


SHAPES = {"train_4k": ShapeSpec("train_4k", 16, 32, "train")}


@pytest.mark.parametrize("arch,variant", [
    ("qwen1.5-4b-smoke", "zero1"), ("qwen1.5-4b-smoke", "hc_a_zero1"),
    ("mixtral-8x7b-smoke", "hc_b_zero1"), ("mixtral-8x7b-smoke",
                                           "hc_b_final")])
def test_zero1_variants_run_with_sharded_moments(tmp_path, arch, variant):
    """Each ZeRO-1 variant's cell is ok; its moments are the ZeRO-1
    layout's bytes, 1/dp of the baseline's on the variant's own mesh (its
    rules, axes and knobs, ``zero1`` off) for each leaf with a dim the
    data axes divide; the data axes reduce-scatter and all-gather."""
    v = VARIANTS[variant]
    var = hillclimb.run_variant(arch, "train_4k", variant,
                                out_dir=str(tmp_path), shapes=SHAPES)
    assert var["status"] == "ok", var.get("error") or var.get("reason")
    assert var["zero1"] and var["grad_unreduced"]
    mesh = variant_mesh(v, False)
    overrides = dict(v.get("overrides", {}))
    cfg = get_config(arch)
    if v.get("moe_combine_first"):
        overrides["moe"] = dataclasses.replace(cfg.moe, combine_first=True)
    base = dryrun.run_cell(arch, "train_4k", out_dir=str(tmp_path),
                           shapes=SHAPES, mesh="single", mesh_obj=mesh,
                           rules=v.get("rules"), axes=v.get("axes"),
                           overrides=overrides or None,
                           microbatch=v.get("microbatch"), tag="@base")
    assert base["status"] == "ok"
    cfg = dataclasses.replace(cfg, **overrides)
    p = params_specs(build_model(cfg))
    sizes = mesh_sizes(mesh)
    specs = partition.params_pspecs(p, sizes, v.get("axes"))
    zspecs = partition.zero1_specs(specs, p, sizes)
    dp = sizes["data"]

    def moments(sp):       # two f32 moments a leaf, and the int32 count
        return 4 + 2 * sum(4 * int(np.prod(partition.local_shape(
            t.shape, s, sizes))) for t, s in zip(
                partition.flatten(p).values(),
                partition.flatten(sp).values()))
    assert var["bytes"]["opt_state"] == moments(zspecs)
    assert base["bytes"]["opt_state"] == moments(specs)
    zflat, whole = partition.flatten(zspecs), 0
    for path, s in partition.flatten(specs).items():
        t = partition.flatten(p)[path]
        n, nz = (int(np.prod(partition.local_shape(t.shape, sp, sizes)))
                 for sp in (s, zflat[path]))
        if partition.zero1_dim(s, zflat[path]) is None:
            assert nz == n, path         # no dim the data axes divide
            whole += n
        else:
            assert nz * dp == n, path
    # the leaves left whole are small (biases over few heads); only they
    # and the loss and norm scalars are all-reduced over the data axes
    assert 8 * whole < 0.05 * base["bytes"]["opt_state"]
    data = {k: b for k, b in var["collectives"][
        "link_bytes_by_kind_axis"].items() if k.endswith("|data")}
    assert data["reduce-scatter|data"] > 0 and data["all-gather|data"] > 0
    assert data.get("all-reduce|data", 0.0) < 0.01 * \
        base["collectives"]["link_bytes_by_kind_axis"]["all-reduce|data"]


def test_a_remat_body_recomputed_on_another_thread_keeps_the_context():
    """On the card autograd runs the backward, and so a remat body's
    recompute, on a device thread, where the thread-local ``spmd``
    context is not set: ``spmd.bound`` carries it there (the full-width
    qwen1.5-4b remats its layers under ``launch/tp_train.py``)."""
    import threading
    from repro_torch.launch import spmd
    from repro_torch.launch.sharding import resolve
    sizes = {"data": 2, "model": 4}
    seen = {}

    def body():
        seen["ctx"] = spmd.current()
        seen["heads"] = resolve("heads")[0]
    with spmd.spmd(sizes, {"heads": "model"}) as c:
        run = spmd.bound(body)
        t = threading.Thread(target=run)
        t.start()
        t.join()
        assert seen == {"ctx": c, "heads": "model"}
        t = threading.Thread(target=body)
        t.start()
        t.join()
        assert seen == {"ctx": None, "heads": None}
    assert spmd.bound(body) is body
