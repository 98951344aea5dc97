"""The port's partition specs (``launch/partition.py``) against the
reference's, on every architecture's full-width trees.

Shape-only trees as ``tests/test_torch_dryrun.py`` builds them (the
reference's ``params_specs`` and ``input_specs``, the port's on meta).
The reference's functions read only ``mesh.shape`` and
``mesh.axis_names``, so they get a stand-in object; the port's take the
``{axis: size}`` mapping.  Meshes: the production (16, 16) and
(2, 16, 16), the (1, 4) that ``chip_smoke.py`` serves over, and the
``attn2d`` and ``ep`` variant meshes with their param axes.  Per arch and
mesh: ``params_pspecs`` leaf for leaf, ``rules_for``, and
``make_cache_pspec_fn`` and ``batch_pspec`` at every (path, shape) of
both packages' decode caches and batches of every applicable cell (the
two caches lay their leaves out differently, so each function is held
on the leaves of both).  One difference, by design: a stacked cache leaf
(L, B, ...) with as many layers as rows (L = B, mixtral-8x7b's
prefill_32k at "single") keeps its layers whole in the port and cuts its
rows, where the reference's rule cuts its layers; every other leaf's spec
is the reference's.  Then ``shard_tree`` and ``unshard_tree``.
"""
import types

import jax
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.launch import partition as ref_partition
from repro.launch.variants import VARIANTS as REF_VARIANTS
from repro.models import build_model as ref_build_model
from repro.models import input_specs as ref_input_specs
from repro.models import params_specs as ref_params_specs

from repro_torch.configs import ARCH_NAMES, SHAPES, applicable, get_config
from repro_torch.launch import partition
from repro_torch.launch.sharding import PartitionSpec
from repro_torch.launch.variants import VARIANTS
from repro_torch.models import build_model, input_specs, params_specs
from _torch_threads import one_torch_thread  # noqa: F401

MESHES = {
    "single": ({"data": 16, "model": 16}, None),
    "multi": ({"pod": 2, "data": 16, "model": 16}, None),
    "1x4": ({"data": 1, "model": 4}, None),
    "attn2d": (dict(zip(VARIANTS["attn2d"]["mesh_axes"],
                        VARIANTS["attn2d"]["mesh_shape"])),
               VARIANTS["attn2d"]["axes"]),
    "ep": (dict(zip(VARIANTS["ep"]["mesh_axes"],
                    VARIANTS["ep"]["mesh_shape"])), VARIANTS["ep"]["axes"]),
}


def _stand_in(sizes):
    return types.SimpleNamespace(shape=dict(sizes),
                                 axis_names=tuple(sizes))


def _spec(p):
    return repr(tuple(p))


def _ref_flat(tree):
    """(path, leaf) of a reference tree, paths as its ``tree_pspecs``
    joins them."""
    return [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (str(k),))
    elif isinstance(tree, (tuple, list)) and not isinstance(
            tree, PartitionSpec):
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


@pytest.fixture(scope="module")
def trees():
    out = {}

    def get(arch):
        if arch not in out:
            rcfg, cfg = ref_get_config(arch), get_config(arch)
            rm, pm = ref_build_model(rcfg), build_model(cfg)
            inputs = []
            for name, shape in SHAPES.items():
                if not applicable(cfg, shape)[0] or shape.kind == "train":
                    continue
                inputs.append((shape, input_specs(cfg, shape, pm),
                               ref_input_specs(rcfg, REF_SHAPES[name], rm)))
            out[arch] = dict(rcfg=rcfg, cfg=cfg,
                             ref=ref_params_specs(rm), mine=params_specs(pm),
                             inputs=inputs)
        return out[arch]
    return get


def test_variants_table_is_the_reference():
    assert VARIANTS == REF_VARIANTS


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_specs_equal_the_reference(arch, mesh, trees):
    t = trees(arch)
    sizes, axes = MESHES[mesh]
    ref_mesh = _stand_in(sizes)
    # params, leaf for leaf
    ref = dict(_ref_flat(jax.tree_util.tree_map(
        _spec, ref_partition.params_pspecs(t["ref"], ref_mesh, axes),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))))
    mine = dict(_flat(partition.params_pspecs(t["mine"], sizes, axes)))
    assert sorted(ref) == sorted(mine)
    for path, spec in mine.items():
        assert isinstance(spec, PartitionSpec)
        assert repr(tuple(spec)) == ref[path], path
    assert partition.rules_for(t["cfg"], sizes) == \
        ref_partition.rules_for(t["rcfg"], ref_mesh)
    # caches and batches: each function on both packages' leaves
    attn = (axes or {}).get("attn", "model")
    for shape, pin, rin in t["inputs"]:
        B = shape.global_batch
        mine_fn = partition.make_cache_pspec_fn(B, sizes, attn_axis=attn)
        ref_fn = ref_partition.make_cache_pspec_fn(B, ref_mesh,
                                                   attn_axis=attn)
        pc = pin["cache"] if shape.kind == "decode" else pin["batch"]["cache"]
        rc = rin["cache"] if shape.kind == "decode" else rin["batch"]["cache"]
        leaves = [(p, tuple(x.shape)) for p, x in _flat(pc)] + \
            [(p, tuple(x.shape)) for p, x in _ref_flat(rc)]
        for path, shp in leaves:
            want = list(ref_fn(path, shp, ref_mesh))
            if len(shp) >= 2 and shp[0] == shp[1] == B:
                # a stacked cache of as many layers as rows: the port keeps
                # its layers whole and cuts the rows (the reference cuts
                # the layers in their place)
                want[0], want[1] = want[1], want[0]
            assert list(mine_fn(path, shp, sizes)) == want, \
                (shape.name, path, shp)
        batch = {} if shape.kind == "decode" else \
            {k: v for k, v in pin["batch"].items() if k != "cache"}
        for path, x in list(_flat(batch)) + [("tokens", torch.empty(
                (B, 1), device="meta"))]:
            assert tuple(partition.batch_pspec(path, x.shape, sizes)) == \
                tuple(ref_partition.batch_pspec(path, x.shape, ref_mesh))


def test_cache_pspec_raises_as_the_reference():
    with pytest.raises(NotImplementedError):
        partition.cache_pspec("k", (1, 2), {"model": 2})
    with pytest.raises(NotImplementedError):
        ref_partition.cache_pspec("k", (1, 2), _stand_in({"model": 2}))


@pytest.mark.parametrize("sizes", [{"data": 1, "model": 4},
                                   {"data": 2, "model": 2},
                                   {"data": 2, "model_h": 2, "model_f": 2}])
def test_shard_tree_round_trips(sizes):
    """Every rank's shard has ``local_shape``; ``unshard_tree`` puts the
    shards back bit for bit."""
    g = torch.Generator().manual_seed(0)
    tree = {"attn": {"wq": torch.randn(2, 8, 16, generator=g),
                     "wo": torch.randn(2, 16, 8, generator=g)},
            "ln": {"scale": torch.randn(8, generator=g)},
            "embed": {"table": torch.randn(12, 8, generator=g)}}
    axes = {"attn": tuple(a for a in sizes if a != "data"),
            "ffn": "model", "vocab": tuple(a for a in sizes if a != "data"),
            "ssm": "model", "expert": None}
    specs = partition.params_pspecs(tree, sizes, axes)
    shards = [partition.shard_tree(tree, specs, sizes, c)
              for c in partition.mesh_coords(sizes)]
    for sh in shards:
        for (p, t), (_, s) in zip(_flat(sh), _flat(specs)):
            assert tuple(t.shape) == partition.local_shape(
                dict(_flat(tree))[p].shape, s, sizes)
    back = partition.unshard_tree(shards, specs, sizes)
    for (p, a), (_, b) in zip(_flat(back), _flat(tree)):
        assert torch.equal(a, b), p


def _packed_tree(cfg, L=1, B=2):
    """zamba2's packed leaves at ``cfg``'s width (``L`` layers, a conv
    cache of ``B`` slots), random, under their model paths."""
    from repro_torch.models.mamba2 import dims
    g = torch.Generator().manual_seed(0)
    d_inner, nheads, conv_dim = dims(cfg)
    K = cfg.ssm.conv_kernel
    params = {"layers": {"mix": {
        "in_proj": torch.randn(L, cfg.d_model, d_inner + conv_dim + nheads,
                               generator=g),
        "conv_w": torch.randn(L, K, conv_dim, generator=g),
        "conv_b": torch.randn(L, conv_dim, generator=g)}}}
    cache = {"mamba": {"conv": torch.randn(L, B, K - 1, conv_dim,
                                           generator=g)}}
    return params, cache


@pytest.mark.parametrize("m", [2, 4, 16])
def test_component_layout_round_trips_and_cuts_every_component(m):
    """zamba2-1.2b at full width: ``shard_tree`` with ``packed_layout``
    gives rank r the r-th 1/m of every component of ``in_proj`` (z, x, B,
    C, dt), ``conv_w`` and the ``conv`` cache (x, B, C), in order, under
    the unchanged spec, and ``unshard_tree`` puts the leaves back bit for
    bit."""
    cfg = get_config("zamba2-1.2b")
    sizes = {"data": 1, "model": m}
    layout = partition.packed_layout(cfg)
    assert [c for c, _ in layout["in_proj"]] == ["z", "x", "B", "C", "dt"]
    assert [w for _, w in layout["in_proj"]] == [4096, 4096, 64, 64, 64]
    params, cache = _packed_tree(cfg)
    for tree, specs in (
            (params, partition.params_pspecs(params, sizes)),
            (cache, partition.tree_pspecs(cache, sizes,
                                          partition.make_cache_pspec_fn(
                                              2, sizes)))):
        for path, spec in partition.flatten(specs).items():
            assert spec[-1] == "model", (path, spec)
        shards = [partition.shard_tree(tree, specs, sizes, c, layout=layout)
                  for c in partition.mesh_coords(sizes)]
        flat = partition.flatten(tree)
        for r, sh in enumerate(shards):
            for path, t in partition.flatten(sh).items():
                full = flat[path]
                assert t.shape[-1] * m == full.shape[-1]
                comps = layout[path.split("/")[-1]]
                off, pos = 0, 0
                for _, w in comps:       # rank r's 1/m of each, in order
                    n = w // m
                    assert torch.equal(
                        t[..., pos:pos + n],
                        full[..., off + r * n:off + (r + 1) * n]), path
                    off, pos = off + w, pos + n
        back = partition.unshard_tree(shards, specs, sizes, layout=layout)
        for path, t in partition.flatten(back).items():
            assert torch.equal(t, flat[path]), path


def test_component_that_does_not_divide_is_refused_by_name():
    """A leaf that divides m with a component that does not: ``shard_tree``
    and the runtime raise ``NotImplementedError`` naming both; the dry run
    records the cell as a skip."""
    import dataclasses

    from repro_torch.launch import dryrun, spmd
    cfg = get_config("zamba2-1.2b")
    odd = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                           state_dim=48))
    sizes = {"data": 1, "model": 32}        # 8352 columns: 261 a rank
    params, _ = _packed_tree(odd)
    specs = partition.params_pspecs(params, sizes)
    assert partition.flatten(specs)["layers/mix/in_proj"][-1] == "model"
    with pytest.raises(NotImplementedError,
                       match=r"(in_proj|conv_[bw]): its B component \(48"):
        partition.shard_tree(params, specs, sizes, {"data": 0, "model": 1},
                             layout=partition.packed_layout(odd))
    with spmd.spmd(sizes, partition.rules_for(odd, sizes)):
        with pytest.raises(NotImplementedError, match=r"in_proj.*\bB\b"):
            spmd.check_runtime(odd)
    spmd.check_runtime(odd)                  # outside spmd: nothing
    smoke = get_config("zamba2-1.2b-smoke")
    rec = dryrun.run_cell(
        "zamba2-1.2b-smoke", "decode_32k", mesh="1x2", force=True,
        out_dir=str(__import__("tempfile").mkdtemp()),
        shapes={"decode_32k": dataclasses.replace(SHAPES["decode_32k"],
                                                  seq_len=64,
                                                  global_batch=2)},
        overrides={"ssm": dataclasses.replace(smoke.ssm, state_dim=17)})
    assert rec["status"] == "skip" and "in_proj" in rec["reason"], rec
