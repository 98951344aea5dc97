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
on the leaves of both).  Then ``shard_tree`` and ``unshard_tree``.
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
            assert tuple(mine_fn(path, shp, sizes)) == \
                tuple(ref_fn(path, shp, ref_mesh)), (shape.name, path, shp)
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
