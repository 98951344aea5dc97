"""The port's logical-axis rules (``launch/sharding.py``), production
meshes (``launch/mesh.py``) and the runtime's collectives outside and
inside ``spmd`` (``launch/spmd.py``), against the reference where it has
a counterpart.

``resolve`` is held to the reference's over every rule set the port uses
(``DEFAULT_RULES``, ``rules_for`` on each arch, the variants' rules) on
the meshes of ``tests/test_torch_partition.py`` and with no mesh; the
reference reads only ``mesh.axis_names`` there, so it gets a stand-in.
``test_sharding_constrain_narrow_except`` (``tests/test_lanefault.py``)
is restated for the port's ``constrain``.
"""
import types

import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch import partition as ref_partition
from repro.launch import sharding as ref_sharding

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import partition, sharding, spmd
from repro_torch.launch.variants import VARIANTS
from _torch_threads import one_torch_thread  # noqa: F401

MESHES = {
    "none": None,
    "single": {"data": 16, "model": 16},
    "multi": {"pod": 2, "data": 16, "model": 16},
    "1x4": {"data": 1, "model": 4},
    "attn2d": dict(zip(VARIANTS["attn2d"]["mesh_axes"],
                       VARIANTS["attn2d"]["mesh_shape"])),
    "ep": dict(zip(VARIANTS["ep"]["mesh_axes"],
                   VARIANTS["ep"]["mesh_shape"])),
}
NAMES = list(sharding.DEFAULT_RULES) + [None, "unknown"]


def _stand_in(sizes):
    return None if sizes is None else types.SimpleNamespace(
        shape=dict(sizes), axis_names=tuple(sizes))


def _rule_sets():
    out = {"default": sharding.DEFAULT_RULES}
    for v in ("attn2d", "ep", "hc_b"):
        out[v] = VARIANTS[v]["rules"]
    return out


@pytest.mark.parametrize("rules,mesh", [
    (r, m) for r in list(_rule_sets()) + list(ARCH_NAMES) for m in MESHES
    if not (r in ARCH_NAMES and MESHES[m] is None)])   # rules_for: a mesh
def test_resolve_equals_the_reference(rules, mesh):
    sizes = MESHES[mesh]
    if rules in ARCH_NAMES:
        mine_rules = partition.rules_for(get_config(rules), sizes)
        ref_rules = ref_partition.rules_for(ref_get_config(rules),
                                            _stand_in(sizes))
        assert mine_rules == ref_rules
    else:
        mine_rules = ref_rules = _rule_sets()[rules]
    with sharding.axis_rules(mine_rules, sizes), \
            ref_sharding.axis_rules(ref_rules, _stand_in(sizes)):
        for n in NAMES:
            assert tuple(sharding.resolve(n)) == \
                tuple(ref_sharding.resolve(n)), n
        assert tuple(sharding.resolve(*NAMES)) == \
            tuple(ref_sharding.resolve(*NAMES))
        m, spec = sharding.named_sharding(sizes, "batch", "heads")
        assert m is sizes and spec == sharding.resolve("batch", "heads")


def test_axis_rules_restore_the_previous_rules():
    assert sharding.resolve("heads") == sharding.PartitionSpec(None)
    with sharding.axis_rules({"heads": "model"}):
        with sharding.axis_rules({"heads": None}):
            assert sharding.resolve("heads") == (None,)
        assert sharding.resolve("heads") == ("model",)
    assert sharding.resolve("heads") == (None,)


def test_partition_spec_normalises_one_name_tuples():
    assert tuple(sharding.PartitionSpec(("data",), ("pod", "data"), ())) == \
        ("data", ("pod", "data"), None)


def test_sharding_constrain_narrow_except(monkeypatch):
    x = torch.ones((4, 4))
    assert sharding.constrain(x, "batch") is x     # no rules: no-op
    with sharding.axis_rules({"batch": None}):
        def spec_error(*a, **k):
            raise ValueError("rank mismatch")
        monkeypatch.setattr(sharding, "check_layout", spec_error)
        assert sharding.constrain(x, "batch") is x  # expected: swallowed

        def bug(*a, **k):
            raise RuntimeError("not a spec error")
        monkeypatch.setattr(sharding, "check_layout", bug)
        with pytest.raises(RuntimeError, match="not a spec error"):
            sharding.constrain(x, "batch")


def test_constrain_checks_the_local_shape_inside_spmd():
    """Inside ``spmd`` the local shape is held to the global one cut by
    the rules; a mismatch is a spec error (logged), never a new value."""
    sizes = {"data": 1, "model": 2}
    with spmd.spmd(sizes, {"heads": "model"}, coords={"data": 0,
                                                       "model": 1},
                   dims={"heads": 4, "head_dim": 8}):
        ok = torch.ones(2, 3, 2, 8)
        sharding.check_layout(ok, ("batch", "seq", "heads", "head_dim"))
        bad = torch.ones(2, 3, 4, 8)
        with pytest.raises(ValueError, match="heads"):
            sharding.check_layout(bad, ("batch", "seq", "heads",
                                        "head_dim"))
        assert sharding.constrain(bad, "batch", "seq", "heads",
                                  "head_dim") is bad


def test_collectives_outside_spmd_return_their_input():
    x = torch.randn(3, 4, requires_grad=True)
    assert spmd.current() is None
    for fn in (lambda t: spmd.reduce_over(t, "model"),
               lambda t: spmd.replicate_over(t, "model"),
               lambda t: spmd.gather_over(t, "model", -1),
               lambda t: spmd.scatter_over(t, "model", -1),
               lambda t: spmd.reshard(t, -1, "model", None)):
        assert fn(x) is x
    # inside, over an axis of one rank: the same
    with spmd.spmd({"data": 2, "model": 1}, sharding.DEFAULT_RULES):
        assert spmd.reduce_over(x, "model") is x
        assert spmd.gather_over(x, "model", -1) is x


def test_counting_comm_gives_shapes_and_ring_bytes():
    """The dry run's stub: the result shapes, and per call the payload and
    the ring's per-device link bytes (all-reduce 2(m-1)/m, all-gather
    (m-1)/m of the output)."""
    sizes = {"data": 1, "model": 4}
    comm = spmd.CountingComm(sizes)
    with spmd.spmd(sizes, sharding.DEFAULT_RULES, coords={"model": 2},
                   comm=comm):
        x = torch.empty(2, 8, dtype=torch.bfloat16, device="meta")
        assert spmd.reduce_over(x, "model").shape == (2, 8)
        assert spmd.gather_over(x, "model", -1).shape == (2, 32)
    snap = comm.log.snapshot()
    assert snap["all-reduce|model|float32"] == {
        "n": 1, "bytes": 64.0, "link_bytes": 2 * 64.0 * 3 / 4}
    assert snap["all-gather|model|bfloat16"] == {
        "n": 1, "bytes": 128.0, "link_bytes": 128.0 * 3 / 4}


def test_scatter_and_gather_are_conjugate_under_autograd():
    """On a one-process "mesh" of two ranks the stub's gather repeats the
    shard; its backward keeps the rank's slice, and the slice's backward
    gathers: gradients flow with the right shapes."""
    sizes = {"model": 2}
    with spmd.spmd(sizes, {"heads": "model"}, coords={"model": 1}):
        x = torch.randn(3, 4, requires_grad=True)
        y = spmd.gather_over(x, "model", -1)
        assert y.shape == (3, 8)
        (g,) = torch.autograd.grad(y.sum(), x)
        assert g.shape == x.shape
        z = spmd.scatter_over(y.detach().requires_grad_(), "model", -1)
        assert torch.equal(z, y.detach()[:, 4:])


def test_production_meshes_and_their_shortfall():
    meta = [torch.device("meta")] * 512
    single = mesh_mod.make_production_mesh(devices=meta)
    multi = mesh_mod.make_production_mesh(multi_pod=True, devices=meta)
    assert (single.shape, single.axes) == ((16, 16), ("data", "model"))
    assert (multi.shape, multi.axes) == ((2, 16, 16),
                                         ("pod", "data", "model"))
    assert single.axis_sizes == {"data": 16, "model": 16}
    with pytest.raises(RuntimeError, match=r"short 254 device\(s\)"):
        mesh_mod.make_production_mesh(devices=[torch.device("cpu")] * 2)
    assert mesh_mod.NVLINK_BW == 450e9 and mesh_mod.GPUS_PER_NODE == 8
