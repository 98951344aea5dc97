"""The port's checkpoints in the reference's on-disk format: a checkpoint
written by either package restores in the other, bit for bit, with the
same manifest (keys, files, shapes, dtypes, byte-sum checksums)."""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.checkpoint import CheckpointManager as RefManager
from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import opt_state_from_jax, params_from_jax


def _ref_tree(seed=0):
    rng = np.random.default_rng(seed)
    params = {"a": jnp.asarray(rng.normal(size=(16, 8)), jnp.float32),
              "b": {"c": jnp.arange(10, dtype=jnp.int32),
                    "d": jnp.asarray(rng.normal(size=(4,)), jnp.bfloat16)},
              "layers": [jnp.asarray(rng.normal(size=(3,)), jnp.float32)]}
    opt = ref_optim.init({"a": params["a"]})
    _, opt, _ = ref_optim.update(ref_optim.AdamWConfig(),
                                 {"a": params["a"] * 2}, opt,
                                 {"a": params["a"]})
    return {"params": params, "opt": opt}


def _port_tree(ref):
    host = jax.tree_util.tree_map(np.asarray, ref)
    return {"params": params_from_jax(host["params"], device="cpu"),
            "opt": opt_state_from_jax(host["opt"], device="cpu")}


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return x.numpy(), x.numpy().dtype.name
    a = np.asarray(x)
    if a.dtype == ml_dtypes.bfloat16:
        return a.view(np.uint16), "bfloat16"
    return a, a.dtype.name


def _assert_bit_equal(got, want):
    g = jax.tree_util.tree_leaves(got, is_leaf=lambda x: isinstance(
        x, torch.Tensor))
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w) > 0
    for a, b in zip(g, w):
        (ab, an), (bb, bn) = _bits(a), _bits(b)
        assert an == bn and ab.shape == bb.shape
        np.testing.assert_array_equal(ab, bb)


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def test_reference_save_restores_in_the_port(tmp_path):
    ref = _ref_tree()
    RefManager(str(tmp_path)).save(3, ref, extra={"data_step": 3})
    like = _port_tree(_ref_tree(seed=1))          # other values, same tree
    got = CheckpointManager(str(tmp_path)).restore(3, like)
    assert isinstance(got["opt"], optim.AdamWState)
    assert got["params"]["b"]["d"].dtype == torch.bfloat16
    assert got["opt"].count.dtype == torch.int32
    _assert_bit_equal(got, ref)
    assert CheckpointManager(str(tmp_path)).extra(3) == {"data_step": 3}


def test_port_save_restores_in_the_reference(tmp_path):
    ref = _ref_tree()
    CheckpointManager(str(tmp_path)).save(5, _port_tree(ref),
                                          extra={"data_step": 5})
    got = RefManager(str(tmp_path)).restore(5, _ref_tree(seed=1))
    assert isinstance(got["opt"], ref_optim.AdamWState)
    _assert_bit_equal(_port_tree(got), ref)
    assert RefManager(str(tmp_path)).extra(5) == {"data_step": 5}


def test_manifests_and_files_agree(tmp_path):
    ref = _ref_tree()
    a, b = str(tmp_path / "ref"), str(tmp_path / "port")
    RefManager(a).save(2, ref, extra={"k": 1})
    CheckpointManager(b).save(2, _port_tree(ref), extra={"k": 1})
    ma, mb = _manifest(a, 2), _manifest(b, 2)
    assert ma == mb
    assert list(ma["leaves"]) == list(mb["leaves"])       # same order
    assert "opt/.mu/a" in mb["leaves"] and "opt/.count" in mb["leaves"]
    assert mb["leaves"]["params/b/d"]["dtype"] == "bfloat16"
    for meta in mb["leaves"].values():
        with open(os.path.join(a, "step_00000002", meta["file"]), "rb") as f:
            fa = f.read()
        with open(os.path.join(b, "step_00000002", meta["file"]), "rb") as f:
            assert f.read() == fa


def test_flipped_byte_raises(tmp_path):
    m = CheckpointManager(str(tmp_path))
    tree = _port_tree(_ref_tree())
    m.save(1, tree)
    d = tmp_path / "step_00000001"
    fn = d / _manifest(str(tmp_path), 1)["leaves"]["params/a"]["file"]
    raw = bytearray(fn.read_bytes())
    raw[-1] ^= 0x01
    fn.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="params/a"):
        m.restore(1, tree)
    m.restore(1, tree, verify=False)              # the check is the guard


def test_keep_three_and_async_snapshot(tmp_path):
    m = CheckpointManager(str(tmp_path), keep=3)
    tree = {"w": torch.arange(6, dtype=torch.float32)}
    for step in range(1, 6):
        m.save_async(step, tree, extra={"data_step": step})
        tree["w"].add_(1.0)         # the next step overwrites in place
    m.wait()
    assert m.steps() == [3, 4, 5] and m.latest_step() == 5
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp_")]
    got = m.restore(4, tree)
    assert got["w"].tolist() == [3.0, 4.0, 5.0, 6.0, 7.0, 8.0]
    assert m.extra(4) == {"data_step": 4}
    placed = m.restore(5, tree, shardings={"w": torch.device("cpu")})
    assert placed["w"].device.type == "cpu"
