"""The port's AdamW, schedule and int8 error-feedback compression against
the reference, on the same seeded numpy inputs.

Tolerances: the port updates in place with the reference's f32
arithmetic; fused multiply-adds and the norm's summation order may move
the last f32 bit, so ten updates agree to 1e-6 of each leaf's largest
magnitude.  A bf16 param is updated in f32 and rounded, as in the
reference: it agrees to one bf16 unit in the last place (2^-7 relative).
Quantization is exact: the int8 ``q`` and the f32 ``scale`` bit for bit,
the residual to 1e-7.
"""
import collections

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.optim import compression as ref_comp
from repro_torch import optim
from repro_torch.convert import opt_state_from_jax, params_from_jax
from repro_torch.optim import compression

SHAPES = {"embed": {"table": (64, 16)}, "layers": {"w": (3, 16, 24),
                                                     "b": (3, 24)},
          "norm": (16,)}


def _tree(rng, shapes, dtype=np.float32, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, dtype, scale) for k, v in shapes.items()}
    return (rng.normal(size=shapes) * scale).astype(dtype)


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _np(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.float().numpy()
        return t.numpy()
    return np.asarray(t, np.float32) if np.asarray(t).dtype == \
        ml_dtypes.bfloat16 else np.asarray(t)


def _rel(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_ten_updates_match_reference(clip):
    rng = np.random.default_rng(7)
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=12, clip_norm=clip)
    params = _tree(rng, SHAPES)
    ref_p = jax.tree_util.tree_map(jnp.asarray, params)
    ref_s = ref_optim.init(ref_p)
    p = params_from_jax(params, device="cpu")
    s = optim.init(p)
    for _ in range(10):
        grads = _tree(rng, SHAPES, scale=3.0)     # norm > 1: clipping bites
        ref_p, ref_s, ref_m = ref_optim.update(
            ref_optim.AdamWConfig(**cfg),
            jax.tree_util.tree_map(jnp.asarray, grads), ref_s, ref_p)
        p, s, m = optim.update(optim.AdamWConfig(**cfg),
                               params_from_jax(grads, device="cpu"), s, p)
        assert _rel(m["grad_norm"], ref_m["grad_norm"]) <= 1e-6
        assert _rel(m["lr"], ref_m["lr"]) <= 1e-6
    assert int(s.count) == int(ref_s.count) == 10
    for tree, ref_tree in ((p, ref_p), (s.mu, ref_s.mu), (s.nu, ref_s.nu)):
        for a, b in zip(_leaves(_flat(tree)), _leaves(ref_tree)):
            assert _rel(a, b) <= 1e-6


def _flat(tree):
    """The port's tree as numpy, for jax's leaf order."""
    return jax.tree_util.tree_map(_np, tree,
                                  is_leaf=lambda x: isinstance(x,
                                                               torch.Tensor))


def test_adamw_updates_in_place_and_casts_bf16_params():
    rng = np.random.default_rng(3)
    shapes = {"w": (32, 8), "v": (8,)}
    params = _tree(rng, shapes)
    params["w"] = params["w"].astype(ml_dtypes.bfloat16)
    ref_p = jax.tree_util.tree_map(jnp.asarray, params)
    ref_s = ref_optim.init(ref_p)
    p = params_from_jax(params, device="cpu")
    s = optim.init(p)
    storage = {k: v.data_ptr() for k, v in p.items()}
    for _ in range(3):
        grads = _tree(rng, shapes)
        ref_p, ref_s, _ = ref_optim.update(
            ref_optim.AdamWConfig(lr=1e-2, warmup_steps=1),
            jax.tree_util.tree_map(jnp.asarray, grads), ref_s, ref_p)
        p, s, _ = optim.update(optim.AdamWConfig(lr=1e-2, warmup_steps=1),
                               params_from_jax(grads, device="cpu"), s, p)
    assert {k: v.data_ptr() for k, v in p.items()} == storage
    assert p["w"].dtype == torch.bfloat16 and s.mu["w"].dtype == torch.float32
    assert _rel(p["v"], ref_p["v"]) <= 1e-6
    assert _rel(p["w"], ref_p["w"]) <= 2 ** -7


@pytest.mark.parametrize("step", [0, 4, 9, 55, 100, 150])
def test_schedule_matches_reference(step):
    """Warmup (0, 4), its end (9), the cosine's midpoint (55), its end
    (100) and past ``total_steps`` (150)."""
    cfg = dict(lr=3e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    want = float(ref_optim.schedule(ref_optim.AdamWConfig(**cfg),
                                    jnp.int32(step)))
    got = float(optim.schedule(optim.AdamWConfig(**cfg),
                               torch.tensor(step, dtype=torch.int32)))
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("n,scale", [(1, 1.0), (300, 1e-3), (4096, 50.0)])
def test_quantize_leaf_bit_equal(n, scale):
    rng = np.random.default_rng(n)
    g = (rng.normal(size=(n,)) * scale).astype(np.float32)
    err = (rng.normal(size=(n,)) * scale * 0.01).astype(np.float32)
    for e in (None, err):
        q, s, r = ref_comp.quantize_leaf(jnp.asarray(g), None if e is None
                                         else jnp.asarray(e))
        tq, ts, tr = compression.quantize_leaf(
            torch.from_numpy(g), None if e is None else torch.from_numpy(e))
        assert tq.dtype == torch.int8
        np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
        assert ts.numpy().tobytes() == np.asarray(s, np.float32).tobytes()
        assert np.abs(tr.numpy() - np.asarray(r)).max() <= 1e-7


def test_compress_tree_error_feedback_matches_reference():
    rng = np.random.default_rng(11)
    params = _tree(rng, SHAPES)
    ref_err = ref_comp.init_error(jax.tree_util.tree_map(jnp.asarray,
                                                         params))
    err = compression.init_error(params_from_jax(params, device="cpu"))
    for _ in range(4):
        grads = _tree(rng, SHAPES)
        ref_deq, ref_err = ref_comp.compress_tree(
            jax.tree_util.tree_map(jnp.asarray, grads), ref_err)
        deq, err = compression.compress_tree(
            params_from_jax(grads, device="cpu"), err)
        for a, b in zip(_leaves(_flat(deq)), _leaves(ref_deq)):
            np.testing.assert_array_equal(a, np.asarray(b))
        for a, b in zip(_leaves(_flat(err)), _leaves(ref_err)):
            assert np.abs(a - np.asarray(b)).max() <= 1e-7
    assert compression.compressed_bytes(params_from_jax(
        params, device="cpu")) == ref_comp.compressed_bytes(
        jax.tree_util.tree_map(jnp.asarray, params))


def test_opt_state_and_namedtuples_carry_across():
    rng = np.random.default_rng(5)
    params = jax.tree_util.tree_map(jnp.asarray, _tree(rng, SHAPES))
    state = ref_optim.init(params)
    _, state, _ = ref_optim.update(
        ref_optim.AdamWConfig(), jax.tree_util.tree_map(
            jnp.asarray, _tree(rng, SHAPES)), state, params)
    host = jax.tree_util.tree_map(np.asarray, state)
    got = opt_state_from_jax(host, device="cpu")
    assert isinstance(got, optim.AdamWState)
    assert got.count.dtype == torch.int32 and int(got.count) == 1
    for a, b in zip(_leaves(_flat(got)), _leaves(host)):
        np.testing.assert_array_equal(a, b)
    # params_from_jax keeps a NamedTuple's class (it used to raise)
    Pair = collections.namedtuple("Pair", "a b")
    pair = params_from_jax(Pair(np.ones(2, np.float32), [np.zeros(1)]),
                           device="cpu")
    assert type(pair) is Pair and isinstance(pair.b, list)
    assert pair.a.tolist() == [1.0, 1.0]
