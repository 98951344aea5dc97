"""The port's qwen1.5-4b model against the reference, on converted params.

``qwen1.5-4b-smoke`` (4 layers, d_model 128) is initialised by the
reference, carried across by ``params_from_jax``, and both packages
compute teacher-forced logits, prefill logits and KV cache, and 8
teacher-forced decode steps, on the SW route (reference SW vs port SW) and
the kernel route (reference Pallas interpret mode vs the port's HW
wrapper, whose CPU path is the kernel's plain blocked version).

Tolerances: float32 agrees to 2e-5 absolute (logits reach ~5; float32
rounding, other summation orders).  bfloat16 rounds every activation to 8
significant bits and the two frameworks round at different points, so
logits and cache entries may differ by a few bf16 units in the last place:
0.1 absolute (six ulps at |x| ~ 4) and 3% of the largest magnitude.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.routing import RoutingPlan as RefPlan
from repro.models import build_model as ref_build_model

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model
from _torch_threads import one_torch_thread  # noqa: F401

ARCH = "qwen1.5-4b-smoke"
STAGES = ["flash_attention", "swiglu_mlp"]
TOL = {"float32": (2e-5, 1e-5), "bfloat16": (0.1, 0.03)}
ROUTES = [("sw", "sw"), ("interpret", "hw")]   # (reference, port)


@pytest.fixture(scope="module")
def np_params():
    cfg = ref_get_config(ARCH)
    params = ref_build_model(cfg).init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    # nonzero biases and norm scales, so those paths are exercised
    rng = np.random.default_rng(0)
    for name in ("bq", "bk", "bv"):
        a = tree["layers"]["attn"][name]
        tree["layers"]["attn"][name] = (rng.normal(size=a.shape) * 0.1
                                        ).astype(np.float32)
    for name in ("ln1", "ln2"):
        a = tree["layers"][name]["scale"]
        tree["layers"][name]["scale"] = (1 + 0.1 * rng.normal(size=a.shape)
                                         ).astype(np.float32)
    return tree


def _models(dtype, routes):
    rcfg = dataclasses.replace(ref_get_config(ARCH), dtype=dtype)
    pcfg = dataclasses.replace(get_config(ARCH), dtype=dtype)
    return (ref_build_model(rcfg, routes=RefPlan.for_stages(STAGES,
                                                            routes[0])),
            build_model(pcfg, routes={s: routes[1] for s in STAGES}))


def _close(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    atol, rel = TOL[dtype]
    d = np.abs(got - want).max()
    assert d <= atol and d <= rel * max(np.abs(want).max(), 1.0), d


def test_params_from_jax_keeps_keys_shapes_dtypes(np_params):
    tp = params_from_jax(np_params, device="cpu")
    flat_np = jax.tree_util.tree_flatten_with_path(np_params)[0]
    for path, a in flat_np:
        t = tp
        for p in path:
            t = t[p.key]
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), a)
    bf = np.asarray([1.5, -2.25, 3e-3], dtype=ml_dtypes.bfloat16)
    tb = params_from_jax({"w": bf}, device="cpu")["w"]
    assert tb.dtype == torch.bfloat16
    np.testing.assert_array_equal(tb.float().numpy(), bf.astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("routes", ROUTES, ids=["sw", "kernel"])
def test_logits_all_and_loss_match(np_params, dtype, routes):
    rm, pm = _models(dtype, routes)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = params_from_jax(np_params, device="cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 512, size=(2, 24)).astype(np.int32)
    want = jax.jit(rm.logits_all)(jp, {"tokens": jnp.asarray(toks)})
    _close(pm.logits_all(tp, {"tokens": torch.from_numpy(toks).long()}),
           want, dtype)
    if dtype == "float32":
        tgt = rng.integers(0, 512, size=(2, 24)).astype(np.int32)
        rloss, _ = jax.jit(rm.forward)(jp, {"tokens": jnp.asarray(toks),
                                            "targets": jnp.asarray(tgt)})
        ploss, _ = pm.forward(tp, {"tokens": torch.from_numpy(toks).long(),
                                   "targets": torch.from_numpy(tgt).long()})
        assert abs(float(ploss) - float(rloss)) <= 1e-5 * float(rloss)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("routes", ROUTES, ids=["sw", "kernel"])
def test_prefill_cache_and_decode_match(np_params, dtype, routes):
    rm, pm = _models(dtype, routes)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    tp = params_from_jax(np_params, device="cpu")
    toks = np.random.default_rng(2).integers(0, 512, size=(1, 20)
                                             ).astype(np.int32)
    P, max_len = 12, 32
    rl, rcache = jax.jit(rm.prefill)(
        jp, {"tokens": jnp.asarray(toks[:, :P]),
             "cache": rm.init_cache(1, max_len)})
    pl, pcache = pm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :P]).long(),
                                 "cache": pm.init_cache(1, max_len,
                                                        device="cpu")})
    _close(pl, rl, dtype)
    ref_kv = rcache["grp"][0]          # (L, 1, Smax, Hkv, Dh) per leaf
    for name in ("k", "v"):
        _close(pcache[name], ref_kv[name], dtype)
    np.testing.assert_array_equal(pcache["pos"].numpy(),
                                  np.asarray(ref_kv["pos"]))
    step = jax.jit(rm.decode_step)
    for i in range(8):                 # teacher-forced: same tokens in both
        tok = toks[:, P + i:P + i + 1]
        rl, rcache = step(jp, rcache, jnp.asarray(tok), jnp.int32(P + i))
        pl, pcache = pm.decode_step(tp, pcache, torch.from_numpy(tok).long(),
                                    P + i)
        _close(pl, rl, dtype)
    np.testing.assert_array_equal(pcache["pos"].numpy(),
                                  np.asarray(rcache["grp"][0]["pos"]))


def test_batched_decode_rows_equal_single_decode(np_params):
    """Each slot of a batched decode equals a B=1 decode bit for bit (the
    per-row product order the serve engine's SW contract needs)."""
    pm = build_model(get_config(ARCH))
    tp = params_from_jax(np_params, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, size=(1, n)) for n in (5, 9, 7)]
    caches = []
    batch = pm.init_cache(3, 24, device="cpu")
    for i, pr in enumerate(prompts):
        one = pm.init_cache(1, 24, device="cpu")
        pm.prefill(tp, {"tokens": torch.from_numpy(pr), "cache": one})
        caches.append(one)
        for k in batch:
            batch[k][:, i] = one[k][:, 0]
    tok = torch.from_numpy(rng.integers(0, 512, size=(3, 1)))
    t = [p.shape[1] for p in prompts]
    lb, _ = pm.decode_step(tp, batch, tok, t)
    for i in range(3):
        l1, _ = pm.decode_step(tp, caches[i], tok[i:i + 1], t[i])
        assert torch.equal(lb[i:i + 1], l1)


def test_unported_configs_raise():
    cfg = dataclasses.replace(get_config(ARCH), window=16)
    with pytest.raises(NotImplementedError, match="window"):
        build_model(cfg)
