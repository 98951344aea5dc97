"""mistral-nemo-12b, mixtral-8x7b and llama4-scout-17b-a16e on the port,
against the reference, at their reduced configs.

Each ``-smoke`` model is initialised once by the reference and carried
across by ``params_from_jax``; both packages compute the training forward
(loss and metrics: for the MoE models the aux and z losses and the drop
fraction), prefill logits and KV cache, and 8 teacher-forced decode steps.
mixtral-8x7b-smoke has a window of 16 on every layer: its cache has 16
slots, so the 20-token prompt wraps the ring at prefill and decode keeps
wrapping it.

Routes: SW against SW in float32, to 2e-5 absolute and 1e-4 of the
largest magnitude (float32 rounding in other summation orders); the
kernel route (the reference's Pallas interpret mode against the port's
HW wrappers, whose CPU path is each kernel's plain blocked version) on
prefill logits, at the ops' 2e-2.  Then mixtral-smoke's step-0 grads
against ``jax.value_and_grad`` (1e-4 of each leaf's largest magnitude),
the SW ``ServeEngine`` bit-identical to the port's ``reference_decode``
in both failover modes, and ``init(dtype=bf16)`` equal bit for bit to
``compute_params(init())``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.routing import RoutingPlan as RefPlan
from repro.models import build_model as ref_build_model

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model, compute_params
from repro_torch.serve import (RECOMPILE, RESIDENT, Request, ServeConfig,
                               ServeEngine, reference_decode)
from repro_torch.train.runner import model_stage_names, value_and_grad
from repro_torch.viscosity.lang import tree_leaves
from _torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["mistral-nemo-12b-smoke", "mixtral-8x7b-smoke",
         "llama4-scout-17b-a16e-smoke"]
TOL = (2e-5, 1e-4)
KERNEL_TOL = 2e-2
P, MAX_LEN = 20, 32


@pytest.fixture(scope="module")
def reference():
    """Per arch: the reference's float32 model and params (as numpy), and
    the port's model on the same params."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = dataclasses.replace(ref_get_config(arch), dtype="float32")
            rm = ref_build_model(cfg)
            params = rm.init(jax.random.PRNGKey(0))
            host = jax.tree_util.tree_map(np.asarray, params)
            pcfg = dataclasses.replace(get_config(arch), dtype="float32")
            cache[arch] = dict(rm=rm, params=params, host=host, pcfg=pcfg,
                               pm=build_model(pcfg),
                               tp=params_from_jax(host, device="cpu"))
        return cache[arch]
    return get


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    d = np.abs(got - want).max()
    assert d <= tol[0] and d <= tol[1] * max(np.abs(want).max(), 1.0), d


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 512, size=shape
                                                ).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_metrics_match(arch, reference):
    ref = reference(arch)
    toks, tgt = _tokens(1, (2, 24)), _tokens(2, (2, 24))
    rl, rmet = jax.jit(ref["rm"].forward)(
        ref["params"], {"tokens": jnp.asarray(toks),
                        "targets": jnp.asarray(tgt)})
    pl, pmet = ref["pm"].forward(ref["tp"], {
        "tokens": torch.from_numpy(toks).long(),
        "targets": torch.from_numpy(tgt).long()})
    assert set(pmet) == set(rmet)
    if ref["pcfg"].moe is not None:
        assert {"aux_loss", "z_loss", "drop_frac"} <= set(pmet)
    for k in rmet:
        _close(pmet[k], rmet[k])
    _close(pl, rl)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_and_decode_match(arch, reference):
    ref = reference(arch)
    rm, pm, tp = ref["rm"], ref["pm"], ref["tp"]
    toks = _tokens(3, (1, P + 8))
    rl, rcache = jax.jit(rm.prefill)(
        ref["params"], {"tokens": jnp.asarray(toks[:, :P]),
                        "cache": rm.init_cache(1, MAX_LEN)})
    pl, pcache = pm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :P]
                                                            ).long(),
                                 "cache": pm.init_cache(1, MAX_LEN,
                                                        device="cpu")})
    _close(pl, rl)
    window = ref["pcfg"].window
    assert pcache["k"].shape[2] == (min(MAX_LEN, window) if window
                                    else MAX_LEN)
    ref_kv = rcache["grp"][0]          # (L, 1, Smax, Hkv, Dh) per leaf
    for name in ("k", "v"):
        _close(pcache[name], ref_kv[name])
    np.testing.assert_array_equal(pcache["pos"].numpy(),
                                  np.asarray(ref_kv["pos"]))
    step = jax.jit(rm.decode_step)
    for i in range(8):                 # teacher-forced: same tokens in both
        tok = toks[:, P + i:P + i + 1]
        rl, rcache = step(ref["params"], rcache, jnp.asarray(tok),
                          jnp.int32(P + i))
        pl, pcache = pm.decode_step(tp, pcache, torch.from_numpy(tok).long(),
                                    P + i)
        _close(pl, rl)
    np.testing.assert_array_equal(pcache["pos"].numpy(),
                                  np.asarray(rcache["grp"][0]["pos"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_route_prefill_matches_interpret(arch, reference):
    """Prefill logits on the kernel route: the reference's Pallas
    interpret mode against the port's HW wrappers (on the CPU, the
    kernels' plain blocked versions), at the ops' 2e-2."""
    ref = reference(arch)
    stages = model_stage_names(ref["pcfg"])
    rm = ref_build_model(ref["rm"].cfg, routes=RefPlan.for_stages(
        stages, "interpret"))
    pm = build_model(ref["pcfg"], routes={s: "hw" for s in stages})
    toks = _tokens(4, (1, P))
    rl, _ = jax.jit(rm.prefill)(ref["params"], {
        "tokens": jnp.asarray(toks), "cache": rm.init_cache(1, MAX_LEN)})
    pl, _ = pm.prefill(ref["tp"], {"tokens": torch.from_numpy(toks).long(),
                                   "cache": pm.init_cache(1, MAX_LEN,
                                                          device="cpu")})
    _close(pl, rl, (KERNEL_TOL, KERNEL_TOL))


def test_mixtral_step0_grads_match_jax(reference):
    ref = reference("mixtral-8x7b-smoke")
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, 512, (2, 24)).astype(np.int32),
             "targets": rng.integers(0, 512, (2, 24)).astype(np.int32)}
    (rl, rmet), rg = jax.jit(jax.value_and_grad(
        ref["rm"].forward, has_aux=True))(
        ref["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    (pl, pmet), pg = value_and_grad(
        ref["pm"].forward, ref["tp"],
        {k: torch.from_numpy(v).long() for k, v in batch.items()})
    assert float(pl) == pytest.approx(float(rl), rel=1e-5)
    assert float(pmet["drop_frac"]) == pytest.approx(
        float(rmet["drop_frac"]), abs=1e-7)
    flat = jax.tree_util.tree_flatten_with_path(rg)[0]
    assert len(flat) == len(tree_leaves(pg))
    for path, g in flat:
        got = pg
        for k in path:
            got = got[k.key]
        g = np.asarray(g)
        rel = np.abs(got.numpy() - g).max() / np.abs(g).max()
        assert rel <= 1e-4, (jax.tree_util.keystr(path), rel)


@pytest.mark.parametrize("arch", ARCHS)
def test_sw_engine_bit_identical_to_reference_decode(arch, reference):
    """Both failover modes, 4 requests on 3 slots; for mixtral-smoke two
    prompts exceed the 16-slot window, so their prefill wraps the ring."""
    ref = reference(arch)
    cfg = get_config(arch)               # the default bf16 compute dtype
    params = ref["tp"]
    reqs = [Request(rid=i, prompt=_tokens(10 + i, (n,)), max_new_tokens=m,
                    arrival=i) for i, (n, m) in enumerate(
                        [(9, 6), (21, 5), (17, 7), (4, 3)])]
    wants = {r.rid: reference_decode(cfg, params, r.prompt,
                                     r.max_new_tokens, max_len=MAX_LEN)
             for r in reqs}
    for mode in (RECOMPILE, RESIDENT):
        eng = ServeEngine(cfg, params, ServeConfig(
            max_len=MAX_LEN, max_slots=3, failover=mode), device="cpu")
        done, _ = eng.serve(reqs)
        for r in reqs:
            np.testing.assert_array_equal(done[r.rid].tokens, wants[r.rid])


def test_params_from_jax_carries_the_moe_subtree(reference):
    """The ``moe`` subtree crosses unchanged: the float32 router, the
    experts and llama4's ``shared`` expert, leaf for leaf."""
    for arch in ARCHS[1:]:
        ref = reference(arch)
        want = ref["host"]["layers"]["moe"]
        got = ref["tp"]["layers"]["moe"]
        assert set(got) == set(want)
        assert ("shared" in got) == ref["pcfg"].moe.shared_expert
        flat = jax.tree_util.tree_flatten_with_path(want)[0]
        for path, a in flat:
            t = got
            for k in path:
                t = t[k.key]
            assert t.dtype == torch.float32 and tuple(t.shape) == a.shape
            np.testing.assert_array_equal(t.numpy(), a)
        assert got["router"].shape == (
            ref["pcfg"].num_layers, ref["pcfg"].d_model,
            ref["pcfg"].moe.num_experts)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_in_compute_dtype_equals_cast_init(arch):
    model = build_model(get_config(arch))
    want = compute_params(model.init(3, device="cpu"), torch.bfloat16)
    got = model.init(3, device="cpu", dtype=torch.bfloat16)
    la, lb = tree_leaves(want), tree_leaves(got)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if model.cfg.moe is not None:
        assert got["layers"]["moe"]["router"].dtype == torch.float32
