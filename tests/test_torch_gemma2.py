"""gemma2-2b on the port, against the reference, at its reduced config.

``gemma2-2b-smoke`` has three layers: a local/global group (window 16, then
global) and a local tail; d_model 128, head dim 32, vocab 512, both
softcaps (attention 50, final 30), pre- and post-norms, the sqrt(d)
embedding scale and a GeGLU MLP.  It is initialised once by the reference
and carried across by ``params_from_jax``.

Routes: SW against SW in float32, to 2e-5 absolute and 1e-4 of the
largest magnitude (float32 rounding in other summation orders); the
kernel route (the reference's Pallas interpret mode against the port's
INTERPRET replicas and HW wrappers, whose CPU path is each kernel's plain
blocked version) to the ops' 2e-2 absolute and 1e-2 of the largest
magnitude.  The cache: the local layers hold ``min(max_len, window)`` = 16
slots, the global one ``max_len`` = 32, so a 20-token prompt wraps the
local rings at prefill and decode keeps wrapping them, while the global
layer writes slot t.
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
from repro_torch.train.runner import model_stage_names
from repro_torch.viscosity.lang import tree_leaves
from _torch_threads import one_torch_thread  # noqa: F401

ARCH = "gemma2-2b-smoke"
TOL = (2e-5, 1e-4)
KERNEL_TOL = (2e-2, 1e-2)
P, MAX_LEN, WINDOW = 20, 32, 16


@pytest.fixture(scope="module")
def ref():
    """The reference's float32 model and params (as numpy), the port's
    model on the same params, and the reference's interpret-route model."""
    cfg = dataclasses.replace(ref_get_config(ARCH), dtype="float32")
    rm = ref_build_model(cfg)
    params = rm.init(jax.random.PRNGKey(0))
    host = jax.tree_util.tree_map(np.asarray, params)
    pcfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    stages = model_stage_names(pcfg)
    return dict(rm=rm, params=params, host=host, pcfg=pcfg, stages=stages,
                pm=build_model(pcfg), tp=params_from_jax(host, device="cpu"),
                rm_int=ref_build_model(cfg, routes=RefPlan.for_stages(
                    stages, "interpret")))


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    d = np.abs(got - want).max()
    assert d <= tol[0] and d <= tol[1] * max(np.abs(want).max(), 1.0), d


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 512, size=shape
                                                ).astype(np.int32)


def test_config_and_layout():
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.window, cfg.resolved_head_dim) == (3, WINDOW,
                                                                   32)
    full = get_config("gemma2-2b")
    assert (full.resolved_head_dim, full.window, full.num_layers) == (256,
                                                                      4096,
                                                                      26)
    assert build_model(cfg)._kv_at == (("local", 0), ("global", 0),
                                       ("local", 1))
    # the 5:1 sibling takes the same local/global caches
    assert build_model(get_config("gemma3-1b"))._kv_at[4:7] == (
        ("local", 4), ("global", 0), ("local", 5))


@pytest.mark.parametrize("route", ["sw", "interpret", "hw"])
def test_logits_and_loss_match(route, ref):
    """``logits_all`` (the final softcap on the tied head) and ``forward``
    (loss and metrics, the softcap in the chunked cross-entropy): SW
    against the reference's SW in f32; the kernel routes against its
    interpret route."""
    toks, tgt = _tokens(1, (2, 24)), _tokens(2, (2, 24))
    if route == "sw":
        rm, pm, tol = ref["rm"], ref["pm"], TOL
    else:
        rm = ref["rm_int"]
        pm = build_model(ref["pcfg"], routes={s: route
                                              for s in ref["stages"]})
        tol = KERNEL_TOL
    rbatch = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt)}
    pbatch = {"tokens": torch.from_numpy(toks).long(),
              "targets": torch.from_numpy(tgt).long()}
    rlog = jax.jit(rm.logits_all)(ref["params"], rbatch)
    plog = pm.logits_all(ref["tp"], pbatch)
    assert np.abs(np.asarray(rlog)).max() < 30.0     # under the cap
    _close(plog, rlog, tol)
    rl, rmet = jax.jit(rm.forward)(ref["params"], rbatch)
    pl, pmet = pm.forward(ref["tp"], pbatch)
    assert set(pmet) == set(rmet)
    for k in rmet:
        _close(pmet[k], rmet[k], tol)
    _close(pl, rl, tol)


def test_final_softcap_binds(ref):
    """At init the logits are far below the cap of 30, where tanh is the
    identity to f32 rounding; with the tied table scaled up they reach
    it, and the capped logits and loss still match the reference's."""
    host = dict(ref["host"], embed={"table": ref["host"]["embed"]["table"]
                                    * 30.0})
    toks, tgt = _tokens(5, (1, 24)), _tokens(6, (1, 24))
    rparams = jax.tree_util.tree_map(jnp.asarray, host)
    rlog = np.asarray(jax.jit(ref["rm"].logits_all)(
        rparams, {"tokens": jnp.asarray(toks)}))
    assert 15.0 < np.abs(rlog).max() < 30.0
    tp = params_from_jax(host, device="cpu")
    pbatch = {"tokens": torch.from_numpy(toks).long(),
              "targets": torch.from_numpy(tgt).long()}
    _close(ref["pm"].logits_all(tp, pbatch), rlog)
    rl, _ = jax.jit(ref["rm"].forward)(rparams, {
        "tokens": jnp.asarray(toks), "targets": jnp.asarray(tgt)})
    _close(ref["pm"].forward(tp, pbatch)[0], rl)


def test_prefill_wraps_local_rings_and_decode_matches(ref):
    """Prefill of 20 tokens, then 8 teacher-forced decode steps: logits,
    and each layer's cache against the reference's per-pattern-position
    tuples (grp[0]: the group's local layer, grp[1]: its global layer,
    tail[0]: the local tail)."""
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

    def check_cache():
        local, glob = pcache["local"], pcache["global"]
        assert local["k"].shape[:3] == (2, 1, WINDOW)
        assert glob["k"].shape[:3] == (1, 1, MAX_LEN)
        want = {"local": [rcache["grp"][0], rcache["tail"][0]],
                "global": [rcache["grp"][1]]}
        for kind, trees in want.items():
            for name in ("k", "v", "pos"):
                w = np.concatenate([np.asarray(t[name]).reshape(
                    (-1,) + pcache[kind][name].shape[1:]) for t in trees])
                if name == "pos":
                    np.testing.assert_array_equal(
                        pcache[kind][name].numpy(), w)
                else:
                    _close(pcache[kind][name], w)

    check_cache()
    # the local rings wrapped (the first 4 tokens gone), the global did not
    assert sorted(pcache["local"]["pos"][0, 0].tolist()) == list(
        range(P - WINDOW, P))
    assert pcache["global"]["pos"][0, 0, :P].tolist() == list(range(P))
    assert (pcache["global"]["pos"][0, 0, P:] == -1).all()
    step = jax.jit(rm.decode_step)
    for i in range(8):                 # teacher-forced: same tokens in both
        tok = toks[:, P + i:P + i + 1]
        rl, rcache = step(ref["params"], rcache, jnp.asarray(tok),
                          jnp.int32(P + i))
        pl, pcache = pm.decode_step(tp, pcache, torch.from_numpy(tok).long(),
                                    P + i)
        _close(pl, rl)
    check_cache()


def test_sw_engine_bit_identical_to_reference_decode(ref):
    """Both failover modes, 4 requests on 3 slots; two prompts exceed the
    16-slot window, so their prefill wraps the local rings."""
    cfg = get_config(ARCH)               # the default bf16 compute dtype
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


def test_params_carry_the_post_norms_in_f32(ref):
    """``params_from_jax`` carries ``post_ln1``/``post_ln2`` and the tied
    table unchanged; ``compute_params`` keeps the norm scales in f32, as
    the reference reads them, and casts the weights."""
    layers = ref["tp"]["layers"]
    for name in ("post_ln1", "post_ln2"):
        got, want = layers[name]["scale"], ref["host"]["layers"][name]["scale"]
        assert got.dtype == torch.float32 and tuple(got.shape) == (3, 128)
        np.testing.assert_array_equal(got.numpy(), want)
    assert "lm_head" not in ref["tp"]
    np.testing.assert_array_equal(ref["tp"]["embed"]["table"].numpy(),
                                  ref["host"]["embed"]["table"])
    cp = compute_params(ref["tp"], torch.bfloat16)
    for name in ("ln1", "ln2", "post_ln1", "post_ln2"):
        assert cp["layers"][name]["scale"].dtype == torch.float32
    assert cp["final_norm"]["scale"].dtype == torch.float32
    assert cp["layers"]["mlp"]["w1"].dtype == torch.bfloat16
    assert cp["embed"]["table"].dtype == torch.bfloat16


def test_init_in_compute_dtype_equals_cast_init():
    model = build_model(get_config(ARCH))
    want = compute_params(model.init(3, device="cpu"), torch.bfloat16)
    got = model.init(3, device="cpu", dtype=torch.bfloat16)
    la, lb = tree_leaves(want), tree_leaves(got)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got["layers"]["post_ln1"]["scale"].dtype == torch.float32
    # the post-norms draw nothing: the weights are those of a model
    # without them
    plain = build_model(dataclasses.replace(get_config(ARCH),
                                            post_norms=False))
    other = plain.init(3, device="cpu", dtype=torch.bfloat16)
    assert torch.equal(other["layers"]["mlp"]["w2"],
                       got["layers"]["mlp"]["w2"])
