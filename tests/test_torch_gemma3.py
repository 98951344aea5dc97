"""gemma3-1b on the port, against the reference, at eight layers.

``gemma3-1b-smoke`` has three layers, all local (the 5:1 pattern's first
three), so the tests cut the reduced config to eight: five local layers
(window 16, rope theta 10,000), one global (theta 1,000,000) and a
two-layer local tail; d_model 128, head dim 32, GQA 4 -> 1, qk-norm,
pre- and post-norms, the sqrt(d) embedding scale and a GeGLU MLP.  The
reference initialises the params (its qk-norm scales and post-norms are
ones; the tests draw them at random so that each scale counts) and
``params_from_jax`` carries them across.

Routes: SW against SW in float32, to 2e-5 absolute and 1e-4 of the
largest magnitude; the kernel route (the reference's Pallas interpret
mode against the port's INTERPRET replicas and HW wrappers, whose CPU
path is each kernel's plain blocked version) to the ops' 2e-2.  The
cache: the seven local layers hold ``min(max_len, window)`` = 16 slots,
the global one ``max_len`` = 32, so a 20-token prompt wraps the local
rings at prefill and decode keeps wrapping them.
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
from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model
from repro_torch.models import rope as rope_mod
from repro_torch.serve import (RECOMPILE, RESIDENT, Request, ServeConfig,
                               ServeEngine, reference_decode)
from repro_torch.train.runner import model_stage_names, value_and_grad
from repro_torch.viscosity.lang import tree_leaves
from _torch_threads import one_torch_thread  # noqa: F401

ARCH = "gemma3-1b-smoke"
LAYERS = 8
TOL = (2e-5, 1e-4)
KERNEL_TOL = (2e-2, 1e-2)
P, MAX_LEN, WINDOW = 20, 32, 16


def _cfg(get, **kw):
    return dataclasses.replace(get(ARCH), num_layers=LAYERS, **kw)


@pytest.fixture(scope="module")
def ref():
    """The reference's float32 model and params (qk-norm and post-norm
    scales drawn at random), the port's model on the same params, and the
    reference's interpret-route model."""
    cfg = _cfg(ref_get_config, dtype="float32")
    rm = ref_build_model(cfg)
    host = jax.tree_util.tree_map(np.asarray,
                                  rm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    layers = host["layers"]
    for sub, names in (("attn", ("q_norm", "k_norm")),
                       ("post_ln1", ("scale",)), ("post_ln2", ("scale",))):
        for name in names:
            a = layers[sub][name]
            layers[sub][name] = (1.0 + 0.25 * rng.standard_normal(a.shape)
                                 ).astype(a.dtype)
    params = jax.tree_util.tree_map(jnp.asarray, host)
    pcfg = _cfg(get_config, dtype="float32")
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
    """Five local layers, one global and a two-layer local tail; the
    local layers take the local theta, and the two rope tables differ.
    At full depth: 22 local caches of 512 slots and 4 global ones."""
    cfg = _cfg(get_config)
    assert cfg.layer_kinds() == (ATTN_LOCAL,) * 5 + (ATTN_GLOBAL,) + \
        (ATTN_LOCAL,) * 2
    model = build_model(cfg)
    assert model._kv_at == tuple(("local", i) for i in range(5)) + (
        ("global", 0), ("local", 5), ("local", 6))
    assert [(m.theta, m.local) for m in model.metas] == \
        [(10_000.0, True)] * 5 + [(1_000_000.0, False)]
    cache = model.init_cache(2, MAX_LEN, device="cpu")
    assert cache["local"]["k"].shape == (7, 2, WINDOW, 1, 32)
    assert cache["global"]["k"].shape == (1, 2, MAX_LEN, 1, 32)
    pos = rope_mod.positions_default(1, 8, torch.device("cpu"))
    ropes = model._ropes(pos)
    for name, theta in (("local", 10_000.0), ("global", 1_000_000.0)):
        want = rope_mod.rope_tables(pos, 32, theta)
        assert all(torch.equal(a, b) for a, b in zip(ropes[name], want))
    assert not torch.equal(ropes["local"][1], ropes["global"][1])
    full = build_model(get_config("gemma3-1b"))
    kinds = [k for k, _ in full._kv_at]
    assert (kinds.count("local"), kinds.count("global")) == (22, 4)
    assert kinds[-2:] == ["local", "local"]
    big = full.init_cache(1, 4224, device="cpu")
    assert big["local"]["k"].shape[:3] == (22, 1, 512)
    assert big["global"]["k"].shape[:3] == (4, 1, 4224)


@pytest.mark.parametrize("route", ["sw", "interpret", "hw"])
def test_logits_and_loss_match(route, ref):
    """``logits_all`` and ``forward`` (loss and metrics): SW against the
    reference's SW in f32; the kernel routes against its interpret
    route."""
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
    _close(pm.logits_all(ref["tp"], pbatch),
           jax.jit(rm.logits_all)(ref["params"], rbatch), tol)
    rl, rmet = jax.jit(rm.forward)(ref["params"], rbatch)
    pl, pmet = pm.forward(ref["tp"], pbatch)
    assert set(pmet) == set(rmet)
    for k in rmet:
        _close(pmet[k], rmet[k], tol)
    _close(pl, rl, tol)


def test_prefill_wraps_local_rings_and_decode_matches(ref):
    """Prefill of 20 tokens, then 8 teacher-forced decode steps: logits
    against the reference's and against the port's own teacher-forced
    ``logits_all``, and each layer's cache against the reference's
    per-pattern-position tuples (grp[0..4]: the group's local layers,
    grp[5]: its global layer, tail[0..1]: the local tail)."""
    rm, pm, tp = ref["rm"], ref["pm"], ref["tp"]
    toks = _tokens(3, (1, P + 8))
    full = pm.logits_all(tp, {"tokens": torch.from_numpy(toks).long()})
    rl, rcache = jax.jit(rm.prefill)(
        ref["params"], {"tokens": jnp.asarray(toks[:, :P]),
                        "cache": rm.init_cache(1, MAX_LEN)})
    pl, pcache = pm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :P]
                                                            ).long(),
                                 "cache": pm.init_cache(1, MAX_LEN,
                                                        device="cpu")})
    _close(pl, rl)
    _close(pl[:, 0], full[:, P - 1].detach().numpy())

    def check_cache():
        want = {"local": list(rcache["grp"][:5]) + list(rcache["tail"]),
                "global": [rcache["grp"][5]]}
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
    for i in range(7):       # every local ring wrapped, the global did not
        assert sorted(pcache["local"]["pos"][i, 0].tolist()) == list(
            range(P - WINDOW, P))
    assert pcache["global"]["pos"][0, 0, :P].tolist() == list(range(P))
    step = jax.jit(rm.decode_step)
    for i in range(8):
        tok = toks[:, P + i:P + i + 1]
        rl, rcache = step(ref["params"], rcache, jnp.asarray(tok),
                          jnp.int32(P + i))
        pl, pcache = pm.decode_step(tp, pcache, torch.from_numpy(tok).long(),
                                    P + i)
        _close(pl, rl)
        _close(pl[:, 0], full[:, P + i].detach().numpy())
    check_cache()


def test_sw_engine_bit_identical_to_reference_decode(ref):
    """Both failover modes, 4 requests on 3 slots, bf16; two prompts
    exceed the 16-slot window, so their prefill wraps the local rings."""
    cfg = _cfg(get_config)
    reqs = [Request(rid=i, prompt=_tokens(10 + i, (n,)), max_new_tokens=m,
                    arrival=i) for i, (n, m) in enumerate(
                        [(9, 6), (21, 5), (17, 7), (4, 3)])]
    wants = {r.rid: reference_decode(cfg, ref["tp"], r.prompt,
                                     r.max_new_tokens, max_len=MAX_LEN)
             for r in reqs}
    for mode in (RECOMPILE, RESIDENT):
        eng = ServeEngine(cfg, ref["tp"], ServeConfig(
            max_len=MAX_LEN, max_slots=3, failover=mode), device="cpu")
        done, _ = eng.serve(reqs)
        for r in reqs:
            np.testing.assert_array_equal(done[r.rid].tokens, wants[r.rid])


def test_step0_grads_match_jax(ref):
    """Loss and every leaf's gradient (the qk-norm scales' included)
    against ``jax.value_and_grad`` of the reference's forward, to 1e-4 of
    each leaf's largest magnitude."""
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, 512, (2, 24)).astype(np.int32),
             "targets": rng.integers(0, 512, (2, 24)).astype(np.int32)}
    (rl, _), rg = jax.jit(jax.value_and_grad(ref["rm"].forward,
                                             has_aux=True))(
        ref["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    (pl, _), pg = value_and_grad(
        ref["pm"].forward, ref["tp"],
        {k: torch.from_numpy(v).long() for k, v in batch.items()})
    assert float(pl) == pytest.approx(float(rl), rel=1e-5)
    flat = jax.tree_util.tree_flatten_with_path(rg)[0]
    assert len(flat) == len(tree_leaves(pg))
    for path, g in flat:
        got = pg
        for k in path:
            got = got[k.key]
        g = np.asarray(g)
        rel = np.abs(got.numpy() - g).max() / np.abs(g).max()
        assert rel <= 1e-4, (jax.tree_util.keystr(path), rel)
    assert float(pg["layers"]["attn"]["q_norm"].abs().max()) > 0


def test_own_init_has_qk_norm_and_matches_the_reference(ref):
    """The port's own init carries ``q_norm`` and ``k_norm`` ((L, head
    dim) ones, drawing nothing, so every other leaf keeps its bits): fed
    to the reference as numpy, its SW logits equal the port's in f32."""
    own = ref["pm"].init(0, device="cpu")
    attn = own["layers"]["attn"]
    for name in ("q_norm", "k_norm"):
        assert attn[name].shape == (LAYERS, 32)
        assert torch.equal(attn[name], torch.ones_like(attn[name]))
    host = jax.tree_util.tree_map(lambda t: t.numpy(), own)
    want = jax.tree_util.tree_flatten_with_path(ref["host"])[0]
    got = jax.tree_util.tree_flatten_with_path(host)[0]
    assert [(p, a.shape, a.dtype) for p, a in got] == \
        [(p, a.shape, a.dtype) for p, a in want]
    toks = _tokens(4, (2, 24))
    _close(ref["pm"].logits_all(own, {"tokens": torch.from_numpy(toks)
                                      .long()}),
           jax.jit(ref["rm"].logits_all)(
               jax.tree_util.tree_map(jnp.asarray, host),
               {"tokens": jnp.asarray(toks)}))
