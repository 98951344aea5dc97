"""The port's RWKV-6 model against the reference, on converted params.

``rwkv6-1.6b-smoke`` (3 RWKV-6 layers, d_model 128, 4 WKV heads of
K = V = 32, chunk 8) is initialised by the reference, carried across by
``params_from_jax``, and both packages compute teacher-forced logits and
loss, prefill logits and the whole cache (token shifts and WKV states),
and 8 teacher-forced decode steps, on the SW route (reference SW vs port
SW) and the kernel route (reference Pallas interpret mode vs the port's HW
wrapper, whose CPU path is the kernel's plain blocked version).  The serve
engine runs the same model on the CPU.

Conditioning: the per-head group norm divides o by sqrt(var(o) + 64e-5).
A sequence's first o is ``bonus * v`` (the state is empty); where the
bonus is small, that o's per-head std comes near sqrt(64e-5) = 0.025 and
the norm amplifies rounding.  The fixture draws ``u`` at N(0, 1), ten
times the reference's init scale, which makes the bonus term a larger
part of o and such heads rarer; both packages compute on the same
converted params.

Tolerances: float32 agrees to 5e-5 absolute and 2e-5 of the largest
magnitude (logits reach ~7; even with ``u`` at N(0, 1) the group norm
amplifies float32 rounding, so this is looser than the 2e-5 of
``test_torch_zamba2.py``).  bfloat16 rounds every activation to 8
significant bits at points that differ between the frameworks, and the
group norm amplifies those roundings as well: 0.3 absolute and 7% of the
largest magnitude, which is the size of the reference's own bfloat16
error on this model.  ``test_logits_all_and_loss_match`` asserts that
size: the port's bfloat16 logits lie no further from the reference's
float32 logits than 1.25 times the reference's own bfloat16 logits do.
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
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServeEngine as RefServeEngine
from repro.serve import synthetic_workload as ref_workload

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.rwkv6_scan import wkv6_chunked_cuda
from repro_torch.models import build_model, compute_params
from repro_torch.serve import (RECOMPILE, RESIDENT, ServeConfig, ServeEngine,
                               reference_decode, synthetic_workload)
from repro_torch.viscosity import DEGRADED_REDUCED, DEGRADED_REMAP, HW, SW
from repro_torch.viscosity import lanefault as pt_lf

ARCH = "rwkv6-1.6b-smoke"
STAGES = ["rwkv6_wkv"]
TOL = {"float32": (5e-5, 2e-5), "bfloat16": (0.3, 0.07)}
ROUTES = [("sw", "sw"), ("interpret", "hw")]   # (reference, port)
CACHE_KEYS = ("shift_tm", "shift_cm", "wkv")


@pytest.fixture(scope="module")
def np_params():
    params = ref_build_model(ref_get_config(ARCH)).init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(0)
    tm = tree["layers"]["tm"]
    tm["u"] = rng.normal(size=tm["u"].shape).astype(np.float32)
    # norm scales away from 1, so those products are exercised
    for sub, name in ((tree["layers"]["ln1"], "scale"),
                      (tree["layers"]["ln2"], "scale"), (tm, "ln_scale")):
        sub[name] = (1 + 0.1 * rng.normal(size=sub[name].shape)
                     ).astype(np.float32)
    return tree


def _models(dtype, routes, **changes):
    rcfg = dataclasses.replace(ref_get_config(ARCH), dtype=dtype, **changes)
    pcfg = dataclasses.replace(get_config(ARCH), dtype=dtype, **changes)
    return (ref_build_model(rcfg, routes=RefPlan.for_stages(STAGES,
                                                            routes[0])),
            build_model(pcfg, routes={s: routes[1] for s in STAGES}))


def _close(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    atol, rel = TOL[dtype]
    d = np.abs(got - want).max()
    assert d <= atol and d <= rel * max(np.abs(want).max(), 1.0), d


def _both(np_params):
    return (jax.tree_util.tree_map(jnp.asarray, np_params),
            params_from_jax(np_params, device="cpu"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("routes", ROUTES, ids=["sw", "kernel"])
def test_logits_all_and_loss_match(np_params, dtype, routes):
    rm, pm = _models(dtype, routes)
    jp, tp = _both(np_params)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 512, size=(2, 29)).astype(np.int32)
    want = jax.jit(rm.logits_all)(jp, {"tokens": jnp.asarray(toks)})
    got = pm.logits_all(tp, {"tokens": torch.from_numpy(toks).long()})
    _close(got, want, dtype)
    if dtype == "bfloat16":
        exact = np.asarray(jax.jit(_models("float32", routes)[0].logits_all)(
            jp, {"tokens": jnp.asarray(toks)}), np.float32)
        ref_err = np.abs(np.asarray(want, np.float32) - exact).max()
        assert np.abs(got.float().numpy() - exact).max() <= 1.25 * ref_err
    else:
        tgt = rng.integers(0, 512, size=(2, 29)).astype(np.int32)
        rloss, _ = jax.jit(rm.forward)(jp, {"tokens": jnp.asarray(toks),
                                            "targets": jnp.asarray(tgt)})
        ploss, _ = pm.forward(tp, {"tokens": torch.from_numpy(toks).long(),
                                   "targets": torch.from_numpy(tgt).long()})
        assert abs(float(ploss) - float(rloss)) <= 1e-5 * float(rloss)


def _ref_cache(rcache):
    """The reference's cache ``{"grp": ({leaf: (L, B, ...)},), "tail": ()}``
    (one pattern position) in the port's layout ``{leaf: (L, B, ...)}``."""
    assert rcache["tail"] == ()
    return rcache["grp"][0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("routes", ROUTES, ids=["sw", "kernel"])
def test_prefill_cache_and_decode_match(np_params, dtype, routes):
    """Prefill 21 tokens (past the smoke chunk of 8, so the scan carries a
    state across chunks and pads the last one), compare logits and every
    cache leaf, then 8 teacher-forced decode steps."""
    rm, pm = _models(dtype, routes)
    jp, tp = _both(np_params)
    P, max_len = 21, 40
    toks = np.random.default_rng(2).integers(0, 512, size=(1, P + 8)
                                             ).astype(np.int32)
    rl, rcache = jax.jit(rm.prefill)(
        jp, {"tokens": jnp.asarray(toks[:, :P]),
             "cache": rm.init_cache(1, max_len)})
    pl, pcache = pm.prefill(tp, {
        "tokens": torch.from_numpy(toks[:, :P]).long(),
        "cache": pm.init_cache(1, max_len, device="cpu")})
    _close(pl, rl, dtype)
    for name in CACHE_KEYS:
        _close(pcache[name], _ref_cache(rcache)[name], dtype)
    step = jax.jit(rm.decode_step)
    for i in range(8):
        tok = toks[:, P + i:P + i + 1]
        rl, rcache = step(jp, rcache, jnp.asarray(tok), jnp.int32(P + i))
        pl, pcache = pm.decode_step(tp, pcache, torch.from_numpy(tok).long(),
                                    P + i)
        _close(pl, rl, dtype)
    for name in CACHE_KEYS:
        _close(pcache[name], _ref_cache(rcache)[name], dtype)


@pytest.mark.parametrize("target", [DEGRADED_REMAP, DEGRADED_REDUCED])
def test_degraded_prefill_takes_the_oracle_state(np_params, target):
    """On a DEGRADED rung o's lanes are partly the oracle's, so the prefill
    state comes from ``wkv6_chunked``, as on the SW route: the first
    layer's WKV state (the same input on both routes) equals the SW
    model's bit for bit; the later layers' states and the logits agree
    within the float32 tolerance."""
    tp = params_from_jax(np_params, device="cpu")
    cfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, 512, size=(1, 21)))
    fault = pt_lf.LaneFault(kind="gain", lanes=(1, 9), width=32)
    caches, logits = {}, {}
    with pt_lf.known_map("rwkv6_wkv", fault, base=HW), \
            pt_lf.inject("rwkv6_wkv", fault):
        for t in (SW, target):
            m = build_model(cfg, routes={"rwkv6_wkv": t})
            logits[t], caches[t] = m.prefill(tp, {
                "tokens": toks, "cache": m.init_cache(1, 32, device="cpu")})
    got, want = caches[target]["wkv"], caches[SW]["wkv"]
    assert torch.equal(got[0], want[0])
    _close(got, want.numpy(), "float32")
    _close(logits[target], logits[SW].numpy(), "float32")


def test_compute_params_keeps_decay_params_in_param_dtype(np_params):
    """The reference keeps w0, the decay LoRA and u in float32 and never
    casts them (it reads ``xw.astype(f32) @ w_lora_a``; u goes to the
    kernel as f32); every other weight takes the compute dtype."""
    tp = compute_params(params_from_jax(np_params, device="cpu"),
                        torch.bfloat16)
    tm = tp["layers"]["tm"]
    for name in ("w0", "w_lora_a", "w_lora_b", "u"):
        assert tm[name].dtype == torch.float32, name
    for name in ("wr", "wk", "wv", "wg", "wo", "cwr", "cwk", "cwv",
                 "mix_r", "ln_scale"):
        assert tm[name].dtype == torch.bfloat16, name
    for w in (tp["embed"]["table"], tp["lm_head"]["w"]):
        assert w.dtype == torch.bfloat16


def _workload(cfg, n, seed, **kw):
    kw = dict(dict(min_prompt=4, max_prompt=30, max_new=8, arrival_every=2,
                   per_arrival=2), **kw)
    return synthetic_workload(cfg.vocab_size, n, np.random.default_rng(seed),
                              **kw)


def test_serve_sw_bit_identical_to_reference_decode(np_params):
    """5 requests on 3 slots (staggered admission, slot reuse, prompts
    across the 8-token chunk): every completion equals the single-request
    ``reference_decode``."""
    cfg = get_config(ARCH)
    params = params_from_jax(np_params, device="cpu")
    reqs = _workload(cfg, 5, 1)
    eng = ServeEngine(cfg, params, ServeConfig(max_len=40, max_slots=3),
                      device="cpu")
    done, stats = eng.serve(reqs)
    assert sorted(done) == sorted(r.rid for r in reqs)
    assert max(stats["occupancy"]) == 3
    for r in reqs:
        ref = reference_decode(cfg, params, r.prompt, r.max_new_tokens,
                               max_len=40)
        np.testing.assert_array_equal(done[r.rid].tokens, ref)


def test_wkv_fault_mid_stream_recompiles_once_or_never(np_params):
    """A ``rwkv6_wkv`` fault at step 3 on the kernel route: one rebuild in
    RECOMPILE mode, none in RESIDENT mode, the same tokens in both, and
    the same tokens as an unfaulted run (the reference's
    ``test_fault_midstream_ssm``: a fault and reroute leave the decoded
    tokens unchanged)."""
    cfg = get_config(ARCH)
    params = params_from_jax(np_params, device="cpu")
    reqs = _workload(cfg, 5, 3, max_new=7)
    served = {}
    for mode in (RECOMPILE, RESIDENT):
        eng = ServeEngine(cfg, params, ServeConfig(
            max_len=40, max_slots=3, hw_route=HW, failover=mode),
            device="cpu")
        done, stats = eng.serve(reqs, fault_at_step=(3, "rwkv6_wkv"))
        assert eng.fault_state.is_faulty("rwkv6_wkv")
        assert len(done) == len(reqs)
        assert stats["recompiles"] == (1 if mode == RECOMPILE else 0)
        served[mode] = {r.rid: done[r.rid].tokens.tolist() for r in reqs}
    assert served[RECOMPILE] == served[RESIDENT]
    done, _ = ServeEngine(cfg, params, ServeConfig(
        max_len=40, max_slots=3, hw_route=HW), device="cpu").serve(reqs)
    assert served[RECOMPILE] == {r.rid: done[r.rid].tokens.tolist()
                                 for r in reqs}
    assert wkv6_chunked_cuda.launches == 0   # no card: nothing launched


def test_f32_tokens_match_the_jax_engine(np_params):
    """In float32 on the SW route, the port's engine serves the reference
    JAX engine's tokens for the same converted params and workload."""
    cfg32 = dataclasses.replace(get_config(ARCH), dtype="float32")
    rcfg32 = dataclasses.replace(ref_get_config(ARCH), dtype="float32")
    reqs = _workload(cfg32, 4, 5)
    ref_reqs = ref_workload(cfg32.vocab_size, 4, np.random.default_rng(5),
                            min_prompt=4, max_prompt=30, max_new=8,
                            arrival_every=2, per_arrival=2)
    ref_done, _ = RefServeEngine(
        rcfg32, jax.tree_util.tree_map(jnp.asarray, np_params),
        RefServeConfig(max_len=40, max_slots=2, hw_route=SW)).serve(ref_reqs)
    done, _ = ServeEngine(cfg32, params_from_jax(np_params, device="cpu"),
                          ServeConfig(max_len=40, max_slots=2, hw_route=SW),
                          device="cpu").serve(reqs)
    for r in reqs:
        np.testing.assert_array_equal(done[r.rid].tokens,
                                      ref_done[r.rid].tokens)
