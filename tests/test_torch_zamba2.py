"""The port's zamba2 hybrid model against the reference, on converted params.

``zamba2-1.2b-smoke`` (4 Mamba2 layers, the shared attention+MLP block
after every 2, d_model 128) is initialised by the reference, carried
across by ``params_from_jax``, and both packages compute teacher-forced
logits and loss, prefill logits and the whole cache (conv tails, SSM
states, the shared block's KV), and 8 teacher-forced decode steps, on the
SW route (reference SW vs port SW) and the kernel route (reference Pallas
interpret mode vs the port's HW wrappers, whose CPU paths are the kernels'
plain blocked versions).  The serve engine runs the same model on the CPU.

Tolerances (as ``test_torch_model.py``): float32 agrees to 2e-5 absolute
(logits reach ~1) and 1e-5 of the largest magnitude; bfloat16 rounds every
activation to 8 significant bits at points that differ between the
frameworks: 0.1 absolute and 3% of the largest magnitude.
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
from repro_torch.kernels.mamba2_scan import ssd_chunked_cuda
from repro_torch.models import build_model, compute_params
from repro_torch.serve import (RECOMPILE, RESIDENT, ServeConfig, ServeEngine,
                               reference_decode, synthetic_workload)
from repro_torch.viscosity import DEGRADED_REDUCED, DEGRADED_REMAP, HW, SW
from repro_torch.viscosity import lanefault as pt_lf
from _torch_threads import one_torch_thread  # noqa: F401

ARCH = "zamba2-1.2b-smoke"
STAGES = ["flash_attention", "swiglu_mlp", "mamba2_ssd"]
TOL = {"float32": (2e-5, 1e-5), "bfloat16": (0.1, 0.03)}
ROUTES = [("sw", "sw"), ("interpret", "hw")]   # (reference, port)


@pytest.fixture(scope="module")
def np_params():
    params = ref_build_model(ref_get_config(ARCH)).init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    # norm scales away from 1, so those products are exercised
    rng = np.random.default_rng(0)
    for sub in (tree["layers"]["ln1"], tree["layers"]["mix"],
                tree["shared"]["ln1"], tree["shared"]["ln2"]):
        name = "norm_scale" if "norm_scale" in sub else "scale"
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
    toks = rng.integers(0, 512, size=(2, 40)).astype(np.int32)
    want = jax.jit(rm.logits_all)(jp, {"tokens": jnp.asarray(toks)})
    _close(pm.logits_all(tp, {"tokens": torch.from_numpy(toks).long()}),
           want, dtype)
    if dtype == "float32":
        tgt = rng.integers(0, 512, size=(2, 40)).astype(np.int32)
        rloss, _ = jax.jit(rm.forward)(jp, {"tokens": jnp.asarray(toks),
                                            "targets": jnp.asarray(tgt)})
        ploss, _ = pm.forward(tp, {"tokens": torch.from_numpy(toks).long(),
                                   "targets": torch.from_numpy(tgt).long()})
        assert abs(float(ploss) - float(rloss)) <= 1e-5 * float(rloss)


def _prefill_and_decode(rm, pm, jp, tp, dtype, P=21, max_len=40):
    """Prefill P tokens (past the smoke chunk of 16, so the scan carries a
    state across chunks), compare logits and every cache leaf, then 8
    teacher-forced decode steps."""
    toks = np.random.default_rng(2).integers(0, 512, size=(1, P + 8)
                                             ).astype(np.int32)
    rl, rcache = jax.jit(rm.prefill)(
        jp, {"tokens": jnp.asarray(toks[:, :P]),
             "cache": rm.init_cache(1, max_len)})
    pl, pcache = pm.prefill(tp, {
        "tokens": torch.from_numpy(toks[:, :P]).long(),
        "cache": pm.init_cache(1, max_len, device="cpu")})
    _close(pl, rl, dtype)
    for name in ("conv", "ssm"):
        _close(pcache["mamba"][name], rcache["mamba"][name], dtype)
    for name in ("k", "v"):
        _close(pcache["attn"][name], rcache["attn"][name], dtype)
    np.testing.assert_array_equal(pcache["attn"]["pos"].numpy(),
                                  np.asarray(rcache["attn"]["pos"]))
    step = jax.jit(rm.decode_step)
    for i in range(8):
        tok = toks[:, P + i:P + i + 1]
        rl, rcache = step(jp, rcache, jnp.asarray(tok), jnp.int32(P + i))
        pl, pcache = pm.decode_step(tp, pcache, torch.from_numpy(tok).long(),
                                    P + i)
        _close(pl, rl, dtype)
    _close(pcache["mamba"]["ssm"], rcache["mamba"]["ssm"], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("routes", ROUTES, ids=["sw", "kernel"])
def test_prefill_cache_and_decode_match(np_params, dtype, routes):
    rm, pm = _models(dtype, routes)
    _prefill_and_decode(rm, pm, *_both(np_params), dtype)


def test_tail_layers_match(np_params):
    """Five Mamba2 layers: two groups and a tail layer after the last
    shared block (zamba2-1.2b runs 6 groups of 6 and a tail of 2)."""
    rng = np.random.default_rng(5)
    tree = jax.tree_util.tree_map(lambda a: a, np_params)
    tree["layers"] = jax.tree_util.tree_map(
        lambda a: np.concatenate([a, a[:1] * (1 + 0.1 * rng.normal(
            size=a[:1].shape)).astype(a.dtype)]), np_params["layers"])
    rm, pm = _models("float32", ("sw", "sw"), num_layers=5)
    _prefill_and_decode(rm, pm, *_both(tree), "float32")


@pytest.mark.parametrize("target", [DEGRADED_REMAP, DEGRADED_REDUCED])
def test_degraded_prefill_takes_the_oracle_state(np_params, target):
    """On a DEGRADED rung y's lanes are partly the oracle's, so the prefill
    state comes from ``ssd_chunked``, as on the SW route: the first
    layer's SSM state (the same input on both routes) equals the SW
    model's bit for bit; the later layers' states and the logits agree
    within the float32 tolerance."""
    tp = params_from_jax(np_params, device="cpu")
    cfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, 512, size=(1, 21)))
    fault = pt_lf.LaneFault(kind="gain", lanes=(1, 9), width=16)
    caches, logits = {}, {}
    with pt_lf.known_map("mamba2_ssd", fault, base=HW), \
            pt_lf.inject("mamba2_ssd", fault):
        for t in (SW, target):
            m = build_model(cfg, routes={"mamba2_ssd": t})
            logits[t], caches[t] = m.prefill(tp, {
                "tokens": toks, "cache": m.init_cache(1, 32, device="cpu")})
    got, want = caches[target]["mamba"]["ssm"], caches[SW]["mamba"]["ssm"]
    assert torch.equal(got[0], want[0])
    _close(got, want.numpy(), "float32")
    _close(logits[target], logits[SW].numpy(), "float32")


def test_compute_params_keeps_mamba_scalars_in_param_dtype(np_params):
    tp = compute_params(params_from_jax(np_params, device="cpu"),
                        torch.bfloat16)
    mix = tp["layers"]["mix"]
    for name in ("A_log", "D", "dt_bias", "conv_w", "conv_b"):
        assert mix[name].dtype == torch.float32, name
    for w in (mix["in_proj"], mix["out_proj"], tp["embed"]["table"],
              tp["shared"]["mlp"]["w1"]):
        assert w.dtype == torch.bfloat16


def _workload(cfg, n, seed, **kw):
    kw = dict(dict(min_prompt=4, max_prompt=30, max_new=8, arrival_every=2,
                   per_arrival=2), **kw)
    return synthetic_workload(cfg.vocab_size, n, np.random.default_rng(seed),
                              **kw)


def test_serve_sw_bit_identical_to_reference_decode(np_params):
    """5 requests on 3 slots (staggered admission, slot reuse, prompts
    across the 16-token chunk): every completion equals the single-request
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


def test_ssd_fault_mid_stream_recompiles_once_or_never(np_params):
    cfg = get_config(ARCH)
    params = params_from_jax(np_params, device="cpu")
    reqs = _workload(cfg, 5, 3, max_new=7)
    served = {}
    for mode in (RECOMPILE, RESIDENT):
        eng = ServeEngine(cfg, params, ServeConfig(
            max_len=40, max_slots=3, hw_route=HW, failover=mode),
            device="cpu")
        done, stats = eng.serve(reqs, fault_at_step=(3, "mamba2_ssd"))
        assert eng.fault_state.is_faulty("mamba2_ssd")
        assert len(done) == len(reqs)
        assert stats["recompiles"] == (1 if mode == RECOMPILE else 0)
        served[mode] = {r.rid: done[r.rid].tokens.tolist() for r in reqs}
    assert served[RECOMPILE] == served[RESIDENT]
    assert ssd_chunked_cuda.launches == 0   # no card: nothing launched
