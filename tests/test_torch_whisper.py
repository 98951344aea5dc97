"""whisper-base on the port, against the reference, at its reduced config.

``whisper-base-smoke`` is two encoder and two decoder layers, d_model
128, 4 heads of 32 dims, LayerNorm, QKV biases, plain GELU MLPs, a tied
table and 32 learned decoder positions.  The stub frontend hands in 40
frame embeddings (the encoder attends over them bidirectionally with
sinusoidal positions); the decoder's cross-attention attends over the
encoder output.  The reference initialises the params (its biases are
zeros; the tests draw them at random so that each counts) and
``params_from_jax`` carries them across.

SW against SW in float32, to 2e-5 absolute and 1e-4 of the largest
magnitude; prefill + ``decode_step`` against teacher-forced logits to the
reference's own 2e-4 (``tests/test_consistency.py``), in both packages;
the kernel route (the port's INTERPRET replica and its HW wrapper, whose
CPU path is the kernel's plain blocked version, against the reference's
Pallas interpret mode) to the op's 2e-2, on the prefill, whose
cross-attention has Sq = 4 queries over Skv = 40 keys, and on decode
steps, whose cross-attention has Sq = 1.
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
from repro_torch.models.encdec import EncDecModel
from repro_torch.train.runner import model_stage_names
from repro_torch.viscosity.lang import tree_leaves
from _torch_threads import one_torch_thread  # noqa: F401

ARCH = "whisper-base-smoke"
TOL = (2e-5, 1e-4)
KERNEL_TOL = (2e-2, 1e-2)
B, S_ENC, T, P = 2, 40, 24, 4


@pytest.fixture(scope="module")
def ref():
    cfg = dataclasses.replace(ref_get_config(ARCH), dtype="float32")
    rm = ref_build_model(cfg)
    host = jax.tree_util.tree_map(np.asarray,
                                  rm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)

    def perturb(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                perturb(v)
            elif k.startswith("b") or k == "bias":
                tree[k] = (0.1 * rng.standard_normal(v.shape)).astype(v.dtype)
            elif k == "scale":
                tree[k] = (1.0 + 0.1 * rng.standard_normal(v.shape)
                           ).astype(v.dtype)
    perturb(host)
    params = jax.tree_util.tree_map(jnp.asarray, host)
    pcfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    data = np.random.default_rng(1)
    return dict(rm=rm, params=params, host=host, pcfg=pcfg,
                pm=build_model(pcfg), tp=params_from_jax(host, device="cpu"),
                emb=data.standard_normal((B, S_ENC, 128)).astype(np.float32),
                toks=data.integers(0, 512, (B, T)).astype(np.int32),
                tgt=data.integers(0, 512, (B, T)).astype(np.int32))


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    d = np.abs(got - want).max()
    assert d <= tol[0] and d <= tol[1] * max(np.abs(want).max(), 1.0), d


def _batches(ref, n=T):
    return ({"embeds": jnp.asarray(ref["emb"]),
             "dec_tokens": jnp.asarray(ref["toks"][:, :n]),
             "dec_targets": jnp.asarray(ref["tgt"][:, :n])},
            {"embeds": torch.from_numpy(ref["emb"]),
             "dec_tokens": torch.from_numpy(ref["toks"][:, :n]).long(),
             "dec_targets": torch.from_numpy(ref["tgt"][:, :n]).long()})


def test_build_and_stages():
    cfg = get_config("whisper-base")
    assert isinstance(build_model(cfg), EncDecModel)
    assert model_stage_names(cfg) == ["flash_attention"]
    assert (cfg.enc_layers, cfg.dec_layers, cfg.d_model,
            cfg.max_target_len) == (6, 6, 512, 448)
    model = build_model(get_config(ARCH))
    cache = model.init_cache(3, 100, device="cpu")
    assert cache["k"].shape == (2, 3, 32, 4, 32)      # min(100, 32) slots
    assert bool((cache["pos"] == -1).all())


def test_encode_logits_and_loss_match(ref):
    rb, pb = _batches(ref)
    _close(ref["pm"].encode(ref["tp"], pb["embeds"]),
           jax.jit(ref["rm"].encode)(ref["params"], rb["embeds"]))
    _close(ref["pm"].logits_all(ref["tp"], pb),
           jax.jit(ref["rm"].logits_all)(ref["params"], rb))
    rl, rmet = jax.jit(ref["rm"].forward)(ref["params"], rb)
    pl, pmet = ref["pm"].forward(ref["tp"], pb)
    assert set(pmet) == set(rmet)
    for k in rmet:
        _close(pmet[k], rmet[k])
    _close(pl, rl)


def test_cross_kv_cache_matches(ref):
    rb, pb = _batches(ref)
    enc = ref["pm"].encode(ref["tp"], pb["embeds"])
    k, v = ref["pm"].cross_kv_cache(ref["tp"], enc)
    rk, rv = jax.jit(ref["rm"].cross_kv_cache)(
        ref["params"], ref["rm"].encode(ref["params"], rb["embeds"]))
    assert k.shape == (2, B, S_ENC, 4, 32)
    _close(k, rk)
    _close(v, rv)


def test_prefill_and_decode_match_teacher_forced(ref):
    """``tests/test_consistency.py``'s encoder-decoder case over both
    packages: prefill of 4 decoder tokens, then decode steps to T = 24,
    each step's logits against the teacher-forced ``logits_all`` (2e-4)
    of its own package, and the port's against the reference's
    (``TOL``), the self-attention caches too."""
    rb, pb = _batches(ref)
    rm, pm = ref["rm"], ref["pm"]
    rfull = jax.jit(rm.logits_all)(ref["params"], rb)
    pfull = pm.logits_all(ref["tp"], pb).detach().numpy()
    rl, rstate = jax.jit(rm.prefill)(ref["params"], {
        "embeds": rb["embeds"], "dec_tokens": rb["dec_tokens"][:, :P],
        "cache": rm.init_cache(B, T)})
    pl, pstate = pm.prefill(ref["tp"], {
        "embeds": pb["embeds"], "dec_tokens": pb["dec_tokens"][:, :P],
        "cache": pm.init_cache(B, T, device="cpu")})
    _close(pl, rl)
    errs = [np.abs(pl[:, 0].numpy() - pfull[:, P - 1]).max()]
    step = jax.jit(rm.decode_step)
    for t in range(P, T):
        tok = ref["toks"][:, t:t + 1]
        rl, rstate = step(ref["params"], rstate, jnp.asarray(tok),
                          jnp.int32(t))
        pl, pstate = pm.decode_step(ref["tp"], pstate,
                                    torch.from_numpy(tok).long(), t)
        _close(pl, rl)
        assert float(jnp.abs(rl[:, 0] - rfull[:, t]).max()) < 2e-4
        errs.append(np.abs(pl[:, 0].numpy() - pfull[:, t]).max())
    assert max(errs) < 2e-4, errs
    for name in ("k", "v"):
        _close(pstate["self"][name], rstate["self"][name])
    np.testing.assert_array_equal(pstate["self"]["pos"].numpy(),
                                  np.asarray(rstate["self"]["pos"]))


@pytest.mark.parametrize("route", ["interpret", "hw"])
def test_kernel_route_matches_interpret(route, ref):
    """The prefill (the encoder's bidirectional attention over 40 frames,
    the decoder's causal self-attention over 4 tokens, its cross-attention
    of Sq = 4 over Skv = 40) and 4 decode steps (cross-attention at Sq =
    1) on the kernel route, against the reference's interpret route."""
    rcfg = dataclasses.replace(ref_get_config(ARCH), dtype="float32")
    rm = ref_build_model(rcfg, routes=RefPlan.for_stages(
        ["flash_attention"], "interpret"))
    pm = build_model(ref["pcfg"], routes={"flash_attention": route})
    rb, pb = _batches(ref)
    rl, rstate = jax.jit(rm.prefill)(ref["params"], {
        "embeds": rb["embeds"], "dec_tokens": rb["dec_tokens"][:, :P],
        "cache": rm.init_cache(B, T)})
    pl, pstate = pm.prefill(ref["tp"], {
        "embeds": pb["embeds"], "dec_tokens": pb["dec_tokens"][:, :P],
        "cache": pm.init_cache(B, T, device="cpu")})
    _close(pl, rl, KERNEL_TOL)
    step = jax.jit(rm.decode_step)
    for t in range(P, P + 4):
        tok = ref["toks"][:, t:t + 1]
        rl, rstate = step(ref["params"], rstate, jnp.asarray(tok),
                          jnp.int32(t))
        pl, pstate = pm.decode_step(ref["tp"], pstate,
                                    torch.from_numpy(tok).long(), t)
        _close(pl, rl, KERNEL_TOL)


def test_params_from_jax_carries_the_encdec_tree(ref):
    """``params_from_jax`` keeps the encoder-decoder tree as it is: the
    stacked ``enc``/``dec`` layers, ``dec_pos``, the LayerNorm biases and
    the attention biases, leaf for leaf; ``compute_params`` keeps every
    norm in f32 and casts the rest; the port's own ``init`` makes the same
    tree."""
    flat = jax.tree_util.tree_flatten_with_path(ref["host"])[0]
    assert len(flat) == len(tree_leaves(ref["tp"]))
    for path, want in flat:
        got = ref["tp"]
        for k in path:
            got = got[k.key]
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
    tp = ref["tp"]
    assert tp["enc"]["ln1"]["bias"].shape == (2, 128)
    assert tp["dec"]["cross_attn"]["bv"].shape == (2, 128)
    assert tp["dec_pos"].shape == (32, 128)
    cp = compute_params(tp, torch.bfloat16)
    for tree in (cp["enc"], cp["dec"]):
        for name, sub in tree.items():
            if name.startswith("ln"):
                assert sub["scale"].dtype == sub["bias"].dtype == \
                    torch.float32
    for name in ("enc_norm", "dec_norm"):
        assert cp[name]["bias"].dtype == torch.float32
    assert cp["dec"]["cross_attn"]["wq"].dtype == torch.bfloat16
    assert cp["dec_pos"].dtype == torch.bfloat16
    own = build_model(get_config(ARCH)).init(0, device="cpu")

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}
    assert shapes(own) == shapes(tp)
