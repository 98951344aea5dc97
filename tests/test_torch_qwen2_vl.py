"""qwen2-vl-7b on the port, against the reference, at its reduced config.

``qwen2-vl-7b-smoke`` has three global layers, d_model 128, 4 heads over
one KV head of 32 dims, QKV biases, an untied LM head and M-RoPE with
sections (8, 4, 4) over the (t, h, w) coordinates.  Its stub frontend
hands in precomputed embeddings and 3-D positions.  The inputs follow
Qwen2-VL's rule (arXiv:2409.12191): text at t = h = w = i; an image of
an R x C grid of merged patches at t = o, h = o + row, w = o + col, where
o is its first position; the text after it resumes at the largest
position + 1.  Decode embeds tokens and rotates at positions3 = (t, t,
t), as the reference does, after an image prefill too.

The reference initialises the params and ``params_from_jax`` carries
them across; SW against SW in float32, to 2e-5 absolute and 1e-4 of the
largest magnitude (the kernel route: 2e-2).
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
from repro.models import rope as ref_rope

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import build_model
from repro_torch.models import rope as rope_mod
from repro_torch.serve import (RECOMPILE, RESIDENT, Request, ServeConfig,
                               ServeEngine, reference_decode)
from repro_torch.train.runner import model_stage_names
from _torch_threads import one_torch_thread  # noqa: F401
from chip_smoke import image_positions3

ARCH = "qwen2-vl-7b-smoke"
TOL = (2e-5, 1e-4)
KERNEL_TOL = (2e-2, 1e-2)
MAX_LEN = 48


@pytest.fixture(scope="module")
def ref():
    cfg = dataclasses.replace(ref_get_config(ARCH), dtype="float32")
    rm = ref_build_model(cfg)
    params = rm.init(jax.random.PRNGKey(0))
    host = jax.tree_util.tree_map(np.asarray, params)
    # nonzero QKV biases, so that the biases count
    rng = np.random.default_rng(3)
    for name in ("bq", "bk", "bv"):
        a = host["layers"]["attn"][name]
        host["layers"]["attn"][name] = (0.1 * rng.standard_normal(a.shape)
                                        ).astype(a.dtype)
    params = jax.tree_util.tree_map(jnp.asarray, host)
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


def _embeds(seed, S, d=128, B=1):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)


@pytest.mark.parametrize("head_dim,sections,grid", [
    (32, (8, 4, 4), (4, 4, 4, 4)), (128, (16, 24, 24), (16, 16, 16, 16))])
def test_mrope_tables_match(head_dim, sections, grid):
    """The smoke width's and the full width's sections, on the image-grid
    positions (the full width's: 16 text tokens, a 16 x 16 grid, 16 text
    tokens, as a 448 x 448 image gives at 14-pixel patches merged 2 x 2);
    and at (t, t, t) the tables are the 1-D rope's."""
    p3 = image_positions3(*grid)[None]
    n_before, rows, cols, n_after = grid
    assert p3[0, -1].tolist() == [n_before + max(rows, cols) - 1
                                  + n_after] * 3
    want = ref_rope.mrope_tables(jnp.asarray(p3), head_dim, 1e6, sections)
    got = rope_mod.mrope_tables(torch.from_numpy(p3), head_dim, 1e6,
                                sections)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    t = torch.arange(10, dtype=torch.int32)[None]
    flat = rope_mod.mrope_tables(t[..., None].expand(1, 10, 3), head_dim,
                                 1e6, sections)
    for a, b in zip(flat, rope_mod.rope_tables(t, head_dim, 1e6)):
        assert torch.equal(a, b)


def test_stub_frontend_logits_and_prefill_match(ref):
    """``logits_all`` and ``forward`` on embeddings with the image grid's
    positions3, and prefill on a prefix of them: SW against the
    reference's SW; the kernel routes' prefill against its interpret
    route."""
    p3 = image_positions3(4, 4, 4, 4)[None]
    S = p3.shape[1]
    emb = _embeds(1, S)
    tgt = np.random.default_rng(2).integers(0, 512, (1, S)).astype(np.int32)
    rb = {"embeds": jnp.asarray(emb), "positions3": jnp.asarray(p3)}
    pb = {"embeds": torch.from_numpy(emb), "positions3": torch.from_numpy(p3)}
    _close(ref["pm"].logits_all(ref["tp"], pb),
           jax.jit(ref["rm"].logits_all)(ref["params"], rb))
    rl, _ = jax.jit(ref["rm"].forward)(ref["params"],
                                       {**rb, "targets": jnp.asarray(tgt)})
    pl, _ = ref["pm"].forward(ref["tp"], {**pb,
                                          "targets": torch.from_numpy(tgt)})
    _close(pl, rl)
    P = 20
    rl, rcache = jax.jit(ref["rm"].prefill)(ref["params"], {
        "embeds": rb["embeds"][:, :P], "positions3": rb["positions3"][:, :P],
        "cache": ref["rm"].init_cache(1, MAX_LEN)})
    pl, pcache = ref["pm"].prefill(ref["tp"], {
        "embeds": pb["embeds"][:, :P], "positions3": pb["positions3"][:, :P],
        "cache": ref["pm"].init_cache(1, MAX_LEN, device="cpu")})
    _close(pl, rl)
    for name in ("k", "v"):
        _close(pcache[name], np.asarray(rcache["grp"][0][name]))
    rl_int, _ = jax.jit(ref["rm_int"].prefill)(ref["params"], {
        "embeds": rb["embeds"][:, :P], "positions3": rb["positions3"][:, :P],
        "cache": ref["rm_int"].init_cache(1, MAX_LEN)})
    for route in ("interpret", "hw"):
        pm = build_model(ref["pcfg"], routes={s: route
                                              for s in ref["stages"]})
        got, _ = pm.prefill(ref["tp"], {
            "embeds": pb["embeds"][:, :P],
            "positions3": pb["positions3"][:, :P],
            "cache": pm.init_cache(1, MAX_LEN, device="cpu")})
        _close(got, rl_int, KERNEL_TOL)


def test_decode_on_tokens_matches(ref):
    """After an image prefill (positions3 of the grid) and after a token
    prefill (no positions3: the 1-D positions three times), 6 decode steps
    on tokens at positions3 = (t, t, t), teacher-forced, against the
    reference; the token path also against the port's own
    ``logits_all``."""
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 512, (1, 30)).astype(np.int32)
    p3 = image_positions3(4, 4, 4, 4)[None]
    S = p3.shape[1]
    emb = _embeds(5, S)
    full = ref["pm"].logits_all(ref["tp"], {
        "tokens": torch.from_numpy(toks).long()})
    for label, rb, pb, P in (
            ("image", {"embeds": jnp.asarray(emb),
                       "positions3": jnp.asarray(p3)},
             {"embeds": torch.from_numpy(emb),
              "positions3": torch.from_numpy(p3)}, S),
            ("tokens", {"tokens": jnp.asarray(toks[:, :24])},
             {"tokens": torch.from_numpy(toks[:, :24]).long()}, 24)):
        rl, rcache = jax.jit(ref["rm"].prefill)(
            ref["params"], {**rb, "cache": ref["rm"].init_cache(1, MAX_LEN)})
        pl, pcache = ref["pm"].prefill(ref["tp"], {
            **pb, "cache": ref["pm"].init_cache(1, MAX_LEN, device="cpu")})
        _close(pl, rl)
        step = jax.jit(ref["rm"].decode_step)
        for i in range(6):
            tok = toks[:, 24 + i:25 + i] if label == "tokens" else \
                toks[:, i:i + 1]
            rl, rcache = step(ref["params"], rcache, jnp.asarray(tok),
                              jnp.int32(P + i))
            pl, pcache = ref["pm"].decode_step(
                ref["tp"], pcache, torch.from_numpy(tok).long(), P + i)
            _close(pl, rl)
            if label == "tokens":
                _close(pl[:, 0], full[:, P + i].detach().numpy())


def test_sw_engine_bit_identical_to_reference_decode(ref):
    """Token prompts through ``ServeEngine`` (bf16, both failover modes,
    4 requests on 3 slots) equal the port's single-request
    ``reference_decode`` bit for bit."""
    cfg = get_config(ARCH)
    rng = np.random.default_rng(9)
    reqs = [Request(rid=i, prompt=rng.integers(0, 512, n).astype(np.int32),
                    max_new_tokens=m, arrival=i)
            for i, (n, m) in enumerate([(9, 6), (21, 5), (17, 7), (4, 3)])]
    wants = {r.rid: reference_decode(cfg, ref["tp"], r.prompt,
                                     r.max_new_tokens, max_len=MAX_LEN)
             for r in reqs}
    for mode in (RECOMPILE, RESIDENT):
        eng = ServeEngine(cfg, ref["tp"], ServeConfig(
            max_len=MAX_LEN, max_slots=3, failover=mode), device="cpu")
        done, _ = eng.serve(reqs)
        for r in reqs:
            np.testing.assert_array_equal(done[r.rid].tokens, wants[r.rid])
