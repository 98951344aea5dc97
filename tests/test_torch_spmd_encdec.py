"""The tensor-parallel runtime (``launch/spmd.py``) on the encoder-decoder
family (whisper-base), across two gloo processes on the CPU, against the
unsharded port and the reference.

One (1, 2) ("data", "model") mesh, one process per rank
(``_torch_spmd_worker.py``), on the reference's float32 params of
whisper-base-smoke (its biases and norms drawn at random, as
``test_torch_whisper.py`` draws them, so cutting the biases with their
columns is exercised) cut by ``partition.shard_tree``: a rank holds 2 of
the 4 heads of every self- and cross-attention, half of each MLP's d_ff
and, at the smoke's 512-row vocabulary, half the tied table.

  * SW: the encoder's output, prefill (whose cross-KV holds the rank's
    kv heads) and four teacher-forced decode steps; a train step's loss
    and gradients;
  * INTERPRET: prefill and decode.

Tolerances: against the unsharded port, 1e-5 of the largest magnitude
(the cross-KV to 1e-6 of it); against the reference, the float32
(2e-5, 1e-4) of ``test_torch_whisper.py`` and its gradients 1e-4 of each
leaf's largest (of 1e-4 at least: ``bk``'s gradient is 0 in exact
arithmetic); INTERPRET at the op's 2e-2 against the unsharded port's
INTERPRET.  Then ``launch/tp_serve.py``'s encoder-decoder serve over two
ranks with a lane fault on rank 1's ``flash_attention``.
"""
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import partition, spmd, tp_serve
from repro_torch.launch.mesh import make_mesh
from repro_torch.viscosity import INTERPRET, SW
from _torch_threads import one_torch_thread  # noqa: F401
import _torch_spmd_worker as worker
from test_torch_spmd import _close, _flat, _launch, _ref_close

ARCH = "whisper-base-smoke"
TOL = (2e-5, 1e-4)
GRAD_REL = 1e-4
SHARD_REL = 1e-5
CROSS_REL = 1e-6
# ``bk``'s gradient is 0 in exact arithmetic (a bias on every key shifts a
# row's scores alike) and holds noise near 3e-10 in both packages; every
# other leaf's largest gradient is above 1.6e-3
GRAD_FLOOR = 1e-4
OP_TOL = 2e-2
MESH = (1, 2)
B, FRAMES, P, T = 2, 24, 4, 4
CASES = {"sw": dict(route="sw", run=["prefill", "train"]),
         "interp": dict(route="interpret", run=["prefill"])}
KEYS = ["prefill"] + [f"decode{i}" for i in range(T)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, the unsharded port's (the worker's ``run_case``
    outside ``spmd``) and the reference's model and params."""
    tmp = tmp_path_factory.mktemp("spmd_encdec")
    cfg = dataclasses.replace(ref_get_config(ARCH), dtype="float32")
    rm = ref_build_model(cfg)
    host = jax.tree_util.tree_map(np.asarray, rm.init(jax.random.PRNGKey(0)))
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
    path = str(tmp / "whisper.pt")
    torch.save(params_from_jax(host, device="cpu"), path)
    cases = [{"name": n, "arch": ARCH, "params": path, "batch": B,
              "frames": FRAMES, "prompt": P, "decode": T, "seed": 5, **c}
             for n, c in CASES.items()]
    ranks = _launch(MESH, cases, tmp)
    one = make_mesh((1, 1), ("data", "model"), devices=[torch.device("cpu")])
    plain = {c["name"]: worker.run_case(c, one, {"data": 0, "model": 0})
             for c in cases}
    return dict(ranks=ranks, plain=plain, rm=rm,
                params=jax.tree_util.tree_map(jnp.asarray, host),
                mesh=make_mesh(MESH, ("data", "model"),
                               devices=[torch.device("cpu")] * 2))


def _inputs(seed=5):
    emb = worker._embeds(seed, (B, FRAMES, 128)).numpy()
    toks = worker._tokens(seed, (B, P + T)).numpy().astype(np.int32)
    return jnp.asarray(emb), toks


_MEMO = {}


def _ref_serve(runs):
    if not _MEMO:
        rm, params = runs["rm"], runs["params"]
        emb, toks = _inputs()
        _MEMO["encode"] = jax.jit(rm.encode)(params, emb)
        lg, state = jax.jit(rm.prefill)(params, {
            "embeds": emb, "dec_tokens": jnp.asarray(toks[:, :P]),
            "cache": rm.init_cache(B, P + T)})
        _MEMO["prefill"] = lg
        step = jax.jit(rm.decode_step)
        for i in range(T):
            lg, state = step(params, state,
                             jnp.asarray(toks[:, P + i:P + i + 1]),
                             jnp.int32(P + i))
            _MEMO[f"decode{i}"] = lg
    return _MEMO


def test_sharding_takes_the_encoder_decoder_family():
    cfg = get_config("whisper-base")
    with spmd.spmd({"data": 1, "model": 4}, {}):
        assert spmd.unsharded_reason(cfg) is None
        spmd.check_runtime(cfg)
    assert tp_serve.fault_stage_for(cfg) == "flash_attention"


@pytest.mark.parametrize("key", ["encode"] + KEYS)
def test_encoder_prefill_and_decode_match_unsharded_and_reference(runs, key):
    got = runs["ranks"][0]["sw"][key]
    assert torch.equal(got, runs["ranks"][1]["sw"][key])
    _close(got, runs["plain"]["sw"][key], SHARD_REL)
    _ref_close(got, _ref_serve(runs)[key], TOL)


def test_rank_holds_its_kv_heads_of_the_cross_kv_and_the_cache(runs):
    """Rank r's cross-KV is the unsharded one's kv heads [2r, 2r + 2);
    its self-attention cache holds its 2 kv heads, the positions half the
    slots."""
    full = runs["plain"]["sw"]
    for r in runs["ranks"]:
        mine = r["sw"]
        lo = 2 * r["coords"]["model"]
        for got, want in zip(mine["cross"], full["cross"]):
            assert got.shape == want.shape[:3] + (2, want.shape[4])
            _close(got, want[:, :, :, lo:lo + 2], CROSS_REL)
        shapes = mine["cache_shapes"]
        assert shapes["self/k"] == shapes["self/v"] == (2, B, P + T, 2, 32)
        assert shapes["self/pos"] == (2, B, (P + T) // 2)
        assert mine["cache_bytes"] * 2 == full["cache_bytes"]


def test_train_step_loss_and_grads(runs):
    """The loss on both ranks and the gradients rebuilt from the shards
    equal the unsharded port's and the reference's."""
    plain = runs["plain"]["sw"]
    for r in runs["ranks"]:
        _close(r["sw"]["loss"], plain["loss"], SHARD_REL)
    grads = partition.unshard_tree(
        [r["sw"]["grads"] for r in runs["ranks"]],
        partition.params_pspecs(plain["grads"], runs["mesh"]), runs["mesh"])
    emb, toks = _inputs()
    tgt = worker._tokens(7, (B, P + T)).numpy().astype(np.int32)
    (loss, _), rgrads = jax.jit(jax.value_and_grad(
        runs["rm"].forward, has_aux=True))(runs["params"], {
            "embeds": emb, "dec_tokens": jnp.asarray(toks),
            "dec_targets": jnp.asarray(tgt)})
    _ref_close(runs["ranks"][0]["sw"]["loss"], loss, TOL)
    ref = dict(_flat(jax.tree_util.tree_map(np.asarray, rgrads)))
    want = dict(_flat(plain["grads"]))
    assert set(ref) == set(want) == set(dict(_flat(grads)))
    for path, g in _flat(grads):
        _close(g, want[path], SHARD_REL, floor=GRAD_FLOOR)
        _close(g, ref[path], GRAD_REL, floor=GRAD_FLOOR)


@pytest.mark.parametrize("key", KEYS)
def test_interpret_route_holds_the_op_tol(runs, key):
    got = runs["ranks"][0]["interp"][key]
    assert torch.equal(got, runs["ranks"][1]["interp"][key])
    _close(got, runs["plain"]["interp"][key], OP_TOL)


def test_lane_fault_on_rank_1s_attention_demotes_it_on_both():
    """Rank 1's canary finds a lane fault on ``flash_attention`` at step
    3; both ranks apply it at step 3, emit the same tokens, hold the
    unsharded serve's logits before it, and each holds half of the
    cross-KV's kv heads."""
    spec = tp_serve.TPServeSpec(arch="whisper-base", hw_route=INTERPRET,
                                fault_step=3, fault_rank=1, requests=2,
                                max_prompt=4, max_new=6, frames=FRAMES,
                                dtype="float32")
    assert spec.fault_stage == "flash_attention"
    with tempfile.TemporaryDirectory() as d:
        ref_path = os.path.join(d, "ref.pt")
        ref = tp_serve.reference_run(spec, "cpu", path=ref_path)
        res = tp_serve.launch_ranks(spec, MESH, device="cpu",
                                    ref_logits=ref_path,
                                    env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert tp_serve.check_agreement(res) == []
    for r in res:
        assert r["fault_applied_step"] == 3
        assert r["routes"] == [INTERPRET] * 3 + [SW] * 4
        assert r["steps"] == 7
        before = [rel for rel, c in zip(r["logits_rel"], r["calls"])
                  if c["step"] < 3]
        assert len(before) == 3 and max(before) <= OP_TOL, r["logits_rel"]
        assert r["cache_shapes"]["cross/0"][3] * 2 == \
            get_config("whisper-base-smoke").num_kv_heads
        assert {c["kind"] for c in r["calls"]} == {"prefill", "tick"}
    assert sorted(res[0]["tokens"]) == sorted(ref["tokens"])
