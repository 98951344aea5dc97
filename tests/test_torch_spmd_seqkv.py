"""The tensor-parallel runtime's sequence-cut KV cache (``launch/spmd.py``,
``models/attention.py``), across two gloo processes on the CPU, against
the unsharded port and the reference.

gemma3-1b-smoke has one kv head, which does not divide a model axis of
two, so ``make_cache_pspec_fn`` cuts every cache along its slots: each
rank holds half of them.  The smoke config cut to six layers (five local
with window 16, then its global one), on the reference's float32 params
(qk-norm and post-norm scales drawn at random, as
``test_torch_gemma3.py`` draws them) cut by ``partition.shard_tree``
over one (1, 2) ("data", "model") mesh, one process per rank
(``_torch_spmd_worker.py``).  A 24-token prompt wraps the local rings
(16 slots, 8 a rank) at prefill, and four teacher-forced decode steps
keep wrapping them; the global layer keeps max_len = 28 slots, 14 a
rank.  Each decode step writes a token's k/v on the rank that owns its
slot, attends with every query head over each rank's slots and folds the
gathered f32 softmax partials in rank order.

Tolerances: against the unsharded port, 1e-5 of the largest logit;
against the reference, ``test_torch_gemma3.py``'s float32 (2e-5, 1e-4).
The collectives of one decode step (the partials' and the query heads'
gathers among them) equal what the dry run's counting stub prices for
the same decode cell on one rank.  And the caches the runtime refuses to
cut: heads and slots that both do not divide, and layers that the batch
rule takes for the rows.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model

from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.convert import params_from_jax
from repro_torch.launch import dryrun, partition, spmd
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import build_model
from _torch_threads import one_torch_thread  # noqa: F401
import _torch_spmd_worker as worker
from test_torch_spmd import _close, _launch, _ref_close

ARCH, LAYERS = "gemma3-1b-smoke", 6
TOL = (2e-5, 1e-4)
SHARD_REL = 1e-5
MESH = (1, 2)
B, P, T = 2, 24, 4
MAX_LEN = P + T
KEYS = ["prefill"] + [f"decode{i}" for i in range(T)]


def _cfg(get, **kw):
    return dataclasses.replace(get(ARCH), num_layers=LAYERS, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, the unsharded port's and the reference's
    prefill and decode logits."""
    tmp = tmp_path_factory.mktemp("spmd_seqkv")
    cfg = _cfg(ref_get_config, dtype="float32")
    rm = ref_build_model(cfg)
    host = jax.tree_util.tree_map(np.asarray, rm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    layers = host["layers"]
    for sub, names in (("attn", ("q_norm", "k_norm")),
                       ("post_ln1", ("scale",)), ("post_ln2", ("scale",))):
        for name in names:
            a = layers[sub][name]
            layers[sub][name] = (1.0 + 0.25 * rng.standard_normal(a.shape)
                                 ).astype(a.dtype)
    path = str(tmp / "gemma3.pt")
    torch.save(params_from_jax(host, device="cpu"), path)
    case = {"name": "gemma3", "arch": ARCH, "layers": LAYERS, "route": "sw",
            "run": ["prefill"], "params": path, "batch": B, "prompt": P,
            "decode": T, "seed": 5}
    ranks = _launch(MESH, [case], tmp)
    one = make_mesh((1, 1), ("data", "model"), devices=[torch.device("cpu")])
    plain = worker.run_case(case, one, {"data": 0, "model": 0})
    params = jax.tree_util.tree_map(jnp.asarray, host)
    toks = worker._tokens(5, (B, P + T)).numpy().astype(np.int32)
    lg, cache = jax.jit(rm.prefill)(params, {
        "tokens": jnp.asarray(toks[:, :P]),
        "cache": rm.init_cache(B, MAX_LEN)})
    ref = {"prefill": lg}
    step = jax.jit(rm.decode_step)
    for i in range(T):
        lg, cache = step(params, cache, jnp.asarray(toks[:, P + i:P + i + 1]),
                         jnp.int32(P + i))
        ref[f"decode{i}"] = lg
    return dict(ranks=[r["gemma3"] for r in ranks], plain=plain, ref=ref)


def test_config_mixes_local_rings_and_a_global_layer():
    cfg = _cfg(get_config)
    assert cfg.num_kv_heads == 1 and cfg.window == 16
    cache = build_model(cfg).init_cache(B, MAX_LEN, device="meta")
    assert cache["local"]["k"].shape[:3] == (5, B, 16)
    assert cache["global"]["k"].shape[:3] == (1, B, MAX_LEN)
    assert P > cfg.window


def test_each_rank_holds_half_of_every_caches_slots(runs):
    full = runs["plain"]["cache_shapes"]
    for r in runs["ranks"]:
        assert set(r["cache_shapes"]) == set(full)
        for path, shape in r["cache_shapes"].items():
            want = list(full[path])
            want[2] //= 2                  # (L, B, slots, ...)
            assert list(shape) == want, (path, shape, full[path])
        assert r["cache_bytes"] * 2 == runs["plain"]["cache_bytes"]


@pytest.mark.parametrize("key", KEYS)
def test_prefill_and_decode_match_unsharded_and_reference(runs, key):
    got = runs["ranks"][0][key]
    assert torch.equal(got, runs["ranks"][1][key])
    _close(got, runs["plain"][key], SHARD_REL)
    _ref_close(got, runs["ref"][key], TOL)


def test_decode_step_collectives_equal_the_dry_runs_count(runs):
    """Each decode step gathers the query heads and the partials over the
    cut slots (besides the k/v columns) and sums the ``wo`` and MLP
    partials; the dry run's counting stub, one rank of the same decode
    cell on meta, prices the same calls and bytes."""
    rec = dryrun.analyze_cell(
        _cfg(get_config, dtype="float32"),
        ShapeSpec("seqkv_tick", MAX_LEN, B, "decode"),
        mesh=make_mesh(MESH, ("data", "model"),
                       devices=[torch.device("meta")] * 2))
    want_n = rec["collectives"]["n_by_kind"]
    want_bytes = rec["collectives"]["bytes_by_kind"]
    # per slot and layer: q, k and v gathered, the partials gathered;
    # per slot the vocab-cut logits
    assert want_n["all-gather"] == 4 * B * LAYERS + B
    for r in runs["ranks"]:
        assert len(r["step_collectives"]) == T
        for step in r["step_collectives"]:
            assert step["n"] == want_n
            assert step["bytes"] == want_bytes


def test_whole_heads_and_slots_that_do_not_divide_are_refused():
    """A cache neither of whose dims divides the axis cannot be cut: a
    max_len of 27 leaves the global layer 27 slots over two ranks."""
    sizes = {"data": 1, "model": 2}
    cfg = _cfg(get_config)
    with spmd.spmd(sizes, {}):
        with pytest.raises(NotImplementedError, match="27 slots"):
            spmd.cache_specs(build_model(cfg), B, 27)
        spmd.cache_specs(build_model(cfg), B, MAX_LEN)


def test_a_cache_whose_layers_equal_its_rows_is_refused():
    """What is refused is the cut of its layers, no longer the cache:
    ``make_cache_pspec_fn`` takes a stacked cache's leading dim for its
    layers when the next dim is the batch too, so a cache of as many
    layers as rows keeps its layers whole and cuts its rows over the data
    axis (the reference's rule takes the layers for the batch there, the
    one difference in ``tests/test_torch_partition.py``)."""
    cfg = get_config("qwen1.5-4b-smoke")
    sizes = {"data": 2, "model": 2}
    L = cfg.num_layers
    with spmd.spmd(sizes, {}):
        meta, specs = spmd.cache_specs(build_model(cfg), L, 16)
        for path, spec in partition.flatten(specs).items():
            assert spec[0] is None and spec[1] == "data", (path, spec)
        cache = spmd.init_cache(build_model(cfg), L, 16, device="cpu")
        assert cache["k"].shape[:2] == (L, L // 2)
        spmd.cache_specs(build_model(cfg), 2 * L, 16)
