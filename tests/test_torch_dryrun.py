"""The port's dry run (``configs/shapes.py``, ``models/model.py``'s specs,
``launch/op_analysis.py``, ``launch/dryrun.py``, ``launch/reanalyze.py``)
against the reference, and the MoE dispatch on meta.

The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` for 512 host
devices when imported, which every later subprocess of the test process
would inherit, so no test imports it: its ``model_flops`` and active-param
rule are restated here over ``repro.models.params_specs``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import (SHAPES as REF_SHAPES,
                           SMOKE_SHAPES as REF_SMOKE_SHAPES,
                           applicable as ref_applicable,
                           get_config as ref_get_config)
from repro.launch import hlo_analysis
from repro.models import build_model as ref_build_model
from repro.models import input_specs as ref_input_specs
from repro.models import params_specs as ref_params_specs

from repro_torch.configs import (ARCH_NAMES, SHAPES, SMOKE_SHAPES, applicable,
                                 get_config)
from repro_torch.launch import dryrun, op_analysis, reanalyze
from repro_torch.models import build_model, input_specs, params_specs
from repro_torch.models.moe import init_moe, moe_ffn
from _torch_threads import one_torch_thread  # noqa: F401

META = torch.device("meta")


def _ref_leaves(tree):
    return [(tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in p),
             tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    elif isinstance(tree, torch.Tensor):
        yield prefix, tuple(tree.shape), str(tree.dtype).split(".")[-1]


def _bytes_by_dtype(leaves):
    out = {}
    for _, shape, dt in leaves:
        size = jnp.dtype(dt).itemsize * int(np.prod(shape))
        out[dt] = out.get(dt, 0) + size
    return out


def test_shapes_and_applicable_equal_the_reference():
    for mine, ref in ((SHAPES, REF_SHAPES), (SMOKE_SHAPES, REF_SMOKE_SHAPES)):
        assert list(mine) == list(ref)
        for name in ref:
            a, b = mine[name], ref[name]
            assert (a.name, a.seq_len, a.global_batch, a.kind) == \
                (b.name, b.seq_len, b.global_batch, b.kind)
    assert sorted(ARCH_NAMES) == sorted(
        __import__("repro.configs", fromlist=["x"]).ARCH_NAMES)
    for arch in ARCH_NAMES:
        for name in SHAPES:
            assert applicable(get_config(arch), SHAPES[name]) == \
                ref_applicable(ref_get_config(arch), REF_SHAPES[name])


@pytest.fixture(scope="module")
def specs():
    """Per arch at full width: the reference's model and param specs, the
    port's model and meta params."""
    out = {}
    for arch in ARCH_NAMES:
        rm = ref_build_model(ref_get_config(arch))
        pm = build_model(get_config(arch))
        out[arch] = (rm, ref_params_specs(rm), pm, params_specs(pm))
    return out


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_params_specs_equal_the_reference_leaf_for_leaf(arch, specs):
    """Full width: every leaf's path, shape and dtype (gemma3-1b's qk-norm
    scales included)."""
    _, ref, _, mine = specs[arch]
    assert list(_leaves(mine)) == sorted(_ref_leaves(ref))
    assert all(t.device.type == "meta" for _, t in _flat(mine))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_equal_the_reference(arch, specs):
    """Every applicable cell: the batch leaves equal the reference's; the
    cache (and whisper's cross-KV) hold the same bytes per dtype; decode's
    tokens equal, its ``t`` a host int at the cache's last position."""
    rm, _, pm, _ = specs[arch]
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    for name, shape in SHAPES.items():
        if not applicable(cfg, shape)[0]:
            continue
        mine, ref = input_specs(cfg, shape, pm), \
            ref_input_specs(rcfg, REF_SHAPES[name], rm)
        if shape.kind == "decode":
            assert list(_leaves(mine["tokens"])) == [
                ((), (shape.global_batch, 1), "int32")]
            assert mine["t"] == min(shape.seq_len,
                                    cfg.max_target_len if cfg.is_encdec
                                    else shape.seq_len) - 1
            caches = mine["cache"], ref["cache"]
        else:
            batch = {k: v for k, v in mine["batch"].items() if k != "cache"}
            rbatch = {k: v for k, v in ref["batch"].items() if k != "cache"}
            assert list(_leaves(batch)) == sorted(_ref_leaves(rbatch))
            if shape.kind == "train":
                continue
            caches = mine["batch"]["cache"], ref["batch"]["cache"]
        assert _bytes_by_dtype(_leaves(caches[0])) == \
            _bytes_by_dtype(_ref_leaves(caches[1])), (arch, name)


def _ref_active_params(cfg, p_sds) -> int:
    """The reference dry run's ``_active_params``, restated."""
    total = int(sum(np.prod(x.shape) for x in jax.tree_util.tree_leaves(
        p_sds)))
    if cfg.moe is None:
        return total
    expert = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(p_sds)[0]:
        keys = [str(getattr(p, "key", "")) for p in path]
        if "moe" in keys and keys[-1] in ("w1", "w2", "w3"):
            expert += int(np.prod(leaf.shape))
    return total - expert + expert * cfg.moe.top_k // cfg.moe.num_experts


def _ref_model_flops(cfg, shape, p_sds) -> float:
    n = _ref_active_params(cfg, p_sds)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_and_active_params_equal_the_reference(arch, specs):
    _, ref, _, mine = specs[arch]
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    assert dryrun._active_params(cfg, mine) == _ref_active_params(rcfg, ref)
    for name, shape in SHAPES.items():
        assert dryrun.model_flops(cfg, shape, mine) == \
            _ref_model_flops(rcfg, REF_SHAPES[name], ref)


def test_op_analysis_flops_match_hlo_analysis():
    """Reduced qwen1.5-4b, SW prefill of 2 x 64 tokens into a 64-slot
    cache: the dot FLOPs the dispatch mode counts on meta against
    ``hlo_analysis`` over the reference's compiled single-device HLO."""
    B, S = 2, 64
    rm = ref_build_model(ref_get_config("qwen1.5-4b-smoke"))
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32),
             "cache": jax.eval_shape(lambda: rm.init_cache(B, S))}
    txt = jax.jit(rm.prefill).lower(
        jax.eval_shape(rm.init, jax.random.PRNGKey(0)), batch
    ).compile().as_text()
    want = hlo_analysis.analyze(txt).flops
    pm = build_model(get_config("qwen1.5-4b-smoke"))
    params = params_specs(pm)
    batch = {"tokens": torch.empty((B, S), dtype=torch.int32, device=META),
             "cache": pm.init_cache(B, S, device=META)}
    with op_analysis.OpAnalysis() as oa:
        oa.hold((params, batch))
        with oa.counting() as st:
            pm.prefill(params, batch)
    assert want > 0 and abs(st.flops - want) <= 0.02 * want
    assert st.bytes_hbm > 0 and st.score_bytes > 0
    assert oa.peak_bytes > dryrun._nbytes(params)


def test_op_analysis_score_bytes_do_not_depend_on_call_depth():
    """``attention_chunked`` publishes its (Sq, C) while it runs, so its
    score tensors count the same however deep it is called, and the
    geometry is gone once it returns."""
    from repro_torch.kernels.flash_attention import ref as attn_ref

    q = torch.empty((2, 24, 4, 32), device=META)
    kv = torch.empty((2, 40, 2, 32), device=META)

    def nested(depth):
        if depth == 0:
            return attn_ref.attention_chunked(q, kv, kv, kv_chunk=16)
        return nested(depth - 1)

    counted = []
    for depth in (0, 12):
        with op_analysis.OpAnalysis() as oa, oa.counting() as st:
            nested(depth)
        counted.append(st.score_bytes)
    # per chunk: the QK product, the mask's where, the subtraction and
    # its exp, each (2, 4, 24, 16) f32, 2x; three chunks of 16
    assert counted == [3 * 4 * 2 * (2 * 4 * 24 * 16 * 4)] * 2
    assert attn_ref.score_geometry() is None


def test_op_analysis_tracks_live_bytes():
    """The peak is what was alive at once, allocator-rounded; a freed
    tensor leaves the count."""
    with op_analysis.OpAnalysis() as oa:
        a = torch.empty(1000, device=META)           # 4000 -> 4096
        b = torch.empty(100, device=META)            # 400 -> 512
        del a
        c = torch.empty(10, device=META)             # 40 -> 512
        assert oa.live_bytes == 1024
        with oa.counting() as st:
            (b[:10] + c).sum()
    assert oa.peak_bytes == 4096 + 512
    assert st.flops == 0 and st.n_ops >= 2 and st.bytes_hbm == 2 * (40 + 4)
    del b, c


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
def test_run_cell_record_and_reanalyze(shape, tmp_path):
    """One cell per kind at the smoke shapes (qwen1.5-4b-smoke; its
    long_500k is a skip): a complete record, cached, and ``reanalyze``
    gives it back unchanged."""
    rec = dryrun.run_cell("qwen1.5-4b-smoke", shape, 1, out_dir=str(tmp_path),
                          shapes=SMOKE_SHAPES)
    if shape == "long_500k":
        assert rec["status"] == "skip" and "full-attention" in rec["reason"]
        return
    assert rec["status"] == "ok", rec.get("error")
    for key in ("params", "active_params", "model_flops", "flops_per_dev",
                "bytes", "fits", "microbatch", "roofline", "traffic",
                "device", "power_limit_w", "hbm_limit_bytes", "chips"):
        assert key in rec
    assert set(rec["bytes"]) == {"params", "opt_state", "cache", "peak"}
    assert rec["fits"] and rec["flops_per_dev"] > 0
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s")
    assert rec["roofline"]["collective_s"] == 0.0
    assert "no collective" in rec["roofline"]["collective_reason"]
    if rec["kind"] == "train":
        assert rec["microbatch"] == 1 and rec["bytes"]["opt_state"] > 0
        assert "forward-only" in rec["roofline"]["hw_route"]
    else:
        assert rec["bytes"]["cache"] > 0
        assert rec["roofline"]["hw_route"]["memory_s"] <= \
            rec["roofline"]["memory_s"]
    assert dryrun.run_cell("qwen1.5-4b-smoke", shape, 1,
                           out_dir=str(tmp_path), shapes=SMOKE_SHAPES) == rec
    path = dryrun.cell_path(str(tmp_path), "qwen1.5-4b-smoke", shape, 1)
    assert reanalyze.reanalyze(rec) == rec
    assert reanalyze.reanalyze_one(path)
    assert dryrun.run_cell("qwen1.5-4b-smoke", shape, 1,
                           out_dir=str(tmp_path), shapes=SMOKE_SHAPES) == rec


def test_train_microbatches_split_the_rows():
    """k microbatches: the same counted FLOPs as one (the microbatches'
    sum), a larger peak for the f32 grad accumulator."""
    cfg = get_config("qwen1.5-4b-smoke")
    shape = SMOKE_SHAPES["train_4k"]
    one = dryrun.analyze_cell(cfg, shape, 1, microbatch=1)
    two = dryrun.analyze_cell(cfg, shape, 1, microbatch=2)
    assert two["microbatch"] == 2
    assert abs(two["flops_per_dev"] - one["flops_per_dev"]) <= \
        1e-6 * one["flops_per_dev"]
    assert two["bytes"]["peak"] > one["bytes"]["params"] * 4


@pytest.mark.parametrize("top_k, shared", [(2, False), (1, True)])
def test_moe_ffn_runs_on_meta(top_k, shared):
    """No data-dependent shape: the dispatch runs on meta tensors."""
    gen = torch.Generator().manual_seed(0)
    p = {k: v[0] if not isinstance(v, dict) else
         {n: t[0] for n, t in v.items()}
         for k, v in init_moe(gen, 1, 32, 64, 4, torch.float32, META,
                              shared=shared).items()}
    x = torch.empty((2, 16, 32), dtype=torch.bfloat16, device=META)
    y, aux = moe_ffn(p, x, top_k=top_k, capacity_factor=1.25)
    assert y.device.type == "meta" and y.shape == x.shape
    assert y.dtype == torch.bfloat16
    assert set(aux) == {"aux_loss", "z_loss", "drop_frac"}


# ------------------------------------------------------------ --mesh cells
def _spec_bytes(tree, specs, sizes):
    """The rank's bytes of ``tree`` under ``specs``: each leaf's size over
    the ranks of the axes its spec names."""
    from repro_torch.launch import partition
    flat = partition.flatten(specs)
    return sum(int(np.prod(partition.local_shape(t.shape, flat[p], sizes)))
               * t.element_size()
               for p, t in partition.flatten(tree).items())


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k", "train_4k"])
def test_sharded_cell_bytes_and_collectives(shape, tmp_path):
    """A (1, 2) reduced dense cell (qwen1.5-4b-smoke): per-device param,
    optimiser and cache bytes equal the shard sums of ``params_pspecs``
    and ``make_cache_pspec_fn`` exactly; the collective bytes equal the
    dense transformer's count (per layer an all-reduce after ``wo`` and
    one after the MLP, one after the vocab-sharded embedding lookup, all
    in f32; the logits gathered in the compute dtype; decode also gathers
    each layer's sequence-cut positions); twice the counted FLOPs are no
    fewer than the unsharded cell's."""
    from repro_torch.launch import partition
    from repro_torch.models import (compute_params, decode_state_specs,
                                    prefill_batch_specs)
    arch = "qwen1.5-4b-smoke"
    cfg, spec = get_config(arch), SMOKE_SHAPES[shape]
    rec = dryrun.run_cell(arch, shape, out_dir=str(tmp_path),
                          shapes=SMOKE_SHAPES, mesh="1x2")
    one = dryrun.run_cell(arch, shape, 1, out_dir=str(tmp_path),
                          shapes=SMOKE_SHAPES)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["chips"] == 2 and rec["mesh"] == "1x2"
    sizes = {"data": 1, "model": 2}
    model = build_model(cfg)
    p = params_specs(model)
    pspecs = partition.params_pspecs(p, sizes)
    B, S, L, D, V = (spec.global_batch, spec.seq_len, cfg.num_layers,
                     cfg.d_model, cfg.vocab_size)
    coll = rec["collectives"]["bytes_by_kind"]
    if spec.kind == "train":
        n = _spec_bytes(p, pspecs, sizes)
        assert rec["bytes"]["params"] == n
        assert rec["bytes"]["opt_state"] == 2 * n + 4   # f32 moments, count
        assert coll["all-reduce"] > 0 and coll["all-gather"] > 0
    else:
        cp = compute_params(p, model.compute_dtype)
        assert rec["bytes"]["params"] == _spec_bytes(cp, pspecs, sizes)
        cache = (prefill_batch_specs(cfg, model, B, S)["cache"]
                 if spec.kind == "prefill"
                 else decode_state_specs(cfg, model, B, S)[0])
        cspecs = partition.tree_pspecs(cache, sizes,
                                       partition.make_cache_pspec_fn(B, sizes))
        assert rec["bytes"]["cache"] == _spec_bytes(cache, cspecs, sizes)
        assert rec["bytes"]["cache"] * 2 == _spec_bytes(
            cache, partition.tree_pspecs(cache, sizes,
                                         lambda *_: partition.P()), sizes)
        rows = S if spec.kind == "prefill" else 1
        assert coll["all-reduce"] == (2 * L + 1) * B * rows * D * 4
        gathers = B * V * 2
        if spec.kind == "decode":
            gathers += L * B * S * 4          # the positions, int32
        assert coll["all-gather"] == gathers
    assert rec["roofline"]["collective_s"] > 0
    assert rec["collectives"]["within_node"] == {"model": True}
    assert 2 * rec["flops_per_dev"] >= one["flops_per_dev"]
    assert reanalyze.reanalyze(rec) == rec


def _odd_ssm():
    """zamba2's smoke SSM with a state of 17: its B and C components do
    not divide a model axis of two."""
    smoke = get_config("zamba2-1.2b-smoke")
    return {"ssm": dataclasses.replace(smoke.ssm, state_dim=17)}


@pytest.mark.parametrize("arch,overrides,status", [
    ("zamba2-1.2b-smoke", None, "ok"), ("whisper-base-smoke", None, "ok"),
    ("zamba2-1.2b-smoke", "odd_ssm", "skip")])
def test_sharded_family_cell_status_with_spec_bytes(tmp_path, arch,
                                                    overrides, status):
    """Under a model axis the hybrid family runs one rank's step (its
    Mamba2 leaves cut by component), and so does the encoder-decoder
    family; a Mamba2 component that does not divide the axis is a skip.
    Either way the record's per-device bytes are the spec sums."""
    from repro_torch.launch import partition
    over = _odd_ssm() if overrides else None
    rec = dryrun.run_cell(arch, "train_4k", out_dir=str(tmp_path),
                          shapes=SMOKE_SHAPES, mesh="1x2", overrides=over)
    assert rec["status"] == status, rec.get("reason") or rec.get("error")
    if status == "skip":
        assert "does not divide" in rec["reason"] and "B component" in \
            rec["reason"], rec["reason"]
    else:
        assert rec["collectives"]["bytes_by_kind"]["all-gather"] > 0
    sizes = {"data": 1, "model": 2}
    cfg = dataclasses.replace(get_config(arch), **(over or {}))
    p = params_specs(build_model(cfg))
    n = _spec_bytes(p, partition.params_pspecs(p, sizes), sizes)
    assert rec["bytes"]["params"] == n == rec["spec_bytes"]["params"]
    assert rec["bytes"]["opt_state"] == 2 * n + 4


@pytest.mark.parametrize("arch,shape", [("gemma3-1b-smoke", "decode_32k"),
                                        ("whisper-base-smoke", "decode_32k")])
def test_sharded_decode_over_a_cut_cache_is_ok(tmp_path, arch, shape):
    """gemma3-1b's one kv head does not divide a model axis of two, so its
    caches are cut along their slots: the decode cell runs one rank's step,
    its cache half the whole one's bytes, and its gathers include each
    slot and layer's query heads and softmax partials.  whisper-base's
    decode state holds the rank's kv heads of the cross-KV."""
    from repro_torch.launch import partition
    from repro_torch.models import decode_state_specs
    rec = dryrun.run_cell(arch, shape, out_dir=str(tmp_path),
                          shapes=SMOKE_SHAPES, mesh="1x2")
    assert rec["status"] == "ok", rec.get("reason") or rec.get("error")
    cfg = get_config(arch)
    spec = SMOKE_SHAPES[shape]
    full, _, _ = decode_state_specs(cfg, build_model(cfg),
                                    spec.global_batch, spec.seq_len)
    whole = sum(t.numel() * t.element_size()
                for t in partition.flatten(full).values())
    assert rec["bytes"]["cache"] * 2 == whole
    coll = rec["collectives"]["n_by_kind"]
    B, L = spec.global_batch, cfg.num_layers
    if arch.startswith("gemma3"):
        # q, k, v and the partials per slot and layer; the logits per slot
        assert coll["all-gather"] == 4 * B * L + B
    assert coll["all-reduce"] > 0


def test_sharded_prefill_with_as_many_cache_layers_as_rows_is_ok(tmp_path):
    """mixtral-8x7b's prefill_32k at ``--mesh single`` holds 32 rows in a
    cache of 32 layers; here the reduced one's 4 layers and 4 rows over a
    data axis of two: the cell runs, the rank's cache keeps every layer
    and half the rows."""
    from repro_torch.configs.shapes import ShapeSpec
    cfg = get_config("mixtral-8x7b-smoke")
    L = cfg.num_layers
    shapes = {"prefill_32k": ShapeSpec("prefill_32k", 32, L, "prefill")}
    rec = dryrun.run_cell("mixtral-8x7b-smoke", "prefill_32k",
                          out_dir=str(tmp_path), shapes=shapes, mesh="2x2")
    assert rec["status"] == "ok", rec.get("reason") or rec.get("error")
    cache = build_model(cfg).init_cache(L, 32, device="meta")
    whole = sum(t.numel() * t.element_size()
                for t in dryrun.tree_leaves(cache))
    # the rows over "data" (2), the kv heads over "model" (2); k and v
    # carry all but the int32 positions, which the model axis cuts too
    assert rec["bytes"]["cache"] * 4 == whole


def test_hillclimb_base_against_a_variant(tmp_path, capsys):
    """``attn2d`` on the reduced qwen1.5-4b: its mesh, rules and axes
    reach ``run_cell`` as arguments; the table prints; a knob the port
    lacks raises naming it."""
    from repro_torch.launch import hillclimb
    from repro_torch.launch.variants import VARIANTS
    base = dryrun.run_cell("qwen1.5-4b-smoke", "train_4k",
                           out_dir=str(tmp_path), shapes=SMOKE_SHAPES,
                           mesh="single")
    var = hillclimb.run_variant("qwen1.5-4b-smoke", "train_4k", "attn2d",
                                out_dir=str(tmp_path), shapes=SMOKE_SHAPES)
    assert base["status"] == var["status"] == "ok"
    assert var["mesh_shape"] == dict(zip(VARIANTS["attn2d"]["mesh_axes"],
                                         VARIANTS["attn2d"]["mesh_shape"]))
    assert var["rules"]["heads"] == "model_h"
    assert (tmp_path / "qwen1.5-4b-smoke__train_4k__single@attn2d.json"
            ).exists()
    hillclimb.compare(base, var, "qwen1.5-4b-smoke/train_4k + attn2d")
    assert "collective_s" in capsys.readouterr().out
    with pytest.raises(ValueError, match="no_such_knob"):
        hillclimb.check_knobs({"train_kw": {"no_such_knob": True}},
                              get_config("qwen1.5-4b-smoke"))
    assert hillclimb.TRAIN_KNOBS == ("grad_unreduced", "zero1")
