"""The port's autotuner (``repro_torch.kernels.tuning``), on the CPU.

The reference's ``tests/kernels/test_tuning.py`` restated over the port —
cache lifecycle, plan scope, the switch, the Dispatcher, the search — with
a synthetic ``measure`` and a ``tmp_path`` cache: nothing launches and no
clock is read.  Then what the Hopper spaces add: every admissible config
is a plan within the card's shared-memory limits and ``plan`` refuses the
rest; the wrappers' resolvers (memoized, emptied by ``set_cache``; a
row-independent SwiGLU call pinned to one warpgroup; a reduced width that
refuses an entry); one cache file shared with the reference's package,
each reading the other's section as a cold miss; the WKV's chunk bound;
and the SW knobs, each admissible ``kv_chunk`` and ``chunk`` of the port's
SW oracles against the reference's on tiny float32 inputs from a numpy
seed, to 2e-5 absolute and 1e-4 relative (the same algorithm in both
packages, sums in other orders).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import repro.kernels.flash_attention.ref as ref_fa
import repro.kernels.mamba2_scan.ref as ref_ssd
import repro.kernels.rwkv6_scan.ref as ref_wkv
from repro.kernels.tuning import space as ref_space
from repro.kernels.tuning.cache import TuningCache as RefTuningCache

import repro_torch.kernels.flash_attention.ref as pt_fa
import repro_torch.kernels.mamba2_scan.ref as pt_ssd
import repro_torch.kernels.rwkv6_scan.ref as pt_wkv
from repro_torch.core.oobleck import Dispatcher
from repro_torch.kernels import tuning
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.mamba2_scan import ops as ssd_ops
from repro_torch.kernels.swiglu import kernel as sw_kernel
from repro_torch.kernels.tuning import tuner
from repro_torch.kernels.tuning.cache import TuningCache, plan_digest
from repro_torch.kernels.tuning.space import SPACES, space_for
from _torch_threads import one_torch_thread  # noqa: F401

SWIGLU_SHAPE = (256, 2560, 6912)            # (M, D, F): qwen1.5-4b
FLASH_SHAPE = (1, 2048, 2048, 20, 20, 128)  # (B, Sq, Skv, H, Hkv, D)
SW_TOL = (2e-5, 1e-4)                       # (absolute, relative)


@pytest.fixture
def cache(tmp_path):
    """Process tuning cache pointed at a tmp dir with a pinned
    fingerprint (tests never touch the repo's artifacts/ cache)."""
    tuning.reset()
    c = TuningCache(str(tmp_path), fingerprint="torch-test/cpu/cpu")
    tuning.set_cache(c)
    yield c
    tuning.reset()


def _swiglu_cost(cfg):
    """Synthetic surface with the optimum away from the default (nwg 2,
    nsub 1 at SWIGLU_SHAPE)."""
    return abs(cfg["nwg"] - 3) + abs(cfg["nsub"] - 2) / 4 + 1.0


# --------------------------------------------------------- cache lifecycle
def test_cold_miss_then_tune_then_warm_hit(cache, tmp_path):
    assert tuning.lookup("swiglu_mlp", "hw", SWIGLU_SHAPE,
                         torch.bfloat16) is None
    assert tuning.stats()["misses"] == 1 and tuning.stats()["hits"] == 0

    cfg, us = tuning.tune_kernel("swiglu_mlp", "hw", SWIGLU_SHAPE,
                                 torch.bfloat16, measure=_swiglu_cost)
    assert cfg == {"nwg": 3, "nsub": 2}
    assert us == pytest.approx(_swiglu_cost(cfg))

    assert tuning.lookup("swiglu_mlp", "hw", SWIGLU_SHAPE,
                         torch.bfloat16) == cfg
    assert tuning.stats()["hits"] == 1 and tuning.stats()["tuned"] == 1

    # a later process reloads the entry from disk, keyed as the reference
    # keys it
    fresh = TuningCache(str(tmp_path), fingerprint=cache.fingerprint)
    assert fresh.get("swiglu_mlp", "hw", SWIGLU_SHAPE, torch.bfloat16) == cfg
    doc = json.load(open(cache.path))
    assert list(doc["by_backend"][cache.fingerprint]) == [
        "swiglu_mlp|hw|256x2560x6912|bfloat16|default"]


def test_fingerprint_partitions_the_cache(cache, tmp_path):
    cfg = {"nwg": 3, "nsub": 2}
    cache.put("swiglu_mlp", "hw", SWIGLU_SHAPE, torch.bfloat16, cfg, us=1.0)
    other = TuningCache(str(tmp_path), fingerprint="torch-x/cuda-12/H100")
    assert other.get("swiglu_mlp", "hw", SWIGLU_SHAPE, torch.bfloat16) is None
    same = TuningCache(str(tmp_path), fingerprint=cache.fingerprint)
    assert same.get("swiglu_mlp", "hw", SWIGLU_SHAPE, torch.bfloat16) == cfg
    assert tuning.backend_fingerprint().startswith(
        f"torch-{torch.__version__}/")


def test_corrupt_cache_fails_open(cache):
    cache.put("swiglu_mlp", "hw", SWIGLU_SHAPE, torch.bfloat16,
              {"nwg": 3, "nsub": 2})
    with open(cache.path, "w") as f:
        f.write("{ not json")
    cache.invalidate()
    assert tuning.lookup("swiglu_mlp", "hw", SWIGLU_SHAPE,
                         torch.bfloat16) is None
    cache.put("swiglu_mlp", "hw", SWIGLU_SHAPE, torch.bfloat16,
              {"nwg": 1, "nsub": 1})
    assert json.load(open(cache.path))["schema"] == 1


@pytest.mark.parametrize("cfg", [
    {"nwg": 1, "nsub": 2},          # nsub 2 needs two warpgroups
    {"nwg": 4, "nsub": 1},          # no such instantiation
    {"bm": 64, "bf": 256, "bs": 128},   # the reference's TPU tiles
    {"nwg": 2, "nsub": 1, "splits": 4},  # the slices are not a knob
])
def test_stale_inadmissible_entry_is_ignored(cache, cfg):
    cache.put("swiglu_mlp", "hw", SWIGLU_SHAPE, torch.bfloat16, cfg)
    assert tuning.lookup("swiglu_mlp", "hw", SWIGLU_SHAPE,
                         torch.bfloat16) is None


def test_plan_scoped_lookup_prefers_plan_entry(cache):
    plan_key = ("stage0:sw", "stage1:hw")
    default_cfg = {"nwg": 2, "nsub": 1}
    plan_cfg = {"nwg": 3, "nsub": 2}
    cache.put("swiglu_mlp", "hw", SWIGLU_SHAPE, torch.bfloat16, default_cfg)
    cache.put("swiglu_mlp", "hw", SWIGLU_SHAPE, torch.bfloat16, plan_cfg,
              plan=plan_digest(plan_key))
    assert tuning.lookup("swiglu_mlp", "hw", SWIGLU_SHAPE,
                         torch.bfloat16) == default_cfg
    with tuning.plan_scope(plan_key):
        assert tuning.lookup("swiglu_mlp", "hw", SWIGLU_SHAPE,
                             torch.bfloat16) == plan_cfg
    with tuning.plan_scope(("some", "other", "plan")):
        assert tuning.lookup("swiglu_mlp", "hw", SWIGLU_SHAPE,
                             torch.bfloat16) == default_cfg


def test_disabled_by_env(cache, monkeypatch):
    cache.put("swiglu_mlp", "hw", SWIGLU_SHAPE, torch.bfloat16,
              {"nwg": 3, "nsub": 2})
    monkeypatch.setenv("REPRO_TUNER", "off")
    assert tuning.lookup("swiglu_mlp", "hw", SWIGLU_SHAPE,
                         torch.bfloat16) is None
    assert sw_kernel.resolve(*SWIGLU_SHAPE, SWIGLU_SHAPE[1]) == \
        sw_kernel.plan(*SWIGLU_SHAPE, SWIGLU_SHAPE[1])


def test_dispatcher_threads_plan_scope_to_lookups(cache):
    seen = {}

    def build(key):
        seen["build"] = tuning.current_plan_key()

        def fn(x):
            seen["call"] = tuning.current_plan_key()
            return x

        return fn

    d = Dispatcher(build)
    assert d(("planA",), 1) == 1
    assert seen == {"build": ("planA",), "call": ("planA",)}
    assert tuning.current_plan_key() is None   # scope did not leak

    class Model:                 # the port's builds are models
        width = 7

        def prefill(self, x):
            seen["prefill"] = tuning.current_plan_key()
            return x + 1

    m = Dispatcher(lambda key: Model()).get(("planB",))
    assert m.prefill(1) == 2 and m.width == 7
    assert seen["prefill"] == ("planB",)
    assert tuning.current_plan_key() is None


# ------------------------------------------------------------- the search
def test_tuner_sweeps_and_hillclimbs_to_optimum(cache):
    cfg, us, evals = tuner.tune("swiglu_mlp", "hw", SWIGLU_SHAPE,
                                measure=_swiglu_cost, budget=500)
    assert cfg == {"nwg": 3, "nsub": 2} and evals <= 5

    def cost(c):
        return abs(c["stages"] - 2) + abs(c["nwg"] - 1) * 3 + c["per_sm"]

    cfg, us, evals = tuner.tune("flash_attention", "hw", FLASH_SHAPE,
                                measure=cost)
    assert cfg == {"nwg": 1, "stages": 2, "per_sm": 1} and evals == 7


def test_tuner_respects_budget(cache):
    calls = []

    def measure(cfg):
        calls.append(dict(cfg))
        return float(len(calls))

    _, _, evals = tuner.tune("flash_attention", "hw", FLASH_SHAPE,
                             measure=measure, budget=3)
    assert evals == 3 and len(calls) == 3


def test_crashing_config_never_aborts_search(cache):
    def measure(cfg):
        if cfg["nwg"] != 2:
            raise RuntimeError("simulated launch failure")
        return float(cfg["nsub"])

    cfg, us, _ = tuner.tune("swiglu_mlp", "hw", SWIGLU_SHAPE,
                            measure=measure, budget=500)
    assert cfg == {"nwg": 2, "nsub": 1}


def test_tuner_raises_when_nothing_measures(cache):
    def measure(cfg):
        raise RuntimeError("every config fails")

    with pytest.raises(RuntimeError, match="no admissible config"):
        tuner.tune("swiglu_mlp", "hw", SWIGLU_SHAPE, measure=measure,
                   budget=10)


def test_seeded_default_is_measured_first(cache):
    calls = []

    def measure(cfg):
        calls.append(dict(cfg))
        return _swiglu_cost(cfg)

    _, us, _ = tuner.tune("swiglu_mlp", "hw", SWIGLU_SHAPE, measure=measure)
    default = SPACES[("swiglu_mlp", "hw")].default(SWIGLU_SHAPE)
    assert calls[0] == default == sw_kernel.plan(
        *SWIGLU_SHAPE, SWIGLU_SHAPE[1]).knobs()
    assert us <= _swiglu_cost(default)


# ----------------------------------- the Hopper spaces against the plans
def _attention_ok(p):
    budget = min(fa_kernel.SMEM_LIMIT,
                 fa_kernel.SMEM_SM // p.blocks_per_sm - 1024)
    return (p.smem == fa_kernel.ring_bytes(p.nwg, p.kd, p.vb, p.stages)
            <= budget and 2 <= p.stages <= fa_kernel.MAX_STAGES
            and p.grid == min(p.items, fa_kernel.SM_COUNT * p.blocks_per_sm)
            and (max(p.kd, p.vb) <= 2 or (p.nwg == 1 and (p.kd, p.vb)
                                          in fa_kernel.COMPILED_WIDE)))


@settings(max_examples=25, deadline=None)
@given(B=st.sampled_from([1, 2, 4]), sq=st.sampled_from([1, 16, 128, 4200]),
       skv=st.sampled_from([1, 128, 1500]), H=st.sampled_from([8, 20, 32]),
       g=st.sampled_from([1, 4]), D=st.sampled_from([64, 80, 128, 200, 256]))
def test_attention_space_is_what_plan_takes(B, sq, skv, H, g, D):
    shape = (B, sq, skv, H, H // g, D)
    space = space_for("flash_attention", "hw")
    admissible = list(space.configs(shape))
    assert space.default(shape) in admissible
    for nwg in (1, 2, 3):
        for stages in (1, 2, 3, 4, 5):
            for per_sm in (1, 2, 3):
                cfg = {"nwg": nwg, "stages": stages, "per_sm": per_sm}
                if cfg in admissible:
                    p = fa_kernel.plan(B, H, H // g, sq, skv, D, D, **cfg)
                    assert p.knobs() == cfg and _attention_ok(p)
                else:
                    with pytest.raises(ValueError):
                        fa_kernel.plan(B, H, H // g, sq, skv, D, D, **cfg)
    if D > 128:               # one config: one warpgroup, two stages
        assert admissible == [{"nwg": 1, "per_sm": 1, "stages": 2}]


@settings(max_examples=25, deadline=None)
@given(M=st.sampled_from([1, 4, 128, 288, 384, 4200]),
       D=st.sampled_from([64, 1152, 2048, 2304, 2560, 3000]),
       F=st.sampled_from([128, 6912, 9216]))
def test_swiglu_space_is_what_plan_takes(M, D, F):
    shape = (M, D, F)
    space = space_for("swiglu_mlp", "hw")
    admissible = list(space.configs(shape))
    assert set(space.params) == {"nwg", "nsub"}      # no splits knob
    assert space.default(shape) in admissible
    default = sw_kernel.plan(M, D, F, D)
    for nwg in (0, 1, 2, 3, 4):
        for nsub in (1, 2, 3):
            cfg = {"nwg": nwg, "nsub": nsub}
            if cfg in admissible:
                p = sw_kernel.plan(M, D, F, D, **cfg)
                assert p.knobs() == cfg
                assert max(p.smem) <= sw_kernel.SMEM_LIMIT
                assert p.smem == (sw_kernel.ring_bytes(nwg),
                                  sw_kernel.ring_bytes(nwg, nsub))
                assert p.dims[2] % (sw_kernel.TILE * nsub) == 0
                # the slices and K tiling (each row's summation order)
                # are the default's whatever the knobs
                assert (p.splits, p.k_per_split, p.bk) == (
                    default.splits, default.k_per_split, default.bk)
            else:
                with pytest.raises(ValueError):
                    sw_kernel.plan(M, D, F, D, **cfg)


@pytest.mark.parametrize("kernel,limit", [("mamba2_ssd", 128),
                                          ("rwkv6_wkv", 16)])
def test_scan_spaces_stop_at_the_kernels_chunk(kernel, limit):
    from repro_torch.kernels.mamba2_scan import kernel as ssd_k
    from repro_torch.kernels.rwkv6_scan import kernel as wkv_k
    lmax = {"mamba2_ssd": ssd_k.LMAX, "rwkv6_wkv": wkv_k.LMAX}[kernel]
    assert lmax == limit
    shape = (1, 4096, 32, 64, 64)
    chunks = [c["chunk"] for c in space_for(kernel, "hw").configs(shape)]
    assert max(chunks) == limit and chunks == sorted(chunks)
    plan = ssd_k.plan if kernel == "mamba2_ssd" else wkv_k.plan
    for L in chunks:
        assert plan(1, 4096, 32, L).chunks == 4096 // L
    with pytest.raises(ValueError):
        plan(1, 4096, 32, 2 * limit)


def test_wkv_spaces_stop_at_16_where_the_references_overflow():
    for kind in ("hw", "sw"):
        assert max(space_for("rwkv6_wkv", kind).params["chunk"]) == 16
        assert not tuning.admissible("rwkv6_wkv", kind, {"chunk": 32},
                                     (1, 128, 2, 16, 16))
    assert tuning.admissible("rwkv6_wkv", "sw", {"chunk": 16},
                             (1, 128, 2, 16, 16))
    # the reference's space admits 32, where its own chunked oracle leaves
    # f32 at the clamp lw = -4: exp(-la) reaches e^128
    assert ref_space.admissible("rwkv6_wkv", "sw", {"chunk": 32},
                                (1, 128, 2, 16, 16))
    rng = np.random.default_rng(0)
    B, S, H, K = 1, 128, 2, 16
    r, k, v = (jnp.asarray(rng.normal(size=(B, S, H, K)) * 0.3, jnp.float32)
               for _ in range(3))
    u = jnp.asarray(rng.normal(size=(H, K)) * 0.5, jnp.float32)
    lw = jnp.full((B, S, H, K), -4.0, jnp.float32)
    o16, _ = ref_wkv.wkv6_chunked(r, k, v, lw, u, chunk=16)
    o32, _ = ref_wkv.wkv6_chunked(r, k, v, lw, u, chunk=32)
    assert np.isfinite(np.asarray(o16)).all()
    assert not np.isfinite(np.asarray(o32)).all()


# ------------------------------------------------------- the resolvers
def test_no_entry_resolves_to_todays_plans(cache):
    for shp in ((1, 20, 20, 128, 128, 128, 128), (1, 32, 32, 384, 384, 64, 64),
                (1, 8, 4, 4200, 4200, 256, 256), (4, 8, 8, 4, 1500, 64, 64)):
        assert fa_kernel.resolve(*shp) == fa_kernel.plan(*shp)
    for shp in ((4, 2560, 6912, 2560, True), (128, 2560, 6912, 2560, False),
                (384, 2048, 8192, 2048, False)):
        assert sw_kernel.resolve(*shp) == sw_kernel.plan(*shp)


def test_resolver_is_memoized_and_invalidated_by_set_cache(cache, tmp_path):
    B, Sq, Skv, H, Hkv, D = FLASH_SHAPE
    args = (B, H, Hkv, Sq, Skv, D, D)
    fa_kernel._CALLS[("stale",)] = None     # a CUDA call's record
    p0 = fa_kernel.resolve(*args)
    assert fa_kernel.resolve(*args) is p0
    assert tuning.stats() == {"hits": 0, "misses": 1, "tuned": 0}
    # a write to the live cache takes effect only after set_cache
    entry = {"nwg": 1, "stages": 2, "per_sm": 2}
    cache.put("flash_attention", "hw", FLASH_SHAPE, torch.bfloat16, entry)
    assert fa_kernel.resolve(*args) is p0
    tuning.set_cache(cache)
    assert not fa_kernel._CALLS
    p1 = fa_kernel.resolve(*args)
    assert p1.knobs() == entry and p1 == fa_kernel.plan(*args, **entry)
    assert fa_kernel.resolve(*args) is p1
    assert tuning.stats()["hits"] == 1
    # each routing-plan key resolves once, falling back to the default
    with tuning.plan_scope(("planA",)):
        assert fa_kernel.resolve(*args) == p1
        assert fa_kernel.resolve(*args) == p1
    assert tuning.stats()["hits"] == 2
    # tune_kernel and reset forget too
    tuning.tune_kernel("flash_attention", "hw", FLASH_SHAPE, torch.bfloat16,
                       measure=lambda c: sum(c.values()),
                       persist=False)
    assert fa_kernel.resolve(*args).knobs() == {"nwg": 1, "stages": 2,
                                                "per_sm": 1}
    tuning.reset()
    tuning.set_cache(TuningCache(str(tmp_path / "empty"),
                                 fingerprint="torch-test/cpu/cpu"))
    assert fa_kernel.resolve(*args) == p0


def test_reduced_width_ignores_an_entry_it_cannot_take(cache):
    # attention: a narrower Dv only shrinks the ring, so a DEGRADED_REDUCED
    # call keeps the entry
    B, Sq, Skv, H, Hkv, D = FLASH_SHAPE
    cache.put("flash_attention", "hw", FLASH_SHAPE, torch.bfloat16,
              {"nwg": 1, "stages": 2, "per_sm": 2})
    tuning.set_cache(cache)
    assert fa_kernel.resolve(B, H, Hkv, Sq, Skv, D, 126).knobs() == {
        "nwg": 1, "stages": 2, "per_sm": 2}
    # SwiGLU: nsub 2 needs a padded Do of whole 128s; w2 sliced to 61
    # lanes pads to 64
    M, Dm, Fm = SWIGLU_SHAPE
    cache.put("swiglu_mlp", "hw", SWIGLU_SHAPE, torch.bfloat16,
              {"nwg": 3, "nsub": 2})
    tuning.set_cache(cache)
    assert sw_kernel.resolve(M, Dm, Fm, Dm).knobs() == {"nwg": 3, "nsub": 2}
    assert sw_kernel.resolve(M, Dm, Fm, 61) == sw_kernel.plan(M, Dm, Fm, 61)


def test_row_independent_swiglu_keeps_one_warpgroup(cache):
    M, Dm, Fm = 4, 2560, 6912
    cache.put("swiglu_mlp", "hw", (M, Dm, Fm), torch.bfloat16,
              {"nwg": 3, "nsub": 2})
    tuning.set_cache(cache)
    assert sw_kernel.resolve(M, Dm, Fm, Dm, False).knobs() == {"nwg": 3,
                                                               "nsub": 2}
    p = sw_kernel.resolve(M, Dm, Fm, Dm, True)
    assert p.nwg == 1 and p == sw_kernel.plan(M, Dm, Fm, Dm, True)
    with pytest.raises(ValueError):
        sw_kernel.plan(M, Dm, Fm, Dm, True, nwg=3, nsub=2)


def test_cpu_operands_look_nothing_up_on_the_hw_route(cache):
    # the plain versions keep the reference's TPU tiles: no lookup at all
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(1, 32, 2, 8)), dtype=torch.float32)
    dt = torch.full((1, 32, 2), 0.5)
    A = torch.tensor([-1.0, -2.0])
    Bm = torch.tensor(rng.normal(size=(1, 32, 8)), dtype=torch.float32)
    q = torch.tensor(rng.normal(size=(1, 32, 2, 8)), dtype=torch.float32)
    ssd_ops._hw(x, dt, A, Bm, Bm)
    fa_ops._kernel_path(q, q, q)
    assert tuning.stats()["hits"] + tuning.stats()["misses"] == 0
    # the SW lowerings look up once per signature and plan key
    for _ in range(3):
        ssd_ops._sw(x, dt, A, Bm, Bm)
        fa_ops._sw_path(q, q, q)
    assert tuning.stats()["misses"] == 2
    with tuning.plan_scope(("planA",)):
        ssd_ops._sw(x, dt, A, Bm, Bm)
    assert tuning.stats()["misses"] == 3


# ------------------------------------------- one file, two packages
def test_cache_file_shared_with_the_reference(tmp_path):
    import jax
    ref = RefTuningCache(str(tmp_path))           # the jax fingerprint
    pt = TuningCache(str(tmp_path))               # the torch fingerprint
    assert ref.fingerprint.startswith(f"jax-{jax.__version__}/")
    assert pt.fingerprint.startswith(f"torch-{torch.__version__}/")
    shape = (128, 2560, 6912)
    ref.put("swiglu_mlp", "hw", shape, jnp.dtype(jnp.bfloat16),
            {"bm": 64, "bf": 256, "bs": 128})
    assert TuningCache(str(tmp_path)).get("swiglu_mlp", "hw", shape,
                                          torch.bfloat16) is None
    pt.put("swiglu_mlp", "hw", shape, torch.bfloat16, {"nwg": 2, "nsub": 2})
    assert RefTuningCache(str(tmp_path)).get(
        "swiglu_mlp", "hw", shape, jnp.dtype(jnp.bfloat16)) == {"bm": 64, "bf": 256,
                                                     "bs": 128}
    ref2 = RefTuningCache(str(tmp_path))
    ref2.put("mamba2_ssd", "sw", (1, 64, 2, 8, 8), jnp.dtype(jnp.float32),
             {"chunk": 32})
    doc = json.load(open(pt.path))
    assert set(doc["by_backend"]) == {ref.fingerprint, pt.fingerprint}
    assert TuningCache(str(tmp_path)).get(
        "swiglu_mlp", "hw", shape, torch.bfloat16) == {"nwg": 2, "nsub": 2}
    assert TuningCache(str(tmp_path)).get(
        "mamba2_ssd", "sw", (1, 64, 2, 8, 8), torch.float32) is None
    # the entry keys are spelled alike in both sections
    keys = {fp: sorted(sec) for fp, sec in doc["by_backend"].items()}
    assert keys[pt.fingerprint] == [
        "swiglu_mlp|hw|128x2560x6912|bfloat16|default"]
    assert "swiglu_mlp|hw|128x2560x6912|bfloat16|default" in \
        keys[ref.fingerprint]


# ------------------------------------------------------------ SW knobs
def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max()
    assert np.isfinite(got).all()
    assert err <= SW_TOL[0] + SW_TOL[1] * np.abs(want).max(), err


def test_sw_knobs_against_the_reference(cache):
    rng = np.random.default_rng(0)
    # attention: (B, S, H, D) = (1, 200, 4, 16), GQA 4 -> 2, causal
    q = rng.normal(size=(1, 200, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(1, 200, 2, 16)).astype(np.float32)
            for _ in range(2))
    shape = (1, 200, 200, 4, 2, 16)
    chunks = [c["kv_chunk"] for c in
              space_for("flash_attention", "sw").configs(shape)]
    assert chunks == [64, 128, 256]
    for c in chunks:
        want = ref_fa.attention_chunked(*map(jnp.asarray, (q, k, v)),
                                        kv_chunk=c)
        got = pt_fa.attention_chunked(*map(torch.from_numpy, (q, k, v)),
                                      kv_chunk=c)
        _close(got.numpy(), want)
        # the SW lowering takes the tuned chunk: the same bits
        cache.put("flash_attention", "sw", shape, torch.float32,
                  {"kv_chunk": c})
        tuning.set_cache(cache)
        assert torch.equal(fa_ops._sw_path(
            *map(torch.from_numpy, (q, k, v))), got)
    # the SSD: (B, S, H, P, N) = (1, 96, 2, 8, 8)
    x = rng.normal(size=(1, 96, 2, 8)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(-1.0, 0.5, size=(1, 96, 2)))).astype(
        np.float32)
    A = -np.linspace(0.3, 2.0, 2).astype(np.float32)
    Bm, C = ((rng.normal(size=(1, 96, 8)) * 0.5).astype(np.float32)
             for _ in range(2))
    for cfg in space_for("mamba2_ssd", "sw").configs((1, 96, 2, 8, 8)):
        want = ref_ssd.ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, C)),
                                   chunk=cfg["chunk"])
        got = pt_ssd.ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, C)),
                                 chunk=cfg["chunk"])
        for g, w in zip(got, want):
            _close(g.numpy(), w)
    # the WKV: (B, S, H, K, V) = (1, 40, 2, 8, 8), lw in the clamp
    r, kk, vv = (rng.normal(size=(1, 40, 2, 8)).astype(np.float32) * 0.3
                 for _ in range(3))
    lw = rng.uniform(-4.0, -1e-4, size=(1, 40, 2, 8)).astype(np.float32)
    u = (rng.normal(size=(2, 8)) * 0.5).astype(np.float32)
    cfgs = list(space_for("rwkv6_wkv", "sw").configs((1, 40, 2, 8, 8)))
    assert [c["chunk"] for c in cfgs] == [8, 16]
    for cfg in cfgs:
        want = ref_wkv.wkv6_chunked(*map(jnp.asarray, (r, kk, vv, lw, u)),
                                    chunk=cfg["chunk"])
        got = pt_wkv.wkv6_chunked(*map(torch.from_numpy,
                                       (r, kk, vv, lw, u)),
                                  chunk=cfg["chunk"])
        for g, w in zip(got, want):
            _close(g.numpy(), w)
