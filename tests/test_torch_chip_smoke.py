"""``chip_smoke.py``'s fleet and training phases, rehearsed on the CPU.

``fleet_phase`` drives qwen1.5-4b through a 3-device ``FleetServeEngine``
on the card.  Its schedule never reads token values, so the same phase
at smoke width, with the full vocabulary (the workload draws depend on
it), must take the card's schedule step for step: the steps, requeues,
per-device tokens, builds and kernel launches asserted below are the
ones ``python3 chip_smoke.py`` printed on an H100 (launches scaled by
40 / 4 layers).  The kernel wrappers count their calls here (on the CPU
they run their plain versions and count nothing), and the allocator's
figure is the bytes of the live tensors' storages.

``train_phase`` runs at the reduced config: its checks (finite and
falling losses, the forward-only refusal, the NaN guard's restore, the
fleet's migration, transient and host loss, card against CPU) do not
depend on the width.
"""
import dataclasses
import gc
import sys
import types

import pytest
import torch

import chip_smoke
from repro_torch.configs import get_config
from repro_torch.kernels import checksum
from repro_torch.kernels.flash_attention import ops as attention_ops
from repro_torch.kernels.swiglu import ops as swiglu_ops
from _torch_threads import one_torch_thread  # noqa: F401


def _live_tensor_bytes(*_):
    storages = {}
    for obj in gc.get_objects():
        if issubclass(type(obj), torch.Tensor):
            st = obj.untyped_storage()
            storages[st.data_ptr()] = st.nbytes()
    return sum(storages.values())


def test_fleet_phase_takes_the_cards_schedule(monkeypatch):
    counters = {name: types.SimpleNamespace(launches=0)
                for name in ("checksum", "flash_attention", "swiglu_mlp")}

    def counted(fn, name):
        def call(*a, **kw):
            counters[name].launches += 1
            return fn(*a, **kw)
        return call
    monkeypatch.setattr(attention_ops, "flash_attention_bhsd", counted(
        attention_ops.flash_attention_bhsd, "flash_attention"))
    monkeypatch.setattr(swiglu_ops, "swiglu_fused", counted(
        swiglu_ops.swiglu_fused, "swiglu_mlp"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated", _live_tensor_bytes)
    full = get_config("qwen1.5-4b")
    cfg = dataclasses.replace(get_config("qwen1.5-4b-smoke"),
                              vocab_size=full.vocab_size)
    entry, launches = chip_smoke.fleet_phase(cfg, torch.device("cpu"),
                                             counters)
    per_layer = cfg.num_layers / full.num_layers
    assert launches == {"checksum": 0,
                        "flash_attention": 4080 * per_layer,
                        "swiglu_mlp": 13800 * per_layer}
    schedule = {k: (entry[k]["steps"], entry[k]["requeued"],
                    entry[k]["per_device_tokens"], entry[k]["decode_builds"],
                    entry[k]["prefill_builds"])
                for k in ("A_recompile", "A_resident", "B_recompile",
                          "B_resident")}
    assert schedule == {
        "A_recompile": (31, 7, [72, 116, 41], 1, 1),
        "A_resident": (31, 7, [72, 116, 41], 1, 1),
        "B_recompile": (30, 4, [10, 102, 90], 3, 2),
        "B_resident": (30, 4, [10, 102, 90], 1, 1)}
    fe = entry["frontend"]
    assert (fe["steps"], fe["expired"], fe["completed"]) == (37, 0, 16)
    # virtual TTFT in steps (the card's, from its JSON report)
    assert (fe["p50_ttft_s"] / fe["step_time_s"],
            fe["p99_ttft_s"] / fe["step_time_s"]) == pytest.approx(
        (8.629846742771024, 15.169940655836577), rel=1e-9)
    mem = entry["memory"]
    assert mem["fleet_bytes"] - mem["single_engine_bytes"] <= \
        2 * mem["pool_bytes"] * (1 + chip_smoke.FLEET_MEM_SLACK)


def test_train_phase_on_the_cpu(monkeypatch, tmp_path):
    """``train_phase`` (T1-T5) at the reduced config on the CPU: every
    check it makes on the card passes, nothing launches a kernel wrapper
    (training runs the SW route; route hw refuses before launching), and
    its checkpoints are cleaned up."""
    counters = {name: types.SimpleNamespace(launches=0)
                for name in ("checksum", "flash_attention", "swiglu_mlp")}

    def counted(fn, name):
        def call(*a, **kw):
            counters[name].launches += 1
            return fn(*a, **kw)
        return call
    monkeypatch.setattr(attention_ops, "flash_attention_bhsd", counted(
        attention_ops.flash_attention_bhsd, "flash_attention"))
    monkeypatch.setattr(swiglu_ops, "swiglu_fused", counted(
        swiglu_ops.swiglu_fused, "swiglu_mlp"))
    cfg = get_config("qwen1.5-4b-smoke")
    entry, launches = chip_smoke.train_phase(cfg, torch.device("cpu"),
                                             counters, workdir=tmp_path)
    assert launches == {"checksum": 0, "flash_attention": 0, "swiglu_mlp": 0}
    t1 = entry["T1"]
    assert len(t1["losses"]) == chip_smoke.TRAIN_STEPS
    assert t1["tokens_per_s"] > 0 and t1["peak_bytes"] is None
    assert set(entry["T2"]) == {"flash_attention", "swiglu_mlp"}
    t3 = entry["T3"]
    assert [s["step"] for s in t3["saves"]] == [3, 6]
    assert t3["guard_trips"] == 1 and t3["compiles"] == 1
    assert entry["T4"]["poison"]["serving"] == [0, 2]
    assert entry["T5"]["loss_rel"] == 0.0
    assert list(tmp_path.iterdir()) == []


def test_chaos_phase_on_the_cpu(monkeypatch, tmp_path):
    """``chaos_phase`` (phase 10: ``run_campaign`` on route hw, its
    telemetry rendered by ``python -m repro_torch.obs.report``) at the
    reduced width with the full vocabulary (the campaign's request draws
    depend on it), so the campaigns take the card's schedule: every check
    it makes on the card passes, the serve and closure campaigns launch
    attention and SwiGLU, training and the checksum launch nothing."""
    counters = {name: types.SimpleNamespace(launches=0)
                for name in ("checksum", "flash_attention", "swiglu_mlp")}

    def counted(fn, name):
        def call(*a, **kw):
            counters[name].launches += 1
            return fn(*a, **kw)
        return call
    monkeypatch.setattr(attention_ops, "flash_attention_bhsd", counted(
        attention_ops.flash_attention_bhsd, "flash_attention"))
    monkeypatch.setattr(swiglu_ops, "swiglu_fused", counted(
        swiglu_ops.swiglu_fused, "swiglu_mlp"))
    from repro_torch.models import build_model, compute_params
    full = get_config("qwen1.5-4b")
    cfg = dataclasses.replace(get_config("qwen1.5-4b-smoke"),
                              vocab_size=full.vocab_size)
    params = compute_params(build_model(cfg).init(0, device="cpu"),
                            torch.bfloat16)
    entry, launches = chip_smoke.chaos_phase(cfg, torch.device("cpu"),
                                             counters, params,
                                             workdir=tmp_path)
    assert launches["checksum"] == 0
    assert launches["flash_attention"] > 0 and launches["swiglu_mlp"] > 0
    assert entry["sections"]["train"]["launches"] == {
        "checksum": 0, "flash_attention": 0, "swiglu_mlp": 0}
    assert entry["invariants"] == {"ok": True, "failed": []}
    assert entry["events_total"] == 3 + 3 + 2 + 1
    # the card's schedule and launches (python3 chip_smoke.py on an H100):
    # a serve mode ran 31 attention prefills of its 20 layers plus 2
    # canary probes (622 launches) and 80 SwiGLU calls plus 3 probes
    # (1,603); the closure 27 and 66 calls (540 and 1,320)
    L = cfg.num_layers
    for mode in ("recompile", "resident"):
        row = entry[f"serve_{mode}"]
        assert [e["kind"] for e in row["schedule"]] == \
            ["lane_fault", "transient_stage", "coord_stall"]
        assert all(row["invariants"].values())
        assert row["traffic"] == {
            "requests": 30, "completed": 30, "expired": 0, "requeued": 1,
            "throughput_tok_s": 112.41, "virtual_time_s": 1.45}
        assert row["quarantined"] == [1]
        assert entry["sections"][f"serve_{mode}"]["launches"] == {
            "checksum": 0, "flash_attention": 31 * L + 2,
            "swiglu_mlp": 80 * L + 3}
    assert entry["sections"]["closure"]["launches"] == {
        "checksum": 0, "flash_attention": 27 * L, "swiglu_mlp": 66 * L}
    assert (entry["closure"]["measured_ratio"],
            entry["closure"]["analytic_ratio"]) == (0.4881, 0.5)
    assert entry["train"]["quarantined"] == [0, 1]
    assert entry["train"]["guard_trips"] == 1
    assert list(tmp_path.iterdir()) == []


def test_zoo_phase_on_the_cpu(monkeypatch):
    """``zoo_phase`` (phase 11) at smoke width with each model's full
    vocabulary (the request draws depend on it): every check it makes on
    the card passes (the canaries, both failover modes under the
    transient and the persistent fault, the launch schedule, SW
    bit-identity, the router-flip accounting, the ring), with the
    wrappers counting their calls and a stand-in for the profiler that
    counts the same kernels' launches.  The ring request is cut to 40
    prompt tokens at max_len 56: the smoke window of 16 makes the same
    wrap as the card's 4200 tokens over 4096 slots (the plain attention
    over 4200 tokens takes half a minute on the CPU), in mixtral's every
    layer and gemma2's local layers, while gemma2's global layer keeps
    all 56 slots in order, as its 4224 on the card."""
    from repro_torch.serve import ServeConfig, ServeEngine
    counters = {name: types.SimpleNamespace(launches=0)
                for name in ("checksum", "flash_attention", "swiglu_mlp")}

    def counted(fn, name):
        def call(*a, **kw):
            counters[name].launches += 1
            return fn(*a, **kw)
        return call

    def profile(torch_, cfg, hw_model, params, toks, cache, reqs, max_len,
                dev):
        eng = ServeEngine(cfg, params, ServeConfig(
            max_len=max_len, max_slots=4, hw_route="hw"), device=dev)
        sess = eng.session()
        for r in reqs:
            sess.submit(r)
        while eng.occupancy() < 4:
            sess.step()
        res = {}
        for name, fn in (("prefill", lambda: hw_model.prefill(
                params, {"tokens": toks, "cache": cache})),
                ("decode_tick_4", sess.step)):
            n0 = {k: c.launches for k, c in counters.items()}
            fn()
            res[name] = {"attention_launches": counters[
                "flash_attention"].launches - n0["flash_attention"],
                "swiglu_calls": counters["swiglu_mlp"].launches
                - n0["swiglu_mlp"]}
        sess.close()
        return res
    monkeypatch.setattr(attention_ops, "flash_attention_bhsd", counted(
        attention_ops.flash_attention_bhsd, "flash_attention"))
    monkeypatch.setattr(swiglu_ops, "swiglu_fused", counted(
        swiglu_ops.swiglu_fused, "swiglu_mlp"))
    monkeypatch.setattr(chip_smoke, "profile_serving", profile)
    monkeypatch.setattr(chip_smoke, "time_ms", lambda *a, **kw: 0.0)
    # the Fig. 4 fold over the full vocabulary's weights takes seconds on
    # the CPU; test_torch_checksum.py holds it against the plain fold
    monkeypatch.setattr(checksum, "checksum_tree", lambda tree: 0)
    monkeypatch.setattr(checksum, "checksum_tree_ref", lambda tree: 0)
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(chip_smoke, "RING_PROMPT", 40)
    monkeypatch.setattr(chip_smoke, "RING_MAX_LEN", 56)
    # gemma3-1b-smoke's three layers are all local: eight give the 5:1
    # pattern's local and global layers and its two-layer tail
    configs = [(dataclasses.replace(
        get_config(c.name + "-smoke"), vocab_size=c.vocab_size,
        **({"num_layers": 8} if c.name == "gemma3-1b" else {})), stage)
        for c, stage in chip_smoke.zoo_configs()]
    entries, launches = chip_smoke.zoo_phase(configs, torch.device("cpu"),
                                             counters)
    assert list(entries) == [c.name for c, _ in configs]
    L = {c.name: c.num_layers for c, _ in configs}
    mistral, mixtral, llama4, gemma, gemma3, qwen_vl = L
    # the schedule of each serve, the same on the card at its depth
    # (python3 chip_smoke.py on an H100: 480 and 650, 74 and 8, 58): per
    # mode one launch a layer for each prefill and (SwiGLU) each tick while
    # the stage is healthy, plus the 2 + 3 canary probes on the fault
    # stage.  mistral: 6 prefills, and 8 SwiGLU calls (prefills and ticks)
    # before its fault at step 4; the MoE models and gemma2: 4 prefills
    # before their attention fault; gemma2's SwiGLU, never faulted, every
    # one of the 6 prefills and 26 ticks; each ring prefill one launch a
    # layer of each kernel
    assert launches["checksum"] == {n: 0 for n in L}
    assert launches["flash_attention"] == {
        mistral: 2 * 6 * L[mistral], mixtral: 2 * (4 * L[mixtral] + 5),
        f"{mixtral} ring": L[mixtral], llama4: 2 * (4 * L[llama4] + 5),
        gemma: 2 * (4 * L[gemma] + 5), f"{gemma} ring": L[gemma],
        gemma3: 2 * 6 * L[gemma3], f"{gemma3} ring": L[gemma3],
        qwen_vl: 2 * (4 * L[qwen_vl] + 5),
        f"{qwen_vl} image prefill": L[qwen_vl]}
    assert launches["swiglu_mlp"] == {
        mistral: 2 * (8 * L[mistral] + 5), gemma: 2 * (6 + 26) * L[gemma],
        f"{gemma} ring": L[gemma], gemma3: 2 * (8 * L[gemma3] + 5),
        f"{gemma3} ring": L[gemma3], qwen_vl: 2 * (6 + 26) * L[qwen_vl],
        f"{qwen_vl} image prefill": L[qwen_vl]}
    assert entries[mistral]["hw_vs_sw_logits"].get("router") is None
    for name in (mixtral, llama4):
        router = entries[name]["hw_vs_sw_logits"]["router"]
        tf = router["teacher_forced"]
        assert router["end_to_end"]["layers"] == tf["layers"] == L[name]
        assert all(m < tf["drift"] for m in tf["margins"])
    ring = entries[mixtral]["ring"]
    assert ring["bit_identical"] and ring["cache_slots"] == 16 < 40
    assert len(ring["tokens"]) == chip_smoke.RING_NEW
    assert ring["caches"] == {"all": {"layers": L[mixtral], "slots": 16,
                                      "wraps": True}}
    ring = entries[gemma]["ring"]
    assert ring["bit_identical"] and len(ring["tokens"]) == chip_smoke.RING_NEW
    assert ring["caches"] == {
        "local": {"layers": 2, "slots": 16, "wraps": True},
        "global": {"layers": 1, "slots": 56, "wraps": False}}
    assert entries[gemma]["hw_vs_sw_logits"].get("router") is None
    # gemma3: the seven local rings of 16 wrap, the global cache keeps 56
    ring = entries[gemma3]["ring"]
    assert ring["bit_identical"] and ring["caches"] == {
        "local": {"layers": 7, "slots": 16, "wraps": True},
        "global": {"layers": 1, "slots": 56, "wraps": False}}
    image = entries[qwen_vl]["image_prefill"]
    assert image["tokens"] == 2 * chip_smoke.VL_TEXT + chip_smoke.VL_GRID ** 2
    assert image["positions3_last"] == [2 * chip_smoke.VL_TEXT
                                        + chip_smoke.VL_GRID - 1] * 3
    assert image["max_rel"] <= chip_smoke.LOGITS_REL
    assert "ring" not in entries[qwen_vl]


def test_encdec_phase_on_the_cpu(monkeypatch):
    """Phase 12 (``encdec_phase``) at whisper-base-smoke's width with the
    full vocabulary and 64 frames: the canary, the f32 SW decode against
    teacher-forced logits to 2e-4 over every step to max_target_len (32),
    HW against SW prefill logits, the attention launches (2 + 2 * 2 a
    prefill, 2 a step: 2 + 2 layers here, 6 + 2 * 6 and 6 on the card), and
    the persistent fault's SW rebuild bit-identical to the healthy SW run,
    with the wrapper counting its calls."""
    counters = {name: types.SimpleNamespace(launches=0)
                for name in ("checksum", "flash_attention", "swiglu_mlp")}

    def counted(fn, name):
        def call(*a, **kw):
            counters[name].launches += 1
            return fn(*a, **kw)
        return call
    monkeypatch.setattr(attention_ops, "flash_attention_bhsd", counted(
        attention_ops.flash_attention_bhsd, "flash_attention"))
    monkeypatch.setattr(chip_smoke, "time_ms", lambda *a, **kw: 0.0)
    for name in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    full = get_config("whisper-base")
    cfg = dataclasses.replace(get_config("whisper-base-smoke"),
                              vocab_size=full.vocab_size)
    entry, launches = chip_smoke.encdec_phase(cfg, torch.device("cpu"),
                                              counters, frames=64)
    T, P, Ld = cfg.max_target_len, chip_smoke.ENCDEC_PROMPT, cfg.dec_layers
    steps = T - P - 1
    assert entry["f32_decode_vs_teacher_forced"]["steps"] == T - P
    assert entry["launches"] == {"prefill": 2 + 2 * Ld, "per_step": [Ld],
                                 "steps": steps}
    failover = entry["failover"]
    assert failover["bit_identical_to_sw"]
    assert failover["plan"] == {"flash_attention": "sw"}
    assert failover["verdict"]["transient"] is False
    # the HW greedy run, the faulted run's prefill and 4 steps, its probes
    assert launches == {"flash_attention": (2 + 2 * Ld) * 2 + Ld * (
        steps + chip_smoke.FAULT_STEP) + failover["verdict"]["probes"]}
    assert failover["verdict"]["probes"] == 3
    assert all(entry["canaries"]["flash_attention"]["faults_caught"]
               .values())


def test_tuning_phase_plans_on_the_cpu(tmp_path):
    """Phase 13's sweep, tune and non-default-entry logic on the CPU, with
    plans only (nothing launches) and a synthetic ``measure``: the main
    path's shapes and their admissible configs, each a plan carrying its
    knobs with today's plan among them; the tuner's pick per shape; the
    non-default entries; and the check of the wrappers' launch records
    against a cache, on the records the serve's prefills and decode
    ticks would leave (phase 4's prompt lengths)."""
    import numpy as np

    from repro_torch.kernels import tuning
    from repro_torch.kernels.flash_attention.kernel import plan as fa_plan
    from repro_torch.kernels.swiglu.kernel import plan as sw_plan
    from repro_torch.kernels.tuning.cache import TuningCache
    from repro_torch.serve import synthetic_workload

    qwen = get_config("qwen1.5-4b")
    prompts = [len(r.prompt) for r in synthetic_workload(
        qwen.vocab_size, 6, np.random.default_rng(0),
        **chip_smoke.QWEN_WORKLOAD)]
    assert prompts == [112, 117, 120, 124, 36, 105]
    shapes = [(k, chip_smoke.tune_shape(k, get_config(m), n))
              for k, m, n in chip_smoke.TUNE_CASES]
    served = sorted({(k, chip_smoke.tune_shape(k, qwen, P)) for P in prompts
                     for k in ("flash_attention", "swiglu_mlp")})
    shapes += served
    assert shapes[:10] == [
        ("flash_attention", (1, 128, 128, 20, 20, 128)),
        ("flash_attention", (1, 2048, 2048, 20, 20, 128)),
        ("flash_attention", (1, 384, 384, 32, 32, 64)),
        ("flash_attention", (1, 4200, 4200, 8, 4, 256)),
        ("swiglu_mlp", (4, 2560, 6912)), ("swiglu_mlp", (128, 2560, 6912)),
        ("swiglu_mlp", (384, 2048, 8192)), ("swiglu_mlp", (288, 3584, 18944)),
        ("mamba2_ssd", (1, 384, 64, 64, 64)),
        ("rwkv6_wkv", (1, 512, 32, 64, 64))]
    plans = {(k, s): chip_smoke.sweep_plans(k, s) for k, s in shapes}
    assert [len(plans[ks]) for ks in shapes[:10]] == [7, 7, 9, 1, 5, 5, 5,
                                                      5, 4, 2]
    assert [c["chunk"] for c, _ in plans[shapes[8]]] == [16, 32, 64, 128]
    assert [p.chunks for _, p in plans[shapes[8]]] == [24, 12, 6, 3]
    assert [c["chunk"] for c, _ in plans[shapes[9]]] == [8, 16]

    def measure_for(kernel, shape):
        by_cfg = {tuple(sorted(c.items())): p for c, p in plans[kernel,
                                                                shape]}

        def measure(cfg):            # a cost read off the plan
            p = by_cfg[tuple(sorted(cfg.items()))]
            if kernel == "flash_attention":
                return p.smem / 1e3 + p.grid / (p.nwg * p.blocks_per_sm)
            if kernel == "swiglu_mlp":
                return float(p.grid_a[0] * p.nwg + p.grid_b[1])
            return float(p.chunks + cfg["chunk"])
        return measure

    tuning.reset()
    cache = TuningCache(str(tmp_path / "tuned"),
                        fingerprint="torch-test/cpu/cpu")
    tuning.set_cache(cache)
    try:
        rows = chip_smoke.tune_cases(shapes, measure_for)
        for (kernel, shape), row in zip(shapes, rows):
            m = measure_for(kernel, shape)
            assert row["tuned_us"] == m(row["tuned"]) == min(
                m(c) for c, _ in plans[kernel, shape])
            assert row["default_us"] == m(row["default"])
            assert row["tried"] == len(plans[kernel, shape])
            assert cache.get(kernel, "hw", shape, torch.bfloat16) == \
                row["tuned"]
        assert tuning.stats()["tuned"] == len(shapes)

        # a config whose measurement raises fails the phase
        def crashing(kernel, shape):
            def measure(cfg):
                if cfg["chunk"] == 16:
                    raise RuntimeError("launch failed")
                return 1.0
            return measure
        with pytest.raises(SystemExit, match="measured 1 of 2"):
            chip_smoke.tune_cases([shapes[9]], crashing)

        picks = chip_smoke.non_default_entries(shapes, cache)
        assert ("flash_attention", shapes[3][1]) not in picks
        assert len(picks) == len(shapes) - 1
        forced = TuningCache(str(tmp_path / "forced"),
                             fingerprint="torch-test/cpu/cpu")
        for (kernel, shape), cfg in picks.items():
            space = tuning.space_for(kernel, "hw")
            assert space.admissible(cfg, shape)
            assert cfg != space.default(shape)
            if len(list(space.configs(shape))) > 2:
                assert cfg != cache.get(kernel, "hw", shape, torch.bfloat16)
            forced.put(kernel, "hw", shape, torch.bfloat16, cfg)

        # the records the serve would leave: a prefill per request, 40
        # layers each, decode ticks on row-independent SwiGLU (4 rows)
        def knobs(cfg):
            return tuple(sorted(cfg.items()))
        H, D = qwen.num_heads, qwen.resolved_head_dim
        records = {"flash_attention": {}, "swiglu_mlp": {
            ((4, qwen.d_model, qwen.d_ff, qwen.d_model, True),
             (("nsub", 1), ("nwg", 1))): 400}}
        for P in prompts:
            records["flash_attention"][
                (1, P, P, H, H, D, D),
                knobs(picks["flash_attention", (1, P, P, H, H, D)])] = 40
            records["swiglu_mlp"][
                (P, qwen.d_model, qwen.d_ff, qwen.d_model, False),
                knobs(picks["swiglu_mlp", (P, qwen.d_model, qwen.d_ff)])] = 40
        assert chip_smoke.check_launched_plans(records, forced, "forced") == {
            "flash_attention": 240, "swiglu_mlp": 240}
        # the empty cache wants today's plans, which these are not
        empty = TuningCache(str(tmp_path / "empty"),
                            fingerprint="torch-test/cpu/cpu")
        with pytest.raises(SystemExit, match="launched"):
            chip_smoke.check_launched_plans(records, empty, "empty")
        today = {"flash_attention": {
            ((1, P, P, H, H, D, D), knobs(fa_plan(1, H, H, P, P, D, D)
                                          .knobs())): 40 for P in prompts}}
        assert chip_smoke.check_launched_plans(today, empty, "empty") == {
            "flash_attention": 0}
        # a narrowed Do (a DEGRADED_REDUCED w2 of 61 lanes) refuses nsub 2
        M = 128
        forced.put("swiglu_mlp", "hw", (M, qwen.d_model, qwen.d_ff),
                   torch.bfloat16, {"nwg": 3, "nsub": 2})
        narrow = (M, qwen.d_model, qwen.d_ff, 61, False)
        assert chip_smoke.expected_knobs("swiglu_mlp", narrow, forced) == (
            sw_plan(*narrow).knobs(), False)
    finally:
        tuning.reset()


# the workloads of phase 15's models that have their own (TP_WORKLOADS),
# at the reduced configs: whisper-base one batch of 24 stub frames a row;
# gemma3-1b prompts past its smoke window of 16, max_len 32 cut by four
TP_SMOKE_WORK = {"whisper-base": dict(min_prompt=4, max_prompt=4, min_new=16,
                                      max_new=16, frames=24),
                 "gemma3-1b": dict(min_prompt=20, max_prompt=24, max_new=8)}


@pytest.mark.parametrize("arch,layers,kernels", [
    ("qwen1.5-4b", 2, ("flash_attention", "swiglu_mlp")),
    ("zamba2-1.2b", 4, ("flash_attention", "swiglu_mlp", "mamba2_ssd")),
    ("rwkv6-1.6b", 3, ("rwkv6_wkv",)),
    ("whisper-base", None, ("flash_attention",)),
    ("gemma3-1b", 6, ("flash_attention", "swiglu_mlp")),
    ("zamba2-1.2b@attn2d", 4, ("flash_attention", "swiglu_mlp",
                               "mamba2_ssd"))])
def test_tp_phase_on_the_cpu(monkeypatch, arch, layers, kernels):
    """Phase 15's wiring at the reduced config on four gloo ranks of the
    CPU, job by job: the ranks agree, demote the model's own kernel
    stage at the fault step together, hold the unsharded engine's logits
    before it (rwkv6-1.6b layer by layer, and its prefill against the f32
    model), call the wrappers at the shard shapes as often as the card's
    counts want, hold their share of the unsharded cache (a quarter over
    (1, 4): whisper-base's kv heads and cross-KV, gemma3-1b's slots; a
    half of zamba2-1.2b's kv heads, conv channels and SSM heads over
    ``attn2d``'s "model_h", whose Mamba2 params are cut four ways), and
    move the bytes a tick the dry run's stub counts."""
    from repro_torch.launch.tp_serve import TPServeSpec
    from repro_torch.viscosity import HW
    name = arch
    arch, _, variant = name.partition("@")
    variant = variant or None

    def spec(a=arch, v=variant):
        return TPServeSpec(arch=a, layers=layers, dtype="bfloat16",
                           hw_route=HW, fault_step=chip_smoke.TP_FAULT_STEP,
                           fault_rank=chip_smoke.TP_FAULT_RANK, variant=v,
                           **{**chip_smoke.TP_WORKLOAD, "min_prompt": 8,
                              "max_prompt": 16, **TP_SMOKE_WORK.get(a, {})})
    monkeypatch.setattr(chip_smoke, "tp_spec", spec)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    counters = {name: types.SimpleNamespace(launches=0)
                for name in ("checksum", "flash_attention", "swiglu_mlp",
                             "mamba2_ssd", "rwkv6_wkv")}
    entry, paths = chip_smoke.tp_phase(torch.device("cpu"), counters,
                                       "cpu", count="kernel_calls",
                                       jobs=((arch, variant),))
    cfg = spec().config()
    model = entry["models"][name]
    assert len(model["ranks"]) == 4 and model["layers"] == cfg.num_layers
    assert model["mesh"] == list(chip_smoke.TP_VARIANT_MESH if variant
                                 else chip_smoke.TP_MESH)
    launches = paths[f"tp {name}"]
    assert all(launches[k] > 0 for k in kernels), launches
    assert all(n == 0 for k, n in launches.items() if k not in kernels)
    assert set(model["stub_tick_bytes"]) == {"all-reduce", "all-gather"}
    assert all(r["logits_rel_max"] <= chip_smoke.LOGITS_REL
               for r in model["ranks"]) or arch == "rwkv6-1.6b"


def test_tp_train_phase_on_the_cpu(monkeypatch):
    """Phase 16's wiring at the reduced qwen1.5-4b on eight gloo ranks of
    the CPU over (2, 4): the unsharded steps, the half-batch control, the
    ranks' baseline and ZeRO-1 jobs from its initial params, and every
    check the card's run makes (the losses, grad norms, first moments and
    params against the unsharded run's, params against each other, the
    control beyond the limit, the moments halved, each step's collective
    bytes the dry run's)."""
    from repro_torch.launch.tp_train import TPTrainSpec

    def spec(zero1=False):
        return TPTrainSpec(**{**chip_smoke.TPT_SPEC, "full": False,
                              "layers": None, "seq": 16}, zero1=zero1)
    monkeypatch.setattr(chip_smoke, "tpt_spec", spec)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    entry = chip_smoke.tpt_phase(torch.device("cpu"), "cpu")
    assert entry["mesh"] == [2, 4] and set(entry["jobs"]) == {"baseline",
                                                             "zero1"}
    stubs = entry["stub_bytes"]
    assert set(stubs["baseline"]) == {"all-reduce", "all-gather"}
    assert set(stubs["zero1"]) == {"all-reduce", "all-gather",
                                   "reduce-scatter"}
    for r in entry["jobs"]["zero1"]:
        assert r["vs_compare"] <= chip_smoke.TPT_PAIR_REL
        assert r["opt_count"] == spec().steps
    for job in entry["jobs"].values():
        for r in job:
            assert max(r["vs_want"].values()) <= chip_smoke.TPT_REF_REL
    assert entry["control"]["vs"]["mu"] > chip_smoke.TPT_REF_REL


def test_tp_train_phase_spec_and_its_checks():
    """Phase 16's cell is the full-width qwen1.5-4b at 4 layers, B = 4,
    S = 128, over (2, 4), baseline then ZeRO-1 from one initial tree; its
    checks catch each fault on a synthetic result."""
    import copy
    spec = chip_smoke.tpt_spec()
    cfg = spec.config()
    assert (cfg.d_model, cfg.d_ff, cfg.num_layers, cfg.vocab_size) == \
        (2560, 6912, 4, get_config("qwen1.5-4b").vocab_size)
    assert (spec.batch, spec.seq, spec.zero1) == (4, 128, False)
    assert chip_smoke.tpt_spec(True).zero1
    jobs = chip_smoke.tpt_jobs("i.pt", "w.pt", "r")
    assert [(j["name"], j["compare"], j["init"], j["want"], j["ready"])
            for j in jobs] == [("baseline", None, "i.pt", "w.pt", "r"),
                               ("zero1", "baseline", "i.pt", "w.pt", None)]
    stubs = {"baseline": {"all-reduce": 10.0},
             "zero1": {"all-reduce": 2.0, "reduce-scatter": 8.0}}
    ref = {"losses": [2.0, 1.5], "grad_norms": [3.0, 2.5]}
    ctrl = {"grad_norms": [3.3, 2.4], "vs": {"mu": 0.5, "params": 1e-6}}

    def rank(name, r, moments, **kw):
        out = {"name": name, "rank": r,
               "vs_want": {"params": 1e-6, "mu": 2e-6},
               "moment_bytes": moments,
               "steps": [{"loss": x, "grad_norm": n,
                          "collectives": {"bytes": stubs[name]}}
                         for x, n in zip(ref["losses"], ref["grad_norms"])]}
        return {**out, **kw}
    good = [[rank("baseline", r, 16) for r in range(8)],
            [rank("zero1", r, 8, vs_compare=1e-7) for r in range(8)]]
    assert chip_smoke.tpt_faults(ref, ctrl, good, stubs) == []
    for breaks, what in (
            (lambda res: res[1][3].update(vs_compare=2e-5), "baseline's"),
            (lambda res: res[0][1]["vs_want"].update(params=2e-4),
             "params"),
            (lambda res: res[1][4]["vs_want"].update(mu=2e-4), "mu"),
            (lambda res: res[1][2].update(moment_bytes=16), "not half"),
            (lambda res: res[0][0]["steps"][1].update(loss=1.6), "losses"),
            (lambda res: res[1][6]["steps"][0].update(grad_norm=3.01),
             "grad norms"),
            (lambda res: res[1][5]["steps"][0].update(
                collectives={"bytes": stubs["baseline"]}), "stub"),
            (lambda res: res[0].pop(), "7 ranks")):
        res = copy.deepcopy(good)
        breaks(res)
        bad = chip_smoke.tpt_faults(ref, ctrl, res, stubs)
        assert bad and what in " ".join(bad), (what, bad)
    for blind in ({"grad_norms": [3.0001, 2.4], "vs": ctrl["vs"]},
                  {"grad_norms": ctrl["grad_norms"],
                   "vs": {"mu": 5e-5, "params": 1e-6}}):
        bad = chip_smoke.tpt_faults(ref, blind, good, stubs)
        assert bad and "control" in " ".join(bad), (blind, bad)


# phase 17's MoE jobs at the reduced configs: few requests, 8 new tokens
# each (the fault at step 6 needs 7 steps), the full-depth job 6 deep
NCCL_SMOKE_WORK = dict(requests=2, slots=2, min_prompt=8, max_prompt=16,
                       min_new=8, max_new=8)


def test_nccl_phase_on_the_cpu(monkeypatch):
    """Phase 17's (c)-(f) on four gloo CPU ranks with
    ``GroupComm(host=False)``, NCCL's path without host copies: (c) one
    of phase 15's jobs (the rest run in ``test_tp_phase_on_the_cpu``),
    (d) mixtral-8x7b and llama4-scout at 4 layers in f32 on SW (logits
    within 1e-3 of the unsharded run) and on HW with the fault (mixtral
    within 4e-3 before it), and bf16 (HW, the fault, router flips
    counted, mixtral's logits the control that fails the f32 HW bound),
    (e) the same 6 deep, each rank drawing its block (``init_keyed``:
    layers 0-3's checksum that of the 4-layer job's block), (f) phase 16
    over (2, 2); every check the card's run makes.  The full job list and
    depths are the card's."""
    from repro_torch.launch.tp_serve import TPServeSpec
    from repro_torch.launch.tp_train import TPTrainSpec
    from repro_torch.viscosity import HW, SW
    full = chip_smoke.nccl_moe_spec("llama4-scout-17b-a16e", 48)
    assert (full.full, full.keyed, full.config().num_layers,
            full.fault_stage, full.requests, full.hw_route,
            full.fault_step) == (True, True, 48, "flash_attention", 6, HW,
                                 chip_smoke.TP_FAULT_STEP)
    parity = chip_smoke.nccl_moe_spec("mixtral-8x7b", 4, "float32", SW)
    assert (parity.hw_route, parity.fault_step) == (SW, -1)
    parity = chip_smoke.nccl_moe_spec("mixtral-8x7b", 4, "float32")
    assert (parity.hw_route, parity.fault_step) == (
        HW, chip_smoke.TP_FAULT_STEP)
    assert chip_smoke.NCCL_MOE_FULL == {"mixtral-8x7b": 32,
                                        "llama4-scout-17b-a16e": 48}

    def tp_spec(a="qwen1.5-4b", v=None):
        return TPServeSpec(arch=a, layers=2, dtype="bfloat16", hw_route=HW,
                           fault_step=chip_smoke.TP_FAULT_STEP,
                           fault_rank=chip_smoke.TP_FAULT_RANK, variant=v,
                           **{**chip_smoke.TP_WORKLOAD, "min_prompt": 8,
                              "max_prompt": 16})

    card_spec = chip_smoke.nccl_moe_spec

    def moe_spec(arch, layers, dtype="bfloat16", route=HW):
        return dataclasses.replace(card_spec(arch, layers, dtype, route),
                                   full=False, **NCCL_SMOKE_WORK)

    def tpt_spec(zero1=False):
        return TPTrainSpec(**{**chip_smoke.TPT_SPEC, "full": False,
                              "layers": None, "seq": 16}, zero1=zero1)
    monkeypatch.setattr(chip_smoke, "tp_spec", tp_spec)
    monkeypatch.setattr(chip_smoke, "nccl_moe_spec", moe_spec)
    monkeypatch.setattr(chip_smoke, "NCCL_MOE_FULL",
                        dict.fromkeys(chip_smoke.NCCL_MOE, 6))
    monkeypatch.setattr(chip_smoke, "tpt_spec", tpt_spec)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    counters = {name: types.SimpleNamespace(launches=0)
                for name in ("checksum", "flash_attention", "swiglu_mlp",
                             "mamba2_ssd", "rwkv6_wkv")}
    entry, paths = chip_smoke.nccl_phase(
        torch.device("cpu"), counters, "cpu", count="kernel_calls",
        backend="gloo", host=False, jobs=(("qwen1.5-4b", None),),
        gloo_too=False)
    assert set(entry["c"]) == {"qwen1.5-4b"}
    assert list(entry["moe"]) == [
        f"{kind} {arch}" for arch in chip_smoke.NCCL_MOE
        for kind in ("d f32 sw", "d f32 hw", "d bf16")] + [
        f"e {arch}" for arch in chip_smoke.NCCL_MOE]
    for name, e in entry["moe"].items():
        assert len(e["ranks"]) == 4
        if name.startswith("d f32 sw"):
            assert all(r["logits_rel_max"] <= chip_smoke.NCCL_MOE_REL
                       for r in e["ranks"])
        held = name.split()[-1] in chip_smoke.NCCL_MOE_HW_HELD
        if name.startswith("d f32 hw") and held:
            assert all(r["logits_rel_max"] <= chip_smoke.NCCL_MOE_HW_REL
                       for r in e["ranks"])
        if name.startswith("d bf16"):
            assert all(len(r["router"]["flips"]) == 4 for r in e["ranks"])
            assert not held or all(
                r["control_rel_max"] > chip_smoke.NCCL_MOE_HW_REL
                for r in e["ranks"])
    for arch in chip_smoke.NCCL_MOE:
        assert [r["checksum_layers"] for r in
                entry["moe"][f"e {arch}"]["ranks"]] == [
            r["checksum_layers"] for r in
            entry["moe"][f"d bf16 {arch}"]["ranks"]]
        assert paths[f"nccl e {arch}"]["flash_attention"] > 0
        assert paths[f"nccl e {arch}"]["swiglu_mlp"] == 0
    assert entry["f"]["mesh"] == [2, 2]
    for job in entry["f"]["jobs"].values():
        for r in job:
            assert max(r["vs_want"].values()) <= chip_smoke.TPT_REF_REL
            assert not r["host_copies"]
            assert all("collective_ms" in st for st in r["steps"])


@pytest.mark.parametrize("rels, n_calls, holds", [
    ([1.9e-3, 1.6e-3, 5e-4, 9.0], 3, True),     # after the fault: unheld
    ([6.6e-3, 1e-3, 1e-3], 3, False),           # bf16's least reading
    ([1e-3, 1e-3], 3, False),                   # a call without a reading
    ([], 0, False)])
def test_nccl_logits_bound(rels, n_calls, holds):
    """The logits check of phase 17's f32 HW job, which its bf16 control
    must fail: the calls before the fault within ``NCCL_MOE_HW_REL``."""
    bad = chip_smoke.nccl_logits_faults(rels, n_calls,
                                        chip_smoke.NCCL_MOE_HW_REL, "f32 hw")
    assert (bad == []) == holds, bad


def test_four_cards_needs_four_cards(monkeypatch):
    """``--four-cards`` raises where the process sees fewer than four
    cards: it never skips."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py", "--four-cards"])
    with pytest.raises(SystemExit, match="2 card"):
        chip_smoke.main()
