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
import types

import pytest
import torch

import chip_smoke
from repro_torch.configs import get_config
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
