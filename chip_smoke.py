#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failed check exits non-zero; nothing falls back to the CPU):

1. build   — compile the Hopper kernels from ``src/repro_torch/csrc`` with
             nvcc (all sources at once) into ``build/repro_torch/``;
2. parity  — each kernel against its plain PyTorch version on the card, in
             bf16 at the serving shapes, healthy and under one LaneFault of
             each kind: flash attention at P in {128, 200} (causal,
             H=Hkv=20, D=128, kv_len padding), SwiGLU at M in {1, 4, 200};
3. serve   — qwen1.5-4b at full width (40 layers, d_model 2560, vocab
             151936; random weights from a seeded torch.Generator) through
             the port's ServeEngine on the HW route, in RECOMPILE and
             RESIDENT mode, each with a fault on ``swiglu_mlp`` at step 4:
             every request completes, the modes agree token for token,
             recompiles are 1 and 0, and both kernels' launch counters rose
             by 40 per prefill (attention, SwiGLU) and 40 per decode tick
             (SwiGLU) while SwiGLU was healthy;
4. sw      — three requests on the SW route, bit-identical to the port's
             single-request ``reference_decode``; the HW route's prefill
             logits finite and within 5% of the SW oracle's;
5. times   — per-kernel ms (CUDA events) beside the plain version's and a
             library call's (a yardstick the port never calls), the bound
             from this run's shapes, prefill ms, decode-tick ms, tokens/s,
             and a torch.profiler trace of one prefill and one decode tick
             (device time by kernel, the device's busy share).

The second-to-last line is one JSON object with the per-kernel numbers; the
last line is ``{"ok": true, "device": {...}}``.  Details also go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound's rates.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

ATTN_TOL = (2e-2, 1e-2)     # (max abs, max abs / max |plain|)
SWIGLU_TOL = (2e-2, 2e-2)
# HW against SW logits after 40 bf16 layers: each route rounds its
# activations to bf16 at other points, so the logits drift apart by a few
# bf16 ulps per layer; 5% of the largest logit bounds that drift.
LOGITS_REL = 5e-2


def out(line: str = ""):
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def check(cond: bool, msg: str):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_serving(torch, cfg, hw_model, params, toks, cache, reqs,
                    max_len, dev):
    """torch.profiler over one prefill (P = 128) and one decode tick with
    4 active slots: device time by kernel and the device's busy share of
    the traced wall time (the profiler's own overhead inflates the wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.viscosity import HW

    eng = ServeEngine(cfg, params, ServeConfig(max_len=max_len, max_slots=4,
                                               hw_route=HW), device=dev)
    sess = eng.session()
    for r in reqs:
        sess.submit(r)
    while eng.occupancy() < 4:
        sess.step()
    phases = {"prefill_P128": lambda: hw_model.prefill(
        params, {"tokens": toks, "cache": cache}), "decode_tick_4": sess.step}
    result = {}
    for name, fn in phases.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        # device-side events only (kernels, copies): a CPU op's own
        # "self device time" would count its kernels a second time
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
        busy_ms = sum(r[1] for r in rows)
        result[name] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                        "idle_share": (1.0 - busy_ms / wall_ms
                                       if busy_ms else None),
                        "top": rows[:8]}
        out(f"[profile] {name}: wall {wall_ms:.2f} ms, device busy "
            f"{busy_ms:.3f} ms" + "".join(
                f"\n[profile]   {ms:.3f} ms x{n} {k[:70]}"
                for k, ms, n in rows[:8]))
    sess.close()
    return result


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    if not (SRC / "repro_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: run from the root of a checkout "
                         "(src/repro_torch is missing)")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    sys.path.insert(0, str(SRC))
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (attention_flops,
                                                     attention_ref_blocked,
                                                     flash_attention_bhsd)
    from repro_torch.kernels.swiglu import (swiglu_flops, swiglu_fused,
                                            swiglu_ref_blocked)
    from repro_torch.kernels.swiglu.ops import default_tiles
    from repro_torch.models import build_model, compute_params
    from repro_torch.serve import (RECOMPILE, RESIDENT, ServeConfig,
                                   ServeEngine, percentile, reference_decode,
                                   synthetic_workload)
    from repro_torch.viscosity import HW, SW
    from repro_torch.viscosity.lanefault import KINDS, LaneFault

    dev = resolve_device("cuda")
    report = {"device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}
    out(f"device {report['device']} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # ---------------------------------------------------------- 1. build
    t0 = time.perf_counter()
    built = _build.build()
    report["build_s"] = time.perf_counter() - t0
    out(f"[build] {report['build_s']:.1f} s for {sorted(built)} "
        f"-> {_build.build_dir()}")
    for name in _build.SOURCES:
        log = (_build.build_dir() / f"{name}.log")
        if log.exists():
            for ln in log.read_text().splitlines():
                if "registers" in ln or "spill" in ln:
                    out(f"[build] {name}: {ln.strip()}")

    # --------------------------------------------------------- 2. parity
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(torch.bfloat16)

    def compare(tag, got, want, tol):
        d = (got.float() - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        rel = d / max(ref, 1e-30)
        ok = d <= tol[0] and rel <= tol[1]
        out(f"[parity] {tag}: max_abs {d:.3e} max_rel {rel:.3e} "
            f"(tol abs {tol[0]:g}, rel {tol[1]:g}) {'ok' if ok else 'FAIL'}")
        check(bool(torch.isfinite(got.float()).all()), f"{tag}: non-finite")
        check(ok, f"{tag} disagrees with its plain version")
        return d

    max_err = {"flash_attention": 0.0, "swiglu_mlp": 0.0}
    H, D = 20, 128
    for P in (128, 200):
        S = -(-P // 128) * 128          # ops pads the prompt to bq = 128
        q, k, v = (randn(1, H, S, D) for _ in range(3))
        for kind in (None,) + KINDS:
            fault = None if kind is None else LaneFault(kind, (3, 77), D)
            kw = dict(causal=True, kv_len=P, bq=128, bk=128,
                      lane_fault=fault)
            got = flash_attention_bhsd(q, k, v, **kw)
            torch.cuda.synchronize()
            want = attention_ref_blocked(q, k, v, **kw)
            max_err["flash_attention"] = max(
                max_err["flash_attention"],
                compare(f"flash_attention P={P} fault={kind}", got, want,
                        ATTN_TOL))
    cfg = get_config("qwen1.5-4b")
    Dm, Ff = cfg.d_model, cfg.d_ff
    w1, w3 = randn(Dm, Ff, scale=Dm ** -0.5), randn(Dm, Ff, scale=Dm ** -0.5)
    w2 = randn(Ff, Dm, scale=Ff ** -0.5)
    for M in (1, 4, 200):
        x = randn(M, Dm)
        bm, bf, bs = default_tiles(M, Ff)
        for kind in (None,) + KINDS:
            fault = None if kind is None else LaneFault(kind, (5, 2000), Dm)
            got = swiglu_fused(x, w1, w3, w2, lane_fault=fault)
            torch.cuda.synchronize()
            want = swiglu_ref_blocked(x, w1, w3, w2, bm=bm, bf=bf, bs=bs,
                                      lane_fault=fault)
            max_err["swiglu_mlp"] = max(
                max_err["swiglu_mlp"],
                compare(f"swiglu M={M} fault={kind}", got, want, SWIGLU_TOL))
    report["max_abs_err"] = max_err

    # ---------------------------------------------------------- 3. serve
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    params = compute_params(params, torch.bfloat16)   # f32 copy released
    torch.cuda.synchronize()
    report["init_s"] = time.perf_counter() - t0
    out(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model {Dm}, "
        f"vocab {cfg.vocab_size}; weights ready in {report['init_s']:.1f} s")
    L = cfg.num_layers
    reqs = synthetic_workload(cfg.vocab_size, 6, np.random.default_rng(0),
                              min_prompt=16, max_prompt=128, min_new=8,
                              max_new=16, arrival_every=2, per_arrival=2)
    max_len = 128 + 16
    fault_step, fault_stage = 4, "swiglu_mlp"

    flash_attention_bhsd.launches = 0
    swiglu_fused.launches = 0
    runs = {}
    for mode in (RECOMPILE, RESIDENT):
        eng = ServeEngine(cfg, params, ServeConfig(
            max_len=max_len, max_slots=4, hw_route=HW, failover=mode),
            device=dev)
        a0, s0 = flash_attention_bhsd.launches, swiglu_fused.launches
        sess = eng.session()
        for r in reqs:
            sess.submit(r)
        want_sw = 0
        t_start = time.perf_counter()
        while sess.pending():
            if sess.step_count == fault_step:
                eng.inject_fault(fault_stage)
            healthy = not eng.fault_state.is_faulty(fault_stage)
            admitted = sess.stats["admitted"]
            tick = sess.step()
            if healthy:
                want_sw += L * ((sess.stats["admitted"] - admitted)
                                + (1 if tick["active"] else 0))
        wall = time.perf_counter() - t_start
        stats = sess.close()
        done = {c.rid: c for c in sess.poll()}
        attn_n = flash_attention_bhsd.launches - a0
        sw_n = swiglu_fused.launches - s0
        out(f"[serve] {mode}: {len(done)}/{len(reqs)} done in "
            f"{stats['steps']} steps, {wall:.2f} s; recompiles "
            f"{stats['recompiles']}; launches attention {attn_n} "
            f"(want {L * len(reqs)}), swiglu {sw_n} (want {want_sw})")
        check(sorted(done) == sorted(r.rid for r in reqs),
              f"{mode}: not every request completed")
        for r in reqs:
            check(len(done[r.rid].tokens) == r.max_new_tokens,
                  f"{mode}: request {r.rid} has a short completion")
        check(stats["recompiles"] == (1 if mode == RECOMPILE else 0),
              f"{mode}: recompiles {stats['recompiles']}")
        check(attn_n == L * len(reqs), f"{mode}: attention launches {attn_n}")
        check(sw_n == want_sw and want_sw > 0,
              f"{mode}: swiglu launches {sw_n}, want {want_sw}")
        runs[mode] = {r.rid: done[r.rid].tokens.tolist() for r in reqs}
    check(runs[RECOMPILE] == runs[RESIDENT],
          "RECOMPILE and RESIDENT served different tokens")
    launches = {"flash_attention": flash_attention_bhsd.launches,
                "swiglu_mlp": swiglu_fused.launches}
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the path never launched: {launches}")
    report["launches"] = launches
    out(f"[serve] modes agree on {sum(map(len, runs[RESIDENT].values()))} "
        f"tokens; launches {launches}")

    # ------------------------------------------------------------- 4. sw
    sw_reqs = reqs[:3]
    eng = ServeEngine(cfg, params, ServeConfig(
        max_len=max_len, max_slots=4, hw_route=SW), device=dev)
    a0, s0 = flash_attention_bhsd.launches, swiglu_fused.launches
    done, _ = eng.serve(sw_reqs)
    for r in sw_reqs:
        ref = reference_decode(cfg, eng.params, r.prompt, r.max_new_tokens,
                               max_len=max_len)
        check(done[r.rid].tokens.tolist() == ref.tolist(),
              f"SW route: request {r.rid} differs from reference_decode")
    check((flash_attention_bhsd.launches, swiglu_fused.launches) == (a0, s0),
          "the SW route launched a kernel")
    out(f"[sw] {len(sw_reqs)} requests bit-identical to reference_decode")
    # the kernel route against the SW oracle at full width, on one prompt
    prompt = torch.as_tensor(np.asarray(reqs[0].prompt, np.int64),
                             device=dev)[None]
    last = {}
    for route in (HW, SW):
        m = build_model(cfg, routes={"flash_attention": route,
                                     "swiglu_mlp": route})
        logits, _ = m.prefill(params, {"tokens": prompt, "cache":
                                       m.init_cache(1, max_len, device=dev)})
        last[route] = logits[0, -1].float()
    check(last[HW].shape == (cfg.vocab_size,)
          and bool(torch.isfinite(last[HW]).all()),
          "HW prefill logits are not finite of shape (vocab,)")
    d = (last[HW] - last[SW]).abs().max().item()
    rel = d / last[SW].abs().max().item()
    out(f"[sw] HW vs SW prefill logits (P={prompt.shape[1]}): max_abs "
        f"{d:.3e} max_rel {rel:.3e} (tol rel {LOGITS_REL:g}); argmax "
        f"{int(last[HW].argmax())} vs {int(last[SW].argmax())}")
    check(rel <= LOGITS_REL, "HW route logits disagree with the SW oracle")
    report["hw_vs_sw_logits"] = {"max_abs": d, "max_rel": rel}

    # ---------------------------------------------------------- 5. times
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    report["nvidia_smi"] = smi
    kernels = []
    # attention at the serving prefill shape: P = 128, causal
    P = 128
    q, k, v = (randn(1, H, P, D) for _ in range(3))
    akw = dict(causal=True, kv_len=P, bq=128, bk=128)
    attn_bytes = 4 * q.numel() * 2
    attn_ops = attention_flops(1, P, P, H, D, causal=True)
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:33",
        "launches": launches["flash_attention"],
        "max_abs_err": max_err["flash_attention"],
        "ms": time_ms(torch, lambda: flash_attention_bhsd(q, k, v, **akw),
                      50),
        "plain_ms": time_ms(torch, lambda: attention_ref_blocked(q, k, v,
                                                                 **akw), 10),
        "bound_ms": 1e3 * max(attn_bytes / PEAK_BYTES,
                              attn_ops / PEAK_BF16_FLOPS),
        "bound_by": ("bytes" if attn_bytes / PEAK_BYTES
                     >= attn_ops / PEAK_BF16_FLOPS else "operations"),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), 50),
    })
    shapes = {}
    for M in (4, 128):
        x = randn(M, Dm)
        bm, bf, bs = default_tiles(M, Ff)
        by = (x.numel() + w1.numel() + w3.numel() + w2.numel()
              + M * Dm) * 2
        ops = swiglu_flops(M, Dm, Ff)
        shapes[M] = {
            "ms": time_ms(torch, lambda: swiglu_fused(x, w1, w3, w2), 20),
            "plain_ms": time_ms(torch, lambda: swiglu_ref_blocked(
                x, w1, w3, w2, bm=bm, bf=bf, bs=bs), 2, warmup=1),
            "library_ms": time_ms(torch, lambda: (
                F.silu(x @ w1) * (x @ w3)) @ w2, 20),
            "bound_ms": 1e3 * max(by / PEAK_BYTES, ops / PEAK_BF16_FLOPS),
            "bound_by": ("bytes" if by / PEAK_BYTES
                         >= ops / PEAK_BF16_FLOPS else "operations"),
        }
        out(f"[times] swiglu M={M}: " + " ".join(
            f"{k_}={v_:.4f}" if isinstance(v_, float) else f"{k_}={v_}"
            for k_, v_ in shapes[M].items()))
    report["swiglu_shapes"] = shapes
    kernels.append({
        "name": "swiglu_mlp", "route": "cuda",
        "source": "src/repro_torch/csrc/swiglu.cu",
        "replaces": "src/repro/kernels/swiglu/kernel.py:32",
        "launches": launches["swiglu_mlp"],
        "max_abs_err": max_err["swiglu_mlp"], **shapes[4],
    })
    # end to end: prefill at P = 128, and a healthy HW serve's ticks
    hw_model = build_model(cfg, routes={"flash_attention": HW,
                                        "swiglu_mlp": HW})
    toks = torch.randint(0, cfg.vocab_size, (1, P), generator=gen,
                         device=dev)
    cache = hw_model.init_cache(1, max_len, device=dev)
    prefill_ms = time_ms(torch, lambda: hw_model.prefill(
        params, {"tokens": toks, "cache": cache}), 5)
    eng = ServeEngine(cfg, params, ServeConfig(
        max_len=max_len, max_slots=4, hw_route=HW), device=dev)
    t0 = time.perf_counter()
    done, stats = eng.serve(reqs)
    wall = time.perf_counter() - t0
    n_tok = sum(len(c.tokens) for c in done.values())
    report["serve"] = {
        "prefill_ms_P128": prefill_ms,
        "decode_tick_ms_median": 1e3 * percentile(stats["step_times"], 0.5),
        "tokens_per_s": n_tok / wall, "tokens": n_tok, "wall_s": wall,
        "slots": 4, "requests": len(reqs)}
    report["kernels"] = kernels
    report["profile"] = profile_serving(torch, cfg, hw_model, params, toks,
                                        cache, reqs, max_len, dev)
    out(f"[times] serve: {json.dumps(report['serve'])}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    out(smi)
    out(json.dumps({"kernels": kernels}))
    out(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
