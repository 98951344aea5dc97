#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py            # from the root of a checkout

Phases (any failed check exits non-zero; nothing falls back to the CPU):

1. build   — compile the Hopper kernels from ``src/repro_torch/csrc`` with
             nvcc (all sources at once) into ``build/repro_torch/``; print
             each SwiGLU, attention, SSD and WKV kernel's registers, static
             shared memory, stack and spills from ``-Xptxas -v`` (and
             whether ptxas serialized its wgmma: C7510-C7520), and hold each
             SwiGLU ring's and each attention plan's dynamic shared memory
             (every shape this run launches) against the Python plan's, and
             each WKV and SSD launch plan (grids, group size, scratch,
             shared memory; the parity cases and every serving prompt
             length) against the compiled library's;
2. parity  — each kernel against its plain PyTorch version on the card.
             First the Fig. 4 checksum, bit for bit against the chunked
             plain ``checksum_ref``: bool, uint8, int32, int64, float16,
             bfloat16 and float32 at 0, 1, 3, 4 and 64 bytes and 8191, 8192
             and 8193 words, a view at every byte offset 1-16, a transposed
             tensor, 2^30 bytes of 0xFF (2^33 bits: checksum 0) and one
             byte more (8), 1 GiB of bf16, and the (4, 16) uint8 outputs
             that the AES canary compares: each 11- and 3-stage stage's SW
             run on its canary.  Then the others in bf16, healthy
             and under a LaneFault, at the shapes the serving paths give
             them.  The RWKV-6 WKV (against its blocked
             plain version and the token-by-token scan, o and the final
             state, healthy and under each lane-fault kind): 32 chunks of
             16 at rwkv6-1.6b's (H, K, V) = (32, 64, 64), 256 chunks
             (S = 4096, groups of 16 chunks), B = 4 with S = 512, a ragged
             S = 100 padded to 112, B = 2 with S = 200, a short S = 7 (one
             chunk of L = 7), the smoke width
             K = V = 32, a narrow V = 40, and lw = -4 on every token (the
             clamp bound, where the factorization's e^64 factors appear);
             and two calls give the same bits.
             Then the Mamba2 SSD (against its blocked plain version and
             the token-by-token scan, healthy and under each lane-fault
             kind): three chunks of
             128 at zamba2-1.2b's (H, P, N) = (64, 64, 64), 16 chunks
             (S = 2048), B = 4 with S = 384, one unpadded
             chunk of 100, B = 2 with padding (S = 200), and a narrow
             P = 40 (also under a gain of 2); two calls give the same
             bits; and on x, B and C cut as strided views from one xbc
             tensor, as ``models/mamba2.py`` passes them, it reads them in
             place and equals its run on contiguous copies bit for bit.
             Then flash attention on strided
             (B, S, H, D) views, as the model passes them, against
             ``attention_ref_blocked`` on padded contiguous copies, healthy
             and under each lane-fault kind (``ATTN_CASES``): qwen1.5-4b
             (H = 20, D = 128) at P in {16, 128, 200, 2048}, zamba2-1.2b
             (H = 32, D = 64) at P = 384, window 40 with softcap 30 (B = 2,
             GQA 8 -> 2), window 40 without a softcap at D = 64 (B = 2,
             GQA 8 -> 2; and H = 32 over P = 1000, two warpgroups), window
             300 over P = 1000, a non-causal cross call
             (Sq = 64, Skv = 192), GQA 32 -> 8 at D = 128 and a narrow
             Dv = 126 (the pad path); and its bits: two calls, the
             contiguous (B, H, S, D) copies and ``_kernel_path`` agree.
             Then SwiGLU (qwen1.5-4b 2560 -> 6912: M in {1, 4, 200};
             zamba2-1.2b 2048 -> 8192: M in {4, 384}; qwen1.5-4b with w2
             sliced to 61 lanes: M in {4, 200}; the canary stage's (64, 64)
             x (64, 128) x (128, 64)), then SwiGLU's bits: each row of an
             M = 4 row-independent call equals that row alone, and two
             runs agree, at decode and at prefill;
3. cases   — the paper's case studies on the card: FFT-64 over (2^20, 64)
             complex64 (512 MiB), the 8x8 DCT over (2^20, 8, 8) float32
             (256 MiB), AES-128 in 11 and 3 stages over 64 MiB of
             plaintext.  The healthy run equals ``run_reference`` (exactly)
             and ``fft_reference`` / ``dct_reference`` within 1e-4; with
             the reference example's faults (FFT stage 3 and DCT stage 4 at
             gain 0.25, AES stage 5 ``^ 0x40`` and a stuck-at-one
             ``| 0x40``) the canary sweep finds exactly the faulty stage
             (AES: as the canary's popcount predicts, the XOR being
             invisible when 32 of its 64 bytes have bit 6 set), the
             rerouted run and ``run_resident`` under every single-stage
             mask equal the healthy output, and the checksum kernel runs
             22 times per 11-stage AES sweep and 6 per 3-stage sweep;
4. serve   — each model at full width (random weights from a seeded
             torch.Generator).  First its canary stages on the card: every
             healthy stage passes on HW (``max|hw - sw|`` printed beside its
             tol) and each lane-fault kind fails it, and
             ``checksum_tree`` over its whole parameter dict equals the
             plain fold.  Then the port's ServeEngine on the HW route, in
             RECOMPILE and RESIDENT mode, with a ``FaultClassifier`` over a
             ``ChaosCanary``: a transient canary fault on the model's fault
             stage at step 2 goes through probation to
             ``transient_recovered`` with the HW route kept and nothing
             built; a hard one at step 4 goes to ``persistent``, with
             admissions after it: every request completes, the modes agree
             token for token, recompiles are 1 and 0, and each kernel's
             launch counter rose by exactly its launches per prefill and
             per decode tick while its stage was healthy, plus the probes'
             own canary launches (2 + 3 on the fault stage's kernel).
             qwen1.5-4b (40 layers): 6 requests of 16-128 prompt tokens,
             fault on ``swiglu_mlp``.  zamba2-1.2b (38 Mamba2 layers, the
             shared block 6 times): 6 requests of 96-384 prompt tokens, so
             prefill crosses chunk boundaries, fault on ``mamba2_ssd``.
             rwkv6-1.6b (24 RWKV-6 layers): 6 requests of 64-512 prompt
             tokens, so a prefill walks 4-32 chunks with ragged tails,
             fault on ``rwkv6_wkv``;
5. sw      — per model, three requests on the SW route, bit-identical to
             the port's single-request ``reference_decode``, and the HW
             route's prefill logits finite and within 5% of the largest
             SW logit.  rwkv6-1.6b amplifies bf16 rounding from layer to
             layer at its random init, so for it the 5% bound holds layer
             by layer (each time-mix on HW and SW from the same input),
             and end to end the HW logits must lie within 1.25 times the
             bf16 SW route's distance from the f32 SW model;
6. fleet   — qwen1.5-4b at full width in ``FleetServeEngine``: 3 logical
             devices of 4 slots (device 2 the hot spare), every pool on the
             one card, HW route, 16 requests of 16-128 prompt tokens and
             8-16 new, two arriving a step.  ``memory_allocated`` after
             building the fleet against one engine's, on f32 weights that
             each engine would cast: the fleet may add the two extra pools'
             caches and 5%, not a second copy of the weights.  Scenario A
             (a ``swiglu_mlp`` fault on device 0 at step 3, its recovery at
             step 12), in RECOMPILE and RESIDENT mode: every completion
             equals the healthy single-device HW engine's tokens, work was
             requeued and finished on the spare, the spare is back in the
             pool at close, RESIDENT builds one decode model.  Scenario B
             (the reference's "spares_exhausted"): both modes agree, and
             per device and stage the launch counters show the kernel
             launched on every healthy call and on no faulted one (device
             1 runs both stages off the kernel after steps 4 and 6; the
             spare runs them on it).  Then the admission ``Frontend`` over
             the fleet (RECOMPILE, scenario A's events): Poisson arrivals
             with deadlines, one engine step = this run's median decode
             tick; no request that did not expire is dropped; goodput,
             expired count and virtual TTFT p50/p99 printed;
7. times   — per-kernel ms (CUDA events) beside the plain version's and a
             library call's where one PyTorch call computes the same
             function (a yardstick the port never calls), the bound from
             this run's shapes (attention also at zamba2-1.2b's prefill
             shape and at qwen1.5-4b P = 2048; the checksum over 1 GiB of
             bf16 and over the 64-byte AES canary; attention, SwiGLU, the
             SSD (also on the model's strided views, where the profiler
             must see no kernel but the SSD's: no copy) and the WKV also
             the profiler's device time a call, kernel by kernel, the
             kernels a call, and the time of calls queued behind a sleep,
             beside the event time), per model the prefill ms, decode-tick
             ms and tokens/s, and a torch.profiler trace of one prefill and
             one decode tick (device time by kernel, the device's idle
             share, copy kernels; attention's device time and launches,
             which must be 40 and 6 a qwen1.5-4b and zamba2-1.2b prefill
             and 0 a tick; the SSD's and the WKV's device time, kernels
             and calls; for the models with a gated MLP, one SwiGLU
             phase-A kernel a layer in each).

8. train   — qwen1.5-4b at full width through the port's TrainRunner on
             the SW route (the kernels are forward-only, as in the
             reference), SyntheticLM batches of 4 x 128 tokens, AdamW in
             place.  T1: full depth (40 layers, 3.95 B params, remat
             "full"), 8 steps: every loss finite and the last three's mean
             below the first; median step ms after the first, tokens/s,
             ``max_memory_allocated`` against 16 bytes a param (f32 params,
             grads and moments), and the device idle share of one step
             under torch.profiler.  T2: on route hw the first step raises
             the forward-only error, at attention and (attention
             quarantined to SW) at SwiGLU.  T3 (2 layers, 0.94 B params):
             a checkpoint at step 3 (the disk's free space printed first,
             then each write's seconds and bytes), NaN in the embedding
             row of the next batch's first token trips the StepGuard,
             which restores it and continues; a SW reroute of
             ``swiglu_mlp`` builds nothing; a fresh runner restores the
             second checkpoint onto the card, equal to the live state bit
             for bit, and continues.  T4 (2 layers): FleetTrainRunner, 3
             devices with one spare: poison migrates device 1 to the
             spare; with probation a transient recovers with no
             quarantine; on HostTopology(2, 2) a host loss restores the
             fleet's checkpoint and re-folds onto the surviving host.  T5:
             the reduced config's first float32 step on the card and on
             the CPU agree (loss, grad norm, updated params) to 1e-4.  No
             kernel launches in this phase (rehearsed on the CPU by
             ``test_torch_chip_smoke.py``).

The second-to-last line is one JSON object with the per-kernel numbers
(``launches`` sums the counts of the paths, each read with the counters
set to 0 just before that path: each model's serve, probes included, the
case studies and the fleet runs); the last line is ``{"ok": true, "device": {...}}``.  Details also go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import re
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
# (B, Sq, Skv, H, Hkv, D, Dv, options): the served shapes at unpadded
# prompt lengths (qwen1.5-4b H = 20, D = 128; zamba2-1.2b H = 32, D = 64),
# the two-warpgroup plan at P = 2048, window + softcap, windows without a
# softcap at D = 64 on one and two warpgroups (rows whose first admitted
# tile is fully masked, where the exponent's scale is not 1), a window over
# ten query tiles, a non-causal cross call, GQA, and a narrow Dv
# (DEGRADED_REDUCED) that takes the pad path
ATTN_CASES = (
    (1, 16, 16, 20, 20, 128, 128, dict(causal=True)),
    (1, 128, 128, 20, 20, 128, 128, dict(causal=True)),
    (1, 200, 200, 20, 20, 128, 128, dict(causal=True)),
    (1, 384, 384, 32, 32, 64, 64, dict(causal=True)),
    (1, 2048, 2048, 20, 20, 128, 128, dict(causal=True)),
    (2, 300, 300, 8, 2, 64, 64, dict(causal=True, window=40, softcap=30.0)),
    (2, 300, 300, 8, 2, 64, 64, dict(causal=True, window=40)),
    (1, 1000, 1000, 32, 32, 64, 64, dict(causal=True, window=40)),
    (1, 1000, 1000, 16, 16, 128, 128, dict(causal=True, window=300)),
    (2, 64, 192, 8, 8, 128, 128, dict(causal=False)),
    (1, 256, 256, 32, 8, 128, 128, dict(causal=True)),
    (1, 128, 128, 20, 20, 128, 126, dict(causal=True)),
)
SWIGLU_TOL = (2e-2, 2e-2)
# The SSD kernel and its plain version compute y and the state in f32 from
# the same bf16 inputs in other summation orders; y is then rounded to bf16
# by both, so they may differ by one bf16 ulp.  The parity inputs keep
# max|y| near 1.4 (B and C ~ N(0, 0.1^2)), where one ulp is 0.008.
SSD_TOL = (2e-2, 1e-2)
# The WKV kernel and its plain version compute o and the state in f32 from
# the same bf16 inputs in other summation orders; o is then rounded to bf16
# by both, so they may differ by one bf16 ulp.  The parity inputs keep
# max|o| near 2 (r, k ~ N(0, 0.2^2), v ~ N(0, 0.5^2), u ~ N(0, 0.5^2);
# below 4 under the default 1.25 gain fault), where one ulp is 0.016.  Model-scale
# activations (|o| near 40, one ulp 0.25) are held by the HW-vs-SW logits
# check below, not by this bound.
WKV_TOL = (2e-2, 1e-2)
# (B, S, H, K, V, lw = -4 throughout): 32 chunks at rwkv6-1.6b's prefill,
# 256 chunks (groups of 16), B = 4, a ragged S padded to 112, B = 2 with
# padding, a short prompt (L = S = 7), the smoke width, a narrow V
# (DEGRADED_REDUCED), the clamp bound (e^64 factors)
WKV_CASES = ((1, 512, 32, 64, 64, False), (1, 4096, 32, 64, 64, False),
             (4, 512, 32, 64, 64, False), (1, 100, 32, 64, 64, False),
             (2, 200, 32, 64, 64, False), (1, 7, 32, 64, 64, False),
             (1, 128, 4, 32, 32, False), (1, 128, 32, 64, 40, False),
             (1, 128, 32, 64, 64, True))
# (B, S, H, P, N): three chunks at zamba2-1.2b's prefill, 16 chunks, B = 4,
# one unpadded chunk of 100, B = 2 padded to 256 (dt = 0), a narrow P
# (also under a gain of 2)
SSD_CASES = ((1, 384, 64, 64, 64), (1, 2048, 64, 64, 64),
             (4, 384, 64, 64, 64), (1, 100, 64, 64, 64),
             (2, 200, 64, 64, 64), (1, 384, 64, 40, 64))
# HW against SW logits after every bf16 layer: each route rounds its
# activations to bf16 at other points, so the logits drift apart by a few
# bf16 ulps per layer; 5% of the largest logit bounds that drift.
LOGITS_REL = 5e-2
FAULT_STEP = 4
TRANSIENT_STEP = 2


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


def bound(nbytes: int, ops: int):
    """(least ms on the card, what bounds it) for ``nbytes`` moved and
    ``ops`` bf16 operations."""
    tb, to = nbytes / PEAK_BYTES, ops / PEAK_BF16_FLOPS
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def ptxas_kernels(log: str):
    """Per kernel of an ``nvcc -Xptxas -v`` log: registers, static shared
    memory, stack, spills, and whether ptxas serialized its wgmma (the
    C7510-C7520 warnings: "wgmma.mma_async instructions are serialized").
    Template arguments are read back from the mangled name."""
    rows, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = mangled = m.group(1)
            t = (re.search(r"\d+((?:rwkv6_wkv|mamba2_ssd)_[a-z_]+?)"
                           r"(?:I((?:L[ib]\d+E)+)E)?[Ev]", name)
                 or re.search(r"\d([a-z_]+)I((?:L[ib]\d+E)+)E", name))
            if t:
                args = [a if k == "i" else ("true" if a == "1" else "false")
                        for k, a in re.findall(r"L([ib])(\d+)E",
                                               t.group(2) or "")]
                name = t.group(1) + (f"<{', '.join(args)}>" if args else "")
            cur = {"kernel": name, "mangled": mangled,
                   "serialized_wgmma": False}
            rows.append(cur)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            sm = re.search(r"(\d+) bytes smem", ln)
            cur.update(registers=int(m.group(1)),
                       static_smem=int(sm.group(1)) if sm else 0)
    for ln in log.splitlines():
        if "instructions are serialized" in ln:
            for r in rows:
                if f"'{r['mangled']}'" in ln:
                    r["serialized_wgmma"] = True
    return rows


def profile_serving(torch, cfg, hw_model, params, toks, cache, reqs,
                    max_len, dev):
    """torch.profiler over one prefill and one decode tick with 4 active
    slots: device time by kernel and the device's busy share of the traced
    wall time (the profiler's own overhead inflates the wall)."""
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
    phases = {f"prefill_P{toks.shape[1]}": lambda: hw_model.prefill(
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
                        "kernels": sum(r[2] for r in rows),
                        # SwiGLU's phase-A kernel: one a gated-MLP call
                        "swiglu_calls": sum(
                            n for k, _, n in rows
                            if re.search(r"swiglu_gemm<\d, 0,", k)),
                        "swiglu_ms": sum(ms for k, ms, _ in rows
                                         if "swiglu_" in k),
                        "attention_launches": sum(
                            n for k, _, n in rows if "flash_attn_fwd" in k),
                        "attention_ms": sum(ms for k, ms, _ in rows
                                            if "flash_attn_fwd" in k),
                        # the scans: three kernels a call, one chunk scan
                        **{f"{op}_{what}": fn_(op_key)
                           for op, op_key in (("wkv", "rwkv6_wkv_"),
                                              ("ssd", "mamba2_ssd_"))
                           for what, fn_ in (
                               ("ms", lambda key: sum(
                                   ms for k, ms, _ in rows if key in k)),
                               ("kernels", lambda key: sum(
                                   n for k, _, n in rows if key in k)),
                               ("calls", lambda key: sum(
                                   n for k, _, n in rows
                                   if key + "chunk_scan" in k)))},
                        "copy_kernels": sum(n for k, _, n in rows
                                            if "copy" in k.lower()),
                        "top": rows[:8]}
        out(f"[profile] {cfg.name} {name}: wall {wall_ms:.2f} ms, device "
            f"busy {busy_ms:.3f} ms, {result[name]['kernels']} device "
            f"events; attention {result[name]['attention_ms']:.4f} ms in "
            f"{result[name]['attention_launches']} launches; "
            + "".join(f"{op.upper()} {result[name][op + '_ms']:.4f} ms in "
                      f"{result[name][op + '_calls']} calls "
                      f"({result[name][op + '_kernels']} kernels); "
                      for op in ("wkv", "ssd") if result[name][op + "_calls"])
            + f"{result[name]['copy_kernels']} copy kernels"
            + "".join(f"\n[profile]   {ms:.3f} ms x{n} {k[:70]}"
                      for k, ms, n in rows[:8]))
    sess.close()
    return result


# The fleet phase: qwen1.5-4b, 3 logical devices (device 2 the hot spare),
# 4 slots each, all pools on the one card.  Scenario A: the spare absorbs
# a fault on device 0, which recovers at step 12: late enough that
# requests re-admitted on the spare at step 3 finish there (8 tokens or
# more take until step 10), so the spare's own tokens are checked too.
# Scenario B: the reference's "spares_exhausted"
# (tests/test_fleet_scenarios.py).
FLEET_WORKLOAD = dict(min_prompt=16, max_prompt=128, min_new=8, max_new=16,
                      arrival_every=1, per_arrival=2)
FLEET_A = {3: [("stage", 0, "swiglu_mlp")], 12: [("recover", 0)]}
FLEET_B = {2: [("stage", 0, "flash_attention")],
           4: [("stage", 1, "flash_attention")],
           6: [("stage", 1, "swiglu_mlp")]}
# Memory of the fleet beyond one engine: the two extra pools' caches, plus
# this share of them for the allocator's rounding and small buffers.
FLEET_MEM_SLACK = 0.05


def fleet_phase(cfg, dev, wrappers, *, n_requests: int = 16,
                workload=FLEET_WORKLOAD):
    """Phase 6 for one dense model: ``FleetServeEngine`` on the HW route in
    both failover modes.  Returns (report entry, kernel launches of the
    fleet runs, counted from 0).  ``wrappers`` maps each stage to its
    kernel wrapper (whose ``launches`` counts CUDA launches)."""
    import numpy as np
    import torch

    from repro_torch.models import build_model
    from repro_torch.serve import (RECOMPILE, RESIDENT, FleetConfig,
                                   FleetServeEngine, Frontend,
                                   FrontendConfig, LengthModel, Poisson,
                                   ServeConfig, ServeEngine, percentile,
                                   synthetic_workload, with_deadlines)
    from repro_torch.train.runner import model_stage_names
    from repro_torch.viscosity import HW
    from repro_torch.viscosity.lang import tree_leaves

    stages = model_stage_names(cfg)
    L = cfg.num_layers
    per_prefill = {"flash_attention": L, "swiglu_mlp": L}
    per_tick = {"flash_attention": 0, "swiglu_mlp": L}
    max_len = workload["max_prompt"] + workload["max_new"]
    reqs = synthetic_workload(cfg.vocab_size, n_requests,
                              np.random.default_rng(1), **workload)
    scfg = {m: ServeConfig(max_len=max_len, max_slots=4, hw_route=HW,
                           failover=m) for m in (RECOMPILE, RESIDENT)}
    fcfg = FleetConfig(n_devices=3, n_spares=1)
    entry = {"requests": n_requests, "slots": 4, "n_devices": 3,
             "n_spares": 1, "max_len": max_len}

    # weights once: f32 params, which each engine would cast to bf16
    params32 = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(0), device=dev)

    def allocated():
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()
    base = allocated()
    single = ServeEngine(cfg, params32, scfg[RECOMPILE], device=dev)
    single_bytes = allocated() - base
    fleets = {RECOMPILE: FleetServeEngine(cfg, params32, scfg[RECOMPILE],
                                          fcfg, device=dev)}
    fleet_bytes = allocated() - base - single_bytes
    pool_bytes = sum(t.numel() * t.element_size()
                     for t in tree_leaves(single._caches) + [single._toks])
    entry["memory"] = {"single_engine_bytes": single_bytes,
                       "fleet_bytes": fleet_bytes, "pool_bytes": pool_bytes,
                       "limit_bytes": single_bytes + 2 * pool_bytes * (
                           1 + FLEET_MEM_SLACK)}
    out(f"[fleet] {cfg.name} memory_allocated: one engine "
        f"{single_bytes / 2**30:.3f} GiB, the 3-device fleet "
        f"{fleet_bytes / 2**30:.3f} GiB (one pool's cache "
        f"{pool_bytes / 2**20:.1f} MiB; limit: one engine + 2 pools + "
        f"{FLEET_MEM_SLACK:.0%})")
    check(single_bytes > 2 * pool_bytes * (1 + FLEET_MEM_SLACK),
          "fleet: one engine holds no more than two pools (the weights' "
          "copy is missing, so the check below would be blind)")
    check(fleet_bytes - single_bytes
          <= 2 * pool_bytes * (1 + FLEET_MEM_SLACK),
          f"fleet: {fleet_bytes} bytes against one engine's "
          f"{single_bytes}: the weights are held more than once")
    check(all(w.params is fleets[RECOMPILE].params
              for w in fleets[RECOMPILE].workers),
          "fleet: a worker holds its own weights")
    params = single.params           # bf16 on the card
    del params32
    torch.cuda.empty_cache()

    # the oracle: a healthy single-device engine on the HW route
    t0 = time.perf_counter()
    ref_done, ref_stats = single.serve(reqs)
    ref_wall = time.perf_counter() - t0
    ref_tokens = {r.rid: ref_done[r.rid].tokens.tolist() for r in reqs}
    tick_s = percentile(ref_stats["step_times"], 0.5)
    n_ref = sum(map(len, ref_tokens.values()))
    entry["single_engine"] = {"wall_s": ref_wall, "tokens": n_ref,
                              "tokens_per_s": n_ref / ref_wall,
                              "decode_tick_ms_median": 1e3 * tick_s}
    out(f"[fleet] {cfg.name} single engine (oracle): {len(ref_done)} "
        f"requests, {n_ref} tokens in {ref_wall:.2f} s, median tick "
        f"{1e3 * tick_s:.2f} ms")
    for w in wrappers.values():      # the fleet runs' own counts
        w.launches = 0

    def instrument(fleet):
        """Per device and stage: kernel launches while the stage was
        healthy there (``got``) against its calls' due (``want``), launches
        while it was faulty there (``off``, must stay 0) and the calls that
        ran while it was faulty (``faulted_calls``)."""
        acct = {k: [dict.fromkeys(stages, 0) for _ in fleet.workers]
                for k in ("got", "want", "off", "faulted_calls")}
        for d, w in enumerate(fleet.workers):
            for name in ("admit", "decode_tick"):
                def wrapped(*a, _f=getattr(w, name), _d=d, _w=w,
                            _per=per_prefill if name == "admit" else per_tick,
                            **kw):
                    faulty = {s: _w.fault_state.is_faulty(s) for s in stages}
                    n0 = {s: wrappers[s].launches for s in stages}
                    res = _f(*a, **kw)
                    ran = isinstance(res, int) or res["active"] > 0
                    for s in stages:
                        n = wrappers[s].launches - n0[s]
                        if faulty[s]:
                            acct["off"][_d][s] += n
                            acct["faulted_calls"][_d][s] += int(
                                ran and _per[s] > 0)
                        else:
                            acct["got"][_d][s] += n
                            acct["want"][_d][s] += _per[s] if ran else 0
                    return res
                setattr(w, name, wrapped)
        return acct

    def run(fleet, events, label):
        """Drive ``reqs`` through a fleet session (as ``serve`` does),
        timing each step; returns (completions, stats, accounting)."""
        acct = instrument(fleet)
        ev = {k: list(v) for k, v in events.items()}
        sess = fleet.session()
        for r in reqs:
            sess.submit(r)
        steps_s = []
        t0 = time.perf_counter()
        while sess.pending():
            t1 = time.perf_counter()
            sess.step(ev.pop(sess.step_count, ()))
            steps_s.append(time.perf_counter() - t1)
        stats = sess.close(late_events=ev)
        wall = time.perf_counter() - t0
        done = {c.rid: c for c in sess.poll()}
        n_tok = sum(len(c.tokens) for c in done.values())
        row = {"wall_s": wall, "tokens": n_tok, "tokens_per_s": n_tok / wall,
               "steps": stats["steps"], "step_ms_median":
               1e3 * percentile(steps_s, 0.5),
               "per_device_tokens": stats["per_device_tokens"],
               "requeued": stats["requeued"],
               "decode_builds": stats["decode_compiles"],
               "prefill_builds": stats["prefill_compiles"],
               "quarantined": stats["quarantined"],
               "spares_in_service": stats["spares_in_service"],
               "launches_by_device": acct["got"]}
        out(f"[fleet] {cfg.name} {label}: {len(done)}/{len(reqs)} done, "
            f"{n_tok} tokens in {stats['steps']} steps, {wall:.2f} s, "
            f"{row['tokens_per_s']:.2f} tok/s, median step "
            f"{row['step_ms_median']:.2f} ms; per-device tokens "
            f"{stats['per_device_tokens']}, requeued {stats['requeued']}, "
            f"builds {stats['decode_compiles']} decode / "
            f"{stats['prefill_compiles']} prefill; launches by device "
            f"{acct['got']}, while faulty {acct['off']} over "
            f"{acct['faulted_calls']} calls")
        check(sorted(done) == sorted(r.rid for r in reqs)
              and all(len(done[r.rid].tokens) == r.max_new_tokens
                      for r in reqs),
              f"fleet {label}: a request was dropped or cut short")
        check(acct["got"] == acct["want"], f"fleet {label}: launches "
              f"{acct['got']} while healthy, want {acct['want']}")
        check(all(n == 0 for dev_ in acct["off"] for n in dev_.values()),
              f"fleet {label}: a faulted stage launched its kernel: "
              f"{acct['off']}")
        return done, row, acct

    tokens = {}
    for mode in (RECOMPILE, RESIDENT):
        fleet = fleets.get(mode) or FleetServeEngine(cfg, params, scfg[mode],
                                                     fcfg, device=dev)
        done, row, _ = run(fleet, FLEET_A, f"A {mode}")
        entry[f"A_{mode}"] = row
        check(all(done[r.rid].tokens.tolist() == ref_tokens[r.rid]
                  for r in reqs), f"fleet A {mode}: a completion differs "
              "from the healthy single-device engine's")
        check(row["requeued"] > 0 and any(c.device == 2
                                          for c in done.values()),
              f"fleet A {mode}: device 0's work was not re-admitted on the "
              "spare")
        check(row["spares_in_service"] == [] and row["quarantined"] == [],
              f"fleet A {mode}: the spare stayed in service after the "
              "recovery")
        if mode == RESIDENT:
            check(row["decode_builds"] == 1, f"fleet A {mode}: "
                  f"{row['decode_builds']} decode builds, want 1")
        tokens[("A", mode)] = {r: c.tokens.tolist() for r, c in done.items()}
        fleets.pop(mode, None)
        del fleet
        torch.cuda.empty_cache()
    for mode in (RECOMPILE, RESIDENT):
        fleet = FleetServeEngine(cfg, params, scfg[mode], fcfg, device=dev)
        done, row, acct = run(fleet, FLEET_B, f"B {mode}")
        entry[f"B_{mode}"] = row
        check(row["quarantined"] == [0] and fleet.fleet.serving() == (1, 2)
              and all(fleet.fleet.plans[1].target_for(s) == "sw"
                      for s in stages),
              f"fleet B {mode}: the spares were not exhausted as planned "
              f"({fleet.fleet})")
        check(all(acct["faulted_calls"][1][s] > 0 for s in stages),
              f"fleet B {mode}: device 1 ran no call while faulted "
              f"({acct['faulted_calls']}): the off-kernel check is blind")
        check(all(acct["got"][2][s] > 0 for s in stages),
              f"fleet B {mode}: the healthy spare launched no kernel")
        tokens[("B", mode)] = {r: c.tokens.tolist() for r, c in done.items()}
        del fleet
    check(tokens[("A", RECOMPILE)] == tokens[("A", RESIDENT)]
          and tokens[("B", RECOMPILE)] == tokens[("B", RESIDENT)],
          "fleet: RECOMPILE and RESIDENT served different tokens")

    # the admission front end over the fleet: open-loop Poisson arrivals
    # with deadlines, one engine step = this run's median decode tick
    fleet = FleetServeEngine(cfg, params, scfg[RECOMPILE], fcfg, device=dev)
    lm = LengthModel(vocab_size=cfg.vocab_size,
                     min_prompt=workload["min_prompt"],
                     max_prompt=workload["max_prompt"],
                     min_new=workload["min_new"], max_new=workload["max_new"])
    fe_reqs = with_deadlines(
        Poisson(n_requests=n_requests, rate=1.0 / tick_s, lengths=lm)
        .build(2), slack_s=12 * tick_s, slack_per_token_s=2 * tick_s)
    t0 = time.perf_counter()
    comps, fstats = Frontend(fleet, FrontendConfig(step_time_s=tick_s)).run(
        fe_reqs, events=FLEET_A)
    fe_wall = time.perf_counter() - t0
    kept = [r for r in fe_reqs if not comps[r.rid].expired]
    check(sorted(comps) == sorted(r.rid for r in fe_reqs)
          and fstats["shed"] == []
          and all(len(comps[r.rid].tokens) == r.max_new_tokens
                  for r in kept),
          "fleet front end: a request that did not expire was dropped")
    entry["frontend"] = {
        "step_time_s": tick_s, "wall_s": fe_wall, "requests": n_requests,
        "requeued": fstats["engine"]["requeued"],
        **{k: fstats[k] for k in ("completed", "deadline_met", "expired",
                                  "goodput_tokens", "goodput_tok_s",
                                  "throughput_tok_s", "p50_ttft_s",
                                  "p99_ttft_s", "p50_latency_s",
                                  "p99_latency_s", "virtual_time_s",
                                  "steps")}}
    out(f"[fleet] {cfg.name} front end (Poisson, deadlines, step "
        f"{1e3 * tick_s:.2f} ms virtual): goodput "
        f"{fstats['goodput_tok_s']:.2f} tok/s ({fstats['goodput_tokens']} "
        f"tokens), expired {fstats['expired']}, virtual TTFT p50 "
        f"{fstats['p50_ttft_s']:.3f} s p99 {fstats['p99_ttft_s']:.3f} s, "
        f"{fstats['steps']} steps in {fe_wall:.2f} s wall")
    launches = {name: w.launches for name, w in wrappers.items()}
    out(f"[fleet] {cfg.name} kernel launches of the fleet runs: {launches}")
    check(all(launches[s] > 0 for s in stages),
          f"fleet: a kernel of the path never launched: {launches}")
    entry["launches"] = launches
    return entry, launches


# The training phase (phase 8): qwen1.5-4b at full width.  T1 at full
# depth, T2-T4 with the layers cut to TRAIN_CUT_LAYERS (the embedding and
# the head, 0.78 B of its 0.94 B params, keep their size); SyntheticLM
# batches of B x S tokens; AdamW at TRAIN_LR after 2 warmup steps.
TRAIN_STEPS = 8
TRAIN_BATCH, TRAIN_SEQ = 4, 128
TRAIN_CUT_LAYERS = 2
TRAIN_LR = 1e-3
# T5: the same first step on the card and on the CPU, in float32
TRAIN_CPU_REL = 1e-4


def train_phase(cfg, dev, wrappers, *, steps: int = TRAIN_STEPS,
                cut_layers: int = TRAIN_CUT_LAYERS, workdir=None):
    """Phase 8 for one dense model: the port's TrainRunner and
    FleetTrainRunner on the SW route (the kernels are forward-only).
    Returns (report entry, kernel launches of the phase, counted from 0:
    training on SW launches none).  ``workdir`` holds the checkpoints
    (default: ``build/`` of the checkout)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from repro_torch import optim
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch.distributed import HostTopology
    from repro_torch.models import build_model
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.train import TrainConfig, TrainRunner
    from repro_torch.checkpoint.manager import _leaf_paths as leaf_paths
    from repro_torch.train.runner import (FleetTrainConfig, FleetTrainRunner,
                                          value_and_grad)
    from repro_torch.viscosity import HW, SW
    from repro_torch.viscosity.lang import tree_leaves, tree_map

    on_card = dev.type == "cuda"
    for w in wrappers.values():
        w.launches = 0
    B, S = TRAIN_BATCH, TRAIN_SEQ
    ocfg = optim.AdamWConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=100)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, batch=B,
                                  seq_len=S))
    cut = dataclasses.replace(cfg, num_layers=cut_layers)
    entry = {"batch": B, "seq": S, "steps": steps, "lr": TRAIN_LR,
             "cut_layers": cut_layers}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def finite(xs):
        return all(np.isfinite(x) for x in xs)

    def n_params(tree):
        return sum(t.numel() for t in tree_leaves(tree))

    def gib(n):
        return n / 2 ** 30

    # ------------------------------------------- T1: the full model
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        entry["held_at_start_bytes"] = held
        live = sorted(((t.numel() * t.element_size(), tuple(t.shape),
                        str(t.dtype)) for t in gc.get_objects()
                       if issubclass(type(t), torch.Tensor) and t.is_cuda),
                      reverse=True)[:5]
        out(f"[train] held on the card at the start: {gib(held):.3f} GiB; "
            f"largest live tensors {live}")
    runner = TrainRunner(cfg, ocfg, TrainConfig(steps=steps, hw_route=SW),
                         data, device=dev)
    params, opt, err = runner.init_state(0)
    N = n_params(params)
    params, opt, err = runner.run(params, opt, err)
    losses = [h["loss"] for h in runner.history]
    dts = [h["dt"] for h in runner.history]
    step_s = float(np.median(dts[1:]))
    peak = torch.cuda.max_memory_allocated() if on_card else None
    t1 = {"layers": cfg.num_layers, "params": N, "losses": losses,
          "grad_norms": [h["grad_norm"] for h in runner.history],
          "step_ms": [1e3 * d for d in dts],
          "median_step_ms": 1e3 * step_s,
          "tokens_per_s": B * S / step_s,
          "peak_bytes": peak,
          # params, grads, mu, nu in f32, then the issue's bf16 copies
          "reckoned_f32_state_bytes": 16 * N,
          "reckoned_bytes": 18 * N}
    check(finite(losses), f"train T1: a loss is not finite: {losses}")
    check(np.mean(losses[-3:]) < losses[0],
          f"train T1: the last three losses {losses[-3:]} do not fall below "
          f"the first {losses[0]}")
    # one more step under torch.profiler: the device's busy share of it
    if on_card:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn = runner.dispatcher.get(runner.plan())
        batch = data.device_batch(steps, device=dev)
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn(params, opt, err, batch)
            sync()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        t1["traced_step"] = {
            "wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms if busy else None,
            # the profiler slows the host; against an untraced step
            "idle_share_of_median_step": (1.0 - busy / t1["median_step_ms"]
                                          if busy else None),
            "device_events": sum(r[2] for r in rows), "top": rows[:10]}
        out(f"[train] T1 traced step: wall {wall_ms:.2f} ms, device busy "
            f"{busy:.2f} ms, idle share "
            + (f"{t1['traced_step']['idle_share']:.3f} (of the median "
               f"untraced step: "
               f"{t1['traced_step']['idle_share_of_median_step']:.3f})"
               if busy else "not measured (no device events)")
            + f", {t1['traced_step']['device_events']} device events"
            + "".join(f"\n[train]   {ms:.3f} ms x{n} {k[:70]}"
                      for k, ms, n in rows[:10]))
    out(f"[train] T1 {cfg.name} full width and depth ({cfg.num_layers} "
        f"layers, {N / 1e9:.3f} B params), B={B} S={S}, SW route, "
        f"{steps} steps: losses {[round(x, 4) for x in losses]}; median "
        f"step {t1['median_step_ms']:.2f} ms after the first "
        f"({t1['step_ms'][0]:.2f} ms), {t1['tokens_per_s']:.1f} tok/s; peak "
        + (f"{gib(peak):.2f} GiB" if peak is not None else "not measured")
        + f" against {gib(16 * N):.2f} GiB of f32 params, grads and moments"
        f" ({gib(18 * N):.2f} GiB with bf16 copies)")
    entry["T1"] = t1
    del runner, params, opt, err
    if on_card:
        torch.cuda.empty_cache()

    # ------------------------------------- T2: the forward-only guard
    runner = TrainRunner(cut, ocfg, TrainConfig(steps=1, hw_route=HW), data,
                         device=dev)
    state = runner.init_state(0)
    refused = {}
    for stage in ("flash_attention", "swiglu_mlp"):
        try:
            runner.run(*state, steps=1)
        except RuntimeError as e:
            refused[stage] = str(e)
        check(stage in refused and f"'{stage}'" in refused[stage]
              and "forward-only" in refused[stage],
              f"train T2: route hw did not refuse autograd at {stage}: "
              f"{refused.get(stage)}")
        runner.inject_fault(stage)          # SW from here: the next stage
    check(runner.history == [], "train T2: a step ran on route hw")
    out(f"[train] T2 route hw under autograd: {refused}")
    entry["T2"] = refused
    del runner, state

    # ------------------------- T3: recovery at full width, cut depth
    root = Path(workdir) if workdir is not None else ROOT / "build"
    root.mkdir(parents=True, exist_ok=True)
    du = shutil.disk_usage(root)
    out(f"[train] T3 disk at {root}: total {gib(du.total):.1f} GiB, free "
        f"{gib(du.free):.1f} GiB")
    tmp = tempfile.mkdtemp(dir=root, prefix="train_ckpt_")
    saves = []

    def timed(runner):
        """Record each checkpoint write (seconds, bytes) of ``runner``."""
        write = runner.ckpt._write

        def timed_write(step, host, extra):
            t0 = time.perf_counter()
            write(step, host, extra)
            d = Path(runner.ckpt.dir) / f"step_{step:08d}"
            saves.append({"step": step,
                          "write_s": time.perf_counter() - t0,
                          "bytes": sum(f.stat().st_size
                                       for f in d.iterdir())})
        runner.ckpt._write = timed_write
        return runner

    try:
        reg = obs_metrics.Registry()
        with obs_metrics.use(reg):
            tcfg = TrainConfig(steps=3, ckpt_every=3, ckpt_dir=tmp,
                               hw_route=SW)
            runner = timed(TrainRunner(cut, ocfg, tcfg, data, device=dev))
            params, opt, err = runner.run(*runner.init_state(0))  # saves 3
            # silent corruption: NaN in the embedding row of the next
            # batch's first token trips the StepGuard
            tok = int(data.batch_at(3)["tokens"][0, 0])
            params["embed"]["table"][tok, 0] = float("nan")
            params, opt, err = runner.run(params, opt, err, start_step=3,
                                          steps=2)
            check(runner.guard_trips == 1
                  and [h["step"] for h in runner.history] == [0, 1, 2, 3, 4]
                  and finite(h["loss"] for h in runner.history),
                  f"train T3: the NaN guard did not restore and continue: "
                  f"trips {runner.guard_trips}, steps "
                  f"{[h['step'] for h in runner.history]}")
            runner.inject_fault("swiglu_mlp")
            params, opt, err = runner.run(params, opt, err, start_step=5,
                                          steps=1)          # saves 6
            check(runner.dispatcher.compiles == 1,
                  f"train T3: a SW reroute built a new step "
                  f"({runner.dispatcher.compiles} builds)")
            # a fresh runner restores the card's checkpoint and continues
            fresh = TrainRunner(cut, ocfg, TrainConfig(
                steps=1, ckpt_every=100, ckpt_dir=tmp, hw_route=SW), data,
                device=dev)
            p2, o2, e2 = fresh.init_state(1)
            last = fresh.ckpt.latest_step()
            r0 = time.perf_counter()
            got = fresh.ckpt.restore(last, {"params": p2, "opt": o2})
            restore_s = time.perf_counter() - r0
            p2, o2 = got["params"], got["opt"]
            same = all(torch.equal(a, b) for a, b in zip(
                tree_leaves((params, opt)), tree_leaves((p2, o2))))
            check(last == 6 and same and all(
                t.device.type == dev.type for t in tree_leaves((p2, o2))),
                f"train T3: checkpoint {last} did not restore the live state "
                f"onto {dev}")
            del params, opt, err
            fresh.run(p2, o2, e2, start_step=last, steps=1)
            check(finite(h["loss"] for h in fresh.history),
                  "train T3: the restored run's loss is not finite")
        snap = {f["name"]: f["samples"] for f in reg.snapshot()["families"]}
        hist = {k: [(s["count"], s["sum"]) for s in snap.get(k, [])]
                for k in ("ckpt_save_seconds", "ckpt_restore_seconds")}
        t3 = {"params": n_params(p2), "saves": saves,
              "snapshot_seconds": hist["ckpt_save_seconds"],
              "guard_restore_seconds": hist["ckpt_restore_seconds"],
              "fresh_restore_s": restore_s,
              "losses": [h["loss"] for h in runner.history],
              "restored_losses": [h["loss"] for h in fresh.history],
              "guard_trips": runner.guard_trips,
              "compiles": runner.dispatcher.compiles}
        check(len(saves) == 2, f"train T3: {len(saves)} checkpoints written")
        out(f"[train] T3 {cut_layers} layers ({t3['params'] / 1e9:.3f} B "
            f"params): checkpoints "
            + ", ".join(f"step {s['step']}: {gib(s['bytes']):.2f} GiB "
                        f"written in {s['write_s']:.2f} s" for s in saves)
            + f"; snapshot to host (count, s) {hist['ckpt_save_seconds']}; "
            f"NaN guard restore (count, s) {hist['ckpt_restore_seconds']}; "
            f"fresh runner restore {restore_s:.2f} s; losses "
            f"{[round(x, 4) for x in t3['losses']]} then "
            f"{[round(x, 4) for x in t3['restored_losses']]}; builds "
            f"{t3['compiles']} after the swiglu_mlp reroute")
        entry["T3"] = t3
        del runner, fresh, p2, o2, e2, got
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if on_card:
        torch.cuda.empty_cache()

    # ------------------------------- T4: the fleet, at the same depth
    def fleet(tcfg, fcfg):
        return FleetTrainRunner(cut, ocfg, tcfg, data, fcfg, device=dev)
    t4 = {}
    r = fleet(TrainConfig(steps=4, hw_route=SW),
              FleetTrainConfig(n_devices=3, n_spares=1))
    p, o = r.run(*r.init_state(0), steps=4, poison={2: 1})
    check(r.guard_trips == 1 and 1 in r.fleet.quarantined
          and 2 in r.fleet.serving() and r.dispatcher.compiles == 1
          and finite(h["loss"] for h in r.history),
          f"train T4: poison did not migrate device 1 to the spare: "
          f"quarantined {r.fleet.quarantined}, serving {r.fleet.serving()}")
    t4["poison"] = {"losses": [h["loss"] for h in r.history],
                    "step_ms": [1e3 * h["dt"] for h in r.history],
                    "serving": list(r.fleet.serving())}
    del r, p, o
    r = fleet(TrainConfig(steps=3, hw_route=SW, probation_retries=2),
              FleetTrainConfig(n_devices=3, n_spares=1))
    p, o = r.run(*r.init_state(0), steps=3, transient={1: 0})
    kinds = [e["kind"] for e in r.fault_state.log]
    check(r.guard_trips == 1 and r.fleet.quarantined == ()
          and "transient_recovered" in kinds
          and finite(h["loss"] for h in r.history),
          f"train T4: the transient was not recovered: {kinds}")
    t4["transient"] = {"losses": [h["loss"] for h in r.history],
                       "log": kinds}
    del r, p, o
    tmp = tempfile.mkdtemp(dir=root, prefix="train_ckpt_")
    try:
        r = fleet(TrainConfig(steps=3, ckpt_every=2, ckpt_dir=tmp,
                              hw_route=SW),
                  FleetTrainConfig(n_devices=4, n_spares=1,
                                   topology=HostTopology(2, 2)))
        p, o = r.run(*r.init_state(0), steps=3, host_loss={2: 0})
        kinds = [e["kind"] for e in r.fault_state.log]
        check([h["step"] for h in r.history] == [0, 1, 2]
              and "checkpoint_restored" in kinds
              and set(r.fleet.quarantined) == {0, 1}
              and r.history[-1]["hosts_serving"] == 1
              and r.history[-1]["n_serving"] == 2
              and finite(h["loss"] for h in r.history),
              f"train T4: the host loss did not restore and re-fold: "
              f"{kinds}, quarantined {r.fleet.quarantined}")
        t4["host_loss"] = {
            "losses": [h["loss"] for h in r.history],
            "n_serving": [h["n_serving"] for h in r.history],
            "hosts_serving": [h["hosts_serving"] for h in r.history],
            "fingerprint": r.ckpt.extra(2)["fingerprint"]}
        del r, p, o
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out(f"[train] T4 fleet ({cut_layers} layers): poison at step 2 -> "
        f"serving {t4['poison']['serving']}, losses "
        f"{[round(x, 4) for x in t4['poison']['losses']]}; transient -> "
        f"{t4['transient']['log']}; host loss at step 2 -> restored, "
        f"serving {t4['host_loss']['n_serving']} devices on "
        f"{t4['host_loss']['hosts_serving']} hosts, losses "
        f"{[round(x, 4) for x in t4['host_loss']['losses']]}")
    entry["T4"] = t4
    if on_card:
        torch.cuda.empty_cache()

    # ------------------------------------- T5: the card and the CPU agree
    small = dataclasses.replace(cfg.reduced(), dtype="float32")
    small_data = SyntheticLM(DataConfig(vocab_size=small.vocab_size,
                                        batch=B, seq_len=64))
    init = build_model(small).init(0, device="cpu")
    batch = small_data.batch_at(0)
    first = {}
    model = build_model(small)              # the SW route, as a step's
    for d in (dev, torch.device("cpu")):
        p = tree_map(lambda t: t.to(d, copy=True), init)
        b = {k: torch.from_numpy(v).to(d) for k, v in batch.items()}
        (loss, _), grads = value_and_grad(model.forward, p, b)
        host = {k: t.to("cpu", copy=True)        # update consumes grads
                for k, t in leaf_paths(grads).items()}
        p, _, m = optim.update(ocfg, grads, optim.init(p), p)
        first[d.type] = (float(loss), float(m["grad_norm"]), host,
                         {k: t.cpu() for k, t in leaf_paths(p).items()})
    (l_dev, n_dev, g_dev, p_dev) = first[dev.type]
    (l_cpu, n_cpu, g_cpu, p_cpu) = first["cpu"]

    def worst(got, want, scale):
        return max(((float((got[k] - want[k]).abs().max()) / scale(k), k)
                    for k in want), key=lambda e: e[0])
    p_max = max(float(t.abs().max()) for t in p_cpu.values())
    t5 = {"loss": (l_dev, l_cpu), "grad_norm": (n_dev, n_cpu),
          "loss_rel": abs(l_dev - l_cpu) / abs(l_cpu),
          "grad_norm_rel": abs(n_dev - n_cpu) / abs(n_cpu),
          # each grad leaf against its own largest magnitude
          "grads_worst_rel": worst(g_dev, g_cpu, lambda k: max(
              float(g_cpu[k].abs().max()), 1e-30)),
          # the updated params as one vector, against its largest entry
          "params_rel": worst(p_dev, p_cpu, lambda k: p_max),
          # and leaf by leaf: Adam's first step moves each element by ~lr
          # whatever the size of its grad, so elements whose grads are at
          # rounding level may step differently
          "params_worst_leaf_rel": worst(p_dev, p_cpu, lambda k: max(
              float(p_cpu[k].abs().max()), 1e-30))}
    out(f"[train] T5 {small.name} float32, first step on {dev.type} vs "
        f"cpu: loss {l_dev:.6f} vs {l_cpu:.6f} (rel {t5['loss_rel']:.2e}), "
        f"grad_norm {n_dev:.6f} vs {n_cpu:.6f} (rel "
        f"{t5['grad_norm_rel']:.2e}), "
        f"grads worst leaf rel {t5['grads_worst_rel']}, updated params rel "
        f"{t5['params_rel']} (per leaf {t5['params_worst_leaf_rel']}); tol "
        f"{TRAIN_CPU_REL:g}")
    check(max(t5["loss_rel"], t5["grad_norm_rel"], t5["grads_worst_rel"][0],
              t5["params_rel"][0]) <= TRAIN_CPU_REL,
          "train T5: the card's first step disagrees with the CPU's")
    entry["T5"] = t5

    launches = {name: w.launches for name, w in wrappers.items()}
    check(not any(launches.values()),
          f"train: a kernel launched on the SW route: {launches}")
    entry["launches"] = launches
    return entry, launches


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

    from repro_torch.chaos import CANARY_WIDTHS, ChaosCanary, canary_fault
    from repro_torch.configs import get_config
    from repro_torch.core import (CanaryChecker, FaultState,
                                  StagedAccelerator, inject)
    from repro_torch.core import casestudies as cs
    from repro_torch.core.fault import (PERSISTENT, TRANSIENT_RECOVERED,
                                        FaultClassifier)
    from repro_torch.core.stage import Stage
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels.checksum import (checksum_popcount, checksum_ref,
                                              checksum_tree,
                                              checksum_tree_ref)
    from repro_torch.viscosity.lang import tree_leaves
    from repro_torch.kernels.flash_attention import (attention_flops,
                                                     attention_ref_blocked,
                                                     flash_attention_bhsd)
    from repro_torch.kernels.flash_attention.kernel import \
        _CALLS as attention_calls
    from repro_torch.kernels.flash_attention.kernel import \
        plan as attention_plan
    from repro_torch.kernels.flash_attention.kernel import \
        smem_bytes as attention_smem_bytes
    from repro_torch.kernels.flash_attention.ops import \
        _kernel_path as attention_kernel_path
    from repro_torch.kernels.mamba2_scan import (ssd_chunked_cuda, ssd_flops,
                                                 ssd_ref_blocked,
                                                 ssd_scan_ref)
    from repro_torch.kernels.mamba2_scan.kernel import c_plan as ssd_c_plan
    from repro_torch.kernels.mamba2_scan.kernel import plan as ssd_plan
    from repro_torch.kernels.mamba2_scan.kernel import strided_ready
    from repro_torch.kernels.rwkv6_scan import (wkv6_chunked_cuda,
                                                wkv6_flops, wkv6_ref_blocked,
                                                wkv6_scan_ref)
    from repro_torch.kernels.rwkv6_scan.kernel import c_plan as wkv_c_plan
    from repro_torch.kernels.rwkv6_scan.kernel import plan as wkv_plan
    from repro_torch.models.mamba2 import dims as mamba2_dims
    from repro_torch.kernels.swiglu import (swiglu_flops, swiglu_fused,
                                            swiglu_ref_blocked)
    from repro_torch.kernels.swiglu.kernel import ring_bytes
    from repro_torch.kernels.swiglu.kernel import \
        smem_bytes as swiglu_smem_bytes
    from repro_torch.kernels.swiglu.ops import default_tiles
    from repro_torch.models import build_model, compute_params
    from repro_torch.serve import (RECOMPILE, RESIDENT, ServeConfig,
                                   ServeEngine, percentile, reference_decode,
                                   synthetic_workload)
    from repro_torch.train.runner import canary_stages, model_stage_names
    from repro_torch.viscosity import HW, SW, lanefault
    from repro_torch.viscosity.lanefault import KINDS, LaneFault

    dev = resolve_device("cuda")
    report = {"device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}
    out(f"device {report['device']} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    wrappers = {"checksum": checksum_popcount,
                "flash_attention": flash_attention_bhsd,
                "swiglu_mlp": swiglu_fused, "mamba2_ssd": ssd_chunked_cuda,
                "rwkv6_wkv": wkv6_chunked_cuda}

    # ---------------------------------------------------------- 1. build
    t0 = time.perf_counter()
    built = _build.build()
    report["build_s"] = time.perf_counter() - t0
    out(f"[build] {report['build_s']:.1f} s for {sorted(built)} "
        f"-> {_build.build_dir()}")
    # kernel by kernel: the TMA + wgmma kernels and the scans' phases
    by_kernel = ("swiglu", "flash_attention", "mamba2_ssd", "rwkv6_wkv")
    for name in _build.SOURCES:
        log = (_build.build_dir() / f"{name}.log")
        if not log.exists() or name in by_kernel:
            continue
        for ln in log.read_text().splitlines():
            if "registers" in ln or "spill" in ln:
                out(f"[build] {name}: {ln.strip()}")
    # the wgmma kernels one by one; then their shared memory against the
    # Python plans
    for name in by_kernel:
        log = _build.build_dir() / f"{name}.log"
        report[f"{name}_ptxas"] = ptxas_kernels(log.read_text()) \
            if log.exists() else []
        for k in report[f"{name}_ptxas"]:
            out(f"[build] {name}: {k['kernel']}: {k.get('registers')} "
                f"registers, {k.get('static_smem')} B static smem, "
                f"{k.get('stack')} B stack, spills {k.get('spill_stores')}/"
                f"{k.get('spill_loads')} B"
                + (", wgmma SERIALIZED" if k["serialized_wgmma"] else ""))
    rings = {}
    for nwg, nsub in ((1, 0), (1, 1), (2, 0), (2, 1), (2, 2), (3, 0), (3, 1),
                      (3, 2)):
        rings[f"nwg={nwg} nsub={nsub}"] = got = swiglu_smem_bytes(nwg, nsub)
        check(got == ring_bytes(nwg, nsub) and got <= 232448,
              f"swiglu ring nwg={nwg} nsub={nsub}: compiled {got} B, plan "
              f"{ring_bytes(nwg, nsub)} B")
    report["swiglu_rings"] = rings
    out(f"[build] swiglu dynamic shared memory by ring (nsub 0: phase A), "
        f"as the plan computes it: {rings}")
    # attention: every plan this run launches (the parity cases below, the
    # serving prompts, the timed shapes)
    qwen, zamba = get_config("qwen1.5-4b"), get_config("zamba2-1.2b")
    qh, qd = qwen.num_heads, qwen.resolved_head_dim
    zh, zd = zamba.num_heads, zamba.resolved_head_dim
    attn_shapes = {(B_, H_, Hkv_, Sq_, Skv_, -(-D_ // 8) * 8, -(-Dv_ // 8) * 8)
                   for B_, Sq_, Skv_, H_, Hkv_, D_, Dv_, _ in ATTN_CASES}
    attn_shapes |= {(1, qh, qh, P_, P_, qd, qd) for P_ in range(16, 129)}
    attn_shapes |= {(1, zh, zh, P_, P_, zd, zd) for P_ in range(96, 385)}
    plans = {}
    for shp in sorted(attn_shapes):
        pl = attention_plan(*shp)
        got = attention_smem_bytes(pl.nwg, pl.kd, pl.vb, pl.stages)
        check(got == pl.smem and got <= 232448,
              f"flash_attention plan {shp}: compiled {got} B, plan "
              f"{pl.smem} B")
        plans[f"nwg={pl.nwg} kd={pl.kd} vb={pl.vb} stages={pl.stages}"] = got
    report["attention_smem"] = plans
    out(f"[build] flash_attention dynamic shared memory by plan, as the "
        f"plan computes it ({len(attn_shapes)} shapes): {plans}")
    # the scans: every plan this run launches (the parity cases below and
    # every serving prompt length, padded as the ops pad it) against the
    # compiled library's
    rwkv = get_config("rwkv6-1.6b")
    zh_ssd = mamba2_dims(zamba)[1]
    wkv_shapes = {(Bt_, -(-S_ // min(16, S_)) * min(16, S_), H_, min(16, S_))
                  for Bt_, S_, H_, *_ in WKV_CASES}
    wkv_shapes |= {(1, S_, rwkv.num_heads, 16) for S_ in range(16, 513, 16)}
    ssd_shapes = {(Bt_, -(-S_ // min(128, S_)) * min(128, S_), H_,
                   min(128, S_)) for Bt_, S_, H_, *_ in SSD_CASES}
    ssd_shapes |= {(1, S_, zh_ssd, S_) for S_ in range(96, 128)}
    ssd_shapes |= {(1, 128 * k, zh_ssd, 128) for k in (1, 2, 3)}
    scan_plans = {}
    for label, plan_fn, c_plan_fn, shapes in (
            ("rwkv6_wkv", wkv_plan, wkv_c_plan, wkv_shapes),
            ("mamba2_ssd", ssd_plan, ssd_c_plan, ssd_shapes)):
        for shp in sorted(shapes):
            pl, cpl = plan_fn(*shp), c_plan_fn(*shp)
            check(pl == cpl, f"{label} plan {shp}: Python {pl}, compiled "
                  f"{cpl}")
        scan_plans[label] = {str(shp): dataclasses.asdict(plan_fn(*shp))
                             for shp in sorted(shapes)
                             if shp[0] > 1 or shp[1] in (512, 4096, 384,
                                                         2048)}
        out(f"[build] {label}: {len(shapes)} launch plans equal the "
            f"compiled library's; " + "; ".join(
                f"{k}: {v}" for k, v in scan_plans[label].items()))
    report["scan_plans"] = scan_plans

    # --------------------------------------------------------- 2. parity
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

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

    max_err = {name: 0.0 for name in wrappers}

    # the Fig. 4 checksum, bit for bit against its chunked plain version
    def checksum_parity(tag, x):
        got = int(checksum_popcount(x))
        torch.cuda.synchronize()
        want = int(checksum_ref(x))
        max_err["checksum"] = max(max_err["checksum"], abs(got - want))
        check(got == want, f"checksum {tag}: {got}, plain {want}")
        return got

    def random_bytes(nbytes):
        return torch.randint(0, 256, (nbytes,), generator=gen, device=dev,
                             dtype=torch.uint8)

    n_cases = 0
    for dtype in (torch.bool, torch.uint8, torch.int32, torch.int64,
                  torch.float16, torch.bfloat16, torch.float32):
        item = torch.empty((), dtype=dtype).element_size()
        for nbytes in (0, 1, 3, 4, 64, 4 * 8191, 4 * 8192, 4 * 8193):
            raw = random_bytes(nbytes // item * item)
            x = raw > 127 if dtype == torch.bool else raw.view(dtype)
            checksum_parity(f"{dtype} {x.numel()} elements", x)
            n_cases += 1
    raw = random_bytes(100003)
    for off in range(1, 17):                 # every 16-byte misalignment
        checksum_parity(f"uint8[{off}:]", raw[off:])
    checksum_parity("uint8[1:-3]", raw[1:-3])
    m = torch.randn((777, 333), generator=gen, device=dev)
    check(not m.t().is_contiguous(), "the transposed case is contiguous")
    checksum_parity("transposed (333, 777) f32", m.t())
    ones = torch.full((1 << 30,), 255, dtype=torch.uint8, device=dev)
    wrap = (checksum_parity("2^30 bytes of 0xFF", ones),
            checksum_parity("2^30 + 1 bytes of 0xFF",
                            torch.cat([ones, ones[:1]])))
    check(wrap == (0, 8), f"checksum wrap cases gave {wrap}, want (0, 8)")
    del ones
    big = randn(1 << 29)                     # 1 GiB of bf16
    checksum_parity("1 GiB bf16", big)
    n_cases += 21
    aes_key = np.arange(16, dtype=np.uint8)
    for n_stages in (11, 3):             # what the AES canary compares
        for st in cs.aes_accelerator(aes_key, n_stages, device=dev).stages:
            y = st.run(*st.canary_inputs(0), route=SW)
            check(y.shape == (4, 16) and y.dtype == torch.uint8
                  and y.is_cuda, f"AES {st.name} canary output {y.shape}")
            checksum_parity(f"AES{n_stages} {st.name} canary output", y)
            n_cases += 1
    out(f"[parity] checksum: {n_cases} cases bit-identical to checksum_ref "
        "(7 dtypes x 8 sizes, 17 unaligned views, a transposed tensor, the "
        "wrap to 0 and to 8, 1 GiB of bf16, 14 AES canary outputs)")

    def wkv_inputs(Bt, S, H, K, V, lw_clamp=False):
        # lw in the model's clamp [-4, -1e-4] (a plain normal would leave
        # the domain, ROADMAP queue 3), or -4 on every token
        lw = (torch.full((Bt, S, H, K), -4.0, device=dev) if lw_clamp else
              torch.rand((Bt, S, H, K), generator=gen, device=dev)
              * (4.0 - 1e-4) - 4.0)
        return (randn(Bt, S, H, K, scale=0.2), randn(Bt, S, H, K, scale=0.2),
                randn(Bt, S, H, V, scale=0.5), lw.to(torch.bfloat16),
                randn(H, K, scale=0.5, dtype=torch.float32))

    # chunk L = min(16, S), S padded to a multiple of L with zero tokens as
    # the op pads
    for Bt, S, H, K, V, clamp in WKV_CASES:
        r, k, v, lw, u = wkv_inputs(Bt, S, H, K, V, clamp)
        L = min(16, S)
        pad = (L - S % L) % L
        rp, kp, vp, lwp = (F.pad(t, (0, 0, 0, 0, 0, pad))
                           for t in (r, k, v, lw))
        p_ = wkv_plan(Bt, S + pad, H, L)
        for kind in (None,) + KINDS:
            fault = None if kind is None else LaneFault(kind, (3, 17, V - 1),
                                                        V)
            tag = (f"rwkv6_wkv B={Bt} S={S} H={H} K={K} V={V}"
                   f"{' lw=-4' if clamp else ''} fault={kind} (G={p_.group}"
                   f", {p_.grids} blocks)")
            o, state = wkv6_chunked_cuda(rp, kp, vp, lwp, u, chunk=16,
                                         lane_fault=fault, with_state=True)
            torch.cuda.synchronize()
            o = o[:, :S]
            check(bool(torch.isfinite(o.float()).all()),
                  f"{tag}: non-finite o")
            want_o, want_state = wkv6_ref_blocked(rp, kp, vp, lwp, u,
                                                  chunk=16, lane_fault=fault)
            max_err["rwkv6_wkv"] = max(
                max_err["rwkv6_wkv"],
                compare(f"{tag} o", o, want_o[:, :S], WKV_TOL),
                compare(f"{tag} state", state, want_state, WKV_TOL))
            if fault is None:   # the token-by-token oracle, unpadded
                scan_o, scan_state = wkv6_scan_ref(r, k, v, lw, u)
                compare(f"{tag} o vs scan", o, scan_o, WKV_TOL)
                compare(f"{tag} state vs scan", state, scan_state, WKV_TOL)
                o2, state2 = wkv6_chunked_cuda(rp, kp, vp, lwp, u, chunk=16,
                                               with_state=True)
                same = torch.equal(o, o2[:, :S]) and torch.equal(state,
                                                                 state2)
                out(f"[parity] {tag} two calls bit-identical: {same}")
                check(same, f"{tag}: two calls differ")

    def ssd_inputs(Bt, S, H, P, N):
        # in the scan's domain: dt = softplus(.) > 0, A < 0 (zamba2's
        # A = -exp(A_log) spans -1 .. -16)
        return (randn(Bt, S, H, P),
                F.softplus(randn(Bt, S, H, dtype=torch.float32) - 1.0),
                -torch.linspace(1.0, 16.0, H, device=dev),
                randn(Bt, S, N, scale=0.1), randn(Bt, S, N, scale=0.1))

    # chunk 128 throughout; S padded to a multiple of L with dt = 0 as the
    # op pads
    for Bt, S, H, P, N in SSD_CASES:
        x, dt, A, Bm, C = ssd_inputs(Bt, S, H, P, N)
        L = min(128, S)
        pad = (L - S % L) % L
        xp = F.pad(x, (0, 0, 0, 0, 0, pad))
        dtp, Bp, Cp = (F.pad(t, (0, 0, 0, pad)) for t in (dt, Bm, C))
        p_ = ssd_plan(Bt, S + pad, H, L)
        faults = [None] + [LaneFault(kind, (3, 17, P - 1), P)
                           for kind in KINDS]
        if P < 64:
            faults.append(LaneFault("gain", (3, 17, 39), P, gain=2.0))
        for fault in faults:
            tag = (f"mamba2_ssd B={Bt} S={S} P={P} fault="
                   f"{fault and (fault.kind, fault.gain)} ({p_.grids} "
                   "blocks)")
            y, state = ssd_chunked_cuda(xp, dtp, A, Bp, Cp, chunk=128,
                                        lane_fault=fault, with_state=True)
            torch.cuda.synchronize()
            y = y[:, :S]
            check(not bool(torch.isnan(y.float()).any()), f"{tag}: NaN in y")
            want_y, want_state = ssd_ref_blocked(xp, dtp, A, Bp, Cp,
                                                 chunk=128, lane_fault=fault)
            max_err["mamba2_ssd"] = max(
                max_err["mamba2_ssd"],
                compare(f"{tag} y", y, want_y[:, :S], SSD_TOL),
                compare(f"{tag} state", state, want_state, SSD_TOL))
            if fault is None:   # the token-by-token oracle, unpadded
                scan_y, scan_state = ssd_scan_ref(x, dt, A, Bm, C)
                compare(f"{tag} y vs scan", y, scan_y, SSD_TOL)
                compare(f"{tag} state vs scan", state, scan_state, SSD_TOL)
                y2, state2 = ssd_chunked_cuda(xp, dtp, A, Bp, Cp, chunk=128,
                                              with_state=True)
                same = torch.equal(y, y2[:, :S]) and torch.equal(state,
                                                                 state2)
                out(f"[parity] {tag} two calls bit-identical: {same}")
                check(same, f"{tag}: two calls differ")

    def ssd_views(Bt, S):
        """x, B and C as ``models/mamba2.py`` passes them: views cut from
        one (B, S, d_inner + 2N) xbc tensor (row stride 4224 at
        zamba2-1.2b), with dt and A as the model makes them."""
        H, P, N = mamba2_dims(zamba)[1], zamba.ssm.head_dim, \
            zamba.ssm.state_dim
        xbc = randn(Bt, S, H * P + 2 * N)
        xbc[..., H * P:] *= 0.1        # B and C as ``ssd_inputs`` draws
        xs, Bv, Cv = torch.split(xbc, [H * P, N, N], dim=-1)
        return (xs.reshape(Bt, S, H, P),
                F.softplus(randn(Bt, S, H, dtype=torch.float32) - 1.0),
                -torch.linspace(1.0, 16.0, H, device=dev), Bv, Cv)

    # the strided views, read in place, against contiguous copies
    for Bt, S in ((1, 384), (2, 256)):
        xs, dt, A, Bv, Cv = ssd_views(Bt, S)
        check(all(strided_ready(t) for t in (xs, Bv, Cv))
              and not xs.is_contiguous(),
              f"mamba2_ssd views B={Bt} S={S}: not read in place")
        P = xs.shape[-1]
        for fault in [None] + [LaneFault(kind, (3, 17, P - 1), P)
                               for kind in KINDS]:
            tag = (f"mamba2_ssd strided views B={Bt} S={S} "
                   f"fault={fault and fault.kind}")
            got = ssd_chunked_cuda(xs, dt, A, Bv, Cv, chunk=128,
                                   lane_fault=fault, with_state=True)
            want = ssd_chunked_cuda(xs.contiguous(), dt, A, Bv.contiguous(),
                                    Cv.contiguous(), chunk=128,
                                    lane_fault=fault, with_state=True)
            torch.cuda.synchronize()
            same = all(torch.equal(g_, w_) for g_, w_ in zip(got, want))
            out(f"[parity] {tag}: bit-identical to contiguous copies: "
                f"{same}")
            check(same, f"{tag}: differs from contiguous copies")
            if fault is None:
                ref_y, ref_state = ssd_ref_blocked(
                    xs, dt, A, Bv, Cv, chunk=128)
                max_err["mamba2_ssd"] = max(
                    max_err["mamba2_ssd"],
                    compare(f"{tag} y", got[0], ref_y, SSD_TOL),
                    compare(f"{tag} state", got[1], ref_state, SSD_TOL))

    def attention_parity(B_, Sq, Skv, H, Hkv, D, Dv, kw):
        """The kernel on strided (B, S, H, D) views, as the model's
        ``_kernel_path`` passes them, against ``attention_ref_blocked`` on
        contiguous copies padded to its 128-row tiles (kv_len masks the
        padded keys), healthy and under each lane-fault kind; then its bits:
        two calls, the contiguous (B, H, S, D) copies and, for a causal
        self-attention case, ``_kernel_path`` itself all give the same."""
        q, k, v = randn(B_, Sq, H, D), randn(B_, Skv, Hkv, D), \
            randn(B_, Skv, Hkv, Dv)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        pq, pk = -(-Sq // 128) * 128, -(-Skv // 128) * 128
        qp = F.pad(qt, (0, 0, 0, pq - Sq)).contiguous()
        kp, vp = (F.pad(t, (0, 0, 0, pk - Skv)).contiguous() for t in (kt, vt))
        pl = attention_plan(B_, H, Hkv, Sq, Skv, -(-D // 8) * 8,
                            -(-Dv // 8) * 8)
        tag = (f"flash_attention B={B_} Sq={Sq} Skv={Skv} H={H} Hkv={Hkv} "
               f"D={D} Dv={Dv} {kw} (nwg={pl.nwg}, {pl.stages} stages, "
               f"{pl.grid} blocks)")
        for kind in (None,) + KINDS:
            fault = None if kind is None else LaneFault(kind, (3, Dv - 5), Dv)
            got = flash_attention_bhsd(qt, kt, vt, lane_fault=fault, **kw)
            torch.cuda.synchronize()
            want = attention_ref_blocked(qp, kp, vp, kv_len=Skv, bq=128,
                                         bk=128, lane_fault=fault, **kw)
            max_err["flash_attention"] = max(
                max_err["flash_attention"],
                compare(f"{tag} fault={kind}", got, want[:, :, :Sq],
                        ATTN_TOL))
        got = flash_attention_bhsd(qt, kt, vt, **kw)
        same = {"run to run": torch.equal(
                    got, flash_attention_bhsd(qt, kt, vt, **kw)),
                "strided = contiguous": torch.equal(got, flash_attention_bhsd(
                    qt.contiguous(), kt.contiguous(), vt.contiguous(), **kw))}
        if Sq == Skv and "window" not in kw:
            same["_kernel_path"] = torch.equal(
                got.transpose(1, 2), attention_kernel_path(q, k, v, **kw))
        out(f"[parity] {tag} bits: {same}")
        check(all(same.values()), f"{tag}: bits differ {same}")

    def swiglu_weights(Dm, Ff):
        return (randn(Dm, Ff, scale=Dm ** -0.5),
                randn(Dm, Ff, scale=Dm ** -0.5),
                randn(Ff, Dm, scale=Ff ** -0.5))

    def swiglu_parity(Dm, Ff, rows, Do=None, tag=""):
        w1, w3, w2 = swiglu_weights(Dm, Ff)
        w2 = w2[:, :Do or Dm]           # a narrow w2 is a strided view
        Do = w2.shape[1]
        for M in rows:
            x = randn(M, Dm)
            bm, bf, bs = default_tiles(M, Ff)
            for kind in (None,) + KINDS:
                fault = None if kind is None else LaneFault(
                    kind, (5, max(0, Do - 60)), Do)
                got = swiglu_fused(x, w1, w3, w2, lane_fault=fault)
                torch.cuda.synchronize()
                want = swiglu_ref_blocked(x, w1, w3, w2, bm=bm, bf=bf, bs=bs,
                                          lane_fault=fault)
                max_err["swiglu_mlp"] = max(
                    max_err["swiglu_mlp"],
                    compare(f"swiglu {Dm}->{Ff}->{Do}{tag} M={M} "
                            f"fault={kind}", got, want, SWIGLU_TOL))

    def swiglu_bits(cfg, prefill_rows):
        """Row independence: each row of an M=4 ``row_independent`` call
        equals that row run alone; and the same call twice gives the same
        bits, at decode and at prefill."""
        w1, w3, w2 = swiglu_weights(cfg.d_model, cfg.d_ff)
        x = randn(4, cfg.d_model)
        y = swiglu_fused(x, w1, w3, w2, row_independent=True)
        rows_ok = all(torch.equal(y[i:i + 1], swiglu_fused(
            x[i:i + 1], w1, w3, w2, row_independent=True)) for i in range(4))
        runs_ok = torch.equal(y, swiglu_fused(x, w1, w3, w2,
                                              row_independent=True))
        xp = randn(prefill_rows, cfg.d_model)
        runs_ok &= torch.equal(swiglu_fused(xp, w1, w3, w2),
                               swiglu_fused(xp, w1, w3, w2))
        out(f"[parity] swiglu {cfg.name}: rows of an M=4 row-independent "
            f"call equal M=1 calls bit for bit: {rows_ok}; run to run (M=4 "
            f"and M={prefill_rows}) bit for bit: {runs_ok}")
        check(rows_ok, f"swiglu {cfg.name}: a row depends on the batch")
        check(runs_ok, f"swiglu {cfg.name}: two runs gave other bits")

    for B_, Sq, Skv, H, Hkv, D, Dv, kw in ATTN_CASES:
        attention_parity(B_, Sq, Skv, H, Hkv, D, Dv, kw)
    swiglu_parity(qwen.d_model, qwen.d_ff, (1, 4, 200))
    swiglu_parity(zamba.d_model, zamba.d_ff, (4, 384))
    # a narrow w2 (61 lanes, as DEGRADED_REDUCED slices it) and the canary
    # stage's (64, 64) x (64, 128) x (128, 64)
    swiglu_parity(qwen.d_model, qwen.d_ff, (4, 200), Do=61, tag=" (narrow)")
    swiglu_parity(64, 128, (64,), tag=" (canary)")
    swiglu_bits(qwen, 200)
    swiglu_bits(zamba, 384)
    report["max_abs_err"] = max_err
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    report["nvidia_smi"] = smi
    launches = {name: {} for name in wrappers}

    # ---------------------------------------------------------- 3. cases
    def case_study(acc, x, faults, *, reference=None, expect=None):
        """One accelerator at size: the healthy run against the all-SW run
        (exactly) and ``reference`` (1e-4); per ``faults`` entry (label,
        stage index, stage -> faulty stage) the canary sweep's finding
        (``expect(label, canary of that stage)`` or exactly that stage),
        the checksum launches of the sweep, the rerouted run; then
        ``run_resident`` under every single-stage mask."""
        name, n = acc.name, len(acc.stages)
        healthy = acc.run(x)
        entry = {"input": f"{tuple(x.shape)} {x.dtype}",
                 "run_ms": time_ms(torch, lambda: acc.run(x), 3)}
        check(torch.equal(healthy, acc.run_reference(x)),
              f"{name}: the HW run differs from run_reference")
        if reference is not None:
            err = (healthy - reference(x)).abs().max().item()
            entry["max_abs_vs_reference"] = err
            check(err <= 1e-4, f"{name}: {err:.3e} from the reference")
        for label, idx, corrupt in faults:
            stages = list(acc.stages)
            stages[idx] = corrupt(stages[idx])
            broken = StagedAccelerator(name, stages)
            check(not torch.equal(broken.run(x), healthy),
                  f"{name} {label}: the fault is invisible in the output")
            state = FaultState()
            n0 = checksum_popcount.launches
            found = CanaryChecker(broken.stages).sweep(state)
            sweep = checksum_popcount.launches - n0
            want = ([stages[idx].name] if expect is None else
                    expect(label, acc.stages[idx],
                           stages[idx].canary_inputs(0)[0]))
            check(found == want, f"{name} {label}: the canary found "
                  f"{found}, want {want}")
            check(sweep == (2 * n if stages[idx].tol == 0.0 else 0),
                  f"{name} {label}: {sweep} checksum launches in a sweep")
            if found:
                check(torch.equal(broken.run(
                    x, state.signature(broken.stage_names)), healthy),
                    f"{name} {label}: the rerouted run differs")
                mask = [i != idx for i in range(n)]
                check(torch.equal(broken.run_resident(x, mask), healthy),
                      f"{name} {label}: the resident reroute differs")
            entry[label] = {"found": found, "checksum_launches": sweep}
        for i in range(n):
            check(torch.equal(acc.run_resident(
                x, [j != i for j in range(n)]), healthy),
                f"{name}: run_resident without stage {i} differs")
        out(f"[cases] {name}: {json.dumps(entry)}")
        return entry

    def gain(stage):
        return inject(stage, kind="gain", magnitude=0.25)

    def aes_fault(op):
        def corrupt(stage):
            return Stage(name=stage.name, hw=lambda s, f=stage.hw: op(f(s)),
                         sw=stage.sw, ports=stage.ports, tol=0.0, device=dev)
        return corrupt

    def popcount_rule(label, stage, canary):
        # ^ 0x40 moves the 64-byte canary's popcount by 64 - 2n, | 0x40 by
        # 64 - n (n = output bytes with bit 6 set): the checksum sees the
        # fault unless that is 0
        n = int(((stage.run(canary, route=SW) >> 6) & 1).sum())
        seen = n != 32 if label == "xor_0x40" else n < 64
        out(f"[cases] {stage.name} {label}: {n} canary bytes have bit 6 "
            f"set, so the checksum {'sees' if seen else 'cannot see'} it")
        return [stage.name] if seen else []

    for w in wrappers.values():      # the case studies' own count
        w.launches = 0
    cases = {"fft": case_study(
        cs.fft_accelerator(64, device=dev),
        torch.randn((1 << 20, 64), generator=gen, device=dev,
                    dtype=torch.complex64),
        [("gain_0.25", 3, gain)], reference=cs.fft_reference)}
    cases["dct"] = case_study(
        cs.dct_accelerator(device=dev),
        torch.randn((1 << 20, 8, 8), generator=gen, device=dev),
        [("gain_0.25", 4, gain)], reference=cs.dct_reference)
    plaintext = random_bytes(64 << 20).view(-1, 16)
    fips = torch.tensor([[0x00, 0x11, 0x22, 0x33, 0x44, 0x55, 0x66, 0x77,
                          0x88, 0x99, 0xaa, 0xbb, 0xcc, 0xdd, 0xee, 0xff]],
                        dtype=torch.uint8, device=dev)
    for n_stages, idx in ((11, 5), (3, 1)):
        aes = cs.aes_accelerator(aes_key, n_stages, device=dev)
        check(bytes(aes.run(fips)[0].tolist()).hex()
              == "69c4e0d86a7b0430d8cdb78070b4c55a",
              f"aes{n_stages}: FIPS-197 C.1 ciphertext differs")
        cases[f"aes{n_stages}"] = case_study(
            aes, plaintext,
            [("xor_0x40", idx, aes_fault(lambda o: o ^ 0x40)),
             ("or_0x40", idx, aes_fault(lambda o: o | 0x40))],
            expect=popcount_rule)
    launches["checksum"]["casestudies"] = checksum_popcount.launches
    report["casestudies"] = cases
    out(f"[cases] checksum launches in the case studies: "
        f"{checksum_popcount.launches} (22 per 11-stage AES sweep, 6 per "
        "3-stage sweep)")

    # ------------------------------------------------- 4-5. serve and sw

    def canary_phase(cfg):
        """Every healthy canary stage passes on HW; each lane-fault kind
        (armed at the canary's width) fails it."""
        stages = canary_stages(cfg, device=dev)
        chk = CanaryChecker(stages, route_hw=HW)
        margins = {}
        for st in stages:
            args = st.canary_inputs(0)
            sw = st.run(*args, route=SW)
            d = CanaryChecker.max_diff(st.run(*args, route=HW), sw)
            healthy = chk.check_stage(st)
            caught = {}
            for kind in KINDS:
                with lanefault.inject(st.name, LaneFault(
                        kind, (1,), CANARY_WIDTHS[st.name])):
                    caught[kind] = not chk.check_stage(st)
            margins[st.name] = {"max_abs_hw_sw": d, "tol": st.tol,
                                "max_abs_sw": sw.float().abs().max().item(),
                                "faults_caught": caught}
            out(f"[canary] {cfg.name} {st.name}: healthy max|hw-sw| {d:.3e} "
                f"(tol {st.tol:g}, max|sw| "
                f"{margins[st.name]['max_abs_sw']:.3f}) "
                f"{'pass' if healthy else 'FAIL'}; lane faults caught "
                f"{caught}")
            check(healthy and d <= st.tol,
                  f"{cfg.name} {st.name}: the healthy canary fails on HW")
            check(all(caught.values()),
                  f"{cfg.name} {st.name}: a lane fault passed the canary")
        return margins

    def serve_path(cfg, workload, fault_stage, per_prefill, per_tick,
                   prefill_len, logits_check=None):
        """Phases 4 and 5 for one model, then its end-to-end times (a
        prefill of ``prefill_len`` tokens, a healthy serve, the profiler);
        returns its report entry.  ``logits_check(cfg, params, params32,
        prompt, last)`` replaces the bound on HW against SW prefill logits
        for a model that amplifies bf16 rounding (see ``rwkv_logits``)."""
        entry = {"canaries": canary_phase(cfg)}
        t0 = time.perf_counter()
        model = build_model(cfg)
        params32 = model.init(torch.Generator(device=dev).manual_seed(0),
                              device=dev)
        params = compute_params(params32, torch.bfloat16)
        if logits_check is None:
            params32 = None          # the f32 copy is released
        torch.cuda.synchronize()
        entry["init_s"] = time.perf_counter() - t0
        out(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model "
            f"{cfg.d_model}, vocab {cfg.vocab_size}; weights ready in "
            f"{entry['init_s']:.1f} s")
        # checksum_tree over the parameters against the plain fold
        leaves = tree_leaves(params)
        got, want = checksum_tree(params), checksum_tree_ref(params)
        nbytes = sum(t.numel() * t.element_size() for t in leaves)
        entry["checksum_tree"] = {
            "value": got, "leaves": len(leaves), "bytes": nbytes,
            "ms": time_ms(torch, lambda: checksum_tree(params), 3)}
        out(f"[parity] checksum_tree over {cfg.name}'s {len(leaves)} "
            f"parameter leaves ({nbytes / 2**30:.2f} GiB): {got} (plain "
            f"fold {want}) in {entry['checksum_tree']['ms']:.2f} ms")
        check(got == want, f"{cfg.name}: checksum_tree disagrees with the "
              "plain fold")
        reqs = synthetic_workload(cfg.vocab_size, 6,
                                  np.random.default_rng(0), **workload)
        max_len = workload["max_prompt"] + workload["max_new"]
        stages = model_stage_names(cfg)
        for w in wrappers.values():      # counts of this path's run only
            w.launches = 0
        runs = {}
        for mode in (RECOMPILE, RESIDENT):
            canary = ChaosCanary(CanaryChecker(canary_stages(cfg, device=dev),
                                               route_hw=HW))
            eng = ServeEngine(cfg, params, ServeConfig(
                max_len=max_len, max_slots=4, hw_route=HW, failover=mode),
                device=dev, classifier=FaultClassifier(canary))
            before = {s: wrappers[s].launches for s in stages}
            want = dict.fromkeys(stages, 0)
            probe = dict.fromkeys(stages, 0)   # the canary probes' launches
            before_fault = 0
            healthy_plan = eng.plan()

            def observe(step, fails):
                """A detection on the fault stage at ``step``, its canary
                armed to fail ``fails`` probes (None: every probe)."""
                n0 = {s: wrappers[s].launches for s in stages}
                canary.arm(fault_stage, canary_fault(fault_stage),
                           fails=fails)
                transient = eng.observe_fault(fault_stage, step=step)
                canary.disarm(fault_stage)
                for s in stages:
                    probe[s] += wrappers[s].launches - n0[s]
                return transient

            sess = eng.session()
            for r in reqs:
                sess.submit(r)
            t_start = time.perf_counter()
            while sess.pending():
                if sess.step_count == TRANSIENT_STEP:
                    builds = (eng._prefill.compiles, eng._decode.compiles)
                    check(observe(TRANSIENT_STEP, 1), f"{cfg.name} {mode}: "
                          "the transient episode was not transient")
                    check(eng.fault_state.log[-1]["kind"]
                          == TRANSIENT_RECOVERED and eng.plan()
                          == healthy_plan and all(eng.health_mask()),
                          f"{cfg.name} {mode}: the transient episode left "
                          "the HW route")
                if sess.step_count == TRANSIENT_STEP + 1:
                    check((eng._prefill.compiles, eng._decode.compiles)
                          == builds, f"{cfg.name} {mode}: the transient "
                          "episode built a model")
                if sess.step_count == FAULT_STEP:
                    before_fault = wrappers[fault_stage].launches - \
                        before[fault_stage] - probe[fault_stage]
                    check(not observe(FAULT_STEP, None)
                          and eng.fault_state.log[-1]["kind"] == PERSISTENT
                          and eng.fault_state.is_faulty(fault_stage),
                          f"{cfg.name} {mode}: the hard fault was not "
                          "persistent")
                admitted = sess.stats["admitted"]
                healthy = {s: not eng.fault_state.is_faulty(s)
                           for s in stages}
                tick = sess.step()
                for s in stages:
                    if healthy[s]:
                        want[s] += per_prefill[s] * (
                            sess.stats["admitted"] - admitted) + \
                            per_tick[s] * (1 if tick["active"] else 0)
            wall = time.perf_counter() - t_start
            stats = sess.close()
            done = {c.rid: c for c in sess.poll()}
            got = {s: wrappers[s].launches - before[s] - probe[s]
                   for s in stages}
            verdicts = [e["kind"] for e in eng.fault_state.log
                        if e["kind"] in (TRANSIENT_RECOVERED, PERSISTENT)]
            out(f"[serve] {cfg.name} {mode}: {len(done)}/{len(reqs)} done "
                f"in {stats['steps']} steps, {wall:.2f} s; recompiles "
                f"{stats['recompiles']}; launches {got} (want {want}) and "
                f"{probe} by the canary probes; verdicts {verdicts}; "
                f"{fault_stage} launches before the step-{FAULT_STEP} "
                f"fault {before_fault}")
            check(probe == {s: 5 if s == fault_stage else 0 for s in stages},
                  f"{cfg.name} {mode}: probe launches {probe}, want 2 + 3 "
                  f"on {fault_stage}")
            check(sorted(done) == sorted(r.rid for r in reqs),
                  f"{cfg.name} {mode}: not every request completed")
            check(any(r.arrival >= FAULT_STEP for r in reqs),
                  f"{cfg.name}: no admission after the fault")
            for r in reqs:
                check(len(done[r.rid].tokens) == r.max_new_tokens,
                      f"{cfg.name} {mode}: request {r.rid} is short")
            check(stats["recompiles"] == (1 if mode == RECOMPILE else 0),
                  f"{cfg.name} {mode}: recompiles {stats['recompiles']}")
            check(got == want and all(n > 0 for n in got.values()),
                  f"{cfg.name} {mode}: launches {got}, want {want}")
            check(before_fault > 0, f"{cfg.name} {mode}: {fault_stage} "
                  "never launched before its fault")
            runs[mode] = {r.rid: done[r.rid].tokens.tolist() for r in reqs}
        check(runs[RECOMPILE] == runs[RESIDENT],
              f"{cfg.name}: RECOMPILE and RESIDENT served different tokens")
        for s in stages + ["checksum"]:
            launches[s][cfg.name] = wrappers[s].launches
        check(checksum_popcount.launches == 0, f"{cfg.name}: the serve "
              "launched the checksum (its stages compare with tol > 0)")
        out(f"[serve] {cfg.name}: modes agree on "
            f"{sum(map(len, runs[RESIDENT].values()))} tokens; launches "
            f"{ {s: wrappers[s].launches for s in stages} }")

        sw_reqs = reqs[:3]
        eng = ServeEngine(cfg, params, ServeConfig(
            max_len=max_len, max_slots=4, hw_route=SW), device=dev)
        before = [w.launches for w in wrappers.values()]
        done, _ = eng.serve(sw_reqs)
        for r in sw_reqs:
            ref = reference_decode(cfg, eng.params, r.prompt,
                                   r.max_new_tokens, max_len=max_len)
            check(done[r.rid].tokens.tolist() == ref.tolist(),
                  f"{cfg.name} SW route: request {r.rid} differs from "
                  "reference_decode")
        check([w.launches for w in wrappers.values()] == before,
              f"{cfg.name}: the SW route launched a kernel")
        out(f"[sw] {cfg.name}: {len(sw_reqs)} requests bit-identical to "
            "reference_decode")
        # the kernel route against the SW oracle at full width
        longest = max(reqs, key=lambda r: len(r.prompt))
        prompt = torch.as_tensor(np.asarray(longest.prompt, np.int64),
                                 device=dev)[None]
        last = {}
        for route in (HW, SW):
            m = build_model(cfg, routes={s: route for s in stages})
            logits, _ = m.prefill(params, {
                "tokens": prompt, "cache": m.init_cache(1, max_len,
                                                        device=dev)})
            last[route] = logits[0, -1].float()
            check(last[route].shape == (cfg.vocab_size,)
                  and bool(torch.isfinite(last[route]).all()),
                  f"{cfg.name} {route} prefill logits are not finite of "
                  "shape (vocab,)")
        d = (last[HW] - last[SW]).abs().max().item()
        rel = d / last[SW].abs().max().item()
        out(f"[sw] {cfg.name} HW vs SW prefill logits (P="
            f"{prompt.shape[1]}): max_abs {d:.3e} max_rel {rel:.3e} (tol "
            f"rel {LOGITS_REL:g}); argmax {int(last[HW].argmax())} vs "
            f"{int(last[SW].argmax())}")
        entry["hw_vs_sw_logits"] = {"max_abs": d, "max_rel": rel,
                                    "prompt": prompt.shape[1]}
        if logits_check is None:
            check(rel <= LOGITS_REL,
                  f"{cfg.name}: HW route logits disagree with the SW oracle")
        else:
            entry["logits_check"] = logits_check(cfg, params, params32,
                                                 prompt, last)
            params32 = None

        # end to end: prefill of the longest prompt, a healthy HW serve
        hw_model = build_model(cfg, routes={s: HW for s in stages})
        toks = torch.randint(0, cfg.vocab_size, (1, prefill_len),
                             generator=gen, device=dev)
        cache = hw_model.init_cache(1, max_len, device=dev)
        prefill_ms = time_ms(torch, lambda: hw_model.prefill(
            params, {"tokens": toks, "cache": cache}), 5)
        eng = ServeEngine(cfg, params, ServeConfig(
            max_len=max_len, max_slots=4, hw_route=HW), device=dev)
        t0 = time.perf_counter()
        done, stats = eng.serve(reqs)
        wall = time.perf_counter() - t0
        n_tok = sum(len(c.tokens) for c in done.values())
        entry["serve"] = {
            f"prefill_ms_P{toks.shape[1]}": prefill_ms,
            "decode_tick_ms_median": 1e3 * percentile(stats["step_times"],
                                                      0.5),
            "tokens_per_s": n_tok / wall, "tokens": n_tok, "wall_s": wall,
            "slots": 4, "requests": len(reqs)}
        entry["profile"] = profile_serving(torch, cfg, hw_model, params,
                                           toks, cache, reqs, max_len, dev)
        if "flash_attention" in per_prefill:
            calls = [ph["attention_launches"]
                     for ph in entry["profile"].values()]
            check(calls == [per_prefill["flash_attention"],
                            per_tick["flash_attention"]],
                  f"{cfg.name}: the profiler saw {calls} attention kernels "
                  "in a prefill and a decode tick, want "
                  f"{per_prefill['flash_attention']} and "
                  f"{per_tick['flash_attention']}")
        if "swiglu_mlp" in per_prefill:
            calls = [ph["swiglu_calls"] for ph in entry["profile"].values()]
            check(calls == [per_prefill["swiglu_mlp"],
                            per_tick["swiglu_mlp"]],
                  f"{cfg.name}: the profiler saw {calls} SwiGLU kernel "
                  "calls in a prefill and a decode tick, want "
                  f"{per_prefill['swiglu_mlp']} and "
                  f"{per_tick['swiglu_mlp']}")
        out(f"[times] {cfg.name} serve: {json.dumps(entry['serve'])}")
        return entry

    def rwkv_logits(cfg, params, params32, prompt, last):
        """rwkv6-1.6b at its random init amplifies bf16 rounding from layer
        to layer: its SW route in bf16 ends far from the same route in f32,
        so a bound on HW against SW logits would measure that amplification
        and not the kernel.  Two checks take its place: (1) layer by layer,
        teacher-forced: each layer's time-mix on the HW route and on the SW
        route, from the same input (the SW run's activations), within
        LOGITS_REL of the largest SW output; (2) end to end: the HW route's
        logits no further from the f32 SW model's than 1.25 times the bf16
        SW route's (the two bf16 routes round at the same points except the
        WKV output)."""
        from repro_torch.models import layers as Lm
        from repro_torch.models import rwkv6 as rwkv_mod
        m32 = build_model(dataclasses.replace(cfg, dtype="float32"),
                          routes={"rwkv6_wkv": SW})
        logits, _ = m32.prefill(params32, {
            "tokens": prompt, "cache": m32.init_cache(1, 1, device=dev)})
        exact = logits[0, -1].float()
        scale = exact.abs().max().item()
        err = {r: (last[r] - exact).abs().max().item() / scale
               for r in (HW, SW)}
        x = Lm.embed(params["embed"], prompt)
        worst = 0.0
        for i in range(cfg.num_layers):
            p = {k: {n: t[i] for n, t in sub.items()}
                 for k, sub in params["layers"].items()}
            h = Lm.norm(p["ln1"], x, eps=cfg.norm_eps)
            tm = {r: rwkv_mod.time_mix(p["tm"], h, cfg, route=r).float()
                  for r in (HW, SW)}
            worst = max(worst, (tm[HW] - tm[SW]).abs().max().item()
                        / tm[SW].abs().max().item())
            x = x + tm[SW].to(x.dtype)
            x = x + rwkv_mod.channel_mix(
                p["tm"], Lm.norm(p["ln2"], x, eps=cfg.norm_eps))
        out(f"[sw] {cfg.name} prefill logits against the f32 SW model: HW "
            f"max_rel {err[HW]:.3e}, bf16 SW max_rel {err[SW]:.3e} (HW "
            f"must be within 1.25x of SW); per-layer time-mix HW vs SW "
            f"from the same input: worst max_rel {worst:.3e} (tol "
            f"{LOGITS_REL:g})")
        check(err[HW] <= 1.25 * err[SW], f"{cfg.name}: the HW route's "
              "logits are further from the f32 model than bf16 rounding")
        check(worst <= LOGITS_REL, f"{cfg.name}: a layer's HW time-mix "
              "disagrees with the SW oracle")
        return {"hw_vs_f32_rel": err[HW], "sw_vs_f32_rel": err[SW],
                "layer_time_mix_worst_rel": worst}

    Lq, G = qwen.num_layers, zamba.num_layers // zamba.shared_attn_every
    report["qwen1.5-4b"] = serve_path(
        qwen, dict(min_prompt=16, max_prompt=128, min_new=8, max_new=16,
                   arrival_every=2, per_arrival=2), "swiglu_mlp",
        per_prefill={"flash_attention": Lq, "swiglu_mlp": Lq},
        per_tick={"flash_attention": 0, "swiglu_mlp": Lq}, prefill_len=128)
    torch.cuda.empty_cache()
    report["zamba2-1.2b"] = serve_path(
        zamba, dict(min_prompt=96, max_prompt=384, min_new=8, max_new=16,
                    arrival_every=3, per_arrival=2), "mamba2_ssd",
        per_prefill={"flash_attention": G, "swiglu_mlp": G,
                     "mamba2_ssd": zamba.num_layers},
        per_tick={"flash_attention": 0, "swiglu_mlp": G, "mamba2_ssd": 0},
        prefill_len=384)
    torch.cuda.empty_cache()
    report["rwkv6-1.6b"] = serve_path(
        rwkv, dict(min_prompt=64, max_prompt=512, min_new=8, max_new=16,
                   arrival_every=2, per_arrival=2), "rwkv6_wkv",
        per_prefill={"rwkv6_wkv": rwkv.num_layers},
        per_tick={"rwkv6_wkv": 0}, prefill_len=512,
        logits_check=rwkv_logits)
    check(all(sum(n.values()) > 0 for n in launches.values()),
          f"a kernel of the paths never launched: {launches}")
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 6. fleet
    report["fleet"], fleet_launches = fleet_phase(qwen, dev, wrappers)
    for name, n in fleet_launches.items():
        launches[name]["fleet"] = n
    check(launches["checksum"]["fleet"] == 0, "the fleet launched the "
          "checksum (its stages compare with tol > 0)")
    report["launches"] = launches

    # ---------------------------------------------------------- 7. times
    def kernel_entry(name, source, replaces, shape, **numbers):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(launches[name].values()),
                "launches_by_path": launches[name],
                "max_abs_err": max_err[name], "shape": shape, **numbers}

    def device_ms(fn, prefix, reps=10):
        """Device time a call: each kernel's mean duration over the
        launches torch.profiler recorded in ``reps`` calls (it has dropped
        some), summed over the call's kernels, every one of which must
        carry ``prefix``; and the CUDA-event time a call with the calls
        queued behind a 5e6-cycle ``torch.cuda._sleep`` (the host has
        enqueued them all before the device reaches the start event, so
        that time holds the kernels and the gaps between them, not the
        host's enqueue)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        for _ in range(3):   # a trace of short calls can come back empty
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            by = {e.key.replace("void (anonymous namespace)::", "")
                  .replace("(anonymous namespace)::", "")
                  .split("(")[0]: e.self_device_time_total / 1e3 / e.count
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0}
            if by:
                break
        check(all(prefix in k for k in by),
              f"{prefix}: the profiler saw other kernels: {sorted(by)}")
        if not by:
            out(f"[times] {prefix}: the profiler recorded no device events "
                "(device time not measured)")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(5_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return {"device_ms": sum(by.values()) if by else None,
                "queued_ms": start.elapsed_time(end) / reps}, by

    kernels = []
    # attention at the prefill shapes, causal: qwen1.5-4b P = 128 (the
    # kernels line), zamba2-1.2b's shared block at P = 384, and qwen1.5-4b
    # at P = 2048, where the operations bound it.  The kernel reads (B, S,
    # H, D) views, as the model gives them; scaled_dot_product_attention
    # and the plain version get contiguous (B, H, S, D) tensors.
    attn = {}
    for cfg, P in ((qwen, 128), (zamba, 384), (qwen, 2048)):
        H, D = cfg.num_heads, cfg.resolved_head_dim
        qs_, ks_, vs_ = (randn(1, P, H, D).transpose(1, 2) for _ in range(3))
        q, k, v = (t.contiguous() for t in (qs_, ks_, vs_))
        pad = -(-P // 128) * 128 - P
        qp, kp, vp = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        akw = dict(causal=True, kv_len=P, bq=128, bk=128)
        ms, by = bound(4 * q.numel() * 2, attention_flops(1, P, P, H, D,
                                                          causal=True))
        key = f"B=1 H={H} P={P} D={D} causal"
        attn[key] = {
            "ms": time_ms(torch, lambda: flash_attention_bhsd(
                qs_, ks_, vs_, causal=True), 50),
            "plain_ms": time_ms(torch, lambda: attention_ref_blocked(
                qp, kp, vp, **akw), 10),
            "bound_ms": ms, "bound_by": by,
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True), 50)}
        attn[key].update(device_ms(lambda: flash_attention_bhsd(
            qs_, ks_, vs_, causal=True), "flash_attn_fwd")[0])
        if P <= 384:
            # the wrapper's host time without its per-signature cache: every
            # call takes the checked path (the cache emptied before each)
            attn[key]["checked_ms"] = time_ms(torch, lambda: (
                attention_calls.clear(),
                flash_attention_bhsd(qs_, ks_, vs_, causal=True)), 50)
        attn[key]["share_of_bound"] = ms / attn[key]["ms"]
        if attn[key]["device_ms"]:
            attn[key]["share_of_bound_device"] = ms / attn[key]["device_ms"]
        out(f"[times] attention {cfg.name} {key}: " + " ".join(
            f"{k_}={v_:.4f}" if isinstance(v_, float) else f"{k_}={v_}"
            for k_, v_ in attn[key].items()))
    report["attention_shapes"] = attn
    kernels.append(kernel_entry(
        "flash_attention", "src/repro_torch/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:33",
        "B=1 H=20 P=128 D=128 causal", **attn["B=1 H=20 P=128 D=128 causal"]))

    shapes, swiglu_kernels = {}, {}
    for cfg, M in ((qwen, 4), (qwen, 128), (zamba, 4), (zamba, 384)):
        Dm, Ff = cfg.d_model, cfg.d_ff
        w1, w3, w2 = swiglu_weights(Dm, Ff)
        x = randn(M, Dm)
        bm, bf, bs = default_tiles(M, Ff)
        ms, by = bound((x.numel() + w1.numel() + w3.numel() + w2.numel()
                        + M * Dm) * 2, swiglu_flops(M, Dm, Ff))
        key = f"{cfg.name} M={M}"
        shapes[key] = {
            "ms": time_ms(torch, lambda: swiglu_fused(x, w1, w3, w2), 20),
            "plain_ms": time_ms(torch, lambda: swiglu_ref_blocked(
                x, w1, w3, w2, bm=bm, bf=bf, bs=bs), 2, warmup=1),
            "library_ms": time_ms(torch, lambda: (
                F.silu(x @ w1) * (x @ w3)) @ w2, 20),
            "bound_ms": ms, "bound_by": by}
        # the kernels' own device time a call (torch.profiler), beside the
        # event time above, which also holds the wrapper's host time
        device_times, names = device_ms(
            lambda: swiglu_fused(x, w1, w3, w2), "swiglu_")
        shapes[key].update(device_times)
        shapes[key]["share_of_bound"] = shapes[key]["bound_ms"] / \
            shapes[key]["ms"]
        swiglu_kernels[key] = names
        out(f"[times] swiglu {key}: " + " ".join(
            f"{k_}={v_:.4f}" if isinstance(v_, float) else f"{k_}={v_}"
            for k_, v_ in shapes[key].items()) + "; device ms by kernel "
            + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in names.items()))
    report["swiglu_shapes"] = shapes
    report["swiglu_device_kernels"] = swiglu_kernels
    kernels.append(kernel_entry(
        "swiglu_mlp", "src/repro_torch/csrc/swiglu.cu",
        "src/repro/kernels/swiglu/kernel.py:32",
        "qwen1.5-4b decode M=4 2560->6912->2560", **shapes["qwen1.5-4b M=4"]))
    # the SSD at zamba2-1.2b's prefill shape, with the final state (as the
    # prefill calls it): B=1 S=384 H=64 P=N=64, chunk 128; on contiguous
    # tensors, and on the model's strided views of one xbc tensor, where the
    # profiler must see the SSD's kernels only (the wrapper copies nothing)
    H, Pd, N, S = mamba2_dims(zamba)[1], zamba.ssm.head_dim, \
        zamba.ssm.state_dim, 384
    x, dt, A, Bm, C = ssd_inputs(1, S, H, Pd, N)
    ssd_bytes = (x.numel() * 2 * 2 + dt.numel() * 4 + A.numel() * 4
                 + 2 * Bm.numel() * 2 + H * N * Pd * 4)
    ms, by = bound(ssd_bytes, ssd_flops(1, S, H, Pd, N, chunk=128))

    def scan_row(fn, plain_fn, prefix, views_fn=None):
        row = {"ms": time_ms(torch, fn, 50),
               "plain_ms": time_ms(torch, plain_fn, 10),
               "bound_ms": ms, "bound_by": by, "library_ms": None}
        device_times, names = device_ms(fn, prefix)
        row.update(device_times)
        row["kernels_per_call"] = len(names)
        row["device_ms_by_kernel"] = names
        row["share_of_bound"] = ms / row["ms"]
        if row["device_ms"]:
            row["share_of_bound_device"] = ms / row["device_ms"]
        if views_fn is not None:
            row["views_ms"] = time_ms(torch, views_fn, 50)
            view_times, view_names = device_ms(views_fn, prefix)
            row["views_device_ms"] = view_times["device_ms"]
            row["views_queued_ms"] = view_times["queued_ms"]
            row["views_kernels_per_call"] = len(view_names)
        out(f"[times] {prefix}: " + " ".join(
            f"{k_}={v_:.5f}" if isinstance(v_, float) else f"{k_}={v_}"
            for k_, v_ in row.items() if k_ != "device_ms_by_kernel")
            + "; device ms by kernel " + ", ".join(
                f"{k_} {v_:.4f}" for k_, v_ in names.items()))
        check(row["kernels_per_call"] == 3,
              f"{prefix}: {len(names)} kernels a call, want 3: {names}")
        return row

    xs, dtv, Av, Bv, Cv = ssd_views(1, S)
    ssd_row = scan_row(
        lambda: ssd_chunked_cuda(x, dt, A, Bm, C, chunk=128,
                                 with_state=True),
        lambda: ssd_ref_blocked(x, dt, A, Bm, C, chunk=128), "mamba2_ssd",
        views_fn=lambda: ssd_chunked_cuda(xs, dtv, Av, Bv, Cv, chunk=128,
                                          with_state=True))
    report["mamba2_ssd_times"] = ssd_row
    kernels.append(kernel_entry(
        "mamba2_ssd", "src/repro_torch/csrc/mamba2_ssd.cu",
        "src/repro/kernels/mamba2_scan/kernel.py:28",
        f"B=1 S={S} H={H} P={Pd} N={N} chunk=128, final state",
        **{k_: ssd_row[k_] for k_ in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}))
    # the WKV at rwkv6-1.6b's prefill shape, with the final state (as the
    # prefill calls it): B=1 S=512 H=32 K=V=64, chunk 16
    H, K, S = rwkv.num_heads, rwkv.ssm.rwkv_head_dim, 512
    r, k, v, lw, u = wkv_inputs(1, S, H, K, K)
    wkv_bytes = (4 * r.numel() * 2 + u.numel() * 4 + r.numel() * 2
                 + H * K * K * 4)
    ms, by = bound(wkv_bytes, wkv6_flops(1, S, H, K, K, chunk=16))
    wkv_row = scan_row(
        lambda: wkv6_chunked_cuda(r, k, v, lw, u, chunk=16, with_state=True),
        lambda: wkv6_ref_blocked(r, k, v, lw, u, chunk=16), "rwkv6_wkv")
    report["rwkv6_wkv_times"] = wkv_row
    kernels.append(kernel_entry(
        "rwkv6_wkv", "src/repro_torch/csrc/rwkv6_wkv.cu",
        "src/repro/kernels/rwkv6_scan/kernel.py:27",
        f"B=1 S={S} H={H} K=V={K} chunk=16, final state",
        **{k_: wkv_row[k_] for k_ in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}))
    # the checksum over 1 GiB of bf16 and over the 64-byte AES canary
    canary = cs.aes_accelerator(aes_key, 11, device=dev).stages[5] \
        .canary_inputs(0)[0]
    checksum_parity("AES canary (4, 16) uint8", canary)
    ck = {}
    for label, x, reps in (("1 GiB bf16", big, 20),
                           ("AES canary (4, 16) uint8", canary, 200)):
        nbytes = x.numel() * x.element_size()
        ms, by = bound(nbytes, 0)
        ck[label] = {"ms": time_ms(torch, lambda: checksum_popcount(x), reps),
                     "plain_ms": time_ms(torch, lambda: checksum_ref(x),
                                         max(2, reps // 10), warmup=1),
                     "bound_ms": ms, "bound_by": by, "library_ms": None,
                     "bytes": nbytes}
        out(f"[times] checksum {label}: " + " ".join(
            f"{k_}={v_:.6f}" if isinstance(v_, float) else f"{k_}={v_}"
            for k_, v_ in ck[label].items()))
    report["checksum_shapes"] = ck
    del big
    kernels.insert(0, kernel_entry(
        "checksum", "src/repro_torch/csrc/checksum.cu",
        "src/repro/kernels/checksum/kernel.py:17", "1 GiB bf16",
        **{k_: v_ for k_, v_ in ck["1 GiB bf16"].items() if k_ != "bytes"}))
    report["kernels"] = kernels

    # ---------------------------------------------------------- 8. train
    gc.collect()          # closures of the serve paths hold their weights
    torch.cuda.empty_cache()
    report["train"], train_launches = train_phase(qwen, dev, wrappers)
    for name, n in train_launches.items():
        launches[name]["train"] = n      # 0: training runs the SW route
    report["train"]["nvidia_smi"] = smi
    for kn in kernels:
        out(f"[times] {kn['name']} {kn['shape']}: ms {kn['ms']:.4f} plain "
            f"{kn['plain_ms']:.4f} bound {kn['bound_ms']:.5f} "
            f"({kn['bound_by']}) library {kn['library_ms']}")
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
