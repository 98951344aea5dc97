#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, multi-process fleet, chaos,
model-zoo, encoder-decoder, tuning and tensor-parallel paths, its examples
and its dry run on one NVIDIA GPU and check them.

    python3 chip_smoke.py               # from the root of a checkout
    python3 chip_smoke.py --four-cards  # phase 17 alone, on four cards

Phases (any failed check exits non-zero; nothing falls back to the CPU):

1. build   — compile the Hopper kernels from ``src/repro_torch/csrc`` with
             nvcc (all sources at once) into ``build/repro_torch/``; print
             each SwiGLU, attention, SSD and WKV kernel's registers, static
             shared memory, stack and spills from ``-Xptxas -v`` (and
             whether ptxas serialized its wgmma: C7510-C7520; attention's
             head-dim-256 instantiation ``flash_attn_fwd<1, 4, 4, *>``
             among them), and hold each
             SwiGLU ring's and each attention plan's dynamic shared memory
             (every shape this run launches, phase 11's SwiGLU for M =
             1-128, its ring and image prefills and its attention prompts
             included) against the Python plan's, and
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
             K = V = 32, a narrow V = 40, lw = -4 on every token (the
             clamp bound, where the factorization's e^64 factors appear),
             and phase 15's rank (8 of the 32 heads) at S = 512 and 77;
             and two calls give the same bits.
             Then the Mamba2 SSD (against its blocked plain version and
             the token-by-token scan, healthy and under each lane-fault
             kind): three chunks of
             128 at zamba2-1.2b's (H, P, N) = (64, 64, 64), 16 chunks
             (S = 2048), B = 4 with S = 384, one unpadded
             chunk of 100, B = 2 with padding (S = 200), a narrow
             P = 40 (also under a gain of 2), and phase 15's rank (16 of
             the 64 heads) at S = 384 and at one chunk of 16 and of 77;
             two calls give the same bits; and on x, B and C cut as
             strided views from one xbc tensor, as ``models/mamba2.py``
             passes them, and on a rank's x (a view of its 1056-wide conv
             output) with the gathered B and C, it reads them in place and
             equals its run on contiguous copies bit for bit.
             Then flash attention on strided
             (B, S, H, D) views, as the model passes them, against
             ``attention_ref_blocked`` on padded contiguous copies, healthy
             and under each lane-fault kind (``ATTN_CASES``): qwen1.5-4b
             (H = 20, D = 128) at P in {16, 128, 200, 2048}, zamba2-1.2b
             (H = 32, D = 64) at P = 384, window 40 with softcap 30 (B = 2,
             GQA 8 -> 2), window 40 without a softcap at D = 64 (B = 2,
             GQA 8 -> 2; and H = 32 over P = 1000, two warpgroups), window
             300 over P = 1000, a non-causal cross call
             (Sq = 64, Skv = 192), GQA 32 -> 8 at D = 128, a narrow
             Dv = 126 (the pad path), and phase 11's prefills (GQA
             32 -> 8 at P = 16 and 128, the same under a 4096 window at
             P = 128 and over mixtral-8x7b's 4200-token ring prompt, GQA
             40 -> 8 at P = 16 and 128; gemma2-2b's head dim 256 with
             GQA 8 -> 4 and the softcap 50 under its 4096 window at
             P = 128 and a ragged 200, and over the 4200-token ring prompt
             with and without the window; gemma3-1b's GQA 4 -> 1 at head
             dim 256, its 512 window at P = 128 and over the ring prompt,
             and a global layer over it; whisper-base's B = 4, 8 heads of
             64: the bidirectional encoder over 1500 frames, the
             decoder's causal 4-token prompt, cross-attention of Sq = 4
             and of Sq = 1 over 1500 keys; qwen2-vl-7b's GQA 28 -> 4 at
             P = 128 and at its image prefill's 288; phase 14's
             serve_with_faults, the reduced qwen1.5-4b's 4 heads of 32 at
             each of its workload's prompt lengths and the shortest it may
             draw, 6; phase 15's tensor-parallel ranks, qwen1.5-4b's 5 of 20
             heads at P = 16, 77 and 128 and zamba2-1.2b's 8 of 32 at
             P = 16, 128 and 384, then whisper-base's 2 of 8 heads of 64
             (B = 4: the encoder over 1500 frames, the 4-token prompt,
             cross-attention of Sq = 4 and 1 over 1500 keys) and
             gemma3-1b's 1 of 4 query heads over its one kv head at head
             dim 256 (window 512 at P = 128 and 600, global at P = 600),
             then zamba2-1.2b's 16 of 32 under ``attn2d`` at P = 16, 128
             and 384); and its bits: two
             calls, the contiguous (B, H, S, D) copies and
             ``_kernel_path`` agree.
             Then SwiGLU (qwen1.5-4b 2560 -> 6912: M in {1, 4, 200}; its
             tensor-parallel rank's 2560 -> 1728 -> 2560 partial sum
             (phase 15): M in {1, 4, 128};
             zamba2-1.2b 2048 -> 8192: M in {4, 384}, and its rank's
             2048 -> 2048 -> 2048: M in {4, 384}; qwen1.5-4b with w2
             sliced to 61 lanes: M in {4, 200}; the canary stage's (64, 64)
             x (64, 128) x (128, 64), which is lane_fault_smoke's, and its
             w2 sliced to 62 lanes, as that example's reduced-width run
             slices it; serve_with_faults' 128 -> 256: M in {1, 2, 3} and
             its prompt lengths; mistral-nemo-12b 5120 -> 14336: M in
             {4, 16, 128}; gemma2-2b's GeGLU, the kernel's tanh-gelu,
             2304 -> 9216, and gemma3-1b's GeGLU 1152 -> 6912: M in {4,
             128, 4200}, the last their ring prefill's; qwen2-vl-7b's
             SwiGLU 3584 -> 18944: M in {4, 128, 288}, the last its image
             prefill's; phase 15's gemma3-1b rank, GeGLU 1152 -> 1728 ->
             1152: M in {4, 600}), then SwiGLU's bits (qwen1.5-4b,
             zamba2-1.2b, the three ranks, mistral-nemo-12b, gemma3-1b,
             qwen2-vl-7b,
             serve_with_faults' reduced qwen1.5-4b): each row of an
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
             22 times per 11-stage AES sweep and 6 per 3-stage sweep.  The
             paper's latency model (``core/latency.py``) prints its healthy
             and one-fault ``speedup_vs_sw`` beside each case study's HW,
             all-SW and rerouted run times on the card (information only:
             here a stage's HW and SW paths run the same code);
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
             qwen1.5-4b (20 of its 40 layers, ``SERVE_LAYERS``; phase 9
             serves all 40): 6 requests of 16-128 prompt tokens,
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
6. fleet   — qwen1.5-4b at full width and 20 of its 40 layers
             (``FLEET_LAYERS``) in ``FleetServeEngine``: 3 logical
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
             bf16 and over the 64-byte AES canary; attention also at
             mistral-nemo-12b's and llama4-scout's P = 128 and mixtral-8x7b's
             P = 4200 under its window, gemma2-2b's head dim 256 with its
             softcap at P = 128 and 4200, windowed and global (the library
             call: sdpa without the softcap, which no PyTorch call
             applies), gemma3-1b's at P = 128 and 4200, windowed and
             global, qwen2-vl-7b's at P = 128 and 288, whisper-base's
             encoder and its cross-attention at Sq = 4 and Sq = 1;
             SwiGLU at mistral-nemo-12b's, gemma2-2b's, gemma3-1b's and
             qwen2-vl-7b's M = 4 and 128, gemma3-1b's ring prefill M =
             4200 and qwen2-vl-7b's image prefill M = 288; attention,
             SwiGLU, the
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
             quarantined to SW) at SwiGLU.  T3 (1 layer, 0.86 B params):
             a checkpoint at step 3 (the disk's free space printed first,
             then each write's seconds and bytes), NaN in the embedding
             row of the next batch's first token trips the StepGuard,
             which restores it and continues; a SW reroute of
             ``swiglu_mlp`` builds nothing; a fresh runner restores the
             second checkpoint onto the card, equal to the live state bit
             for bit, and continues.  T4 (1 layer): FleetTrainRunner, 3
             devices with one spare: poison migrates device 1 to the
             spare; with probation a transient recovers with no
             quarantine; on HostTopology(2, 2) a host loss restores the
             fleet's checkpoint and re-folds onto the surviving host.  T5:
             the reduced config's first float32 step on the card and on
             the CPU agree (loss, grad norm, updated params) to 1e-4.  No
             kernel launches in this phase (rehearsed on the CPU by
             ``test_torch_chip_smoke.py``).
9. multihost — the reference's two-process fleet test on the card:
             qwen1.5-4b at full width and depth in ``FleetServeEngine``, 4
             logical devices of 2 slots (device 3 the hot spare), 6
             requests of 16-128 prompt tokens and 8-16 new, HW route.
             First this process serves them with both hosts' devices local
             (``HostTopology(2, 2)``), a device fault on device 0 at step
             3.  Then two worker processes (``multihost_worker``, started
             after every kernel is built) join one process group through
             ``initialize_runtime`` with backend gloo, printed: both ranks
             share the one card, which NCCL refuses.  Each builds the same
             seeded weights, checksums them on the card (the Fig. 4 kernel)
             and exchanges the sum through ``KVCoordinator`` over the
             group's TCPStore, then serves its half (host 0: devices 0-1;
             host 1: device 2 and the spare), shadowing the other half;
             only rank 0 sees the fault.  Checks: equal checksums, one
             fingerprint, device 0 quarantined onto spare 3, work requeued
             and decoded on device 3, equal schedules, no late event, a
             gloo all-gather of the ranks gives [0, 1], the merged
             completions equal the emulated fleet's tokens, and the ranks'
             attention and SwiGLU launches sum to the emulated fleet's (no
             shadow pool launches).  Per rank: wall, fleet steps, median
             step, tokens/s, exchanges and their p50 and max ms;
10. chaos  — ``chaos.run_campaign`` (seed 1, the reference's smoke
             sizing) with the serve campaigns (RECOMPILE and RESIDENT: a
             lane fault, a transient and a coordinator stall under 30
             Poisson requests, 4 devices with 2 spares, 3 slots, MAX_LEN
             48) and the closure scenario (24 requests, a device loss on 2
             devices) on qwen1.5-4b at full width and 20 of its 40 layers
             (``FLEET_LAYERS``: phase 9's weights, cut), route hw; the
             train campaign (a device loss, then a host loss with a
             checkpoint restore) on the reduced config on the card, SW
             route; one coordinator stall.  Every invariant must hold and
             the closure stay within 15%; each campaign's schedule, MTTR,
             traffic and kernel launches print; the campaign's telemetry
             snapshot, written to a file, is rendered by ``python -m
             repro_torch.obs.report``, whose MTTR and goodput must equal
             the campaigns' own summaries (rehearsed on the CPU by
             ``test_torch_chip_smoke.py``).
11. zoo    — mistral-nemo-12b (6 of 40 layers), mixtral-8x7b (4 of 32:
             8 experts top-2, a 4096-token window on every layer),
             llama4-scout-17b-a16e (4 of 48: 16 experts top-1 and a
             shared expert), gemma2-2b (8 of 26: head dim 256, local
             and global layers in turn, both softcaps, post-norms, GeGLU),
             gemma3-1b (6 of 26: one group of five local layers of
             window 512 and rope theta 1e4 to one global of 1e6, qk-norm,
             GQA 4 -> 1) and qwen2-vl-7b (8 of 28: M-RoPE, QKV biases,
             an untied head) at full width (the dense ones at a quarter
             of their depth or less), each built (weights
             drawn straight into bf16 by the port's own init; gemma3-1b's
             must carry its qk-norm scales), served and freed in turn, its
             peak memory printed.
             Each goes through phases 4-5 and its serve times as above
             (``serve_path``): 6 requests of 16-128 prompt tokens and 8-16
             new on 4 slots, the fault on ``swiglu_mlp`` (mistral,
             gemma3) or ``flash_attention`` (the MoE models, which have
             no SwiGLU stage, gemma2 and qwen2-vl); per prefill one
             attention launch a layer and for the gated MLPs one SwiGLU
             launch a layer per prefill and per tick.  For the MoE models the HW route
             changes only attention, but bf16 drift can flip a near-tied
             router choice:
             every layer's top-k choice is recorded on both routes, end to
             end and layer by layer from the same input; with no flip end
             to end the 5% logits bound holds, and layer by layer each
             attention must hold 5% and every flipped token's router
             margin lie below the largest probability drift on the tokens
             that did not flip.  The ring (mixtral, gemma2, gemma3): one
             request of 4200 prompt tokens and 8 new at max_len 4224, so
             each windowed layer's cache (4096 slots; gemma3's 512)
             wraps and each global layer keeps 4224 slots in order, the
             SW engine bit-identical to ``reference_decode``, the P =
             4200 HW prefill timed.  qwen2-vl's stub frontend: a prefill
             of 288 seeded N(0, 1) bf16 embeddings (16 text tokens, the
             16 x 16 grid of a 448 x 448 image, 16 text tokens) at
             Qwen2-VL's (t, h, w) positions, one attention and one
             SwiGLU launch a layer, HW logits finite and within 5% of SW,
             timed (rehearsed on the CPU by ``test_torch_chip_smoke.py``).
12. encdec — whisper-base at full width (6 + 6 layers, d_model 512)
             through ``EncDecModel.prefill`` and ``decode_step``: its
             ``flash_attention`` canary (healthy passes, each lane fault
             fails); 4 requests of 1500 seeded N(0, 1) bf16 frames and a
             4-token prompt; in f32 on SW, prefill and every decode step
             to 64 equal ``logits_all`` teacher-forced to 2e-4; in bf16
             the HW prefill logits within 5% of SW, greedy decode to 448
             on both routes, attention launches 6 + 2 x 6 a prefill and 6
             a step on HW (a step's self-attention is plain) and none on
             SW; a persistent fault at step 4 (the canary fails every
             probe) rebuilds the model with the stage on SW, whose tokens
             equal the healthy SW run's bit for bit; prefill and decode
             step ms, peak memory (rehearsed on the CPU by
             ``test_torch_chip_smoke.py``).
13. tuning — the autotuner (``kernels/tuning``) on the card.  From its
             start the script points the process's tuning cache at a fresh
             temporary directory (``REPRO_TUNING_CACHE``), so every earlier
             phase runs today's default plans.  qwen1.5-4b on the HW route
             over phase 4's seeded weights and 6 requests on 4 slots,
             served with an empty cache: every launch is the default plan.
             Then every admissible hw config (``sweep_plans``) at the main
             path's shapes (``TUNE_CASES``: attention at qwen1.5-4b P =
             128 and 2048, zamba2-1.2b P = 384, gemma2-2b P = 4200 at head
             dim 256, where one config is admissible; SwiGLU at qwen1.5-4b
             M = 4 and 128, zamba2-1.2b M = 384, qwen2-vl-7b M = 288; the
             SSD at zamba2-1.2b S = 384; the WKV at rwkv6-1.6b S = 512)
             and at the serve's prefill shapes: its shared memory (or the
             scans' whole plan) against the compiled library's before any
             launch, then a launch healthy and under a lane fault, bit-equal
             to the default plan (attention, SwiGLU) or within phase 2's
             tolerances of the plain version at that chunk (the scans).
             ``tune_kernel`` with ``cuda_measure`` tunes each shape into a
             fresh cache (a line per shape: default and tuned configs and
             ms, configs tried; every admissible config must measure).
             The serve runs again with the tuned cache and with every
             entry set to a non-default config: the three give the same
             tokens, the last two hit the cache, and every launch the
             wrappers recorded carries its entry's knobs (a
             row-independent decode SwiGLU keeps one warpgroup).  The
             cache is reset at the end (rehearsed on the CPU by
             ``test_torch_chip_smoke.py``, plans only).
14. examples — the six scripts of ``examples_torch/`` (quickstart,
             serve_with_faults, casestudy_faults, lane_fault_smoke,
             elastic_train, datacenter_sim), each in a worker process of
             its own with no ``--device``, so on the card, all at once
             (``example_worker``): each must exit 0 and print its OK
             line; its wall time and its kernel launches, counted from 0
             in its process, are recorded (serve_with_faults must launch
             attention and SwiGLU, lane_fault_smoke SwiGLU with the lane
             fault compiled in, casestudy_faults the checksum;
             elastic_train starts its eight rank processes of the (2, 4)
             mesh on ``cuda:0``, four of which go on over (1, 4)).
             Meanwhile the dry run (``launch/dryrun.py``) builds phase
             8's T1 cell on meta: its param bytes must equal phase 8's
             and its predicted peak come within 10% of phase 8's
             ``max_memory_allocated``; the achieved TFLOP/s from its
             counted FLOPs over phase 8's median step.
15. tp     — tensor-parallel serving (``launch/spmd.py``,
             ``launch/tp_serve.py``) over a (1, 4) ("data", "model") mesh,
             four gloo ranks on the one card (NCCL refuses ranks that
             share it), each serving its shard (seeded bf16 weights cut by
             ``partition.shard_tree``, Mamba2's packed leaves by
             component) through ``ServeEngine`` on route hw: 4 requests of
             16-128 prompt tokens on 4 slots; a lane fault on rank 1's own
             kernel stage at step 6, found by its canary and agreed
             through ``EventChannel``.  The four rank processes start
             once, join their group once and serve the models in turn
             (``tp_serve.launch_jobs``).  Model by model
             (``TP_LAYERS``): qwen1.5-4b at full width and 4 of 40 layers
             (5 of 20 heads, 1728 of 6912 d_ff columns, a quarter of the
             vocab and of the KV heads; the fault on ``swiglu_mlp``),
             zamba2-1.2b at 6 of 38 (one group of six Mamba2 layers and
             the shared block: 16 of 64 SSD heads, 8 of 32 attention
             heads, 2048 of 8192 d_ff columns; ``mamba2_ssd``),
             rwkv6-1.6b at 3 of 24 (8 of 32 WKV heads; ``rwkv6_wkv``),
             whisper-base at full width and
             depth, 6 + 6 layers (2 of 8 heads, 512 of 2048 d_ff columns,
             a quarter of the cross-KV's and the cache's kv heads; 4
             requests of 1500 stub frames and a 4-token prompt, 16 greedy
             decode steps through ``tp_serve.drive_encdec``, as it has no
             ``ServeEngine`` path; ``flash_attention``) and gemma3-1b at 6
             of 26 (five local layers and its global one: 1 of 4 query
             heads, its one kv head's K/V gathered, a quarter of every
             cache's slots, each decode step combining the ranks' softmax
             partials; prompts of 600-640 tokens wrap the local rings of
             512; ``swiglu_mlp``).  Then zamba2-1.2b once more, under
             the ``attn2d`` variant over (1, 2, 2) ("data", "model_h",
             "model_f") on the same ranks (``TP_JOBS``): its cache cut
             over "model_h", its Mamba2 params over both axes, so every
             layer moves its conv tail (by component) and SSM state
             between the two cuts; 16 of 64 SSD heads, 16 of 32
             attention heads, 2048 of 8192 d_ff columns.  First this
             process serves each model's workload on one unsharded HW
             engine of the same weights (whisper: the same
             ``drive_encdec`` unsharded; the ``attn2d`` job reads its
             (1, 4) job's run).
             Checks: every rank emits the same tokens; each rank's
             gathered logits within ``LOGITS_REL`` of the unsharded
             engine's at every prefill and tick before the fault (the
             ranks are fed the unsharded run's tokens until then, so a
             near-tie cannot fork the streams compared) — for rwkv6-1.6b,
             as phase 5 holds it, each layer's time-mix on the rank (HW,
             sharded) within ``LOGITS_REL`` of the unsharded SW one from
             the same input, and the first prefill's logits no further
             from the f32 model's than 1.25 times the bf16 SW route's;
             every rank demotes the stage at step 6; each rank launches
             attention once a layer a prefill, SwiGLU once a layer a call
             (until the fault where it is the faulted stage), the SSD or
             the WKV once a layer a prefill until the fault (whisper:
             attention 6 + 2 x 6 times a prefill and 6 a step until the
             fault), the faulted rank's canary once more, each at the
             rank's shapes; each rank's cache holds a quarter of the
             unsharded one's kv heads, or of its slots where the kv heads
             do not divide (gemma3-1b), and whisper's cross-KV a quarter
             of the kv heads (under ``attn2d`` a half of the kv heads,
             the conv channels and the SSM heads); each
             tick's collective bytes on the process group equal the dry
             run's counting stub for the same cell and depth.  Each rank's
             prefill and tick ms print, and the phase's seconds with the
             card's name and power limit (rehearsed on the CPU by
             ``test_torch_chip_smoke.py``).
16. tp_train — sharded training (``launch/tp_train.py``) at full width:
             qwen1.5-4b (d_model 2560, d_ff 6912, the full vocab) cut to
             4 of 40 layers (1.1 B params), eight gloo ranks over a (2, 4)
             ("data", "model") mesh on the one card, B = 4, S = 128, f32
             params, AdamW with a clip that binds.  First this process
             takes the same 2 steps unsharded on the card (its initial
             params, and its final params and first moments, saved to the
             host, then freed); then the ranks start once and each takes
             its shard of the initial params through 2 steps without
             ZeRO-1 and, from the same state, 2 with it.  Meanwhile the
             control: the unsharded steps on half of each batch, a wrong
             gradient, held against the full batch's.  Checks: every
             rank's losses and each step's grad norm the unsharded run's
             within 1e-4 relative; its first moments (its ZeRO-1 blocks)
             and its updated params within 1e-4 of each leaf's largest
             magnitude of the unsharded run's (``tp_train.max_rel``), the
             ZeRO-1 run's params within 1e-5 of the baseline's; each
             rank's moment bytes halved under ZeRO-1 (dp = 2); each step's
             collective bytes by kind equal to the dry run's counting stub
             for the same step (``dryrun.analyze_cell``); and the
             control's grad norms and first moments beyond the 1e-4 (the
             checks see a wrong gradient: AdamW's decay moves the params
             more than these clipped steps, so the params alone do not).
             Each step's ms and each rank's peak print beside the card's
             name and power limit (rehearsed on the CPU by
             ``test_torch_chip_smoke.py``).
             Then the seconds of every phase.
17. nccl  — ``--four-cards`` runs this phase alone (not phases 1-16; it
             raises where fewer than four cards are seen): the
             tensor-parallel runtime over NCCL, one rank a card
             (``mesh.rank_device``: rank r on ``cuda:r``; ``GroupComm``
             without host copies).  (a) Each card's name and power limit,
             ``nvidia-smi topo -m`` (or its refusal), the NCCL version and
             the transports NCCL's INFO log names for the first launch.
             (b) Each of the five kernels at one shape it serves
             (attention at mixtral-8x7b's and llama4-scout's rank, H = 8
             and 10 over Hkv = 2; SwiGLU, the SSD and the WKV at phase
             15's ranks; 64 MiB for the checksum) on ``cuda:1``-``cuda:3``
             while the current device stays ``cuda:0``: one launch on that
             card, its plain version's result within phase 2's bounds (the
             checksum equal), ``cuda:0``'s bits; timed on ``cuda:1``
             beside its plain version, the library call and its bound.
             Then every unsharded run on ``cuda:0``, each freed before the
             next: phase 15's six and, per MoE model, 4 layers at full
             width in f32 and bf16 (``TPServeSpec.keyed``: the draw of
             ``LMModel.init_keyed``), and one launch of four NCCL ranks
             serves in turn (c) phase 15's six jobs, checked as phase 15
             checks them, each rank's prefill and tick ms beside the same
             jobs' under gloo on ``cuda:0``, served after it; (d)
             mixtral-8x7b and llama4-scout at 4 layers over (1, 4), phase
             11's workload (6 requests of 16-128 tokens on 4 slots): in
             f32 on route SW, no fault, each call's gathered logits within
             1e-3 of the unsharded f32 run's and every request complete;
             in f32 on route hw with a lane fault on rank 1's attention at
             step 6, mixtral's calls before it within 4e-3 of the
             unsharded f32 hw run's (the attention kernel computes in
             bf16, whose rounding parts the ranks' f32 projections from
             the unsharded run's; llama4-scout's part as far as in bf16,
             so its readings print), the fault demoted at step 6 on
             every rank; in bf16 on route hw with the same fault, the
             ranks agree, demote it at step 6, each layer's router flips
             against the unsharded bf16 run (phase 11's ``choice_flips``)
             print, and mixtral's logits, the control, fail the f32 hw
             job's check; (e) the same
             models at
             full depth, 32 and 48 layers, bf16, each rank drawing only its
             block (21.75 and 50.19 GiB): the ranks agree, every request
             completes, the fault is demoted, each tick moves the dry
             run's stub bytes, the block is the meta's, the peak is under
             80 GiB, the serve's peak within 10% of params and cache, the
             draw's within its bound (``nccl_param_bounds``), and the
             checksum of layers 0-3 equals the bf16 4-layer job's on the
             same rank; prefill and tick ms, tok/s and peaks per rank.  (f)
             Phase 16 over (2, 2), under NCCL and then gloo, its
             collectives counted and timed per kind.  The phase must end
             within 600 s.  Its ``kernels`` line lists the five kernels
             with (b)'s numbers and their phase-17 launches (rehearsed on
             the CPU by ``test_torch_chip_smoke.py``).

The second-to-last line is one JSON object with the per-kernel numbers
(``launches`` sums the counts of the paths, each read with the counters
set to 0 just before that path: each model's serve, probes included, the
case studies, the fleet runs, the two ranks of phase 9, the chaos
campaigns, each phase-11 model's serve, ring prefill and image
prefill, phase 12's decode, faulted run and probes, phase 13's three
serves, each phase-14 example's process, and phase 15's ranks and
unsharded run of each model; the attention, SwiGLU, SSD and WKV entries
also carry the shard shapes' times, ``tp_shapes``, and every entry the
ranks' launches by model, ``tp_launches``);
the last line is ``{"ok": true, "device": {...}}``.  Details
also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published H100 SXM peaks (NVIDIA data sheet, dense): the bound's rates.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# torch.profiler traces a device time takes at most: a trace of short
# calls can come back empty, and has done so three times running
PROFILE_TRIES = 6

ATTN_TOL = (2e-2, 1e-2)     # (max abs, max abs / max |plain|)
# examples_torch/serve_with_faults.py's model ((H, Hkv, D), (d_model,
# d_ff)), its workload's shortest prompt and its prompts' lengths, and its
# decode rows (1 to its slots); phase 1 checks them against the example
SERVE_EXAMPLE = dict(heads=(4, 4, 32), mlp=(128, 256), min_prompt=6,
                     prompts=(10, 13, 15, 17, 20, 23), slots=3)
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
    # phase 11's prefills: mistral-nemo-12b (GQA 32 -> 8) at P = 16 and
    # 128, mixtral-8x7b (window 4096 on every layer) at P = 128 and over
    # the 4200-token ring prompt, llama4-scout (GQA 40 -> 8) at 16 and 128
    (1, 16, 16, 32, 8, 128, 128, dict(causal=True)),
    (1, 128, 128, 32, 8, 128, 128, dict(causal=True)),
    (1, 128, 128, 32, 8, 128, 128, dict(causal=True, window=4096)),
    (1, 4200, 4200, 32, 8, 128, 128, dict(causal=True, window=4096)),
    (1, 16, 16, 40, 8, 128, 128, dict(causal=True)),
    (1, 128, 128, 40, 8, 128, 128, dict(causal=True)),
    # gemma2-2b (GQA 8 -> 4, head dim 256, attention softcap 50): a local
    # layer's prefill at P = 128, a ragged one (Sq = 200), and the
    # 4200-token ring prompt through a local (window 4096) and a global
    # layer
    (1, 128, 128, 8, 4, 256, 256, dict(causal=True, window=4096,
                                       softcap=50.0)),
    (1, 200, 200, 8, 4, 256, 256, dict(causal=True, window=4096,
                                       softcap=50.0)),
    (1, 4200, 4200, 8, 4, 256, 256, dict(causal=True, window=4096,
                                         softcap=50.0)),
    (1, 4200, 4200, 8, 4, 256, 256, dict(causal=True, softcap=50.0)),
    # gemma3-1b (GQA 4 -> 1: every head reads kv head 0; head dim 256, no
    # softcap): a local layer's prefill at P = 128 under its 512 window and
    # the 4200-token ring prompt through a local and a global layer
    (1, 128, 128, 4, 1, 256, 256, dict(causal=True, window=512)),
    (1, 4200, 4200, 4, 1, 256, 256, dict(causal=True, window=512)),
    (1, 4200, 4200, 4, 1, 256, 256, dict(causal=True)),
    # whisper-base (8 heads of 64, 4 requests of 1500 frames): the
    # encoder's bidirectional attention (Skv = 1500 ends in a partial key
    # stage), the decoder's causal self-attention over its 4-token prompt,
    # and cross-attention over the encoder at the prompt's Sq = 4 and at a
    # decode step's Sq = 1 (a one-row query tile)
    (4, 1500, 1500, 8, 8, 64, 64, dict(causal=False)),
    (4, 4, 4, 8, 8, 64, 64, dict(causal=True)),
    (4, 4, 1500, 8, 8, 64, 64, dict(causal=False)),
    (4, 1, 1500, 8, 8, 64, 64, dict(causal=False)),
    # qwen2-vl-7b (GQA 28 -> 4, D = 128): a prompt of 128 tokens and the
    # stub frontend's 288 (16 text, a 16 x 16 image grid, 16 text)
    (1, 128, 128, 28, 4, 128, 128, dict(causal=True)),
    (1, 288, 288, 28, 4, 128, 128, dict(causal=True)),
    # phase 14's serve_with_faults (the reduced qwen1.5-4b): its
    # workload's prompt lengths and the shortest it may draw
    *((1, P, P, *SERVE_EXAMPLE["heads"], SERVE_EXAMPLE["heads"][-1],
       dict(causal=True))
      for P in (SERVE_EXAMPLE["min_prompt"],) + SERVE_EXAMPLE["prompts"]),
    # phase 15: a tensor-parallel rank of qwen1.5-4b over a 4-way model
    # axis (5 of its 20 heads) at its workload's shortest and longest
    # prompts and a ragged one
    (1, 16, 16, 5, 5, 128, 128, dict(causal=True)),
    (1, 77, 77, 5, 5, 128, 128, dict(causal=True)),
    (1, 128, 128, 5, 5, 128, 128, dict(causal=True)),
)
# The rank shapes phase 15's zamba2-1.2b and rwkv6-1.6b add, held after
# every case above (each case draws its inputs from one generator in
# turn, so the cases above keep their draws): zamba2's shared block (8 of
# its 32 heads of 64) at the workload's shortest and longest prompts and
# at its unsharded serve's P = 384
TP_ATTN_CASES = (
    (1, 16, 16, 8, 8, 64, 64, dict(causal=True)),
    (1, 128, 128, 8, 8, 64, 64, dict(causal=True)),
    (1, 384, 384, 8, 8, 64, 64, dict(causal=True)),
)
# The rank shapes phase 15's whisper-base and gemma3-1b add, held after
# every case above: whisper's 2 of 8 heads of 64 (B = 4: the encoder over
# 1500 frames, the decoder's 4-token prompt, cross-attention of Sq = 4 and
# of Sq = 1 over the 1500 frames) and gemma3-1b's 1 of 4 query heads over
# its one kv head at head dim 256: a local layer (window 512) at P = 128
# and past the window at 600, and the global layer at 600
TP_GEMMA3_PROMPT = 600
TP_WHISPER_GEMMA3_ATTN_CASES = (
    (4, 1500, 1500, 2, 2, 64, 64, dict(causal=False)),
    (4, 4, 4, 2, 2, 64, 64, dict(causal=True)),
    (4, 4, 1500, 2, 2, 64, 64, dict(causal=False)),
    (4, 1, 1500, 2, 2, 64, 64, dict(causal=False)),
    (1, 128, 128, 1, 1, 256, 256, dict(causal=True, window=512)),
    (1, TP_GEMMA3_PROMPT, TP_GEMMA3_PROMPT, 1, 1, 256, 256,
     dict(causal=True, window=512)),
    (1, TP_GEMMA3_PROMPT, TP_GEMMA3_PROMPT, 1, 1, 256, 256,
     dict(causal=True)),
)
# The rank shapes phase 15's zamba2-1.2b under ``attn2d`` adds, held after
# every case above: its shared block's 16 of 32 heads of 64 (the heads on
# "model_h", 2 ways) at the workload's shortest and longest prompts and at
# the unsharded serve's P = 384
TP_ATTN2D_ATTN_CASES = (
    (1, 16, 16, 16, 16, 64, 64, dict(causal=True)),
    (1, 128, 128, 16, 16, 64, 64, dict(causal=True)),
    (1, 384, 384, 16, 16, 64, 64, dict(causal=True)),
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
# phase 15's rank: 8 of rwkv6-1.6b's 32 heads, at the prefill shape and at
# a ragged served prompt
TP_WKV_CASES = ((1, 512, 8, 64, 64, False), (1, 77, 8, 64, 64, False))
# (B, S, H, P, N): three chunks at zamba2-1.2b's prefill, 16 chunks, B = 4,
# one unpadded chunk of 100, B = 2 padded to 256 (dt = 0), a narrow P
# (also under a gain of 2)
SSD_CASES = ((1, 384, 64, 64, 64), (1, 2048, 64, 64, 64),
             (4, 384, 64, 64, 64), (1, 100, 64, 64, 64),
             (2, 200, 64, 64, 64), (1, 384, 64, 40, 64))
# phase 15's rank (16 of the 64 heads) at the prefill shape and at its
# served prompts' one chunk of 16 and of 77 tokens (a chunk shorter than
# the 64-row tile)
TP_SSD_CASES = ((1, 384, 16, 64, 64), (1, 16, 16, 64, 64),
                (1, 77, 16, 64, 64))
# HW against SW logits after every bf16 layer: each route rounds its
# activations to bf16 at other points, so the logits drift apart by a few
# bf16 ulps per layer; 5% of the largest logit bounds that drift.
LOGITS_REL = 5e-2
# spin kernels that open a traced serving step (see ``profile_serving``):
# the profiler has lost up to 99 of a step's first device events
WARM_SPINS = 1024
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
    from torch.profiler import ProfilerActivity, profile, schedule

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
        # a trace that lost even the spins is taken again, while the tick
        # still has 4 slots
        for tries in range(1, PROFILE_TRIES + 1):
            torch.cuda.synchronize()
            # a trace can lose its first few dozen device events while the
            # profiler starts up (an attention launch among them): a warm-up
            # step goes first, and the reported step opens with spin kernels
            # and a pause, which take that loss and are left out of the rows
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=1,
                                           repeat=1)) as prof:
                torch.ones(1, device=dev).add_(1)
                torch.cuda.synchronize()
                prof.step()
                for _ in range(WARM_SPINS):
                    torch.cuda._sleep(1000)
                torch.cuda.synchronize()
                time.sleep(0.05)
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t0)
                prof.step()
            # device-side events only (kernels, copies): a CPU op's own
            # "self device time" would count its kernels a second time, and
            # the step's own annotation spans the whole step on the device
            rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA
                    and not e.key.startswith("ProfilerStep")]
            spins = sum(n for k, _, n in rows if "spin_kernel" in k)
            if spins > 0 or eng.occupancy() < 4:
                break
        check(spins > 0, f"{cfg.name} {name}: the profiler lost all "
              f"{WARM_SPINS} warm-up spins, so the step's own first device "
              "events may be lost too")
        rows = sorted((r for r in rows if r[1] > 0 and "spin_kernel"
                       not in r[0]), key=lambda r: -r[1])
        busy_ms = sum(r[1] for r in rows)
        result[name] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
                        "warm_spins_kept": spins, "trace_tries": tries,
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
            + f"{result[name]['copy_kernels']} copy kernels; "
            f"{spins} of {WARM_SPINS} warm-up spins kept"
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
# The depth of phase 6's fleet and phase 10's serve campaigns: a fleet
# step is host-bound ticks whose cost grows with the layers, and nothing
# either phase checks (migration, requeue, per-device launches, the front
# end, the invariants, the closure) depends on depth
FLEET_LAYERS = 20


def _drive_session(eng, reqs, events):
    """Serve ``reqs`` through a fleet session, timing each step; returns
    (completions, stats, step seconds, wall seconds)."""
    ev = {k: list(v) for k, v in events.items()}
    sess = eng.session()
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
    return {c.rid: c for c in sess.poll()}, stats, steps_s, wall


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
        done, stats, steps_s, wall = _drive_session(fleet, reqs, events)
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
# the head, 0.78 B of its 0.86 B params, keep their size); SyntheticLM
# batches of B x S tokens; AdamW at TRAIN_LR after 2 warmup steps.
TRAIN_STEPS = 8
TRAIN_BATCH, TRAIN_SEQ = 4, 128
TRAIN_CUT_LAYERS = 1
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
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
    params, opt, err = runner.run(params, opt, err)
    losses = [h["loss"] for h in runner.history]
    dts = [h["dt"] for h in runner.history]
    step_s = float(np.median(dts[1:]))
    peak = torch.cuda.max_memory_allocated() if on_card else None
    t1 = {"layers": cfg.num_layers, "params": N, "losses": losses,
          "param_bytes": param_bytes,
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


# The two-process fleet (phase 9): the reference's two-process acceptance
# test (tests/test_distributed_fleet.py) on the card.  Two ranks join one
# process group over a TCPStore; each owns half of a 4-device fleet (host
# 0: devices 0 and 1; host 1: device 2 and the hot spare 3), with 2 slots a
# device and the serve phases' prompts of 16-128 tokens and 8-16 new.
# Only rank 0 sees the device fault at step 3.  Both ranks share the one
# card, which NCCL refuses, so the backend is gloo on CPU tensors.
MH_BACKEND = "gloo"
MH_REQUESTS = 6
MH_SLOTS = 2
MH_SEED = 0
MH_WORKLOAD = dict(min_prompt=16, max_prompt=128, min_new=8, max_new=16,
                   arrival_every=1, per_arrival=2)
MH_EVENTS = {3: [("device", 0)]}
MH_TIMEOUT_S = 600
MH_WORKER = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
             "sys.exit(chip_smoke.multihost_worker(sys.argv[2:]))")


class _TimedCoordinator:
    """A coordinator that records each exchange's wall milliseconds."""

    def __init__(self, inner):
        self.inner = inner
        self.num_hosts = inner.num_hosts
        self.host_id = inner.host_id
        self.ms = []

    def exchange(self, payload):
        t0 = time.perf_counter()
        res = self.inner.exchange(payload)
        self.ms.append(1e3 * (time.perf_counter() - t0))
        return res

    def mark_dead(self, host):
        self.inner.mark_dead(host)


def _mh_fleet(cfg, params, dev, topology, coordinator):
    """The phase's fleet on ``topology`` and its requests."""
    import numpy as np

    from repro_torch.serve import (FleetConfig, FleetServeEngine,
                                   ServeConfig, synthetic_workload)
    from repro_torch.viscosity import HW

    reqs = synthetic_workload(cfg.vocab_size, MH_REQUESTS,
                              np.random.default_rng(MH_SEED), **MH_WORKLOAD)
    max_len = MH_WORKLOAD["max_prompt"] + MH_WORKLOAD["max_new"]
    eng = FleetServeEngine(
        cfg, params, ServeConfig(max_len=max_len, max_slots=MH_SLOTS,
                                 hw_route=HW),
        FleetConfig(n_devices=4, n_spares=1, topology=topology),
        coordinator=coordinator, device=dev)
    return eng, reqs


def multihost_worker(argv) -> int:
    """One rank of phase 9 (``argv``: rank, port, arch, device).  Prints
    one ``RESULT {json}`` line; any failure raises (a non-zero exit)."""
    pid, port, arch, device = int(argv[0]), argv[1], argv[2], argv[3]
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as tdist

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    from repro_torch.configs import get_config
    from repro_torch.kernels.checksum import checksum_popcount, checksum_tree
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.mamba2_scan import ssd_chunked_cuda
    from repro_torch.kernels.rwkv6_scan import wkv6_chunked_cuda
    from repro_torch.kernels.swiglu import swiglu_fused
    from repro_torch.launch.distributed import (HostTopology, KVCoordinator,
                                                fleet_fingerprint,
                                                initialize_runtime,
                                                shutdown_runtime)
    from repro_torch.models import build_model
    from repro_torch.serve import percentile

    wrappers = {"checksum": checksum_popcount,
                "flash_attention": flash_attention_bhsd,
                "swiglu_mlp": swiglu_fused, "mamba2_ssd": ssd_chunked_cuda,
                "rwkv6_wkv": wkv6_chunked_cuda}
    t_start = time.perf_counter()
    rt = initialize_runtime(f"127.0.0.1:{port}", 2, pid, backend=MH_BACKEND,
                            timeout_s=MH_TIMEOUT_S)
    coord = _TimedCoordinator(KVCoordinator())
    cfg = get_config(arch)
    params32 = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(MH_SEED), device=dev)
    eng, reqs = _mh_fleet(cfg, params32, dev,
                          HostTopology(2, 2, host_id=rt.process_id), coord)
    del params32
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    for w in wrappers.values():
        w.launches = 0
    # the ranks agree on the weights they serve before serving them
    weights = checksum_tree(eng.params)
    sums = coord.exchange(str(weights))
    done, stats, steps_s, wall = _drive_session(
        eng, reqs, MH_EVENTS if rt.process_id == 0 else {})
    launches = {name: w.launches for name, w in wrappers.items()}
    gathered = [torch.zeros(1, dtype=torch.int64) for _ in range(2)]
    tdist.all_gather(gathered, torch.tensor([rt.process_id]))
    fingerprints = coord.exchange(fleet_fingerprint(eng.fleet))
    owned = HostTopology(2, 2, host_id=rt.process_id).devices_of()
    local_tokens = sum(stats["per_device_tokens"][d] for d in owned)
    exchange_ms = list(coord.ms)
    out = {
        "pid": rt.process_id, "world": tdist.get_world_size(),
        "backend": rt.backend, "checksums": sums,
        "fingerprints": fingerprints,
        "fleet_fingerprint": stats["fleet_fingerprint"],
        "quarantined": list(eng.fleet.quarantined),
        "spare_for_0": eng.fleet.pool.spare_for(0),
        "completed": sorted(done),
        "devices_by_rid": {str(r): done[r].device for r in sorted(done)},
        "tokens": {str(r): done[r].tokens.tolist() for r in sorted(done)},
        "requeued": stats["requeued"], "late_events": stats["late_events"],
        "per_device_tokens": stats["per_device_tokens"],
        "steps": stats["steps"], "allgather": [int(t) for t in gathered],
        "launches": launches, "wall_s": wall,
        "process_s": time.perf_counter() - t_start,
        "step_ms_median": 1e3 * percentile(steps_s, 0.5),
        "local_tokens": local_tokens, "tokens_per_s": local_tokens / wall,
        "exchanges": len(exchange_ms),
        "exchange_ms_p50": percentile(exchange_ms, 0.5),
        "exchange_ms_max": max(exchange_ms),
        "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                     if dev.type == "cuda" else None),
    }
    # one last exchange: rank 0 serves the store, so neither rank leaves
    # while the other still reads it
    coord.exchange("done")
    shutdown_runtime()
    print("RESULT " + json.dumps(out), flush=True)
    return 0


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multihost_phase(cfg, dev, wrappers, *, timeout: float = MH_TIMEOUT_S):
    """Phase 9: the fleet emulated in this process (both hosts' devices
    local), then the same fleet split across two worker processes on the
    same card and weights.  Returns (report entry, kernel launches of the
    two workers, the emulated fleet's bf16 weights on ``dev``)."""
    import os

    import torch

    from repro_torch.kernels.checksum import checksum_tree
    from repro_torch.launch.distributed import (HostTopology,
                                                fleet_fingerprint)
    from repro_torch.models import build_model
    from repro_torch.serve import percentile

    out(f"[multihost] backend {MH_BACKEND} (explicit): both ranks share the "
        "one card, which NCCL refuses; the collectives carry CPU tensors")
    params32 = build_model(cfg).init(
        torch.Generator(device=dev).manual_seed(MH_SEED), device=dev)
    emu, reqs = _mh_fleet(cfg, params32, dev, HostTopology(2, 2), None)
    del params32
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    for w in wrappers.values():
        w.launches = 0
    done, stats, steps_s, wall = _drive_session(emu, reqs, MH_EVENTS)
    emu_launches = {name: w.launches for name, w in wrappers.items()}
    emu_tokens = {str(r): c.tokens.tolist() for r, c in sorted(done.items())}
    n_tok = sum(map(len, emu_tokens.values()))
    entry = {"requests": MH_REQUESTS, "slots": MH_SLOTS, "n_devices": 4,
             "n_spares": 1, "backend": MH_BACKEND, "emulated": {
                 "wall_s": wall, "steps": stats["steps"],
                 "step_ms_median": 1e3 * percentile(steps_s, 0.5),
                 "tokens_per_s": n_tok / wall,
                 "requeued": stats["requeued"],
                 "per_device_tokens": stats["per_device_tokens"],
                 "launches": emu_launches}}
    out(f"[multihost] {cfg.name} emulated in one process: {len(done)} "
        f"requests, {n_tok} tokens in {stats['steps']} steps, {wall:.2f} s, "
        f"median step {entry['emulated']['step_ms_median']:.2f} ms, "
        f"{n_tok / wall:.2f} tok/s; requeued {stats['requeued']}, "
        f"per-device tokens {stats['per_device_tokens']}; launches "
        f"{emu_launches}")
    check(sorted(done) == sorted(r.rid for r in reqs) and stats["requeued"]
          > 0 and emu.fleet.quarantined == (0,),
          "multihost: the emulated fleet did not migrate device 0's work")
    weights = checksum_tree(emu.params)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        entry["parent_allocated_gib"] = torch.cuda.memory_allocated() / 2**30
        out(f"[multihost] this process holds "
            f"{entry['parent_allocated_gib']:.3f} GiB on the card while the "
            "ranks run")

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MH_WORKER, str(ROOT), str(pid), str(port),
         cfg.name, dev.type], env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in (0, 1)]
    results, failures = [], []
    try:
        for pid, p in enumerate(procs):
            try:
                stdout, stderr = p.communicate(
                    timeout=max(1.0, timeout - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                failures.append(f"rank {pid} timed out after {timeout} s")
                continue
            lines = [ln for ln in stdout.splitlines()
                     if ln.startswith("RESULT ")]
            if p.returncode != 0 or not lines:
                failures.append(f"rank {pid} exited {p.returncode}:\n"
                                f"{stderr[-3000:]}")
                continue
            results.append(json.loads(lines[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    check(not failures, "multihost: " + "\n".join(failures))
    r0, r1 = sorted(results, key=lambda r: r["pid"])
    for r in (r0, r1):
        out(f"[multihost] rank {r['pid']}: {r['wall_s']:.2f} s fleet wall "
            f"({r['process_s']:.2f} s from init), {r['steps']} fleet steps, "
            f"median step {r['step_ms_median']:.2f} ms, "
            f"{r['tokens_per_s']:.2f} tok/s ({r['local_tokens']} tokens on "
            f"its devices), {r['exchanges']} exchanges, p50 "
            f"{r['exchange_ms_p50']:.3f} ms, max {r['exchange_ms_max']:.3f} "
            f"ms; peak memory {r['peak_gib']} GiB; launches "
            f"{r['launches']}")
    check(r0["world"] == r1["world"] == 2 and r0["backend"] == r1["backend"]
          == MH_BACKEND, "multihost: the ranks are not one gloo group")
    check(r0["allgather"] == r1["allgather"] == [0, 1],
          f"multihost: all-gather gave {r0['allgather']}, {r1['allgather']}")
    check(r0["checksums"] == r1["checksums"]
          == [str(weights), str(weights)],
          f"multihost: the ranks' weights differ: {r0['checksums']} "
          f"(this process: {weights})")
    check(r0["fleet_fingerprint"] == r1["fleet_fingerprint"]
          == fleet_fingerprint(emu.fleet)
          and r0["fingerprints"] == r1["fingerprints"]
          and len(set(r0["fingerprints"])) == 1,
          "multihost: the ranks folded different plans")
    for r in (r0, r1):
        check(r["quarantined"] == [0] and r["spare_for_0"] == 3
              and r["late_events"] == 0,
              f"multihost: rank {r['pid']} did not migrate device 0 to "
              f"spare 3: {r['quarantined']}, {r['spare_for_0']}")
    check(r0["devices_by_rid"] == r1["devices_by_rid"]
          and r0["requeued"] == r1["requeued"] == stats["requeued"] > 0
          and r0["per_device_tokens"][3] > 0
          and 3 in set(r0["devices_by_rid"].values())
          and r0["per_device_tokens"] == stats["per_device_tokens"]
          and r0["steps"] == r1["steps"] == stats["steps"],
          "multihost: the ranks' schedules differ from each other or from "
          "the emulated fleet's")
    check(r0["completed"] == r1["completed"] == sorted(done)
          and r0["tokens"] == r1["tokens"] == emu_tokens,
          "multihost: the merged completions differ from the emulated "
          "fleet's tokens")
    paths = ("flash_attention", "swiglu_mlp")
    launches = {name: r0["launches"].get(name, 0)
                + r1["launches"].get(name, 0) for name in wrappers}
    check(all(r["launches"][s] > 0 for r in (r0, r1) for s in paths)
          and all(launches[s] == emu_launches[s] for s in paths),
          f"multihost: the ranks launched {r0['launches']} and "
          f"{r1['launches']}, the emulated fleet {emu_launches}: a shadow "
          "pool launched, or an owned one did not")
    check(all(r["launches"]["checksum"] > 0 for r in (r0, r1)),
          "multihost: a rank's weight checksum launched no kernel")
    entry["ranks"] = [{k: r[k] for k in (
        "wall_s", "process_s", "steps", "step_ms_median", "tokens_per_s",
        "local_tokens", "exchanges", "exchange_ms_p50", "exchange_ms_max",
        "peak_gib", "launches", "requeued", "per_device_tokens")}
        for r in (r0, r1)]
    entry["weights_checksum"] = weights
    entry["launches"] = launches
    out(f"[multihost] both ranks: fingerprint {r0['fleet_fingerprint']}, "
        f"device 0 quarantined onto spare 3, requeued {r0['requeued']}, "
        f"all-gather {r0['allgather']}, weights checksum {weights}; merged "
        f"completions equal the emulated fleet's; launches {launches}")
    return entry, launches, emu.params


# The chaos phase (phase 10): ``run_campaign`` at the reference's smoke
# sizing (serve: 3 events, 30 requests, 4 devices with 2 spares, 3 slots,
# MAX_LEN 48, in RECOMPILE and RESIDENT; the closure at 24 requests; the
# train campaign on the reduced config; one coordinator stall) with the
# serve and closure campaigns at full width on route hw.  Seed 1 draws a
# lane fault, a transient and a coordinator stall for serving, a device
# loss and a host loss for training.
CHAOS_SEED = 1


def chaos_phase(cfg, dev, wrappers, params, *, seed: int = CHAOS_SEED,
                workdir=None):
    """Phase 10: ``chaos.run_campaign`` with ``cfg`` and ``params`` served
    on ``dev`` on route hw, its telemetry rendered by ``python -m
    repro_torch.obs.report``.  Returns (report entry, kernel launches of
    the campaign, counted from 0)."""
    import os
    import shutil
    import tempfile

    from repro_torch.chaos import campaign
    from repro_torch.serve import RECOMPILE, RESIDENT
    from repro_torch.viscosity import HW, lanefault

    names = ("serve_campaign", "closure_scenario", "train_campaign",
             "coordinator_campaign")
    originals = {n: getattr(campaign, n) for n in names}
    sections = {}

    def counted(name, fn):
        def call(*a, **kw):
            label = (f"serve_{kw['failover']}" if name == "serve_campaign"
                     else name.split("_")[0])
            n0 = {k: w.launches for k, w in wrappers.items()}
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            sections[label] = {
                "wall_s": time.perf_counter() - t0,
                "launches": {k: w.launches - n0[k]
                             for k, w in wrappers.items()}}
            return res
        return call

    for w in wrappers.values():
        w.launches = 0
    base = Path(workdir) if workdir is not None else ROOT / "build"
    base.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="chaos_", dir=base))
    try:
        for n in names:
            setattr(campaign, n, counted(n, originals[n]))
        t0 = time.perf_counter()
        res = campaign.run_campaign(seed, smoke=True,
                                    ckpt_dir=str(tmp / "ckpt"), cfg=cfg,
                                    params=params, device=dev, hw_route=HW)
        wall = time.perf_counter() - t0
        for n in names:
            setattr(campaign, n, originals[n])
        check(all(lanefault.injection(s) is None for s in
                  campaign.CANARY_WIDTHS)
              and all(lanefault.fault_map(s) is None for s in
                      campaign.CANARY_WIDTHS),
              "chaos: a lane fault outlived its campaign")
        launches = {name: w.launches for name, w in wrappers.items()}
        entry = {"seed": seed, "wall_s": wall, "sections": sections,
                 "events_total": res["events_total"],
                 "invariants": res["invariants"]}
        for mode in (RECOMPILE, RESIDENT):
            s = res["serve"][mode]
            sec = sections[f"serve_{mode}"]
            entry[f"serve_{mode}"] = {k: s[k] for k in (
                "schedule", "mttr", "mttr_summary", "traffic",
                "quarantined")}
            entry[f"serve_{mode}"]["invariants"] = {
                r["invariant"]: r["ok"] for r in s["invariants"]["reports"]}
            out(f"[chaos] serve {mode}: {sec['wall_s']:.2f} s; schedule "
                + ", ".join(f"{e['step']}:{e['kind']}"
                            f"({e['stage'] or e['device']})"
                            for e in s["schedule"])
                + f"; MTTR {s['mttr_summary']} (per event "
                f"{[m['mttr_s'] for m in s['mttr']]}); traffic "
                f"{s['traffic']}; quarantined {s['quarantined']}; "
                f"invariants {entry[f'serve_{mode}']['invariants']}; "
                f"launches {sec['launches']}")
            check(s["invariants"]["ok"], f"chaos serve {mode}: "
                  f"{s['invariants']['failed']}")
            check(s["traffic"]["completed"] == s["traffic"]["requests"],
                  f"chaos serve {mode}: a request was dropped")
            check(all(sec["launches"][k] > 0
                      for k in ("flash_attention", "swiglu_mlp")),
                  f"chaos serve {mode}: a kernel of the path never "
                  f"launched: {sec['launches']}")
        cl, tr, co = res["closure"], res["train"], res["coordinator"]
        entry["closure"] = cl
        entry["train"] = {k: tr[k] for k in (
            "schedule", "mttr", "mttr_summary", "guard_trips",
            "quarantined", "steps")}
        entry["coordinator"] = {k: co[k] for k in ("mttr", "mttr_summary")}
        out(f"[chaos] closure: measured {cl['measured_ratio']} analytic "
            f"{cl['analytic_ratio']} rel_err {cl['rel_err']} (tol "
            f"{cl['tol']}), dropped {cl['dropped']}; "
            f"{sections['closure']['wall_s']:.2f} s, launches "
            f"{sections['closure']['launches']}")
        out(f"[chaos] train ({tr['steps']} steps, reduced config, SW): "
            + ", ".join(f"{e['step']}:{e['kind']}" for e in tr["schedule"])
            + f"; guard trips {tr['guard_trips']}, quarantined "
            f"{tr['quarantined']}, MTTR {tr['mttr_summary']}; "
            f"{sections['train']['wall_s']:.2f} s, launches "
            f"{sections['train']['launches']}")
        out(f"[chaos] coordinator: MTTR {co['mttr_summary']}")
        check(cl["ok"], f"chaos closure: {cl}")
        check(tr["invariants"]["ok"] and co["invariants"]["ok"],
              f"chaos: train {tr['invariants']['failed']}, coordinator "
              f"{co['invariants']['failed']}")
        check(res["invariants"] == {"ok": True, "failed": []},
              f"chaos: {res['invariants']}")
        check(not any(sections["train"]["launches"].values()),
              "chaos: the train campaign launched a kernel on the SW route")
        check(all(sections["closure"]["launches"][k] > 0
                  for k in ("flash_attention", "swiglu_mlp")),
              "chaos: the closure launched no kernel")

        # the campaign's one telemetry snapshot, rendered by the CLI
        snap = tmp / "telemetry.json"
        snap.write_text(json.dumps(res["telemetry"]))
        env = dict(os.environ, PYTHONPATH=str(SRC))
        text, health = (subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.report", str(snap),
             *flag], env=env, cwd=str(ROOT), capture_output=True, text=True,
            timeout=300, check=True).stdout for flag in ((), ("--json",)))
        health = json.loads(health)
        for ln in text.splitlines():
            out(f"[chaos] report: {ln}")
        parts = {f"serve_{m}": res["serve"][m] for m in (RECOMPILE,
                                                          RESIDENT)}
        parts.update(train=tr, coordinator=co)
        for sec, part in parts.items():
            m = part["mttr_summary"]
            check(health["mttr"].get(sec) == m and (
                f"mttr[{sec}]  n={m['n']} mean={m['mean_s']}s "
                f"max={m['max_s']}s") in text,
                  f"chaos report: MTTR of {sec} {health['mttr'].get(sec)} "
                  f"against the campaign's {m}")
        for mode in (RECOMPILE, RESIDENT):
            g = health["serve"][f"serve_{mode}"]
            t = res["serve"][mode]["traffic"]
            # deadline-free arrivals: goodput is the throughput
            check(g["goodput_tok_s"] == g["throughput_tok_s"]
                  and round(g["goodput_tok_s"], 2) == t["throughput_tok_s"]
                  and f"serve[serve_{mode}]  goodput="
                  f"{g['goodput_tok_s']:.2f}tok/s" in text,
                  f"chaos report: goodput of serve_{mode} {g} against the "
                  f"campaign's {t}")
        entry["report"] = {"mttr": health["mttr"], "goodput": {
            k: v["goodput_tok_s"] for k, v in health["serve"].items()}}
    finally:
        for n in names:
            setattr(campaign, n, originals[n])
        shutil.rmtree(tmp, ignore_errors=True)
    entry["launches"] = launches
    out(f"[chaos] {res['events_total']} fault events in {wall:.2f} s; kernel "
        f"launches of the campaign {launches}")
    return entry, launches


def canary_phase(cfg, dev):
    """Every healthy canary stage passes on HW; each lane-fault kind
    (armed at the canary's width) fails it."""
    from repro_torch.chaos import CANARY_WIDTHS
    from repro_torch.core import CanaryChecker
    from repro_torch.train.runner import canary_stages
    from repro_torch.viscosity import HW, SW, lanefault
    from repro_torch.viscosity.lanefault import KINDS, LaneFault

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

def init_weights(cfg, dev, *, f32: bool = False):
    """Seeded random weights of ``cfg`` on ``dev`` in bf16, drawn leaf by
    leaf and cast at once (``LMModel.init(dtype=...)``: the peak is the
    bf16 tree and one f32 leaf); with ``f32`` the float32 tree is drawn,
    kept and cast (the same bf16 values).  Returns (bf16 params, float32
    params or None, seconds)."""
    import torch

    from repro_torch.models import build_model, compute_params
    t0 = time.perf_counter()
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    if f32:
        params32 = model.init(gen, device=dev)
        params = compute_params(params32, torch.bfloat16)
    else:
        params32 = None
        params = model.init(gen, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    return params, params32, time.perf_counter() - t0


def choice_flips(cfg, probs_hw, probs_sw):
    """Per layer, the tokens whose top-k expert choice differs between the
    HW and the SW route's router probabilities: their count, the SW
    router's margin at each (the k-th against the (k+1)-th probability),
    and the largest probability drift between the routes on the tokens
    whose choice agrees."""
    from repro_torch.models.moe import _top_k
    k = cfg.moe.top_k
    flips, margins, drift = 0, [], 0.0
    for ph, ps in zip(probs_hw, probs_sw):
        ih = _top_k(ph, k)[1].sort(-1).values
        vs, is_ = _top_k(ps, k + 1)
        flip = (ih != is_[..., :k].sort(-1).values).any(-1)
        flips += int(flip.sum())
        margins += (vs[..., k - 1] - vs[..., k])[flip].tolist()
        if bool((~flip).any()):
            drift = max(drift, (ph - ps).abs()[~flip].max().item())
    return {"flips": flips, "margins": margins, "drift": drift,
            "layers": len(probs_sw)}


def router_teacher_forced(cfg, params, prompt):
    """Layer by layer from the SW route's activations (teacher-forced):
    each layer's attention on the HW and on the SW route from the same
    input, its largest difference relative to the largest SW output; and
    the router's probabilities in each route's block from that input
    (``moe.observe_router``), for ``choice_flips``.  Each layer then
    continues from the SW block's output."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import blocks as B
    from repro_torch.models import build_model
    from repro_torch.models import layers as Lm
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import rope as rope_mod
    from repro_torch.viscosity import HW, SW

    model = build_model(cfg)
    x = model._embed_in(params, {"tokens": prompt})
    ropes = model._ropes(rope_mod.positions_default(1, prompt.shape[1],
                                                    x.device))
    kw = dict(n_heads=cfg.num_heads, n_kv=cfg.num_kv_heads,
              head_dim=cfg.resolved_head_dim, window=model.metas[0].window,
              softcap=cfg.attn_softcap, scale=cfg.attn_scale, causal=True,
              kv_chunk=cfg.attn_chunk)

    def layer(tree, i):
        return ({k: layer(v, i) for k, v in tree.items()}
                if isinstance(tree, dict) else tree[i])
    probs, worst = {HW: [], SW: []}, 0.0
    for i in range(cfg.num_layers):
        p = layer(params["layers"], i)
        h = Lm.norm(p["ln1"], x, eps=cfg.norm_eps)
        att = {r: attn_mod.attn_full(p["attn"], h, *ropes["global"],
                                     route=r, **kw)
               for r in (HW, SW)}
        worst = max(worst, (att[HW] - att[SW]).float().abs().max().item()
                    / att[SW].float().abs().max().item())
        out_ = {}
        for r in (HW, SW):
            with moe_mod.observe_router(probs[r].append):
                out_[r] = B.attn_block(p, x, cfg, model.metas[0], ropes,
                                       {"flash_attention": r})[0]
        x = out_[SW]
    return probs, worst


def serve_path(cfg, dev, wrappers, params, workload, fault_stage,
               per_prefill, per_tick, prefill_len, *, params32=None,
               logits_check=None):
    """Phases 4 and 5 for one model on ``params`` (bf16), then its
    end-to-end times (a prefill of ``prefill_len`` tokens, a healthy serve,
    the profiler); returns (its report entry, each kernel's launches in
    the serve runs, probes included).  ``logits_check(cfg, params,
    params32, prompt, last)`` replaces the bound on HW against SW prefill
    logits for a model that amplifies bf16 rounding (see ``rwkv_logits``
    in ``main``).  For an MoE model every layer's router choice is
    recorded on both routes, end to end and layer by layer from the same
    input (``router_teacher_forced``): where none flips end to end, the 5%
    bound holds; layer by layer, each attention holds 5% and every flipped
    token's router margin must lie below the largest probability drift
    between the routes on the tokens that did not flip (a near tie, which
    bf16 drift may break either way)."""
    import numpy as np
    import torch

    from repro_torch.chaos import ChaosCanary, canary_fault
    from repro_torch.core import CanaryChecker
    from repro_torch.core.fault import (PERSISTENT, TRANSIENT_RECOVERED,
                                        FaultClassifier)
    from repro_torch.kernels.checksum import checksum_tree, checksum_tree_ref
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.serve import (RECOMPILE, RESIDENT, ServeConfig,
                                   ServeEngine, percentile, reference_decode,
                                   synthetic_workload)
    from repro_torch.train.runner import canary_stages, model_stage_names
    from repro_torch.viscosity import HW, SW
    from repro_torch.viscosity.lang import tree_leaves

    entry = {"canaries": canary_phase(cfg, dev)}
    out(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}")
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
    counts = {s: wrappers[s].launches for s in stages + ["checksum"]}
    check(counts["checksum"] == 0, f"{cfg.name}: the serve "
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
    last, probs = {}, {}
    for route in (HW, SW):
        m = build_model(cfg, routes={s: route for s in stages})
        probs[route] = []
        with moe_mod.observe_router(probs[route].append):
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
    if logits_check is not None:
        entry["logits_check"] = logits_check(cfg, params, params32,
                                             prompt, last)
        params32 = None
    elif cfg.moe is not None:
        # end to end, a flip's expert output moves its token far, and the
        # tokens after it through attention, so later flips follow from
        # it; from the same input, layer by layer, only the route differs
        e2e = choice_flips(cfg, probs[HW], probs[SW])
        tf_probs, attn_rel = router_teacher_forced(cfg, params, prompt)
        tf = choice_flips(cfg, tf_probs[HW], tf_probs[SW])
        entry["hw_vs_sw_logits"]["router"] = {
            "end_to_end": e2e, "teacher_forced": tf,
            "attention_worst_rel": attn_rel}
        out(f"[sw] {cfg.name} router choices HW vs SW over "
            f"{e2e['layers']} layers x {prompt.shape[1]} tokens: end to "
            f"end {e2e['flips']} flipped; layer by layer from the same "
            f"input {tf['flips']} flipped, margins there "
            f"{[f'{m_:.3e}' for m_ in tf['margins']]}, largest probability "
            f"drift on the others {tf['drift']:.3e}; attention HW vs SW "
            f"worst max_rel {attn_rel:.3e} (tol {LOGITS_REL:g})")
        check(e2e["layers"] == tf["layers"] == cfg.num_layers,
              f"{cfg.name}: recorded {e2e['layers']} router calls, want "
              f"{cfg.num_layers}")
        check(attn_rel <= LOGITS_REL, f"{cfg.name}: a layer's HW "
              "attention disagrees with the SW oracle")
        check(all(m_ < tf["drift"] for m_ in tf["margins"]),
              f"{cfg.name}: a router choice flipped where its margin "
              "exceeds the routes' probability drift")
        if not e2e["flips"]:
            check(rel <= LOGITS_REL, f"{cfg.name}: HW route logits "
                  "disagree with the SW oracle")
    else:
        check(rel <= LOGITS_REL,
              f"{cfg.name}: HW route logits disagree with the SW oracle")

    # end to end: prefill of the longest prompt, a healthy HW serve
    hw_model = build_model(cfg, routes={s: HW for s in stages})
    toks = torch.randint(0, cfg.vocab_size, (1, prefill_len),
                         generator=torch.Generator(device=dev).manual_seed(1),
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
    return entry, counts


# The model zoo (phase 11): the architectures served after the main path,
# at full width on one card, depth cut where the weights would not fit:
# (arch, layers served, fault stage).  Each is built, served and freed in
# turn.
# (arch, layers served, fault stage): the dense models cut, mistral-nemo-
# 12b, gemma2-2b and qwen2-vl-7b to about a quarter of their depth or
# less, which pays for phase 16 and phase 15's ``attn2d`` job: their ticks
# are host-bound and scale with depth; gemma2-2b keeps its alternation,
# gemma3-1b one whole 5:1 group, the MoE models four and four layers
ZOO = (("mistral-nemo-12b", 6, "swiglu_mlp"),
       ("mixtral-8x7b", 4, "flash_attention"),
       ("llama4-scout-17b-a16e", 4, "flash_attention"),
       ("gemma2-2b", 8, "flash_attention"),
       ("gemma3-1b", 6, "swiglu_mlp"),
       ("qwen2-vl-7b", 8, "flash_attention"))
ZOO_WORKLOAD = dict(min_prompt=16, max_prompt=128, min_new=8, max_new=16,
                    arrival_every=2, per_arrival=2)
ZOO_PREFILL = 128
# the ring at full width (mixtral-8x7b, gemma2-2b): a prompt longer than
# the 4096-token window, at a max_len whose windowed caches are the window
# (Smax = min(4224, 4096)) and whose global caches (gemma2's) are 4224
RING_PROMPT, RING_NEW, RING_MAX_LEN = 4200, 8, 4224


def zoo_configs():
    """(config cut to its served depth, fault stage) for each ZOO entry."""
    from repro_torch.configs import get_config
    return [(dataclasses.replace(get_config(name), num_layers=n), stage)
            for name, n, stage in ZOO]


def ring_check(cfg, dev, wrappers, params):
    """One request of ``RING_PROMPT`` tokens and ``RING_NEW`` new at
    ``RING_MAX_LEN``: a windowed layer's cache holds ``min(RING_MAX_LEN,
    window)`` slots, so the prefill wraps its ring and decode keeps
    wrapping it; a global layer's (gemma2's every other layer) holds
    ``RING_MAX_LEN`` and does not wrap.  After the serve each windowed
    layer holds the last positions written, each global layer every
    position in order.  The SW engine equals ``reference_decode`` bit for
    bit (and launches nothing); the HW prefill of the prompt makes one
    launch a layer of each kernel of the path and is timed.  Returns (its
    report entry, the HW prefill's launches)."""
    import numpy as np
    import torch

    from repro_torch.models import build_model
    from repro_torch.serve import (Request, ServeConfig, ServeEngine,
                                   reference_decode)
    from repro_torch.train.runner import model_stage_names
    from repro_torch.viscosity import HW, SW

    stages = model_stage_names(cfg)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, RING_PROMPT).astype(np.int32)
    req = Request(rid=0, prompt=prompt, max_new_tokens=RING_NEW)
    eng = ServeEngine(cfg, params, ServeConfig(
        max_len=RING_MAX_LEN, max_slots=1, hw_route=SW), device=dev)
    before = [w.launches for w in wrappers.values()]
    t0 = time.perf_counter()
    done, _ = eng.serve([req])
    sw_s = time.perf_counter() - t0
    # {kind: (layers, slots)}: one stacked cache ("all") or local + global
    kv = eng._caches if "k" not in eng._caches else {"all": eng._caches}
    slots = {n: tuple(c["k"].shape[i] for i in (0, 2)) for n, c in kv.items()}
    want = {n: RING_MAX_LEN if n == "global" else
            min(RING_MAX_LEN, cfg.window) for n in kv}
    check({n: s_ for n, (_, s_) in slots.items()} == want
          and sum(n_ for n_, _ in slots.values()) == cfg.num_layers
          and min(want.values()) < RING_PROMPT,
          f"{cfg.name}: the ring caches hold {slots} (layers, slots)")
    written = RING_PROMPT + RING_NEW - 1       # the last token is not fed
    for n, c in kv.items():
        pos = c["pos"][:, 0].sort(-1).values.cpu()
        keep = torch.arange(max(0, written - want[n]), written,
                            dtype=pos.dtype)
        got = pos[:, -keep.numel():]
        check(torch.equal(got, keep.expand_as(got))
              and bool((pos[:, :-keep.numel()] == -1).all()),
              f"{cfg.name}: the {n} caches do not hold positions "
              f"{int(keep[0])}..{written - 1}")
    ref = reference_decode(cfg, eng.params, prompt, RING_NEW,
                           max_len=RING_MAX_LEN)
    check([w.launches for w in wrappers.values()] == before,
          f"{cfg.name}: the SW route launched a kernel")
    same = done[0].tokens.tolist() == ref.tolist()
    check(same, f"{cfg.name}: the ring request differs from "
          "reference_decode")
    hw = build_model(cfg, routes={s: HW for s in stages})
    toks = torch.as_tensor(prompt[None].astype(np.int64), device=dev)
    cache = hw.init_cache(1, RING_MAX_LEN, device=dev)
    for w in wrappers.values():
        w.launches = 0
    logits, _ = hw.prefill(params, {"tokens": toks, "cache": cache})
    counts = {s: wrappers[s].launches for s in stages}
    check(counts == {s: cfg.num_layers for s in stages}
          and logits.shape == (1, 1, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"{cfg.name}: the P={RING_PROMPT} HW prefill launched {counts} "
          "or gave non-finite logits")
    ms = time_ms(torch, lambda: hw.prefill(params, {"tokens": toks,
                                                    "cache": cache}), 3)
    entry = {"prompt": RING_PROMPT, "new": RING_NEW, "max_len": RING_MAX_LEN,
             "cache_slots": min(want.values()),
             "caches": {n: {"layers": slots[n][0], "slots": slots[n][1],
                            "wraps": want[n] < written} for n in kv},
             "sw_serve_s": sw_s, "tokens": done[0].tokens.tolist(),
             "bit_identical": same, f"hw_prefill_ms_P{RING_PROMPT}": ms}
    out(f"[zoo] {cfg.name} ring: P={RING_PROMPT}, {RING_NEW} new, caches "
        f"{json.dumps(entry['caches'])}: SW engine bit-identical to "
        f"reference_decode ({sw_s:.2f} s); HW prefill {ms:.2f} ms, "
        f"launches {counts}")
    return entry, counts


# qwen2-vl's stub-frontend prefill: 16 text tokens, the 16 x 16 grid of
# merged patches that a 448 x 448 image gives at Qwen2-VL's 14-pixel
# patches merged 2 x 2 (arXiv:2409.12191), then 16 text tokens
VL_TEXT, VL_GRID = 16, 16


def image_positions3(n_before: int, rows: int, cols: int, n_after: int):
    """(S, 3) M-RoPE positions by Qwen2-VL's rule: text at t = h = w = i;
    the image at t = o, h = o + row, w = o + col, o its first position;
    the text after it resumes at the largest position + 1."""
    import numpy as np
    t = np.arange(n_before)
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    img = np.stack([np.full(rows * cols, n_before), n_before + r.ravel(),
                    n_before + c.ravel()], -1)
    t2 = img.max() + 1 + np.arange(n_after)
    return np.concatenate([np.stack([t, t, t], -1), img,
                           np.stack([t2, t2, t2], -1)]).astype(np.int32)


def image_prefill(cfg, dev, wrappers, params):
    """The stub frontend at full width: a prefill of seeded N(0, 1) bf16
    embeddings (``VL_TEXT`` text tokens, a ``VL_GRID`` x ``VL_GRID`` image,
    ``VL_TEXT`` text tokens) at ``image_positions3``, on the HW and on the
    SW route.  The HW prefill makes one attention and one SwiGLU launch a
    layer, its logits are finite and within ``LOGITS_REL`` of the SW
    route's; it is timed.  Returns (its report entry, the HW prefill's
    launches)."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.train.runner import model_stage_names
    from repro_torch.viscosity import HW, SW

    stages = model_stage_names(cfg)
    p3 = torch.as_tensor(image_positions3(VL_TEXT, VL_GRID, VL_GRID,
                                          VL_TEXT)[None], device=dev)
    S = p3.shape[1]
    gen = torch.Generator(device=dev).manual_seed(2)
    emb = torch.randn((1, S, cfg.d_model), generator=gen,
                      device=dev).to(torch.bfloat16)
    last, counts = {}, None
    for route in (HW, SW):
        m = build_model(cfg, routes={s: route for s in stages})
        batch = {"embeds": emb, "positions3": p3,
                 "cache": m.init_cache(1, S, device=dev)}
        for w in wrappers.values():
            w.launches = 0
        logits, _ = m.prefill(params, batch)
        if route == HW:
            counts = {s: wrappers[s].launches for s in stages}
            ms = time_ms(torch, lambda: m.prefill(params, batch), 3)
        last[route] = logits[0, -1].float()
        check(last[route].shape == (cfg.vocab_size,)
              and bool(torch.isfinite(last[route]).all()),
              f"{cfg.name} image prefill on {route}: logits not finite of "
              "shape (vocab,)")
    d = (last[HW] - last[SW]).abs().max().item()
    rel = d / last[SW].abs().max().item()
    entry = {"tokens": S, "text": 2 * VL_TEXT, "image": VL_GRID ** 2,
             "positions3_last": p3[0, -1].tolist(), "max_abs": d,
             "max_rel": rel, "launches": counts,
             f"hw_prefill_ms_P{S}": ms}
    out(f"[zoo] {cfg.name} image prefill: {S} embeddings ({VL_TEXT} text, "
        f"a {VL_GRID}x{VL_GRID} grid, {VL_TEXT} text; last positions3 "
        f"{entry['positions3_last']}): HW vs SW logits max_abs {d:.3e} "
        f"max_rel {rel:.3e} (tol rel {LOGITS_REL:g}); launches {counts}; "
        f"HW prefill {ms:.2f} ms")
    check(counts == {s: cfg.num_layers for s in stages},
          f"{cfg.name} image prefill launched {counts}, want one a layer")
    check(rel <= LOGITS_REL, f"{cfg.name} image prefill: HW logits "
          "disagree with the SW oracle")
    return entry, counts


def zoo_phase(configs, dev, wrappers):
    """Phase 11: each ``(config, fault stage)`` of ``configs`` on seeded
    weights drawn straight into bf16, through ``serve_path`` (its
    canaries, ``checksum_tree``, both failover modes with the transient
    and the persistent fault, the launch schedule: one attention launch a
    layer per prefill, and for a gated MLP one SwiGLU launch a layer per
    prefill and per tick; SW bit-identity, HW against SW logits with the
    router flips accounted, prefill at ``ZOO_PREFILL``, the healthy serve,
    the profiler), then, for a windowed model, ``ring_check``, and for the
    stub frontend ``image_prefill``; then its weights are freed.  Prints each model's peak memory.  Returns (report
    entry per model, launches per kernel and path)."""
    import torch

    from repro_torch.train.runner import model_stage_names

    entries, launches = {}, {name: {} for name in wrappers}
    for cfg, fault_stage in configs:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        params, _, init_s = init_weights(cfg, dev)
        init_peak = torch.cuda.max_memory_allocated()
        out(f"[zoo] {cfg.name}: {cfg.num_layers} layers, weights in bf16 "
            f"ready in {init_s:.1f} s, peak {init_peak / 2**30:.2f} GiB")
        if cfg.qk_norm:
            attn = params["layers"]["attn"]
            check("q_norm" in attn and "k_norm" in attn,
                  f"{cfg.name}: the port's own init has no qk-norm scales")
            out(f"[zoo] {cfg.name}: qk-norm scales q_norm "
                f"{tuple(attn['q_norm'].shape)} and k_norm "
                f"{tuple(attn['k_norm'].shape)} from the port's own init")
        stages = model_stage_names(cfg)
        L = cfg.num_layers
        entry, counts = serve_path(
            cfg, dev, wrappers, params, ZOO_WORKLOAD, fault_stage,
            per_prefill={s: L for s in stages},
            per_tick={s: L if s == "swiglu_mlp" else 0 for s in stages},
            prefill_len=ZOO_PREFILL)
        for name, n in counts.items():
            launches[name][cfg.name] = n
        if cfg.window:
            entry["ring"], ring = ring_check(cfg, dev, wrappers, params)
            for name, n in ring.items():
                launches[name][f"{cfg.name} ring"] = n
        if cfg.stub_frontend:
            entry["image_prefill"], image = image_prefill(cfg, dev, wrappers,
                                                          params)
            for name, n in image.items():
                launches[name][f"{cfg.name} image prefill"] = n
        del params
        gc.collect()
        torch.cuda.empty_cache()
        entry.update(init_s=init_s, init_peak_bytes=init_peak,
                     peak_bytes=torch.cuda.max_memory_allocated(),
                     layers=L, phase_s=time.perf_counter() - t0)
        out(f"[zoo] {cfg.name}: peak memory {entry['peak_bytes'] / 2**30:.2f}"
            f" GiB (init {init_peak / 2**30:.2f} GiB), "
            f"{entry['phase_s']:.1f} s")
        entries[cfg.name] = entry
    return entries, launches


# Phase 12, whisper-base at full width: 4 requests of 1500 stub frames (30 s
# of audio at the encoder's 50 frames a second, arXiv:2212.04356), a
# 4-token decoder prompt, greedy decode to max_target_len; the reference's
# prefill + decode_step bound against teacher-forced logits in f32
# (tests/test_consistency.py), over the first ENCDEC_F32_TARGET tokens
ENCDEC_FRAMES, ENCDEC_BATCH, ENCDEC_PROMPT = 1500, 4, 4
ENCDEC_F32_TOL, ENCDEC_F32_TARGET = 2e-4, 64


def encdec_phase(cfg, dev, wrappers, *, frames: int = ENCDEC_FRAMES,
                 batch: int = ENCDEC_BATCH, prompt: int = ENCDEC_PROMPT,
                 f32_target: int = ENCDEC_F32_TARGET):
    """Phase 12: an encoder-decoder model through ``EncDecModel.prefill``
    and ``decode_step``, the reference's serving contract for it (it has
    no serving engine).  Its ``flash_attention`` canary passes healthy and
    fails under each lane fault.  In f32 on the SW route, the prefill and
    every decode step to ``f32_target`` (at most ``max_target_len``) equal
    ``logits_all`` teacher-forced to ``ENCDEC_F32_TOL``.  In bf16, the HW prefill logits are
    within ``LOGITS_REL`` of the SW route's; each route decodes greedily
    to ``max_target_len``: the HW route makes ``enc + 2 dec`` attention
    launches a prefill (the encoder's, the decoder's self- and
    cross-attention) and ``dec`` a step (cross-attention at Sq = 1; a
    step's self-attention is plain), the SW route none.  Then a
    persistent fault: the canary fails every probe of ``flash_attention``
    at step ``FAULT_STEP``, the classifier calls it persistent, the model
    is rebuilt under the plan with the stage on SW, and the requests run
    again on it equal the healthy SW run's tokens bit for bit.  Prefill
    and decode-step ms are timed.  Returns (its report entry, the
    launches of the HW route's prefill, decode and probes)."""
    import torch

    from repro_torch.chaos import ChaosCanary, canary_fault
    from repro_torch.core import CanaryChecker
    from repro_torch.core.fault import PERSISTENT, FaultClassifier, FaultState
    from repro_torch.core.routing import RoutingPlan
    from repro_torch.models import build_model, compute_params
    from repro_torch.train.runner import canary_stages, model_stage_names
    from repro_torch.viscosity import HW, SW

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    stage = "flash_attention"
    stages = model_stage_names(cfg)
    check(stages == [stage], f"{cfg.name}: stages {stages}")
    T = cfg.max_target_len
    Le, Ld = cfg.enc_layers, cfg.dec_layers
    entry = {"canaries": canary_phase(cfg, dev), "frames": frames,
             "batch": batch, "prompt": prompt, "max_target_len": T}
    gen = torch.Generator(device=dev).manual_seed(0)
    params32 = build_model(cfg).init(gen, device=dev)
    params = compute_params(params32, torch.bfloat16)
    gen.manual_seed(1)
    emb = torch.randn((batch, frames, cfg.d_model), generator=gen,
                      device=dev).to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (batch, T), generator=gen,
                         device=dev)
    out(f"[encdec] {cfg.name}: {Le} + {Ld} layers, d_model {cfg.d_model}, "
        f"{batch} requests of {frames} frames, a {prompt}-token prompt, "
        f"decode to {T}")

    # f32, SW: prefill + decode_step against teacher-forced logits
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = build_model(cfg32)
    T32 = min(T, f32_target)
    full = m32.logits_all(params32, {"embeds": emb,
                                     "dec_tokens": toks[:, :T32]})
    lg, state = m32.prefill(params32, {
        "embeds": emb, "dec_tokens": toks[:, :prompt],
        "cache": m32.init_cache(batch, T, device=dev)})
    errs = [(lg[:, 0] - full[:, prompt - 1]).abs().max()]
    for t in range(prompt, T32):
        lg, state = m32.decode_step(params32, state, toks[:, t:t + 1], t)
        errs.append((lg[:, 0] - full[:, t]).abs().max())
    errs = torch.stack(errs).tolist()
    entry["f32_decode_vs_teacher_forced"] = {
        "max_abs": max(errs), "steps": len(errs) - 1,
        "max_abs_logit": full.abs().max().item()}
    out(f"[encdec] f32 SW: prefill + {len(errs) - 1} decode steps against "
        f"logits_all teacher-forced: max_abs {max(errs):.3e} (tol "
        f"{ENCDEC_F32_TOL:g}; largest logit "
        f"{entry['f32_decode_vs_teacher_forced']['max_abs_logit']:.3f})")
    check(max(errs) <= ENCDEC_F32_TOL, f"{cfg.name}: f32 decode disagrees "
          "with the teacher-forced logits")
    del full, state, params32, m32

    def greedy(model, counted=False, fault_at=None, on_fault=None):
        """Prefill the prompt, then greedy decode to ``T``.  Returns
        (tokens (B, T - prompt), prefill logits, launches of the prefill
        and of each step, the step at which ``on_fault`` stopped it)."""
        n0 = wrappers[stage].launches
        lg, st = model.prefill(params, {
            "embeds": emb, "dec_tokens": toks[:, :prompt],
            "cache": model.init_cache(batch, T, device=dev)})
        pre = wrappers[stage].launches - n0
        first = lg[:, 0].float()
        tok = lg[:, -1].argmax(-1)[:, None]
        got, per_step = [tok], []
        for t in range(prompt, T - 1):
            if fault_at is not None and t - prompt == fault_at:
                on_fault()
                return torch.cat(got, 1), first, pre, per_step, t - prompt
            n0 = wrappers[stage].launches
            lg, st = model.decode_step(params, st, tok, t)
            per_step.append(wrappers[stage].launches - n0)
            tok = lg[:, -1].argmax(-1)[:, None]
            got.append(tok)
        return torch.cat(got, 1), first, pre, per_step, None

    # bf16: SW then HW, greedy to max_target_len
    sw_model = build_model(cfg, routes={stage: SW})
    before = [w.launches for w in wrappers.values()]
    sw_toks, sw_first, *_ = greedy(sw_model)
    check([w.launches for w in wrappers.values()] == before,
          f"{cfg.name}: the SW route launched a kernel")
    for w in wrappers.values():        # counts of this path's run only
        w.launches = 0
    hw_model = build_model(cfg, routes={stage: HW})
    hw_toks, hw_first, pre, per_step, _ = greedy(hw_model)
    check(hw_toks.shape == (batch, T - prompt) and bool(
        torch.isfinite(hw_first).all()), f"{cfg.name}: HW decode gave "
        f"{tuple(hw_toks.shape)} tokens or non-finite logits")
    d = (hw_first - sw_first).abs().max().item()
    rel = d / sw_first.abs().max().item()
    agree = (hw_toks == sw_toks).float().mean().item()
    entry["hw_vs_sw_logits"] = {"max_abs": d, "max_rel": rel}
    entry["launches"] = {"prefill": pre, "per_step": sorted(set(per_step)),
                         "steps": len(per_step)}
    out(f"[encdec] bf16 HW vs SW prefill logits: max_abs {d:.3e} max_rel "
        f"{rel:.3e} (tol rel {LOGITS_REL:g}); greedy tokens agree on "
        f"{100 * agree:.2f}% of {hw_toks.numel()}; attention launches "
        f"{pre} a prefill (want {Le + 2 * Ld}) and {sorted(set(per_step))} "
        f"a step over {len(per_step)} steps (want {Ld})")
    check(rel <= LOGITS_REL, f"{cfg.name}: HW prefill logits disagree "
          "with the SW oracle")
    check(pre == Le + 2 * Ld and set(per_step) == {Ld}
          and len(per_step) == T - prompt - 1,
          f"{cfg.name}: attention launches {pre} a prefill and "
          f"{sorted(set(per_step))} a step")
    entry["greedy_agreement"] = agree

    # a persistent fault at step FAULT_STEP: the canary fails every probe,
    # the plan takes the stage to SW, the rebuilt model runs the requests
    canary = ChaosCanary(CanaryChecker(canary_stages(cfg, device=dev),
                                       route_hw=HW))
    classifier, state = FaultClassifier(canary), FaultState()
    plan = RoutingPlan.for_stages(stages, HW)
    verdict = {}

    def fault():
        n0 = wrappers[stage].launches
        canary.arm(stage, canary_fault(stage), fails=None)
        state.mark(stage, 0, kind="detected", step=FAULT_STEP)
        res = classifier.classify(stage, replica=0, step=FAULT_STEP,
                                  state=state)
        canary.disarm(stage)
        verdict.update(transient=res.transient, attempts=res.attempts,
                       probes=wrappers[stage].launches - n0)
    _, _, _, _, stopped = greedy(build_model(cfg, routes=plan),
                                 fault_at=FAULT_STEP, on_fault=fault)
    check(stopped == FAULT_STEP and verdict["transient"] is False
          and state.log[-1]["kind"] == PERSISTENT,
          f"{cfg.name}: the hard fault was not persistent: {verdict}")
    plan = plan.with_fault(stage)
    n0 = wrappers[stage].launches
    re_toks, *_ = greedy(build_model(cfg, routes=plan))
    check(wrappers[stage].launches == n0, f"{cfg.name}: the rebuilt "
          "model launched the kernel")
    same = torch.equal(re_toks, sw_toks)
    entry["failover"] = {"verdict": verdict, "plan": plan.as_dict(),
                         "bit_identical_to_sw": same}
    out(f"[encdec] persistent fault at step {FAULT_STEP}: {verdict}; "
        f"rebuilt on {plan.as_dict()}: tokens bit-identical to the healthy "
        f"SW run: {same}")
    check(same, f"{cfg.name}: the SW rebuild's tokens differ from the "
          "healthy SW run")
    counts = {stage: wrappers[stage].launches}

    # times on the HW route
    cache = hw_model.init_cache(batch, T, device=dev)
    pbatch = {"embeds": emb, "dec_tokens": toks[:, :prompt], "cache": cache}
    prefill_ms = time_ms(torch, lambda: hw_model.prefill(params, pbatch), 5)
    _, st = hw_model.prefill(params, pbatch)
    tok = toks[:, prompt:prompt + 1]
    step_ms = time_ms(torch, lambda: hw_model.decode_step(
        params, st, tok, prompt), 20)
    entry.update(prefill_ms=prefill_ms, decode_step_ms=step_ms,
                 peak_bytes=torch.cuda.max_memory_allocated(),
                 phase_s=time.perf_counter() - t0)
    out(f"[encdec] {cfg.name}: HW prefill {prefill_ms:.2f} ms ({batch} x "
        f"{frames} frames, {prompt} tokens), decode step {step_ms:.2f} ms "
        f"({batch} rows); peak memory {entry['peak_bytes'] / 2**30:.2f} "
        f"GiB; {entry['phase_s']:.1f} s")
    return entry, counts


# ---------------------------------------------------------- 13. tuning
# phase 4's qwen1.5-4b workload (6 requests on 4 slots), which phase 13
# serves three times
# phase 4's qwen1.5-4b serve: 20 of its 40 layers
SERVE_LAYERS = 20
QWEN_WORKLOAD = dict(min_prompt=16, max_prompt=128, min_new=8, max_new=16,
                     arrival_every=2, per_arrival=2)
# (kernel, model, tokens or rows): phase 13's sweep at the main path's
# shapes; the prefill shapes of the three serves join them
TUNE_CASES = (("flash_attention", "qwen1.5-4b", 128),
              ("flash_attention", "qwen1.5-4b", 2048),
              ("flash_attention", "zamba2-1.2b", 384),
              ("flash_attention", "gemma2-2b", 4200),
              ("swiglu_mlp", "qwen1.5-4b", 4),
              ("swiglu_mlp", "qwen1.5-4b", 128),
              ("swiglu_mlp", "zamba2-1.2b", 384),
              ("swiglu_mlp", "qwen2-vl-7b", 288),
              ("mamba2_ssd", "zamba2-1.2b", 384),
              ("rwkv6_wkv", "rwkv6-1.6b", 512))


def tune_shape(kernel: str, cfg, n: int):
    """The canonical tuning shape (``kernels/tuning/space.py``) of
    ``kernel`` in the model ``cfg`` at ``n`` tokens (a batch of one) or,
    for SwiGLU, ``n`` rows."""
    if kernel == "flash_attention":
        return (1, n, n, cfg.num_heads, cfg.num_kv_heads,
                cfg.resolved_head_dim)
    if kernel == "swiglu_mlp":
        return (n, cfg.d_model, cfg.d_ff)
    if kernel == "mamba2_ssd":
        from repro_torch.models.mamba2 import dims
        return (1, n, dims(cfg)[1], cfg.ssm.head_dim, cfg.ssm.state_dim)
    from repro_torch.models.rwkv6 import dims
    H, K = dims(cfg)
    return (1, n, H, K, K)


def sweep_plans(kernel: str, shape):
    """(config, launch plan) for every admissible hw config of ``kernel``
    at the canonical ``shape``: the plan the wrapper makes with those
    knobs (the scans: S padded to the chunk as their ops pad it), held to
    carry them.  The space's default is among them and is today's plan."""
    from repro_torch.kernels import tuning
    from repro_torch.kernels.flash_attention.kernel import plan as fa_plan
    from repro_torch.kernels.mamba2_scan.kernel import plan as ssd_plan
    from repro_torch.kernels.rwkv6_scan.kernel import plan as wkv_plan
    from repro_torch.kernels.swiglu.kernel import plan as sw_plan

    space = tuning.space_for(kernel, "hw")
    plans = []
    for cfg in space.configs(shape):
        if kernel == "flash_attention":
            B, Sq, Skv, H, Hkv, D = shape
            p = fa_plan(B, H, Hkv, Sq, Skv, D, D, **cfg)
            today = fa_plan(B, H, Hkv, Sq, Skv, D, D)
        elif kernel == "swiglu_mlp":
            M, D, F = shape
            p, today = sw_plan(M, D, F, D, **cfg), sw_plan(M, D, F, D)
        else:
            B, S, H = shape[:3]
            L = min(cfg["chunk"], S)
            plan_fn = ssd_plan if kernel == "mamba2_ssd" else wkv_plan
            p = plan_fn(B, -(-S // L) * L, H, L)
        check(kernel not in ("flash_attention", "swiglu_mlp")
              or p.knobs() == cfg, f"{kernel} {shape}: plan {p} for {cfg}")
        plans.append((cfg, p))
    default = space.default(shape)
    check(default in [c for c, _ in plans], f"{kernel} {shape}: the "
          f"default {default} is not admissible")
    if kernel in ("flash_attention", "swiglu_mlp"):
        check(today.knobs() == default, f"{kernel} {shape}: the space's "
              f"default {default} is not today's plan {today}")
    return plans


def tune_cases(shapes, measure_for):
    """``tune_kernel`` each (kernel, shape) of ``shapes`` into the process
    cache, scored by ``measure_for(kernel, shape)(cfg) -> us``.  Every
    admissible config must be measured (one that raised fails the phase).
    Returns a row per shape: the default and tuned configs and their us,
    the configs tried and each one's us, and whether the operands stayed in L2 from rep to
    rep (``cuda_measure``'s ``warm_l2``; None for another measure)."""
    import torch

    from repro_torch.kernels import tuning
    rows = []
    for kernel, shape in shapes:
        space = tuning.space_for(kernel, "hw")
        scored = {}
        base = measure_for(kernel, shape)

        def measure(cfg, base=base, scored=scored):
            us = base(cfg)
            scored[tuple(sorted(cfg.items()))] = us
            return us

        best, best_us = tuning.tune_kernel(kernel, "hw", shape,
                                           torch.bfloat16, measure=measure)
        configs = list(space.configs(shape))
        check(len(scored) == len(configs), f"tune {kernel} {shape}: "
              f"measured {len(scored)} of {len(configs)} admissible "
              "configs (a config raised)")
        default = space.default(shape)
        rows.append({"kernel": kernel, "shape": list(shape),
                     "default": default,
                     "default_us": scored[tuple(sorted(default.items()))],
                     "tuned": best, "tuned_us": best_us,
                     "tried": len(scored),
                     "scored": {" ".join(f"{k}={v}" for k, v in c): us
                                for c, us in scored.items()},
                     "warm_l2": getattr(base, "warm_l2", None)})
    return rows


def non_default_entries(shapes, cache):
    """Per (kernel, shape), an admissible config other than the default,
    and other than the cached (tuned) entry where a third exists; shapes
    whose space holds one config (attention at head dim 256) have none."""
    import torch

    from repro_torch.kernels import tuning
    picks = {}
    for kernel, shape in shapes:
        space = tuning.space_for(kernel, "hw")
        others = [c for c in space.configs(shape)
                  if c != space.default(shape)]
        if others:
            tuned = cache.get(kernel, "hw", shape, torch.bfloat16)
            picks[(kernel, tuple(shape))] = next(
                (c for c in others if c != tuned), others[0])
    return picks


def expected_knobs(kernel: str, record_shape, cache):
    """The knobs a launch of ``record_shape`` (a wrapper's ``plans`` key:
    attention (B, Sq, Skv, H, Hkv, D, Dv), SwiGLU (M, D, F, Do,
    row_independent)) must carry under ``cache``: its admissible entry
    where the wrapper's ``plan`` takes it, else the default plan's (a
    row-independent SwiGLU call keeps one warpgroup; a narrowed width can
    refuse an entry).  Returns (knobs, whether an entry set them)."""
    import torch

    from repro_torch.kernels import tuning
    from repro_torch.kernels.flash_attention.kernel import plan as fa_plan
    from repro_torch.kernels.swiglu.kernel import plan as sw_plan
    if kernel == "flash_attention":
        B, Sq, Skv, H, Hkv, D, Dv = record_shape
        shape = (B, Sq, Skv, H, Hkv, D)

        def make(**knobs):
            return fa_plan(B, H, Hkv, Sq, Skv, D, Dv, **knobs)
    else:
        M, D, F, Do, ri = record_shape
        shape = (M, D, F)

        def make(**knobs):
            return sw_plan(M, D, F, Do, ri, **knobs)
    entry = cache.get(kernel, "hw", shape, torch.bfloat16)
    if entry and tuning.admissible(kernel, "hw", entry, shape):
        try:
            return make(**entry).knobs(), True
        except ValueError:
            pass
    return make().knobs(), False


def check_launched_plans(records, cache, tag):
    """Every launch in ``records`` ({kernel: wrapper.plans}) carried the
    knobs ``expected_knobs`` gives under ``cache``.  Returns the launches
    whose knobs came from an entry, by kernel."""
    from_entries = {}
    for kernel, plans in records.items():
        from_entries[kernel] = 0
        for (shape, knobs), n in plans.items():
            want, hit = expected_knobs(kernel, shape, cache)
            check(dict(knobs) == want, f"{tag}: {kernel} {shape} launched "
                  f"{dict(knobs)}, want {want}")
            from_entries[kernel] += n if hit else 0
    return from_entries


def tuning_phase(dev, wrappers, tuning_dir):
    """Phase 13: the autotuner on the card.  Serve qwen1.5-4b on the HW
    route over phase 4's seeded weights and requests with an empty cache
    (every launch today's plan); sweep every admissible hw config of each
    ``TUNE_CASES`` shape and of the serve's prefill shapes (the compiled
    shared memory first, then a launch; attention and SwiGLU bit-equal to
    the default plan, healthy and under a lane fault; the scans within
    phase 2's tolerances of their plain version at each chunk);
    ``tune_kernel`` each shape into a fresh cache with ``cuda_measure``;
    serve again with the tuned cache and with every entry set to a
    non-default config.  The three serves give the same tokens; the last
    two hit the cache, and every launch carries its entry's knobs.
    Returns (its report entry, the serves' launches)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import tuning
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.flash_attention.kernel import \
        smem_bytes as fa_smem
    from repro_torch.kernels.mamba2_scan import (ssd_chunked_cuda,
                                                 ssd_ref_blocked)
    from repro_torch.kernels.mamba2_scan.kernel import c_plan as ssd_c_plan
    from repro_torch.kernels.rwkv6_scan import (wkv6_chunked_cuda,
                                                wkv6_ref_blocked)
    from repro_torch.kernels.rwkv6_scan.kernel import c_plan as wkv_c_plan
    from repro_torch.kernels.swiglu import swiglu_fused
    from repro_torch.kernels.swiglu.kernel import smem_bytes as sw_smem
    from repro_torch.kernels.tuning.cache import TuningCache
    from repro_torch.kernels.tuning.tuner import cuda_measure
    from repro_torch.serve import (RECOMPILE, ServeConfig, ServeEngine,
                                   synthetic_workload)
    from repro_torch.viscosity import HW
    from repro_torch.viscosity.lanefault import KINDS, LaneFault

    t_phase = time.perf_counter()
    qwen = get_config("qwen1.5-4b")
    params, _, init_s = init_weights(qwen, dev)
    reqs = synthetic_workload(qwen.vocab_size, 6, np.random.default_rng(0),
                              **QWEN_WORKLOAD)
    max_len = QWEN_WORKLOAD["max_prompt"] + QWEN_WORKLOAD["max_new"]
    recorded = {"flash_attention": flash_attention_bhsd,
                "swiglu_mlp": swiglu_fused}
    launches = dict.fromkeys(wrappers, 0)

    def serve(tag):
        eng = ServeEngine(qwen, params, ServeConfig(
            max_len=max_len, max_slots=4, hw_route=HW, failover=RECOMPILE),
            device=dev)
        for w in wrappers.values():
            w.launches = 0
        for w in recorded.values():
            w.plans.clear()
        s0 = tuning.stats()
        t0 = time.perf_counter()
        done, stats = eng.serve(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for name, w in wrappers.items():
            launches[name] += w.launches
        st = {k: v - s0[k] for k, v in tuning.stats().items()}
        records = {k: dict(w.plans) for k, w in recorded.items()}
        from_entries = check_launched_plans(records, tuning.get_cache(),
                                            f"tuning serve {tag}")
        out(f"[tuning] serve {tag}: {len(done)}/{len(reqs)} done in "
            f"{stats['steps']} steps, {wall:.2f} s; lookups {st}; launches "
            f"from cache entries {from_entries} of "
            f"{ {k: sum(v.values()) for k, v in records.items()} }")
        check(sorted(done) == sorted(r.rid for r in reqs),
              f"tuning serve {tag}: not every request completed")
        return ({rid: list(c.tokens) for rid, c in done.items()}, st,
                from_entries, records, wall)

    # 1. an empty cache: every launch is today's plan
    tuning.set_cache(TuningCache(os.path.join(tuning_dir, "empty")))
    tokens0, st0, hits0, records, wall0 = serve("empty cache")
    check(st0["hits"] == 0 and not any(hits0.values()),
          f"tuning: the empty cache hit {st0}")
    served = {("flash_attention", shp[:6]) for shp, _ in
              records["flash_attention"]}
    served |= {("swiglu_mlp", shp[:3]) for shp, _ in records["swiglu_mlp"]
               if not shp[4]}
    shapes = [(k, tune_shape(k, get_config(m), n)) for k, m, n in TUNE_CASES]
    shapes += sorted(s for s in served if s not in shapes)

    # 2. the sweep
    gen = torch.Generator(device=dev).manual_seed(13)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def inputs(kernel, shape):
        if kernel == "flash_attention":
            B, Sq, Skv, H, Hkv, D = shape
            q, k, v = randn(B, Sq, H, D), randn(B, Skv, Hkv, D), \
                randn(B, Skv, Hkv, D)
            return tuple(t.transpose(1, 2) for t in (q, k, v))
        if kernel == "swiglu_mlp":
            M, D, Fd = shape
            return (randn(M, D), randn(D, Fd, scale=D ** -0.5),
                    randn(D, Fd, scale=D ** -0.5),
                    randn(Fd, D, scale=Fd ** -0.5))
        if kernel == "mamba2_ssd":
            B, S, H, P, N = shape
            return (randn(B, S, H, P),
                    F.softplus(randn(B, S, H, dtype=torch.float32) - 1.0),
                    -torch.linspace(1.0, 16.0, H, device=dev),
                    randn(B, S, N, scale=0.1), randn(B, S, N, scale=0.1))
        B, S, H, K, V = shape
        lw = torch.rand((B, S, H, K), generator=gen, device=dev) \
            * (4.0 - 1e-4) - 4.0
        return (randn(B, S, H, K, scale=0.2), randn(B, S, H, K, scale=0.2),
                randn(B, S, H, V, scale=0.5), lw.to(torch.bfloat16),
                randn(H, K, scale=0.5, dtype=torch.float32))

    def call(kernel, args, cfg, fault=None):
        if kernel == "flash_attention":
            return flash_attention_bhsd(*args, causal=True, knobs=cfg,
                                        lane_fault=fault)
        if kernel == "swiglu_mlp":
            return swiglu_fused(*args, knobs=cfg, lane_fault=fault)
        fn = ssd_chunked_cuda if kernel == "mamba2_ssd" else \
            wkv6_chunked_cuda
        return fn(*args, chunk=cfg["chunk"], lane_fault=fault,
                  with_state=True)

    def close(tag, got, want, tol):
        d = (got.float() - want.float()).abs().max().item()
        rel = d / max(want.float().abs().max().item(), 1e-30)
        check(bool(torch.isfinite(got.float()).all()) and d <= tol[0]
              and rel <= tol[1], f"{tag}: max_abs {d:.3e} max_rel "
              f"{rel:.3e} (tol {tol})")
        return d

    sweep = {}
    t0 = time.perf_counter()
    for kernel, shape in shapes:
        args = inputs(kernel, shape)
        width = shape[{"swiglu_mlp": 1, "mamba2_ssd": 3}.get(kernel, -1)]
        faults = (None, LaneFault(KINDS[0], (3, width - 5), width))
        default = tuning.space_for(kernel, "hw").default(shape)
        want = {f: call(kernel, args, default, f) for f in faults}
        errs, plans = [], sweep_plans(kernel, shape)
        for cfg, p in plans:
            tag = f"tuning sweep {kernel} {shape} {cfg}"
            if kernel == "flash_attention":     # before any launch
                check(fa_smem(p.nwg, p.kd, p.vb, p.stages) == p.smem,
                      f"{tag}: compiled shared memory differs from {p}")
            elif kernel == "swiglu_mlp":
                check((sw_smem(p.nwg, 0), sw_smem(p.nwg, p.nsub))
                      == p.smem, f"{tag}: compiled rings differ from {p}")
            else:
                B, S, H = shape[:3]
                c_plan = ssd_c_plan if kernel == "mamba2_ssd" else \
                    wkv_c_plan
                check(c_plan(B, S, H, cfg["chunk"]) == p,
                      f"{tag}: the compiled plan differs from {p}")
            for f in faults:
                got = call(kernel, args, cfg, f)
                torch.cuda.synchronize()
                if kernel in ("flash_attention", "swiglu_mlp"):
                    check(torch.equal(got, want[f]), f"{tag} fault="
                          f"{f and f.kind}: bits differ from the default "
                          f"plan {default}")
                    continue
                plain = (ssd_ref_blocked if kernel == "mamba2_ssd" else
                         wkv6_ref_blocked)(*args, chunk=cfg["chunk"],
                                           lane_fault=f)
                tol = SSD_TOL if kernel == "mamba2_ssd" else WKV_TOL
                errs += [close(f"{tag} fault={f and f.kind} {part}", g, w,
                               tol)
                         for part, g, w in zip(("out", "state"), got, plain)]
        sweep[f"{kernel} {shape}"] = {
            "configs": [c for c, _ in plans],
            **({"max_abs_vs_plain": max(errs)} if errs else {})}
        out(f"[tuning] sweep {kernel} {shape}: {len(plans)} configs "
            f"launched, healthy and under a {KINDS[0]} lane fault, "
            + (f"each within phase 2's tolerance of the plain version at "
               f"its chunk (max_abs {max(errs):.3e})" if errs else
               f"each bit-equal to the default plan {default}"))
    sweep_s = time.perf_counter() - t0

    # 3. tune each shape into a fresh cache
    tuned_cache = TuningCache(os.path.join(tuning_dir, "tuned"))
    tuning.set_cache(tuned_cache)

    def measure_for(kernel, shape):
        args = inputs(kernel, shape)
        return cuda_measure(lambda cfg: lambda *a: call(kernel, a, cfg),
                            args)

    t0 = time.perf_counter()
    rows = tune_cases(shapes, measure_for)
    tune_s = time.perf_counter() - t0
    for r in rows:
        out(f"[tuning] tune {r['kernel']} {tuple(r['shape'])}: default "
            f"{r['default']} {r['default_us'] / 1e3:.4f} ms, tuned "
            f"{r['tuned']} {r['tuned_us'] / 1e3:.4f} ms, "
            f"{r['tried']} configs tried, operands "
            f"{'warm in L2' if r['warm_l2'] else 'read from HBM'} each rep")

    # 4. serve with the tuned cache, then with non-default entries
    tokens1, st1, hits1, _, wall1 = serve("tuned cache")
    picks = non_default_entries(shapes, tuned_cache)
    forced = TuningCache(os.path.join(tuning_dir, "non_default"))
    for (kernel, shape), cfg in picks.items():
        forced.put(kernel, "hw", shape, torch.bfloat16, cfg)
    tuning.set_cache(forced)
    tokens2, st2, hits2, _, wall2 = serve("non-default entries")
    check(tokens1 == tokens0 and tokens2 == tokens0,
          "tuning: the serves' tokens differ across caches")
    for tag, st, hits in (("tuned", st1, hits1),
                          ("non-default", st2, hits2)):
        check(st["hits"] > 0 and all(hits.values()), f"tuning serve {tag}:"
              f" no launch took an entry ({st}, {hits})")
    tuning.reset()
    phase_s = time.perf_counter() - t_phase
    out(f"[tuning] phase {phase_s:.2f} s (weights {init_s:.1f} s, sweep "
        f"{sweep_s:.1f} s, tune {tune_s:.1f} s); the three serves' tokens "
        "equal")
    return ({"rows": rows, "sweep": sweep,
             "serves": {"empty": {"wall_s": wall0, "lookups": st0},
                        "tuned": {"wall_s": wall1, "lookups": st1,
                                  "launches_from_entries": hits1},
                        "non_default": {
                            "wall_s": wall2, "lookups": st2,
                            "launches_from_entries": hits2,
                            "entries": {f"{k} {s}": c for (k, s), c in
                                        picks.items()}}},
             "phase_s": phase_s, "sweep_s": sweep_s, "tune_s": tune_s},
            launches)


# Phase 14: the six examples of ``examples_torch/``, each a worker process
# of its own with no ``--device`` (so on the card), all at once; and the
# dry run of phase 8's T1 cell held against what phase 8 measured
EXAMPLES = ("quickstart", "serve_with_faults", "casestudy_faults",
            "lane_fault_smoke", "elastic_train", "datacenter_sim")
# the kernels each example's path must launch (the others launch none:
# training runs SW, the fleet sweep is host arithmetic)
EXAMPLE_KERNELS = {"serve_with_faults": ("flash_attention", "swiglu_mlp"),
                   "lane_fault_smoke": ("swiglu_mlp",),
                   "casestudy_faults": ("checksum",)}
EXAMPLE_TIMEOUT_S = 300
EX_WORKER = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
             "sys.exit(chip_smoke.example_worker(sys.argv[2]))")
EX_LAUNCHES = "[example-launches] "
DRYRUN_PEAK_REL = 0.10


def example_module(name: str):
    """``examples_torch/<name>.py``, imported (``src`` on the path)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", ROOT / "examples_torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_worker(name: str) -> int:
    """Run ``examples_torch/<name>.py``'s command line with no arguments,
    the kernels' launch counters from 0, then print them as one
    ``[example-launches] {json}`` line.  Returns the example's exit code
    (a failed check raises: a non-zero exit)."""
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels.checksum import checksum_popcount
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.mamba2_scan import ssd_chunked_cuda
    from repro_torch.kernels.rwkv6_scan import wkv6_chunked_cuda
    from repro_torch.kernels.swiglu import swiglu_fused

    wrappers = {"checksum": checksum_popcount,
                "flash_attention": flash_attention_bhsd,
                "swiglu_mlp": swiglu_fused, "mamba2_ssd": ssd_chunked_cuda,
                "rwkv6_wkv": wkv6_chunked_cuda}
    mod = example_module(name)
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    rc = mod.cli([])
    wall = time.perf_counter() - t0
    sys.stdout.flush()
    print(EX_LAUNCHES + json.dumps({
        "launches": {k: w.launches for k, w in wrappers.items()},
        "wall_s": wall}), flush=True)
    return rc


def dryrun_t1(cfg, t1):
    """Phase 8's T1 cell dry-run on meta (``launch/dryrun.analyze_cell``:
    full depth, B = TRAIN_BATCH, S = TRAIN_SEQ, SW, AdamW, f32 params)
    against what phase 8 measured in this run: the param bytes exactly,
    the predicted peak within DRYRUN_PEAK_REL of
    ``max_memory_allocated``; the achieved TFLOP/s from the counted FLOPs
    and the median step."""
    import torch

    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    rec = dryrun.analyze_cell(cfg, ShapeSpec("phase8_T1", TRAIN_SEQ,
                                             TRAIN_BATCH, "train"), 1)
    step_s = t1["median_step_ms"] / 1e3
    pred, meas = rec["bytes"]["peak"], t1["peak_bytes"]
    entry = {"dryrun_s": time.perf_counter() - t0,
             "param_bytes": rec["bytes"]["params"],
             "measured_param_bytes": t1["param_bytes"],
             "predicted_peak_bytes": pred, "measured_peak_bytes": meas,
             "peak_rel_err": abs(pred - meas) / meas,
             "counted_flops": rec["flops_per_dev"],
             "model_flops": rec["model_flops"],
             "achieved_tflops": rec["flops_per_dev"] / step_s / 1e12,
             "model_tflops": rec["model_flops"] / step_s / 1e12,
             "roofline": {k: rec["roofline"][k] for k in
                          ("compute_s", "memory_s", "dominant")},
             "hbm_limit_bytes": rec["hbm_limit_bytes"], "fits": rec["fits"],
             "dryrun_hbm_bytes": dryrun.HBM_BYTES,
             "card_total_memory": torch.cuda.get_device_properties(0)
             .total_memory}
    out(f"[examples] dry run of T1 ({cfg.name}, {cfg.num_layers} layers, "
        f"B={TRAIN_BATCH} S={TRAIN_SEQ}, SW, AdamW) in "
        f"{entry['dryrun_s']:.1f} s: param bytes {entry['param_bytes']} "
        f"predicted, {entry['measured_param_bytes']} measured; peak "
        f"{pred / 2**30:.3f} GiB predicted, {meas / 2**30:.3f} GiB measured "
        f"(max_memory_allocated), rel err {entry['peak_rel_err']:.4f} (tol "
        f"{DRYRUN_PEAK_REL}); counted {rec['flops_per_dev'] / 1e12:.3f} "
        f"TFLOP a step ({rec['model_flops'] / 1e12:.3f} by 6 N tokens) over "
        f"the median step {t1['median_step_ms']:.2f} ms: achieved "
        f"{entry['achieved_tflops']:.2f} TFLOP/s ({entry['model_tflops']:.2f}"
        f" by 6 N tokens) of {PEAK_BF16_FLOPS / 1e12:.0f}; roofline compute "
        f"{rec['roofline']['compute_s'] * 1e3:.2f} ms, memory "
        f"{rec['roofline']['memory_s'] * 1e3:.2f} ms "
        f"({rec['roofline']['dominant']}); the card's total_memory "
        f"{entry['card_total_memory']}, the dry run's {dryrun.HBM_BYTES} "
        f"less {dryrun.HBM_RESERVE} reserved")
    check(entry["param_bytes"] == entry["measured_param_bytes"],
          "examples: the dry run's param bytes differ from phase 8's")
    check(entry["peak_rel_err"] <= DRYRUN_PEAK_REL,
          f"examples: the dry run's T1 peak {pred} is not within "
          f"{DRYRUN_PEAK_REL:.0%} of phase 8's {meas}")
    return entry


def examples_phase(cfg, t1, *, timeout: float = EXAMPLE_TIMEOUT_S):
    """Phase 14: the six examples as worker processes at once (each must
    exit 0 and print its OK line; its wall time and kernel launches,
    counted from 0 in its process), and meanwhile ``dryrun_t1``.  Returns
    (report entry, launches per kernel and example)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="examples_") as tmp:
        outputs = {name: (Path(tmp) / f"{name}.out",
                          Path(tmp) / f"{name}.err") for name in EXAMPLES}
        entry, ended, rcs = _run_examples(cfg, t1, outputs, t0, timeout)
        texts = {name: (o.read_text(), e.read_text())
                 for name, (o, e) in outputs.items()}
    launches = {}
    for name, (text, err) in texts.items():
        lines = text.strip().splitlines()
        check(rcs[name] == 0 and lines and lines[-1].startswith(
            EX_LAUNCHES), f"examples: {name} exited {rcs[name]}:\n"
              + "\n".join((text + err).splitlines()[-20:]))
        res = json.loads(lines[-1][len(EX_LAUNCHES):])
        ok_line = lines[-2] if len(lines) > 1 else ""
        check(ok_line.startswith("OK"),
              f"examples: {name} did not print its OK line: {ok_line!r}")
        for k in EXAMPLE_KERNELS.get(name, ()):
            check(res["launches"][k] > 0,
                  f"examples: {name} launched no {k}: {res['launches']}")
        for k, n in res["launches"].items():
            launches.setdefault(k, {})[f"example {name}"] = n
        entry["examples"][name] = {"process_s": ended[name],
                                   "main_s": res["wall_s"],
                                   "launches": res["launches"],
                                   "ok_line": ok_line}
        out(f"[examples] {name}: exit 0 in {ended[name]:.2f} s (its cli "
            f"{res['wall_s']:.2f} s), launches "
            f"{ {k: n for k, n in res['launches'].items() if n} }; "
            f"{ok_line}")
    entry["phase_s"] = time.perf_counter() - t0
    out(f"[examples] phase {entry['phase_s']:.2f} s (budget 90 s)")
    return entry, launches


def _run_examples(cfg, t1, outputs, t0, timeout):
    """Start every example's worker (stdout and stderr to ``outputs``),
    run ``dryrun_t1`` meanwhile, wait for all.  Returns (the entry with
    the dry run, seconds each took, exit codes); kills any left."""
    # six processes and this one's dry run share the host's cores
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = {}
    try:
        for name, (o, e) in outputs.items():
            with open(o, "w") as fo, open(e, "w") as fe:
                procs[name] = (subprocess.Popen(
                    [sys.executable, "-c", EX_WORKER, str(ROOT), name],
                    cwd=ROOT, stdout=fo, stderr=fe, env=env),
                    time.perf_counter())
        entry = {"dryrun_T1": dryrun_t1(cfg, t1), "examples": {}}
        ended = {}
        while len(ended) < len(procs):
            for name, (p, start) in procs.items():
                if name not in ended and p.poll() is not None:
                    ended[name] = time.perf_counter() - start
            check(time.perf_counter() - t0 <= timeout,
                  f"examples: still running after {timeout} s: "
                  f"{sorted(set(procs) - set(ended))}")
            time.sleep(0.05)
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return entry, ended, {name: p.returncode for name, (p, _) in procs.items()}


# Phase 15: tensor-parallel serving over a (1, 4) ("data", "model") mesh
# (and zamba2-1.2b again over ``attn2d``'s (1, 2, 2), TP_JOBS):
# four gloo ranks on the one card, each serving its shard of one model
# after another through ``ServeEngine`` under ``launch/spmd.py`` (seeded
# bf16 weights cut by ``partition.shard_tree``, Mamba2's packed leaves by
# component), and a lane fault on rank TP_FAULT_RANK's own kernel stage at
# step TP_FAULT_STEP, found by its canary and agreed through
# ``EventChannel``.  The models and their depths (cut so that the whole
# script stays near 1,000 s on the card): qwen1.5-4b 4 of 40 layers (5 of 20 heads, 1728 of 6912 d_ff
# columns; the fault on ``swiglu_mlp``), zamba2-1.2b 6 of 38 (one group of
# six Mamba2 layers, followed by the shared block: 16 of 64 SSD heads, 8
# of 32 attention heads, 2048 of 8192 d_ff columns; ``mamba2_ssd``),
# rwkv6-1.6b 3 of 24 (8 of 32 WKV heads; ``rwkv6_wkv``),
# whisper-base at its full 6 + 6 (``layers`` cuts ``num_layers`` only: 2 of
# 8 heads, 512 of 2048 d_ff columns; ``flash_attention``) and gemma3-1b 6
# of 26 (five local layers and its global one: 1 of 4 query heads, its
# one kv head's cache cut along the slots; ``swiglu_mlp``).
TP_MESH = (1, 4)
TP_LAYERS = {"qwen1.5-4b": 4, "zamba2-1.2b": 6, "rwkv6-1.6b": 3,
             "whisper-base": None, "gemma3-1b": 6}
# zamba2-1.2b again under the ``attn2d`` variant over (1, 2, 2) ("data",
# "model_h", "model_f"), on the same ranks: its cache cut over "model_h"
# (2 ways), its Mamba2 params over both (4 ways), so every layer moves its
# conv tail and SSM state between the two cuts; 16 of 64 SSD heads, 16 of
# 32 attention heads ("model_h"), 2048 of 8192 d_ff columns.  The same
# workload, weights, route and fault as its (1, 4) job, whose unsharded
# run it shares.
TP_VARIANT_MESH = (1, 2, 2)
TP_JOBS = tuple((a, None) for a in TP_LAYERS) + (("zamba2-1.2b", "attn2d"),)
TP_FAULT_STEP, TP_FAULT_RANK = 6, 1
TP_WORKLOAD = dict(requests=4, slots=4, min_prompt=16, max_prompt=128,
                   min_new=8, max_new=14, arrival_every=1, per_arrival=2)
# whisper-base: one batch of 4 requests of 1500 stub frames, a 4-token
# prompt and 16 decode steps; gemma3-1b: prompts of 600-640 tokens, past
# its 512 window, so the local layers' rings wrap while cut, and a max_len
# of 640 + 16 = 4 x 164, so the global layer's slots are cut too
TP_WORKLOADS = {
    "whisper-base": dict(TP_WORKLOAD, min_prompt=4, max_prompt=4,
                         min_new=16, max_new=16, frames=ENCDEC_FRAMES),
    "gemma3-1b": dict(TP_WORKLOAD, min_prompt=600, max_prompt=640,
                      max_new=16)}
TP_TIMEOUT_S = 300


def tp_spec(arch: str = "qwen1.5-4b", variant=None):
    from repro_torch.launch.tp_serve import TPServeSpec
    from repro_torch.viscosity import HW
    return TPServeSpec(arch=arch, full=True, layers=TP_LAYERS[arch],
                       dtype="bfloat16", seed=0, hw_route=HW,
                       fault_step=TP_FAULT_STEP, fault_rank=TP_FAULT_RANK,
                       variant=variant,
                       **TP_WORKLOADS.get(arch, TP_WORKLOAD))


def tp_name(arch: str, variant=None) -> str:
    """A phase-15 job's name: the arch, and its variant after an "@"."""
    return arch if variant is None else f"{arch}@{variant}"


def tp_mesh(variant=None):
    """A job's mesh on meta: (1, 4) ("data", "model"), or (1, 2, 2) over
    its variant's axes."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.tp_serve import mesh_axes_of
    return make_mesh(TP_VARIANT_MESH if variant else TP_MESH,
                     mesh_axes_of(variant),
                     devices=[torch.device("meta")] * 4)


def tp_collectives_stub(spec):
    """The dry run's counting stub for one tick of the same cell and
    depth: a decode step over the pool's slots at its max_len, one rank
    of the job's mesh (its rules and param axes) on meta.  Returns its
    bytes by kind."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.tp_serve import layout_of
    cfg, mesh = spec.config(), tp_mesh(spec.variant)
    rules, axes = layout_of(spec.variant, cfg, mesh)
    rec = dryrun.analyze_cell(
        cfg, ShapeSpec("tp_tick", spec.max_len, spec.slots, "decode"),
        mesh=mesh, rules=rules, axes=axes)
    return rec["collectives"]["bytes_by_kind"]


def tp_local_shapes(cfg, variant=None):
    """What one rank of the job's mesh holds of ``cfg`` (``tp_mesh``: (1,
    4), or (1, 2, 2) under ``variant``): its attention heads and kv heads
    (every kv head where they do not divide: their K/V are gathered), its
    d_ff columns, its SSD or WKV heads; and the ranks its cache's kv
    heads or slots, positions and recurrent states are cut over (the
    ``attn`` axis)."""
    from repro_torch.launch import spmd
    from repro_torch.launch.tp_serve import layout_of
    mesh = tp_mesh(variant)
    rules, axes = layout_of(variant, cfg, mesh)
    with spmd.spmd(mesh, rules, axes) as c:
        def cut(n, ax):
            return n // c.size(ax)
        n_kv = cfg.num_kv_heads
        out = {"heads": cut(cfg.num_heads, c.rule_axis("heads",
                                                      cfg.num_heads)),
               "kv_heads": cut(n_kv, c.rule_axis("kv_heads", n_kv)),
               "d_ff": cut(cfg.d_ff, c.param_axis("ffn", cfg.d_ff)),
               "cache_ranks": c.size(axes["attn"])}
        if cfg.family == "hybrid":
            n = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
            out["ssd_heads"] = cut(n, c.param_axis("ssm", n))
        elif cfg.family == "ssm":
            n = cfg.d_model // cfg.ssm.rwkv_head_dim
            out["wkv_heads"] = cut(n, c.param_axis("attn", cfg.d_model))
    return out


def tp_want_launches(cfg, stage, rank, n_pre, n_pre_before, n_before,
                     n_calls):
    """A rank's launches of each kernel: a layer's attention a prefill, its
    scan a prefill until the fault, its SwiGLU a call (until the fault when
    SwiGLU is the faulted stage); the faulted rank's canary once more on
    its stage."""
    L = cfg.num_layers
    want = dict.fromkeys(("flash_attention", "swiglu_mlp", "mamba2_ssd",
                          "rwkv6_wkv"), 0)
    if cfg.is_encdec:
        # the encoder's and the decoder's self- and cross-attention a
        # prefill, a step's cross-attention (its self-attention is plain)
        want["flash_attention"] = (
            (cfg.enc_layers + 2 * cfg.dec_layers) * n_pre_before
            + cfg.dec_layers * (n_before - n_pre_before))
    elif cfg.family == "hybrid":
        groups = L // cfg.shared_attn_every
        want.update(flash_attention=groups * n_pre,
                    swiglu_mlp=groups * n_calls, mamba2_ssd=L * n_pre_before)
    elif cfg.family == "ssm":
        want["rwkv6_wkv"] = L * n_pre_before
    elif cfg.moe is not None:
        # attention is the MoE family's one kernel stage, and the faulted
        # one
        want["flash_attention"] = L * n_pre_before
    else:
        want.update(flash_attention=L * n_pre, swiglu_mlp=L * n_before)
    want[stage] += rank == TP_FAULT_RANK
    return want


def tp_shape_faults(cfg, shapes, variant=None):
    """What of a rank's recorded kernel shapes is not its shard's (empty
    when every served call ran at the rank's shapes)."""
    from repro_torch.train.runner import canary_stages, model_stage_names
    loc, bad = tp_local_shapes(cfg, variant), []
    if cfg.family != "ssm":
        # the canary's probe (B, S, H, D) ports as the kernel sees them
        probe = [[list(p.shape[i] for i in (0, 2, 1, 3)) for p in st.ports[:2]]
                 for st in canary_stages(cfg, device="cpu")
                 if st.name == "flash_attention"]
        served = [qk for qk in shapes["flash_attention"]
                  if list(qk) not in probe]
        if not served or any(q[1] != loc["heads"] or k[1] != loc["kv_heads"]
                             for q, k in served):
            bad.append(f"attention ran at {shapes['flash_attention']}, not "
                       f"at {loc['heads']} heads")
    if "swiglu_mlp" in model_stage_names(cfg):
        served = [sh for sh in shapes["swiglu_mlp"]
                  if sh[0][1] == cfg.d_model]     # not the canary's probe
        if not served or any(w1 != [cfg.d_model, loc["d_ff"]]
                             or w2 != [loc["d_ff"], cfg.d_model]
                             for _, w1, w2 in served):
            bad.append(f"SwiGLU ran at {shapes['swiglu_mlp']}")
    if cfg.family == "hybrid":
        served = [sh for sh in shapes["mamba2_ssd"] if sh[0][0] == 1]
        if not served or any(
                x[2:] != [loc["ssd_heads"], cfg.ssm.head_dim]
                or b[1:] != [x[1], cfg.ssm.state_dim] for x, b in served):
            bad.append(f"the SSD ran at {shapes['mamba2_ssd']}")
    if cfg.family == "ssm":
        K = cfg.ssm.rwkv_head_dim
        served = [sh for sh in shapes["rwkv6_wkv"] if sh[0][0] == 1]
        if not served or any(r[2:] != [loc["wkv_heads"], K]
                             or u != [loc["wkv_heads"], K]
                             for r, u in served):
            bad.append(f"the WKV ran at {shapes['rwkv6_wkv']}")
    return bad


def tp_cache_faults(spec, shapes):
    """What of a rank's cache (``shapes``: its leaves' shapes by path) is
    not its share of the unsharded one's over the cache's axis (a
    quarter over (1, 4), a half over ``attn2d``'s "model_h"): each KV
    leaf's kv heads, or its slots where the kv heads do not divide the
    axis, the positions' slots where they divide it, an encoder-decoder
    model's cross-KV's kv heads, and Mamba2's conv channels and SSM heads
    (empty when all are)."""
    import torch

    from repro_torch.launch import partition
    from repro_torch.models import build_model
    cfg, meta = spec.config(), torch.device("meta")
    m = tp_local_shapes(cfg, spec.variant)["cache_ranks"]
    rows = spec.requests if cfg.is_encdec else spec.slots
    full = build_model(cfg).init_cache(rows, spec.max_len, device=meta)
    if cfg.is_encdec:
        kv = torch.empty((cfg.dec_layers, rows, spec.frames,
                          cfg.num_kv_heads, cfg.resolved_head_dim),
                         device=meta)
        full = {"self": full, "cross": (kv, kv)}
    bad = []
    for path, t in partition.flatten(full).items():
        want, name = list(t.shape), path.split("/")[-1]
        if name == "pos":
            want[-1] //= m if want[-1] % m == 0 else 1
        elif name in ("k", "v") or path.startswith("cross"):
            want[-2 if cfg.num_kv_heads % m == 0 else -3] //= m
        elif name in ("conv", "ssm"):
            want[-1 if name == "conv" else -3] //= m
        else:
            continue
        if shapes.get(path) != want:
            bad.append(f"{path} {shapes.get(path)}, want {want} of "
                       f"{list(t.shape)}")
    return bad


def tp_rwkv_reference(spec, dev, path):
    """rwkv6-1.6b's references for the ranks (see ``rwkv_logits`` in
    ``run``): the first admitted request's prompt through the unsharded
    model, layer by layer (each layer's input and its SW time-mix, saved
    to ``path`` for the ranks' ``layer_probe``), and its last-token logits
    in f32 and on the bf16 SW route."""
    import torch

    from repro_torch.models import build_model
    from repro_torch.models import layers as Lm
    from repro_torch.models import rwkv6 as rwkv_mod
    from repro_torch.models.transformer import compute_params
    from repro_torch.viscosity import SW
    cfg = spec.config()
    first = sorted(spec.workload(cfg), key=lambda r: (r.arrival, r.rid))[0]
    prompt = torch.as_tensor(first.prompt, device=dev).long()[None]
    gen = torch.Generator(device=dev).manual_seed(spec.seed)
    params32 = build_model(cfg).init(gen, device=dev)
    logits = {}
    with torch.no_grad():
        for name, dt in (("f32", "float32"), ("sw", "bfloat16")):
            m = build_model(dataclasses.replace(cfg, dtype=dt),
                            routes={"rwkv6_wkv": SW})
            p = params32 if dt == "float32" else compute_params(
                params32, torch.bfloat16)
            lg, _ = m.prefill(p, {"tokens": prompt, "cache": m.init_cache(
                1, prompt.shape[1], device=dev)})
            logits[name] = lg[0, -1].float().cpu()
        params = compute_params(params32, torch.bfloat16)
        del params32
        x = Lm.embed(params["embed"], prompt)
        probe = {"x": [], "tm": []}
        for i in range(cfg.num_layers):
            p = {k: {n: t[i] for n, t in sub.items()}
                 for k, sub in params["layers"].items()}
            h = Lm.norm(p["ln1"], x, eps=cfg.norm_eps)
            tm = rwkv_mod.time_mix(p["tm"], h, cfg, route=SW)
            probe["x"].append(x.cpu())
            probe["tm"].append(tm.float().cpu())
            x = x + tm
            x = x + rwkv_mod.channel_mix(
                p["tm"], Lm.norm(p["ln2"], x, eps=cfg.norm_eps))
    torch.save(probe, path)
    return logits


def tp_reference(arch, dev, wrappers, tmp: str, variant=None, shared=None):
    """Phase 15's unsharded run of one model, in this process, before the
    ranks: the unsharded HW engine of the same weights (whisper-base:
    ``drive_encdec`` unsharded) serves the same workload; its logits, call
    by call, are what each rank's gathered logits are held to before the
    fault (rwkv6-1.6b: also ``tp_rwkv_reference``).  Returns the model's
    job for the ranks (its files under ``tmp``; under ``variant``, on
    ``TP_VARIANT_MESH``), the run's launches, the rwkv6-1.6b references
    and the run's seconds.  ``shared``: the ``tp_reference`` of the same
    spec without the variant, whose unsharded run the job reads (nothing
    runs again; its launches are that run's)."""
    import torch

    from repro_torch.launch import tp_serve

    t0 = time.perf_counter()
    spec = tp_spec(arch, variant)
    mesh = TP_VARIANT_MESH if variant else None
    if shared is not None:
        return {**shared, "spec": spec, "ref_s": 0.0, "shared": True,
                "job": tp_serve.make_job(
                    spec, mesh=mesh, ref_logits=shared["job"]["ref_logits"])}
    d = os.path.join(tmp, tp_name(arch, variant))
    os.makedirs(d)
    for w in wrappers.values():
        w.launches = 0
    ref_path = os.path.join(d, "ref.pt")
    tp_serve.reference_run(spec, device=dev.type, path=ref_path)
    ref_launches = {n: w.launches for n, w in wrappers.items()}
    probe = e2e = None
    if spec.config().family == "ssm":
        probe = os.path.join(d, "probe.pt")
        e2e = tp_rwkv_reference(spec, dev, probe)
    gc.collect()
    torch.cuda.empty_cache()
    return {"spec": spec, "dir": d, "ref_launches": ref_launches,
            "e2e": e2e, "ref_s": time.perf_counter() - t0, "shared": False,
            "job": tp_serve.make_job(spec, mesh=mesh, ref_logits=ref_path,
                                     out_dir=d if e2e else None,
                                     layer_probe_path=probe)}


def tp_rank_faults(spec, r, stub, count: str):
    """What of one rank's report ``r`` of a served job breaks the checks
    every sharded serve is held to (empty: nothing): the fault's stage
    demoted at ``TP_FAULT_STEP`` (``spec.hw_route`` before it, SW from
    it), each kernel's launches (``tp_want_launches``, read from the
    rank's ``count``), the kernels' shapes (the rank's shard's), its
    cache (its share of the unsharded one's) and each tick's collective
    bytes (the dry run's ``stub``).  A spec on the SW route has no fault
    and launches no kernel."""
    from repro_torch.viscosity import SW
    cfg, stage, bad = spec.config(), spec.fault_stage, []
    routes, calls = r["routes"], r["calls"]
    if spec.hw_route == SW:     # every stage on SW: no fault, no kernel
        if r["fault_applied_step"] is not None or set(routes) != {SW}:
            bad.append(f"a fault at step {r['fault_applied_step']}: "
                       f"routes {routes}")
        want = dict.fromkeys(("flash_attention", "swiglu_mlp",
                              "mamba2_ssd", "rwkv6_wkv"), 0)
    else:
        if not (r["fault_applied_step"] == TP_FAULT_STEP
                and routes[:TP_FAULT_STEP] == [spec.hw_route] * TP_FAULT_STEP
                and set(routes[TP_FAULT_STEP:]) == {SW}):
            bad.append(f"demoted {stage} at step "
                       f"{r['fault_applied_step']}: routes {routes}")
        before = [c for c in calls if c["step"] < TP_FAULT_STEP]
        want = tp_want_launches(
            cfg, stage, r["rank"],
            sum(c["kind"] == "prefill" for c in calls),
            sum(c["kind"] == "prefill" for c in before), len(before),
            len(calls))
        bad += tp_shape_faults(cfg, r["kernel_shapes"], spec.variant)
    got = {k: r[count].get(k, 0) for k in want}
    if got != want:
        bad.append(f"launched {got}, want {want}")
    cache_bad = tp_cache_faults(spec, r["cache_shapes"])
    if cache_bad:
        bad.append("its cache is not its share: " + "; ".join(cache_bad))
    ticks = [c for c in calls if c["kind"] == "tick"]
    if not (ticks and all(c["bytes"] == stub for c in ticks)):
        bad.append(f"collective bytes a tick "
                   f"{[c['bytes'] for c in ticks][:2]} differ from the dry "
                   f"run's counting stub {stub}")
    return bad


def tp_model(arch, ref, res, *, count: str, backend: str = MH_BACKEND,
             tag: str = "[tp]"):
    """Phase 15's checks of one job (``arch`` its ``tp_name``): ``ref``
    its ``tp_reference``, ``res`` its four ranks' reports from the
    phase's launch over ``backend``; lines start with ``tag``.  Returns
    (entry, launches of the ranks, launches of the unsharded run)."""
    import numpy as np
    import torch

    from repro_torch.launch import tp_serve

    spec, e2e, ref_launches = ref["spec"], ref["e2e"], ref["ref_launches"]
    cfg = spec.config()
    stage = spec.fault_stage
    first = ([torch.load(os.path.join(ref["dir"], f"logits_{r['rank']}.pt"))[0]
              for r in res] if e2e else None)
    stub = tp_collectives_stub(spec)
    bad = tp_serve.check_agreement(res)
    check(not bad, f"tp {arch}: " + "; ".join(bad))
    entry = {"layers": cfg.num_layers, "fault": [TP_FAULT_STEP,
                                                 TP_FAULT_RANK, stage],
             "variant": spec.variant, "mesh": res[0]["mesh"],
             "mesh_axes": res[0]["mesh_axes"],
             "stub_tick_bytes": stub, "ranks": [],
             "reference_launches": ref_launches,
             "reference_shared": ref["shared"],
             "local": tp_local_shapes(cfg, spec.variant)}
    if e2e:
        exact = e2e["f32"]
        scale = exact.abs().max().item()
        entry["sw_vs_f32_rel"] = (e2e["sw"] - exact).abs().max().item() / \
            scale
    for r in res:
        before = [c for c in r["calls"] if c["step"] < TP_FAULT_STEP]
        rels = r["logits_rel"][:len(before)]
        check(r["world"] == 4 and r["backend"] == backend,
              f"tp {arch}: rank {r['rank']} is not one of four {backend} "
              "ranks")
        bad = tp_rank_faults(spec, r, stub, count)
        check(not bad, f"tp {arch}: rank {r['rank']}: " + "; ".join(bad))
        row = {"coords": r["coords"], "logits_rel_max": max(rels or [0.0])}
        if e2e is None:
            check(len(rels) == len(before) > 0 and max(rels) <= LOGITS_REL,
                  f"tp {arch}: rank {r['rank']}'s gathered logits against "
                  f"the unsharded engine's before the fault: {rels}")
        else:
            # rwkv6-1.6b amplifies bf16 rounding layer by layer: each
            # layer's time-mix on the rank (HW, sharded) against the
            # unsharded SW one from the same input within LOGITS_REL, and
            # the first prefill's logits no further from the f32 model's
            # than 1.25 times the bf16 SW route's
            err = (first[r["rank"]][0].float() - exact).abs().max().item() \
                / scale
            row.update(layer_time_mix_rel=r["layer_rel"],
                       hw_vs_f32_rel=err)
            check(len(rels) == len(before) > 0,
                  f"tp {arch}: rank {r['rank']} made no call before the "
                  "fault")
            check(len(r["layer_rel"]) == cfg.num_layers
                  and max(r["layer_rel"]) <= LOGITS_REL,
                  f"tp {arch}: rank {r['rank']}'s time-mix against the "
                  f"unsharded SW one, layer by layer: {r['layer_rel']}")
            check(err <= 1.25 * entry["sw_vs_f32_rel"],
                  f"tp {arch}: rank {r['rank']}'s prefill logits are "
                  f"{err:.3e} from the f32 model's, the bf16 SW route's "
                  f"{entry['sw_vs_f32_rel']:.3e}")
        calls = r["calls"]
        ticks = [c for c in calls if c["kind"] == "tick"]
        pre_ms = [c["ms"] for c in calls if c["kind"] == "prefill"]
        tick_ms = [c["ms"] for c in ticks]
        row.update({"prefill_ms": pre_ms, "tick_ms": tick_ms,
                    "tick_ms_median": float(np.median(tick_ms)),
                    "process_s": r["process_s"], "peak_gib": r["peak_gib"],
                    "launches": r["launches"],
                    "local_bytes": r["local_bytes"],
                    "cache_shapes": r["cache_shapes"],
                    "collectives": r["collectives"]})
        entry["ranks"].append(row)
        detail = (f"logits within {row['logits_rel_max']:.3e} of the "
                  "unsharded engine's before the fault" if e2e is None else
                  f"time-mix within {max(r['layer_rel']):.3e} of the "
                  f"unsharded SW one (worst layer), prefill logits "
                  f"{err:.3e} from f32 (bf16 SW {entry['sw_vs_f32_rel']:.3e})")
        out(f"{tag} {arch} rank {r['rank']} {r['coords']}: prefill ms "
            f"{[round(x, 2) for x in pre_ms]}, tick ms median "
            f"{row['tick_ms_median']:.2f} (of {len(tick_ms)}), {detail}, "
            f"launches {r['launches']}, params "
            f"{r['local_bytes']['params'] / 2**30:.3f} GiB, cache "
            f"{r['local_bytes']['cache'] / 2**20:.1f} MiB, peak "
            f"{r['peak_gib'] if r['peak_gib'] is None else round(r['peak_gib'], 2)}"
            " GiB")
    entry["tokens"] = res[0]["tokens"]
    entry["steps"] = res[0]["steps"]
    entry["reference_s"] = ref["ref_s"]
    entry["ranks_s"] = max(r["process_s"] for r in res)
    entry["model_s"] = entry["reference_s"] + entry["ranks_s"]
    launches = {n: sum(r[count].get(n, 0) for r in res)
                for n in ref_launches}
    out(f"{tag} {arch}: {len(res)} ranks agree on "
        f"{sum(map(len, entry['tokens'].values()))} tokens over "
        f"{entry['steps']} steps; {stage} demoted on every rank at step "
        f"{TP_FAULT_STEP}; collective bytes a tick {stub} on every rank, as "
        f"the dry run counts them; a rank's shard {entry['local']}; "
        f"launches {launches} (unsharded run {ref_launches}); unsharded "
        f"run {entry['reference_s']:.2f} s, ranks {entry['ranks_s']:.2f} s")
    return entry, launches, ref_launches


def tp_references(dev, wrappers, tmp: str, jobs=TP_JOBS):
    """Each job's ``tp_reference`` by ``tp_name`` (a variant's job shares
    its model's unsharded run), in this process, one after another."""
    refs = {}
    for arch, variant in jobs:
        refs[tp_name(arch, variant)] = tp_reference(
            arch, dev, wrappers, tmp, variant, shared=refs.get(arch))
    return refs


def tp_checks(refs, names, res_all, *, count: str, backend: str,
              tag: str = "[tp]"):
    """``tp_model`` of each job of a launch (``res_all`` in ``names``'
    order): (entries by name, {path: launches}: each job's ranks as "tp
    <name>" and each unsharded run as "tp <name> unsharded")."""
    models, paths = {}, {}
    for name, res in zip(names, res_all):
        models[name], launches, ref_launches = tp_model(
            name, refs[name], res, count=count, backend=backend, tag=tag)
        paths[f"tp {name}"] = launches
        if not refs[name]["shared"]:
            paths[f"tp {name} unsharded"] = ref_launches
    return models, paths


def tp_phase(dev, wrappers, smi: str, *, timeout: float = TP_TIMEOUT_S,
             count: str = "launches", jobs=TP_JOBS):
    """Phase 15 (see the constants above): each job's unsharded run in
    this process (a variant's job shares its model's), then one launch of
    the four ranks, which join their group once and serve the jobs in
    turn, each on its own mesh, then each job's checks.  Returns (report
    entry, {path: launches}: each job's ranks as "tp <name>" and each
    unsharded run as "tp <name> unsharded", ``tp_name``).  ``count`` is
    what each rank's kernel counts are read from: its wrappers'
    ``launches``, or on the CPU (where nothing launches) its recorded
    ``kernel_calls``."""
    from repro_torch.launch import tp_serve
    t0 = time.perf_counter()
    entry = {"mesh": list(TP_MESH), "variant_mesh": list(TP_VARIANT_MESH),
             "backend": MH_BACKEND, "models": {}, "nvidia_smi": smi}
    names = [tp_name(a, v) for a, v in jobs]
    with tempfile.TemporaryDirectory(prefix="tp_") as tmp:
        refs = tp_references(dev, wrappers, tmp, jobs)
        t_ranks = time.perf_counter()
        res_all = tp_serve.launch_jobs(
            [refs[n]["job"] for n in names], TP_MESH, device=dev.type,
            backend=MH_BACKEND, timeout=timeout * len(jobs), src=str(SRC))
        entry["launch_s"] = time.perf_counter() - t_ranks
        entry["models"], paths = tp_checks(refs, names, res_all, count=count,
                                           backend=MH_BACKEND)
    entry["phase_s"] = time.perf_counter() - t0
    out(f"[tp] phase {entry['phase_s']:.2f} s (the ranks' launch "
        f"{entry['launch_s']:.2f} s): " + ", ".join(
            f"{a} {e['model_s']:.2f} s" for a, e in entry["models"].items())
        + f"; {smi}")
    return entry, paths


# Phase 16: sharded training at full width (see the module docstring;
# AdamW as ``tp_train.OCFG``: a clip that binds, eps 1.0)
TPT_MESH = (2, 4)
TPT_SPEC = dict(full=True, layers=4, batch=4, seq=128, steps=2)
TPT_REF_REL = 1e-4          # a rank against the unsharded step
TPT_PAIR_REL = 1e-5         # ZeRO-1 against the baseline
TPT_TIMEOUT_S = 300


def tpt_spec(zero1: bool = False):
    from repro_torch.launch.tp_train import TPTrainSpec
    return TPTrainSpec(**TPT_SPEC, zero1=zero1)


def tpt_jobs(init: str, want: str, ready: str):
    """The ranks' two jobs: the baseline, then ZeRO-1 from the same
    initial params, held to each other; the first waits for ``ready``."""
    from repro_torch.launch.tp_train import make_job
    return [make_job(tpt_spec(), "baseline", init=init, want=want,
                     ready=ready),
            make_job(tpt_spec(True), "zero1", init=init, want=want,
                     compare="baseline")]


def tpt_stub(spec, mesh=TPT_MESH):
    """The dry run's counting stub for one step of ``spec`` on one rank of
    ``mesh`` ((2, 4)) on meta: its collective bytes by kind."""
    import torch

    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    n = mesh[0] * mesh[1]
    rec = dryrun.analyze_cell(
        spec.config(), ShapeSpec("tp_train", spec.seq, spec.batch, "train"),
        microbatch=1, zero1=spec.zero1,
        mesh=make_mesh(mesh, ("data", "model"),
                       devices=[torch.device("meta")] * n))
    return rec["collectives"]["bytes_by_kind"]


def _rel_gaps(got, want):
    return [abs(a - b) / abs(b) for a, b in zip(got, want)]


def tpt_faults(ref, ctrl, res, stubs,
               world: int = TPT_MESH[0] * TPT_MESH[1]):
    """What phase 16's ranks got wrong (empty: nothing): ``ref`` the
    unsharded run's report, ``ctrl`` the half-batch control's (held
    against ``ref``), ``res`` the ranks' reports by job (baseline, zero1),
    ``stubs`` the dry run's bytes a step by job name; ``world`` ranks."""
    bad = []
    base, zero = res
    if not (min(_rel_gaps(ctrl["grad_norms"], ref["grad_norms"]))
            > TPT_REF_REL and ctrl["vs"]["mu"] > TPT_REF_REL):
        bad.append(f"the half-batch control reads grad norms "
                   f"{ctrl['grad_norms']} against {ref['grad_norms']}, "
                   f"first moments {ctrl['vs']['mu']:.3e}: within "
                   f"{TPT_REF_REL}, so the checks cannot see a wrong "
                   "gradient")
    for job in res:
        if len(job) != world:
            bad.append(f"{len(job)} ranks, want {world}")
            continue
        for r in job:
            who = f"{r['name']} rank {r['rank']}"
            losses = [st["loss"] for st in r["steps"]]
            norms = [st["grad_norm"] for st in r["steps"]]
            for what, got, want in (("losses", losses, ref["losses"]),
                                    ("grad norms", norms,
                                     ref["grad_norms"])):
                if len(got) != len(want) or not max(
                        _rel_gaps(got, want)) <= TPT_REF_REL:
                    bad.append(f"{who}: {what} {got}, unsharded {want}")
            for what in ("params", "mu"):
                if not r["vs_want"][what] <= TPT_REF_REL:
                    bad.append(f"{who}: {what} {r['vs_want'][what]:.3e} "
                               f"from the unsharded run's (tol "
                               f"{TPT_REF_REL})")
            if "vs_compare" in r and not r["vs_compare"] <= TPT_PAIR_REL:
                bad.append(f"{who}: params {r['vs_compare']:.3e} from the "
                           f"baseline's (tol {TPT_PAIR_REL})")
            for i, st in enumerate(r["steps"]):
                if st["collectives"]["bytes"] != stubs[r["name"]]:
                    bad.append(f"{who} step {i}: collective bytes "
                               f"{st['collectives']['bytes']}, the dry "
                               f"run's stub {stubs[r['name']]}")
    if not bad:
        for b, z in zip(base, zero):
            if 2 * z["moment_bytes"] != b["moment_bytes"]:
                bad.append(f"rank {z['rank']}: moments {z['moment_bytes']} B "
                           f"under ZeRO-1, {b['moment_bytes']} B without: "
                           "not half")
    return bad


def tpt_phase(dev, smi: str, *, timeout: float = TPT_TIMEOUT_S,
              mesh=TPT_MESH, backend: str = MH_BACKEND,
              host: Optional[bool] = None, tag: str = "[tp_train]"):
    """Phase 16 (see the module docstring and the constants above) over
    ``mesh`` and ``backend`` (phase 17: (2, 2) over NCCL, a card a rank,
    its collectives timed; ``host``: the ranks' ``GroupComm``'s).
    Returns its report entry; lines start with ``tag``."""
    import torch

    from repro_torch.launch import tp_train
    import threading
    world = mesh[0] * mesh[1]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tp_train_") as tmp:
        init, want, ready = (os.path.join(tmp, f) for f in
                             ("init.pt", "want.pt", "ready"))
        # the ranks start (imports, the card, the group) while this
        # process takes the unsharded steps; their first job waits for it
        box = {}

        def ranks():
            try:
                box["res"] = tp_train.launch_ranks(
                    tpt_jobs(init, want, ready), mesh, device=dev.type,
                    backend=backend, host=host, timed=True,
                    timeout=timeout, src=str(SRC),
                    env={**os.environ, "OMP_NUM_THREADS": "1"})
            except Exception as e:  # noqa: BLE001 — raised below
                box["error"] = e
        th = threading.Thread(target=ranks)
        th.start()
        try:
            ref = tp_train.reference_run(tpt_spec(), dev.type, init=init,
                                         want=want)
            t_ref = time.perf_counter() - t0
        finally:
            open(ready, "w").close()
        # the control, while the ranks train: a wrong gradient (half of
        # each batch) against the full batch's run
        ctrl = tp_train.reference_run(
            tpt_spec(), dev.type, rows=slice(0, tpt_spec().batch // 2),
            against=want)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        stubs = {"baseline": tpt_stub(tpt_spec(), mesh),
                 "zero1": tpt_stub(tpt_spec(True), mesh)}
        th.join()
        launch_s = time.perf_counter() - t0
    if "error" in box:
        raise box["error"]
    res = box["res"]
    bad = tpt_faults(ref, ctrl, res, stubs, world)
    check(not bad, f"{tag} " + "; ".join(bad))
    for job in res:
        for r in job:
            check(r["backend"] == backend and r["world"] == world,
                  f"{tag} rank {r['rank']} is not one of {world} {backend} "
                  "ranks")
    spec = tpt_spec()
    entry = {"mesh": list(mesh), "backend": backend,
             "spec": dataclasses.asdict(spec),
             "layers": spec.config().num_layers,
             "params": ref["param_bytes"] // 4, "unsharded": ref,
             "control": ctrl,
             "unsharded_s": t_ref, "launch_s": launch_s, "stub_bytes": stubs,
             "jobs": {job[0]["name"]: job for job in res},
             "nvidia_smi": smi}
    out(f"{tag} unsharded {tp_train.ARCH} at {entry['layers']} layers "
        f"({entry['params'] / 1e9:.3f} B params), B={spec.batch} "
        f"S={spec.seq}: losses {ref['losses']}, grad norms "
        f"{ref['grad_norms']}, step ms "
        f"{[round(x, 2) for x in ref['ms']]}, moments "
        f"{ref['moment_bytes'] / 2**30:.3f} GiB, peak "
        f"{ref['peak_gib'] if ref['peak_gib'] is None else round(ref['peak_gib'], 2)}"
        f" GiB; {t_ref:.1f} s with the saves; {smi}")
    out(f"{tag} control (half of each batch): grad norms "
        f"{ctrl['grad_norms']} (relative gaps "
        f"{_rel_gaps(ctrl['grad_norms'], ref['grad_norms'])}), first "
        f"moments {ctrl['vs']['mu']:.3e} and params "
        f"{ctrl['vs']['params']:.3e} from the full batch's, against the "
        f"limit {TPT_REF_REL:g}; {smi}")
    for job in res:
        for r in job:
            out(f"{tag} {r['name']} rank {r['rank']} {r['coords']} on "
                f"{r['device']}: "
                f"step ms {[round(st['ms'], 1) for st in r['steps']]}, "
                f"losses {[st['loss'] for st in r['steps']]}, grad norms "
                f"{[st['grad_norm'] for st in r['steps']]}; params "
                f"{r['vs_want']['params']:.3e} and first moments "
                f"{r['vs_want']['mu']:.3e} from the unsharded run's"
                + (f", {r['vs_compare']:.3e} from the baseline's"
                   if "vs_compare" in r else "")
                + f", moments {r['moment_bytes'] / 2**30:.3f} GiB, params "
                f"{r['param_bytes'] / 2**30:.3f} GiB, peak "
                f"{r['peak_gib'] if r['peak_gib'] is None else round(r['peak_gib'], 2)}"
                f" GiB; bytes a step {r['steps'][0]['collectives']['bytes']}"
                f" (link {r['steps'][0]['collectives']['link_bytes']}), "
                f"collectives a step by kind (count, ms) "
                f"{[st['collective_ms'] for st in r['steps']]}")
    entry["phase_s"] = time.perf_counter() - t0
    out(f"{tag} {len(res[0])} {backend} ranks over {list(mesh)}: ZeRO-1 "
        f"within {TPT_PAIR_REL:g} of the baseline, both within "
        f"{TPT_REF_REL:g} of the unsharded run (losses, grad norms, first "
        f"moments, params), the half-batch control beyond it, moments "
        f"halved, bytes a "
        f"step the dry run's stub {stubs}; phase {entry['phase_s']:.2f} s "
        f"(the ranks' launch, overlapping the unsharded run, {launch_s:.2f} "
        f"s); {smi}")
    return entry


# Phase 17 (``--four-cards``): the tensor-parallel runtime over NCCL, one
# card a rank (see the module docstring).  (c) phase 15's jobs over NCCL,
# then under gloo on ``cuda:0`` (phase 15 as the one-card run has it); (d)
# mixtral-8x7b and llama4-scout at 4 layers and full width, f32 on SW
# (logits within ``NCCL_MOE_REL`` of the unsharded f32 run), f32 on hw
# (mixtral within ``NCCL_MOE_HW_REL`` of the unsharded f32 hw run), then
# bf16 on hw (router flips counted, mixtral's logits the control that must
# fail the f32 hw bound); (e) the same at full depth, bf16, each rank
# drawing its block alone (``TPServeSpec.keyed``); (f) phase 16 over
# (2, 2).  The MoE jobs serve phase 11's workload.
NCCL = "nccl"
NCCL_CARDS = 4
NCCL_DEVICES = [f"cuda:{i}" for i in range(NCCL_CARDS)]
NCCL_MOE = ("mixtral-8x7b", "llama4-scout-17b-a16e")
NCCL_MOE_LAYERS = 4
NCCL_MOE_FULL = {"mixtral-8x7b": 32, "llama4-scout-17b-a16e": 48}
NCCL_MOE_REL = 1e-3         # f32 on SW against the unsharded f32 run
# f32 on hw: the attention kernel rounds its f32 operands to bf16, and
# that rounding parts mixtral's ranks (their projections equal the
# unsharded run's to 1e-7) from the unsharded run by 1.9e-3 on four H100s;
# bf16's own rounding parts them by 6.6e-3 or more, so the bound tells the
# two apart.  llama4-scout's part by 1.3e-3 to 2.1e-2 a call under the
# same rounding, as far as its bf16 runs' (whose top-1 router flips at
# near-ties): its f32 hw readings print, bounded by nothing
NCCL_MOE_HW_REL = 4e-3
NCCL_MOE_HW_HELD = ("mixtral-8x7b",)
# (d)'s unsharded runs a model: (dtype, route)
NCCL_MOE_REFS = (("float32", "sw"), ("float32", "hw"), ("bfloat16", "hw"))
NCCL_MOE_WORKLOAD = dict(ZOO_WORKLOAD, requests=6, slots=4)
NCCL_TRAIN_MESH = (2, 2)
NCCL_CARD_GIB = 80.0        # a rank's peak stays under the card
NCCL_SERVE_SLACK = 0.10     # a serve's peak over its params and cache
NCCL_DRAW_SLACK = 64 << 20  # bytes over the keyed draw's bound
NCCL_TIMEOUT_S = 900
NCCL_BUDGET_S = 600         # the phase's seconds, checked


def nccl_moe_spec(arch: str, layers: int, dtype: str = "bfloat16",
                  route: str = "hw"):
    """A (d) or (e) job: ``arch`` at full width and ``layers`` deep, in
    ``dtype``, weights from ``init_keyed``, phase 11's workload; on
    ``route`` hw with phase 15's fault (a lane fault on rank 1's
    ``flash_attention``), on SW with none: the f32 SW job holds the
    sharded math to the unsharded run's without the kernel's bf16
    rounding."""
    from repro_torch.launch.tp_serve import TPServeSpec
    from repro_torch.viscosity import HW
    hw = route == HW
    return TPServeSpec(arch=arch, full=True, layers=layers, dtype=dtype,
                       seed=0, hw_route=route,
                       fault_step=TP_FAULT_STEP if hw else -1,
                       fault_rank=TP_FAULT_RANK if hw else -1, keyed=True,
                       **NCCL_MOE_WORKLOAD)


def nccl_cards() -> dict:
    """(a): each card's name and power limit, the topology, the NCCL
    version."""
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    # nvidia-smi may refuse the topology query inside a container: its
    # exit code and error stand in for the matrix then (NCCL's log below
    # names the transport it chose either way)
    got = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                         text=True)
    topo = (got.stdout.rstrip() if got.returncode == 0 else
            f"nvidia-smi topo -m exited {got.returncode}: "
            f"{(got.stdout + got.stderr).strip()}")
    version = ".".join(map(str, torch.cuda.nccl.version()))
    for i, line in enumerate(smi):
        out(f"[nccl] cuda:{i}: {line}")
    for line in topo.splitlines():
        out(f"[nccl] topo {line}")
    out(f"[nccl] NCCL {version}, {torch.cuda.device_count()} cards")
    return {"nvidia_smi": smi, "topo": topo, "nccl_version": version,
            "cards": torch.cuda.device_count()}


def nccl_transports(log_dir: str) -> list:
    """The transports NCCL's INFO log names ("via P2P/...", "via SHM",
    "via NET/...", NVLS), over every rank's log file in ``log_dir``."""
    seen = set()
    for name in sorted(os.listdir(log_dir)):
        text = Path(log_dir, name).read_text(errors="replace")
        seen.update(m.group(1) for m in re.finditer(r"via (\S+)", text))
        if "NVLS" in text:
            seen.add("NVLS")
    return sorted(seen)


def nccl_kernel_cases(dev):
    """(b)'s inputs on ``dev``, one served shape a kernel, drawn on the
    CPU from one seed (the same on every card): name -> (shape key, the
    wrapper's call, the plain version's call, the tolerance, the library
    call or None, (bytes, operations) of the bound)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.checksum import checksum_popcount, checksum_ref
    from repro_torch.kernels.flash_attention import (attention_flops,
                                                     attention_ref_blocked,
                                                     flash_attention_bhsd)
    from repro_torch.kernels.mamba2_scan import (ssd_chunked_cuda, ssd_flops,
                                                 ssd_ref_blocked)
    from repro_torch.kernels.rwkv6_scan import (wkv6_chunked_cuda,
                                                wkv6_flops, wkv6_ref_blocked)
    from repro_torch.kernels.swiglu import (swiglu_flops, swiglu_fused,
                                            swiglu_ref_blocked)
    from repro_torch.kernels.swiglu.ops import default_tiles
    gen = torch.Generator().manual_seed(17)

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen) * scale).to(dev, dtype)
    cases = {}
    ck = torch.randint(0, 256, ((64 << 20) + 3,), generator=gen,
                       dtype=torch.uint8).to(dev)
    cases["checksum"] = ("64 MiB + 3 bytes uint8",
                         lambda: checksum_popcount(ck),
                         lambda: checksum_ref(ck), None, None,
                         (ck.numel(), 0))
    # attention at the MoE ranks' prefill: mixtral-8x7b's 8 of 32 query
    # heads over 2 of 8 kv heads, llama4-scout's 10 of 40 over 2 of 8
    for arch in NCCL_MOE:
        c = get_config(arch)
        loc = tp_local_shapes(c)
        H, Hkv, D, P = loc["heads"], loc["kv_heads"], c.resolved_head_dim, \
            ZOO_PREFILL
        q, k, v = randn(1, H, P, D), randn(1, Hkv, P, D), randn(1, Hkv, P, D)
        cases[f"flash_attention {arch}"] = (
            f"B=1 H={H} Hkv={Hkv} P={P} D={D} causal",
            lambda q=q, k=k, v=v: flash_attention_bhsd(q, k, v),
            lambda q=q, k=k, v=v: attention_ref_blocked(q, k, v),
            ATTN_TOL,
            lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True),
            ((2 * q.numel() + 2 * k.numel()) * 2,
             attention_flops(1, P, P, H, D)))
    # SwiGLU at phase 15's qwen1.5-4b rank (the MoE ranks launch none)
    qwen = get_config("qwen1.5-4b")
    Dm, Ff, M = qwen.d_model, tp_local_shapes(qwen)["d_ff"], 4
    x = randn(M, Dm)
    w1, w3 = randn(Dm, Ff, scale=Dm ** -0.5), randn(Dm, Ff, scale=Dm ** -0.5)
    w2 = randn(Ff, Dm, scale=Ff ** -0.5)
    tiles = dict(zip(("bm", "bf", "bs"), default_tiles(M, Ff)))
    cases["swiglu_mlp"] = (
        f"qwen1.5-4b rank M={M} {Dm}->{Ff}->{Dm}",
        lambda: swiglu_fused(x, w1, w3, w2, **tiles),
        lambda: swiglu_ref_blocked(x, w1, w3, w2, **tiles), SWIGLU_TOL,
        lambda: (F.silu(x @ w1) * (x @ w3)) @ w2,
        ((x.numel() + 3 * w1.numel() + M * Dm) * 2, swiglu_flops(M, Dm, Ff)))
    # the scans at phase 15's ranks: 16 of zamba2's 64 SSD heads, 8 of
    # rwkv6's 32 WKV heads
    Bt, S, H, Pd, N = TP_SSD_CASES[0]
    xs = randn(Bt, S, H, Pd)
    dt = F.softplus(randn(Bt, S, H, dtype=torch.float32) - 1.0)
    A = -torch.linspace(1.0, 16.0, H).to(dev)
    Bm, Cm = randn(Bt, S, N, scale=0.1), randn(Bt, S, N, scale=0.1)
    cases["mamba2_ssd"] = (
        f"B={Bt} S={S} H={H} P={Pd} N={N} chunk=128, final state",
        lambda: ssd_chunked_cuda(xs, dt, A, Bm, Cm, chunk=128,
                                 with_state=True),
        lambda: ssd_ref_blocked(xs, dt, A, Bm, Cm, chunk=128), SSD_TOL, None,
        ((xs.numel() * 2 + Bm.numel() * 4 + dt.numel() * 4 + xs.numel() * 2
          + Bt * H * N * Pd * 4), ssd_flops(Bt, S, H, Pd, N)))
    Bt, S, H, K, V, _ = TP_WKV_CASES[0]
    r, kk = randn(Bt, S, H, K, scale=0.2), randn(Bt, S, H, K, scale=0.2)
    vv = randn(Bt, S, H, V, scale=0.5)
    lw = (torch.rand((Bt, S, H, K), generator=gen) * (4.0 - 1e-4) - 4.0
          ).to(dev, torch.bfloat16)
    u = randn(H, K, scale=0.5, dtype=torch.float32)
    cases["rwkv6_wkv"] = (
        f"B={Bt} S={S} H={H} K=V={K} chunk=16, final state",
        lambda: wkv6_chunked_cuda(r, kk, vv, lw, u, chunk=16,
                                  with_state=True),
        lambda: wkv6_ref_blocked(r, kk, vv, lw, u, chunk=16), WKV_TOL, None,
        ((r.numel() * 3 + vv.numel() * 2 + u.numel() * 2 + Bt * H * K * V * 2)
         * 2, wkv6_flops(Bt, S, H, K, V)))
    return cases


def _outputs(res):
    """A kernel call's result as a list of tensors."""
    import torch
    if isinstance(res, torch.Tensor):
        return [res]
    return [t for t in res if t is not None]


def nccl_kernel_parity(wrappers) -> dict:
    """(b): each kernel at one shape it serves on ``cuda:1`` to ``cuda:3``
    from this process, whose current device stays ``cuda:0``: each call
    launches once on that card (its wrapper's counter), its outputs lie
    there, agree with its plain version there within phase 2's bounds
    (the checksum: equal), and equal bit for bit the same call on
    ``cuda:0``.  Then each kernel's ms on ``cuda:1`` (CUDA events, the
    card current while timing) beside its plain version's, the library
    call's and its bound.  Returns the numbers by case."""
    import torch
    check(torch.cuda.device_count() >= NCCL_CARDS,
          f"--four-cards: {torch.cuda.device_count()} cards")
    torch.cuda.set_device(0)
    home = {name: [t.cpu() for t in _outputs(call())]
            for name, (_, call, *_) in nccl_kernel_cases(
                torch.device("cuda", 0)).items()}
    torch.cuda.synchronize(0)
    report = {}
    for i in range(1, NCCL_CARDS):
        dev = torch.device("cuda", i)
        for name, (shape, call, plain, tol, lib, (nb, ops)) in \
                nccl_kernel_cases(dev).items():
            kernel = name.split()[0]
            before = wrappers[kernel].launches
            got = _outputs(call())
            torch.cuda.synchronize(dev)
            launched = wrappers[kernel].launches - before
            want = _outputs(plain())
            check(torch.cuda.current_device() == 0,
                  f"nccl {name} on {dev}: the current device moved to "
                  f"cuda:{torch.cuda.current_device()}")
            check(launched == 1 and all(t.device == dev for t in got),
                  f"nccl {name} on {dev}: {launched} launches, outputs on "
                  f"{[str(t.device) for t in got]}")
            if tol is None:
                err = max(abs(int(a) - int(b)) for a, b in zip(got, want))
                ok = err == 0
            else:
                err = max((a.float() - b.float()).abs().max().item()
                          for a, b in zip(got, want))
                ref = max(b.float().abs().max().item() for b in want)
                ok = err <= tol[0] and err / max(ref, 1e-30) <= tol[1]
            same = all(torch.equal(a.cpu(), b)
                       for a, b in zip(got, home[name]))
            out(f"[nccl] parity {name} {shape} on {dev} (current cuda:0): "
                f"max_abs {err:.3e} against the plain version (tol "
                f"{tol or 'equal'}), bits equal to cuda:0's: {same}")
            check(ok, f"nccl {name} on {dev} disagrees with its plain "
                  "version")
            check(same, f"nccl {name} on {dev}: bits differ from cuda:0's")
            row = report.setdefault(name, {"shape": shape, "max_abs_err": 0.0,
                                           "cards": {}})
            row["max_abs_err"] = max(row["max_abs_err"], float(err))
            row["cards"][str(dev)] = {"max_abs_err": float(err),
                                      "bits_as_cuda0": same}
            if i == 1:
                with torch.cuda.device(dev):
                    ms_, by = bound(nb, ops)
                    row.update(
                        ms=time_ms(torch, call, 20),
                        plain_ms=time_ms(torch, plain, 3, warmup=1),
                        library_ms=(time_ms(torch, lib, 20) if lib else
                                    None),
                        bound_ms=ms_, bound_by=by)
                out(f"[nccl] times {name} {shape} on {dev}: ms "
                    f"{row['ms']:.4f} plain {row['plain_ms']:.4f} library "
                    f"{row['library_ms']} bound {row['bound_ms']:.5f} "
                    f"({row['bound_by']})")
    return report


def nccl_param_bounds(spec) -> dict:
    """One rank's figures of a keyed job over ``TP_MESH`` on meta: its
    param block's bytes, and the most its keyed draw may hold (the block,
    one layer of it, and the largest layer leaf's transient: the leaf in
    f32, its block in f32 and in the model's dtype; or the embedding
    table in f32 and in the model's dtype, drawn first)."""
    import torch

    from repro_torch.launch import partition
    from repro_torch.models import build_model
    cfg, mesh = spec.config(), tp_mesh()
    dt = getattr(torch, cfg.dtype)
    meta = build_model(cfg).init(torch.Generator().manual_seed(0),
                                 device=torch.device("meta"), dtype=dt)
    specs = partition.flatten(partition.params_pspecs(meta, mesh))

    def block(path, t):
        return math.prod(partition.local_shape(t.shape, specs[path], mesh))
    params = layer = leaf = 0
    for path, t in partition.flatten(meta).items():
        n = block(path, t)
        params += n * t.element_size()
        if path.startswith("layers/"):
            L = t.shape[0]
            layer += n // L * t.element_size()
            leaf = max(leaf, (t.numel() + n) // L * 4
                       + n // L * t.element_size())
    table = meta["embed"]["table"]
    first = table.numel() * (4 + table.element_size())
    return {"params": params, "draw": params + layer + max(leaf, first)
            + NCCL_DRAW_SLACK}


def nccl_moe_references(tmp: str, dev, wrappers):
    """(d)'s unsharded runs on ``cuda:0``, one after another, each freed
    before the next: per model and ``NCCL_MOE_REFS`` entry, its logits
    (what the ranks of the same dtype and route are held to) and, in
    bf16, its router probabilities (what the bf16 ranks' router choices
    are counted against).  Returns {(arch, dtype, route): {"path", "res",
    "s", "launches"}}."""
    import torch

    from repro_torch.launch import tp_serve
    refs = {}
    for arch in NCCL_MOE:
        for dtype, route in NCCL_MOE_REFS:
            t0 = time.perf_counter()
            for w in wrappers.values():
                w.launches = 0
            path = os.path.join(tmp, f"{arch}_{dtype}_{route}.pt")
            res = tp_serve.reference_run(
                nccl_moe_spec(arch, NCCL_MOE_LAYERS, dtype, route),
                device=dev, path=path, router=dtype == "bfloat16")
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            ref = refs[arch, dtype, route] = {
                "path": path, "s": time.perf_counter() - t0, "res": res,
                "launches": {n: w.launches for n, w in wrappers.items()}}
            out(f"[nccl] unsharded {arch} {NCCL_MOE_LAYERS} layers {dtype} "
                f"route {route} on {dev}: {res['steps']} steps, peak "
                f"{res['peak_gib']} GiB, {ref['s']:.1f} s")
    return refs


def nccl_moe_jobs(tmp: str, refs) -> list:
    """The ranks' (d) and (e) jobs, in order: per model f32 on SW and on
    hw (each held to its unsharded run's logits), bf16 (its router
    probabilities saved for the count; the checksum of layers 0-3), then
    full depth (the same checksum)."""
    from repro_torch.launch import tp_serve
    jobs = []
    for arch in NCCL_MOE:
        d = os.path.join(tmp, f"{arch}_ranks")
        os.makedirs(d, exist_ok=True)
        for route in ("sw", "hw"):
            jobs.append((f"d f32 {route}", arch, tp_serve.make_job(
                nccl_moe_spec(arch, NCCL_MOE_LAYERS, "float32", route),
                ref_logits=refs[arch, "float32", route]["path"])))
        jobs.append(("d bf16", arch, tp_serve.make_job(
            nccl_moe_spec(arch, NCCL_MOE_LAYERS),
            ref_logits=refs[arch, "bfloat16", "hw"]["path"], out_dir=d,
            router=True, checksum_layers=NCCL_MOE_LAYERS)))
    for arch in NCCL_MOE:
        jobs.append(("e", arch, tp_serve.make_job(
            nccl_moe_spec(arch, NCCL_MOE_FULL[arch]),
            checksum_layers=NCCL_MOE_LAYERS)))
    return jobs


def nccl_router_flips(cfg, ref_router, rank_router, n_calls: int):
    """Per layer, the tokens whose top-k experts differ between a rank's
    bf16 run and the unsharded one over their first ``n_calls`` calls
    (phase 11's ``choice_flips``, layer by layer; a call's router entries
    are layer-major): {"flips": [per layer], "margins", "drift"}."""
    L = cfg.num_layers
    per_layer = [[[], []] for _ in range(L)]
    for i in range(n_calls):
        mine, theirs = rank_router[i], ref_router[i]
        check(len(mine) == len(theirs) and len(mine) % L == 0,
              f"nccl router: call {i} has {len(mine)} router entries, the "
              f"unsharded run {len(theirs)}")
        rows = len(mine) // L
        for j, (a, b) in enumerate(zip(mine, theirs)):
            per_layer[j // rows][0].append(a)
            per_layer[j // rows][1].append(b)
    flips = [choice_flips(cfg, a, b) for a, b in per_layer]
    return {"flips": [f["flips"] for f in flips],
            "margins": [m for f in flips for m in f["margins"]],
            "drift": max(f["drift"] for f in flips)}


def _completes(spec, res) -> list:
    """What of the workload a rank left unfinished (empty: every request
    emitted its token budget)."""
    want = {str(r.rid): r.max_new_tokens
            for r in spec.workload(spec.config())}
    got = {k: len(v) for k, v in res["tokens"].items()}
    return [] if got == want else [f"tokens {got}, want {want}"]


def nccl_logits_faults(rels, n_calls: int, limit: float, what: str) -> list:
    """What a rank's gathered logits break against its unsharded run's
    (empty: they hold): ``rels`` is each call's max |logits - ref| / max
    |ref|, held to ``limit`` over the first ``n_calls`` calls (those
    before a fault, every call without one)."""
    held = rels[:n_calls]
    if len(held) == n_calls > 0 and max(held) <= limit:
        return []
    return [f"gathered logits against the unsharded {what} run's over "
            f"{n_calls} calls: {[f'{x:.3e}' for x in held]} (limit "
            f"{limit:g})"]


def nccl_moe_checks(kind, arch, spec, res, stub, *, count, backend=NCCL,
                    router_dir=None, ref_router=None, bounds=None,
                    checksums=None):
    """(d) or (e)'s checks of one MoE job's ranks (``kind`` "d f32 sw",
    "d f32 hw", "d bf16" or "e"), beside phase 15's shared ones
    (``tp_rank_faults``): the ranks agree; each completes every request;
    f32 on SW: each call's gathered logits within ``NCCL_MOE_REL`` of the
    unsharded run's; f32 on hw (``NCCL_MOE_HW_HELD``): each call before
    the fault within ``NCCL_MOE_HW_REL``; bf16: the router flips against
    the unsharded bf16 run, per layer (printed, not bounded), and (held
    models) its logits before the fault, the control, fail the f32 hw
    check (``nccl_logits_faults``);
    (e): the param block the meta's, the peak
    under the card, the serve's within ``NCCL_SERVE_SLACK`` of params +
    cache, the draw's within its bound, the checksum of layers 0-3 the
    (d) bf16 job's on the same rank.  ``router_dir`` holds the bf16
    ranks' router files.  Each rank's line prints before its checks.
    Returns the job's entry."""
    import numpy as np
    import torch

    from repro_torch.launch import tp_serve
    cfg = spec.config()
    name = f"{kind} {arch}"
    entry = {"layers": cfg.num_layers, "dtype": cfg.dtype, "ranks": [],
             "stub_tick_bytes": stub, "tokens": res[0]["tokens"],
             "steps": res[0]["steps"]}
    gib = 2 ** 30
    for r in res:
        bad = tp_rank_faults(spec, r, stub, count) + _completes(spec, r)
        if not (r["backend"] == backend and not r["host_copies"]
                and (backend != NCCL or r["device"] == f"cuda:{r['rank']}"
                     and r["mesh_devices"] == NCCL_DEVICES)):
            bad.append(f"on {r['device']} over {r['backend']}, host "
                       f"copies {r['host_copies']}, mesh over "
                       f"{r['mesh_devices']}")
        before = [c for c in r["calls"] if c["step"] < TP_FAULT_STEP]
        ticks = [c["ms"] for c in r["calls"] if c["kind"] == "tick"]
        pre = [c["ms"] for c in r["calls"] if c["kind"] == "prefill"]
        toks = sum(map(len, r["tokens"].values()))
        row = {"coords": r["coords"], "prefill_ms": pre, "tick_ms": ticks,
               "tick_ms_median": float(np.median(ticks)),
               "tok_s": toks / r["wall_s"], "wall_s": r["wall_s"],
               "draw_s": r["draw_s"], "peak_gib": r["peak_gib"],
               "draw_peak_gib": r["draw_peak_gib"],
               "serve_peak_gib": r["serve_peak_gib"],
               "local_bytes": r["local_bytes"], "launches": r["launches"],
               "collectives": r["collectives"],
               "checksum_layers": r.get("checksum_layers")}
        rels = r["logits_rel"]
        held = arch in NCCL_MOE_HW_HELD
        if kind.startswith("d f32"):
            sw = kind == "d f32 sw"     # no fault: every call
            n = len(r["calls"]) if sw else len(before)
            limit = NCCL_MOE_REL if sw else NCCL_MOE_HW_REL
            row["logits_rel_max"] = max(rels[:n] or [0.0])
            detail = (f", logits within {row['logits_rel_max']:.3e} of the "
                      f"unsharded f32 {spec.hw_route} run's over {n} calls "
                      + (f"(limit {limit:g})" if sw or held else
                         f"({[f'{x:.3e}' for x in rels[:n]]}, not bounded: "
                         "not in NCCL_MOE_HW_HELD)"))
            if sw or held:
                bad += nccl_logits_faults(rels, n, limit,
                                          f"f32 {spec.hw_route}")
        elif kind == "d bf16":
            mine = torch.load(os.path.join(router_dir,
                                           f"router_{r['rank']}.pt"))
            row["router"] = nccl_router_flips(cfg, ref_router, mine,
                                              len(before))
            row["control_rel_max"] = max(rels[:len(before)] or [0.0])
            detail = (f", router flips by layer {row['router']['flips']} "
                      f"against the unsharded bf16 run over "
                      f"{len(before)} calls; logits within "
                      f"{row['control_rel_max']:.3e} of its"
                      + (f", the control (fails the f32 hw limit "
                         f"{NCCL_MOE_HW_REL:g})" if held else ""))
            if held and not nccl_logits_faults(rels, len(before),
                                               NCCL_MOE_HW_REL, "bf16"):
                bad.append("the bf16 control passes the f32 hw logits "
                           "check: it cannot tell bf16's rounding from "
                           "the kernel's")
        else:
            params, cache = r["local_bytes"]["params"], \
                r["local_bytes"]["cache"]
            detail = (f", draw {r['draw_s']:.1f} s (peak "
                      f"{_gib(r['draw_peak_gib'])} GiB, bound "
                      f"{bounds['draw'] / gib:.2f}), serve peak "
                      f"{_gib(r['serve_peak_gib'])} GiB (params "
                      f"{params / gib:.2f} + cache {cache / gib:.3f}), "
                      f"layers 0-{NCCL_MOE_LAYERS - 1} checksum "
                      f"{r['checksum_layers']}, at 4 layers "
                      f"{checksums[r['rank']]}")
            for ok, what in (
                    (params == bounds["params"],
                     f"params {params} B, its block {bounds['params']} B"),
                    (r["peak_gib"] is None or r["peak_gib"] < NCCL_CARD_GIB,
                     f"peak {r['peak_gib']} GiB"),
                    (r["serve_peak_gib"] is None or r["serve_peak_gib"] * gib
                     <= (1 + NCCL_SERVE_SLACK) * (params + cache),
                     "the serve's peak over params and cache"),
                    (r["draw_peak_gib"] is None
                     or r["draw_peak_gib"] * gib <= bounds["draw"],
                     "the draw's peak over its bound"),
                    (r["checksum_layers"] == checksums[r["rank"]],
                     "layers 0-3's checksum is not the 4-layer job's")):
                if not ok:
                    bad.append(what)
        entry["ranks"].append(row)
        out(f"[nccl] {name} rank {r['rank']} on {r['device']}: prefill ms "
            f"{[round(x, 1) for x in pre]}, tick ms median "
            f"{row['tick_ms_median']:.1f} (of {len(ticks)}), "
            f"{row['tok_s']:.1f} tok/s, peak {_gib(r['peak_gib'])} GiB"
            f"{detail}; launches {r['launches']}")
        check(not bad, f"nccl {name} rank {r['rank']}: " + "; ".join(bad))
    bad = tp_serve.check_agreement(res)
    check(not bad, f"nccl {name}: " + "; ".join(bad))
    fault = (f"{spec.fault_stage} demoted at step {TP_FAULT_STEP} on every "
             "rank" if spec.fault_step >= 0 else f"route {spec.hw_route}, "
             "no fault")
    out(f"[nccl] {name}: {len(res)} ranks agree on "
        f"{sum(map(len, entry['tokens'].values()))} tokens over "
        f"{entry['steps']} steps, every request complete, {fault}, "
        f"collective bytes a tick {stub} as the dry run counts them")
    return entry


def _gib(x):
    return None if x is None else round(x, 2)


KERNEL_SOURCES = {
    "checksum": ("src/repro_torch/csrc/checksum.cu",
                 "src/repro/kernels/checksum/kernel.py:17"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:33"),
    "swiglu_mlp": ("src/repro_torch/csrc/swiglu.cu",
                   "src/repro/kernels/swiglu/kernel.py:32"),
    "mamba2_ssd": ("src/repro_torch/csrc/mamba2_ssd.cu",
                   "src/repro/kernels/mamba2_scan/kernel.py:28"),
    "rwkv6_wkv": ("src/repro_torch/csrc/rwkv6_wkv.cu",
                  "src/repro/kernels/rwkv6_scan/kernel.py:27")}


def nccl_phase(dev, wrappers, smi: str, *, count: str = "launches",
               backend: str = NCCL, host: Optional[bool] = None,
               jobs=TP_JOBS, gloo_too: bool = True,
               timeout: float = NCCL_TIMEOUT_S):
    """Phase 17's (c)-(f) (see the constants above): every unsharded run
    first, in this process on ``dev`` (``cuda:0``), each freed before the
    next; then one launch of four ``backend`` ranks, a card a rank
    (``host``: their ``GroupComm``'s), that serves (c)'s jobs (phase
    15's ``jobs``) and (d)'s and (e)'s in turn, the first collectives
    logged by NCCL (its transports); each job's checks; (c)'s jobs again
    under gloo on the one card (``gloo_too``); then (f), under
    ``backend`` and (``gloo_too``) gloo.  Returns (entry, {path:
    launches})."""
    import threading

    import torch

    from repro_torch.launch import tp_serve
    t0 = time.perf_counter()
    entry, paths = {"backend": backend, "mesh": list(TP_MESH)}, {}
    names = [tp_name(a, v) for a, v in jobs]
    with tempfile.TemporaryDirectory(prefix="nccl_") as tmp:
        refs = tp_references(dev, wrappers, tmp, jobs)
        moe_refs = nccl_moe_references(tmp, dev, wrappers)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        entry["references_s"] = time.perf_counter() - t0
        for name in names:
            if not refs[name]["shared"]:
                paths[f"nccl {name} unsharded"] = refs[name]["ref_launches"]
        for (arch, dtype, route), ref in moe_refs.items():
            paths[f"nccl {arch} {dtype} {route} unsharded"] = \
                ref["launches"]
        c_jobs = [refs[n]["job"] for n in names]
        moe_jobs = nccl_moe_jobs(tmp, moe_refs)
        log_dir = os.path.join(tmp, "nccl_log")
        os.makedirs(log_dir)
        env = {**os.environ, "OMP_NUM_THREADS": "1"}
        if backend == NCCL:
            env.update(NCCL_DEBUG="INFO", NCCL_DEBUG_FILE=os.path.join(
                log_dir, "nccl.%h.%p.log"))
        # the dry run's stubs of the MoE jobs, while the ranks serve
        stubs, box = {}, {}

        def ranks():
            try:
                box["res"] = tp_serve.launch_jobs(
                    c_jobs + [j for _, _, j in moe_jobs], TP_MESH,
                    device=dev.type, backend=backend, host=host,
                    timeout=timeout, src=str(SRC), env=env)
            except Exception as e:  # noqa: BLE001 — raised below
                box["error"] = e
        t1 = time.perf_counter()
        th = threading.Thread(target=ranks)
        th.start()
        for kind, arch, job in moe_jobs:
            spec = tp_serve.TPServeSpec(**job["spec"])
            stubs[kind, arch] = tp_collectives_stub(spec)
        bounds = {arch: nccl_param_bounds(nccl_moe_spec(
            arch, NCCL_MOE_FULL[arch])) for arch in NCCL_MOE}
        th.join()
        entry["launch_s"] = time.perf_counter() - t1
        if "error" in box:
            raise box["error"]
        res_all = box["res"]
        if dev.type == "cuda":      # kept whatever the checks below say
            (ROOT / "chiprun_out").mkdir(exist_ok=True)
            (ROOT / "chiprun_out" / "chip_smoke_four_cards_ranks.json"
             ).write_text(json.dumps(res_all, default=str))
        entry["transports"] = (nccl_transports(log_dir) if backend == NCCL
                               else [])
        out(f"[nccl] transports NCCL chose (its INFO log): "
            f"{entry['transports']}")
        entry["groups_s"] = [r["groups_s"] for r in res_all[0]]
        entry["c"], c_paths = tp_checks(refs, names, res_all[:len(names)],
                                        count=count, backend=backend,
                                        tag="[nccl] (c)")
        if gloo_too:        # the same jobs, every rank on the one card
            t1 = time.perf_counter()
            res = tp_serve.launch_jobs(
                c_jobs, TP_MESH, device=dev.type, backend=MH_BACKEND,
                timeout=timeout, src=str(SRC))
            entry["c_gloo_launch_s"] = time.perf_counter() - t1
            entry["c_gloo"], gloo_paths = tp_checks(
                refs, names, res, count=count, backend=MH_BACKEND,
                tag="[nccl] (c) gloo")
            paths.update({f"nccl gloo {p[3:]}": n
                          for p, n in gloo_paths.items()
                          if not p.endswith("unsharded")})
        paths.update({f"nccl {p[3:]}": n for p, n in c_paths.items()
                      if not p.endswith("unsharded")})
        for name in names:
            for r, row in zip(res_all[names.index(name)],
                              entry["c"][name]["ranks"]):
                check(backend != NCCL or r["device"] == f"cuda:{r['rank']}"
                      and not r["host_copies"]
                      and r["mesh_devices"] == NCCL_DEVICES,
                      f"nccl (c) {name}: rank {r['rank']} on {r['device']}"
                      f", host copies {r['host_copies']}, mesh over "
                      f"{r['mesh_devices']}")
                g = (entry["c_gloo"][name]["ranks"][r["rank"]]
                     if gloo_too else None)
                out(f"[nccl] (c) {name} rank {r['rank']} on {r['device']}: "
                    f"prefill ms {[round(x, 1) for x in row['prefill_ms']]}"
                    f", tick ms median {row['tick_ms_median']:.2f}"
                    + (f"; gloo on one card: prefill ms "
                       f"{[round(x, 1) for x in g['prefill_ms']]}, tick ms "
                       f"median {g['tick_ms_median']:.2f}" if g else ""))
        entry["moe"], checksums = {}, {}
        for (kind, arch, job), res in zip(moe_jobs, res_all[len(names):]):
            spec = tp_serve.TPServeSpec(**job["spec"])
            e = nccl_moe_checks(
                kind, arch, spec, res, stubs[kind, arch], count=count,
                backend=backend, router_dir=job["out_dir"],
                ref_router=(torch.load(moe_refs[arch, "bfloat16", "hw"][
                    "path"])["router"] if kind == "d bf16" else None),
                bounds=bounds.get(arch), checksums=checksums.get(arch))
            if kind == "d bf16":
                checksums[arch] = [row["checksum_layers"]
                                   for row in e["ranks"]]
            entry["moe"][f"{kind} {arch}"] = e
            paths[f"nccl {kind} {arch}"] = {
                n: sum(r[count].get(n, 0) for r in res) for n in wrappers}
    entry["f"] = tpt_phase(dev, smi, mesh=NCCL_TRAIN_MESH, backend=backend,
                           host=host, tag="[nccl] (f)")
    if gloo_too:
        entry["f_gloo"] = tpt_phase(dev, smi, mesh=NCCL_TRAIN_MESH,
                                    backend=MH_BACKEND,
                                    tag="[nccl] (f) gloo")
    entry["phase_s"] = time.perf_counter() - t0
    return entry, paths


def nccl_kernel_line(parity, paths) -> list:
    """The ``kernels`` line of a ``--four-cards`` run: each kernel's (b)
    numbers (attention's at mixtral-8x7b's rank, llama4-scout's beside
    them) and its launches on phase 17's paths, counted from 0 on each."""
    kernels = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        key = "flash_attention mixtral-8x7b" if name == "flash_attention" \
            else name
        row = parity[key]
        by_path = {p: n[name] for p, n in paths.items() if n.get(name)}
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 "max_abs_err": max(v["max_abs_err"] for k, v in
                                    parity.items()
                                    if k.split()[0] == name),
                 **{k: row[k] for k in ("shape", "ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "library_ms")}}
        if name == "flash_attention":
            entry["moe_shapes"] = {k: v for k, v in parity.items()
                                   if k.startswith("flash_attention ")}
        kernels.append(entry)
    return kernels


def run_four_cards() -> int:
    """Phase 17 alone (``--four-cards``; the module docstring): it needs
    four cards and never skips."""
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.launch.tp_serve import kernel_wrappers
    n = torch.cuda.device_count()
    if n < NCCL_CARDS:
        raise SystemExit(f"chip_smoke --four-cards: {n} card(s); phase 17 "
                         f"runs one rank a card on {NCCL_CARDS}")
    torch.cuda.set_device(0)
    dev = resolve_device("cuda:0")
    wrappers = kernel_wrappers()
    report = {"device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}
    out(f"device {report['device']} x {n} torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t0 = time.perf_counter()
    built = _build.build()
    report["build_s"] = time.perf_counter() - t0
    out(f"[build] {report['build_s']:.1f} s for {sorted(built)} -> "
        f"{_build.build_dir()}")
    t_phase = time.perf_counter()
    report["cards"] = nccl_cards()
    smi = "; ".join(report["cards"]["nvidia_smi"])
    report["parity"] = nccl_kernel_parity(wrappers)
    report["nccl"], paths = nccl_phase(dev, wrappers, smi)
    report["phase_s"] = phase_s = time.perf_counter() - t_phase
    out(f"[times] phases (s): 17 nccl {phase_s:.1f} (of it: references "
        f"{report['nccl']['references_s']:.1f}, ranks' serve launch "
        f"{report['nccl']['launch_s']:.1f}); {smi}")
    check(phase_s <= NCCL_BUDGET_S, f"phase 17 took {phase_s:.1f} s, over "
          f"its {NCCL_BUDGET_S} s")
    kernels = nccl_kernel_line(report["parity"], paths)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_four_cards.json").write_text(
        json.dumps(report, indent=1, default=str))
    for line in report["cards"]["nvidia_smi"]:
        out(line)
    out(json.dumps({"kernels": kernels}))
    out(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run phase 17 alone: the tensor-parallel runtime "
                         "over NCCL, one rank a card on four cards")
    args = ap.parse_args()
    if not (SRC / "repro_torch" / "csrc").is_dir():
        raise SystemExit("chip_smoke: run from the root of a checkout "
                         "(src/repro_torch is missing)")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA GPU")
    sys.path.insert(0, str(SRC))
    # a hermetic tuning cache: no phase reads a cache file left in the
    # checkout (the worker processes of phase 9 inherit the variable)
    with tempfile.TemporaryDirectory(prefix="repro_tuning_") as tuning_dir:
        os.environ["REPRO_TUNING_CACHE"] = tuning_dir
        from repro_torch.kernels import tuning
        tuning.reset()
        return run_four_cards() if args.four_cards else run(tuning_dir)


def run(tuning_dir: str) -> int:
    """The phases, in order; ``tuning_dir`` is the process's tuning-cache
    directory (empty)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core import (CanaryChecker, FaultState,
                                  StagedAccelerator, inject)
    from repro_torch.core import casestudies as cs
    from repro_torch.core import latency
    from repro_torch.core.stage import Stage
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build
    from repro_torch.kernels.checksum import checksum_popcount, checksum_ref
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
    from repro_torch.kernels.swiglu.kernel import plan as swiglu_plan
    from repro_torch.kernels.swiglu.kernel import ring_bytes
    from repro_torch.kernels.swiglu.kernel import \
        smem_bytes as swiglu_smem_bytes
    from repro_torch.kernels.swiglu.ops import default_tiles
    from repro_torch.models import build_model
    from repro_torch.train.runner import model_stage_names
    from repro_torch.viscosity import HW, SW
    from repro_torch.viscosity.lanefault import KINDS, LaneFault
    from repro_torch.viscosity.lang import tree_map

    dev = resolve_device("cuda")
    report = {"device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda}
    out(f"device {report['device']} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    wrappers = {"checksum": checksum_popcount,
                "flash_attention": flash_attention_bhsd,
                "swiglu_mlp": swiglu_fused, "mamba2_ssd": ssd_chunked_cuda,
                "rwkv6_wkv": wkv6_chunked_cuda}

    phase_s, lap_t = {}, [time.perf_counter()]

    def lap(name):
        """Record the seconds since the last lap as phase ``name``."""
        now = time.perf_counter()
        phase_s[name] = now - lap_t[0]
        lap_t[0] = now

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
    # every SwiGLU plan phase 11 launches (mistral-nemo-12b 5120 -> 14336,
    # gemma2-2b 2304 -> 9216, gemma3-1b 1152 -> 6912 and qwen2-vl-7b
    # 3584 -> 18944: prefill rows 16-128, decode rows 1-4, the windowed
    # models' ring prefill of 4200, qwen2-vl's image prefill of 288), and
    # phase 14's serve_with_faults' (128 -> 256), takes a ring checked above
    zoo = [c for c, _ in zoo_configs()]
    mistral = next(c for c in zoo if "swiglu_mlp" in model_stage_names(c))
    gemma = next(c for c in zoo if c.name == "gemma2-2b")
    gemma3 = next(c for c in zoo if c.name == "gemma3-1b")
    qwen_vl = next(c for c in zoo if c.stub_frontend)
    vl_tokens = 2 * VL_TEXT + VL_GRID ** 2
    # phase 14's serve_with_faults: the shapes phase 2 holds its kernels
    # to are its model's and its workload's
    serve_ex = example_module("serve_with_faults")
    serve_cfg = get_config(serve_ex.ARCH).reduced()
    served_ex = dict(
        heads=(serve_cfg.num_heads, serve_cfg.num_kv_heads,
               serve_cfg.resolved_head_dim),
        mlp=(serve_cfg.d_model, serve_cfg.d_ff),
        min_prompt=serve_ex.WORKLOAD["min_prompt"],
        prompts=tuple(sorted({len(r.prompt)
                              for r in serve_ex.requests(serve_cfg)})),
        slots=serve_ex.SLOTS)
    check(served_ex == SERVE_EXAMPLE, f"serve_with_faults serves "
          f"{served_ex}, the parity cases hold {SERVE_EXAMPLE}")
    # phase 15's ranks: qwen1.5-4b's and zamba2-1.2b's heads and d_ff cut
    # four ways (2560 -> 1728, 2048 -> 2048)
    def rank_config(arch, variant=None):
        c = get_config(arch)
        loc = tp_local_shapes(c, variant)
        return dataclasses.replace(
            c, name=f"{arch} {variant or f'tp{TP_MESH[1]}'}",
            num_heads=loc["heads"], num_kv_heads=loc["kv_heads"],
            d_ff=loc["d_ff"])
    qwen_tp, zamba_tp = rank_config("qwen1.5-4b"), rank_config("zamba2-1.2b")
    zamba_2d = rank_config("zamba2-1.2b", "attn2d")
    whisper_tp, gemma3_tp = (rank_config("whisper-base"),
                             rank_config("gemma3-1b"))
    g3_prompts = range(TP_WORKLOADS["gemma3-1b"]["min_prompt"],
                       TP_WORKLOADS["gemma3-1b"]["max_prompt"] + 1)
    for c in (mistral, gemma, gemma3, qwen_vl, serve_cfg, qwen_tp, zamba_tp,
              gemma3_tp):
        rows_ = list(range(1, ZOO_WORKLOAD["max_prompt"] + 1)) + (
            list(g3_prompts) if c is gemma3_tp else [])
        for M in rows_ + ([vl_tokens] if c.stub_frontend else []) + (
                [RING_PROMPT] if c.window else []):
            pl = swiglu_plan(M, c.d_model, c.d_ff, c.d_model,
                             row_independent=M <= 4)
            check(pl.path == "wgmma" and pl.smem == (
                rings[f"nwg={pl.nwg} nsub=0"],
                rings[f"nwg={pl.nwg} nsub={pl.nsub}"]),
                f"swiglu plan {c.name} M={M}: {pl}")
            if M in (4, ZOO_PREFILL, vl_tokens, RING_PROMPT,
                     TP_GEMMA3_PROMPT):
                out(f"[build] swiglu {c.name} M={M}: {pl}")
    out(f"[build] swiglu dynamic shared memory by ring (nsub 0: phase A), "
        f"as the plan computes it: {rings}")
    # attention: every plan this run launches (the parity cases below, the
    # serving prompts, the timed shapes)
    qwen, zamba = get_config("qwen1.5-4b"), get_config("zamba2-1.2b")
    qh, qd = qwen.num_heads, qwen.resolved_head_dim
    zh, zd = zamba.num_heads, zamba.resolved_head_dim
    attn_shapes = {(B_, H_, Hkv_, Sq_, Skv_, -(-D_ // 8) * 8, -(-Dv_ // 8) * 8)
                   for B_, Sq_, Skv_, H_, Hkv_, D_, Dv_, _
                   in ATTN_CASES + TP_ATTN_CASES
                   + TP_WHISPER_GEMMA3_ATTN_CASES + TP_ATTN2D_ATTN_CASES}
    attn_shapes |= {(1, qh, qh, P_, P_, qd, qd) for P_ in range(16, 129)}
    for c in (qwen_tp, zamba_tp, zamba_2d):
        cd = c.resolved_head_dim
        attn_shapes |= {(1, c.num_heads, c.num_kv_heads, P_, P_, cd, cd)
                        for P_ in range(TP_WORKLOAD["min_prompt"],
                                        TP_WORKLOAD["max_prompt"] + 1)}
    attn_shapes |= {(1, zh, zh, P_, P_, zd, zd) for P_ in range(96, 385)}
    for c in zoo:                       # phase 11's prompts and the ring
        cd = c.resolved_head_dim
        attn_shapes |= {(1, c.num_heads, c.num_kv_heads, P_, P_, cd, cd)
                        for P_ in range(ZOO_WORKLOAD["min_prompt"],
                                        ZOO_WORKLOAD["max_prompt"] + 1)}
        if c.window:
            attn_shapes.add((1, c.num_heads, c.num_kv_heads, RING_PROMPT,
                             RING_PROMPT, cd, cd))
    attn_shapes.add((1, qwen_vl.num_heads, qwen_vl.num_kv_heads, vl_tokens,
                     vl_tokens, qwen_vl.resolved_head_dim,
                     qwen_vl.resolved_head_dim))
    # phase 12's: the encoder, the prompt's self- and cross-attention and a
    # decode step's cross-attention
    whisper = get_config("whisper-base")
    wh, wd = whisper.num_heads, whisper.resolved_head_dim
    for Sq_, Skv_ in ((ENCDEC_FRAMES, ENCDEC_FRAMES),
                      (ENCDEC_PROMPT, ENCDEC_PROMPT),
                      (ENCDEC_PROMPT, ENCDEC_FRAMES), (1, ENCDEC_FRAMES)):
        for c in (whisper, whisper_tp):       # phase 15's rank too
            attn_shapes.add((ENCDEC_BATCH, c.num_heads, c.num_kv_heads, Sq_,
                             Skv_, wd, wd))
    # phase 15's gemma3-1b rank: its 600-640-token prompts
    attn_shapes |= {(1, gemma3_tp.num_heads, gemma3_tp.num_kv_heads, P_, P_,
                     gemma3.resolved_head_dim, gemma3.resolved_head_dim)
                    for P_ in g3_prompts}
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
                  for Bt_, S_, H_, *_ in WKV_CASES + TP_WKV_CASES}
    wkv_shapes |= {(1, S_, rwkv.num_heads, 16) for S_ in range(16, 513, 16)}
    ssd_shapes = {(Bt_, -(-S_ // min(128, S_)) * min(128, S_), H_,
                   min(128, S_))
                  for Bt_, S_, H_, *_ in SSD_CASES + TP_SSD_CASES}
    ssd_shapes |= {(1, S_, zh_ssd, S_) for S_ in range(96, 128)}
    ssd_shapes |= {(1, 128 * k, zh_ssd, 128) for k in (1, 2, 3)}
    # phase 15's ranks: a quarter of the heads at every served prompt
    tp_prompts = range(TP_WORKLOAD["min_prompt"], TP_WORKLOAD["max_prompt"]
                       + 1)
    ssd_shapes |= {(1, S_, tp_local_shapes(zamba)["ssd_heads"], S_)
                   for S_ in tp_prompts}
    wkv_shapes |= {(1, -(-S_ // 16) * 16, tp_local_shapes(rwkv)["wkv_heads"],
                    16) for S_ in tp_prompts}
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

    lap("1 build")
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
    def wkv_parity(cases):
        for Bt, S, H, K, V, clamp in cases:
            r, k, v, lw, u = wkv_inputs(Bt, S, H, K, V, clamp)
            L = min(16, S)
            pad = (L - S % L) % L
            rp, kp, vp, lwp = (F.pad(t, (0, 0, 0, 0, 0, pad))
                               for t in (r, k, v, lw))
            p_ = wkv_plan(Bt, S + pad, H, L)
            for kind in (None,) + KINDS:
                fault = (None if kind is None
                         else LaneFault(kind, (3, 17, V - 1), V))
                tag = (f"rwkv6_wkv B={Bt} S={S} H={H} K={K} V={V}"
                       f"{' lw=-4' if clamp else ''} fault={kind} "
                       f"(G={p_.group}"
                       f", {p_.grids} blocks)")
                o, state = wkv6_chunked_cuda(rp, kp, vp, lwp, u, chunk=16,
                                             lane_fault=fault, with_state=True)
                torch.cuda.synchronize()
                o = o[:, :S]
                check(bool(torch.isfinite(o.float()).all()),
                      f"{tag}: non-finite o")
                want_o, want_state = wkv6_ref_blocked(rp, kp, vp, lwp, u,
                                                      chunk=16,
                                                      lane_fault=fault)
                max_err["rwkv6_wkv"] = max(
                    max_err["rwkv6_wkv"],
                    compare(f"{tag} o", o, want_o[:, :S], WKV_TOL),
                    compare(f"{tag} state", state, want_state, WKV_TOL))
                if fault is None:   # the token-by-token oracle, unpadded
                    scan_o, scan_state = wkv6_scan_ref(r, k, v, lw, u)
                    compare(f"{tag} o vs scan", o, scan_o, WKV_TOL)
                    compare(f"{tag} state vs scan", state, scan_state, WKV_TOL)
                    o2, state2 = wkv6_chunked_cuda(rp, kp, vp, lwp, u,
                                                   chunk=16,
                                                   with_state=True)
                    same = torch.equal(o, o2[:, :S]) and torch.equal(state,
                                                                     state2)
                    out(f"[parity] {tag} two calls bit-identical: {same}")
                    check(same, f"{tag}: two calls differ")

    wkv_parity(WKV_CASES)

    def ssd_inputs(Bt, S, H, P, N):
        # in the scan's domain: dt = softplus(.) > 0, A < 0 (zamba2's
        # A = -exp(A_log) spans -1 .. -16)
        return (randn(Bt, S, H, P),
                F.softplus(randn(Bt, S, H, dtype=torch.float32) - 1.0),
                -torch.linspace(1.0, 16.0, H, device=dev),
                randn(Bt, S, N, scale=0.1), randn(Bt, S, N, scale=0.1))

    # chunk 128 throughout; S padded to a multiple of L with dt = 0 as the
    # op pads
    def ssd_parity(cases):
        for Bt, S, H, P, N in cases:
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
                tag = (f"mamba2_ssd B={Bt} S={S} H={H} P={P} fault="
                       f"{fault and (fault.kind, fault.gain)} ({p_.grids} "
                       "blocks)")
                y, state = ssd_chunked_cuda(xp, dtp, A, Bp, Cp, chunk=128,
                                            lane_fault=fault, with_state=True)
                torch.cuda.synchronize()
                y = y[:, :S]
                check(not bool(torch.isnan(y.float()).any()),
                      f"{tag}: NaN in y")
                want_y, want_state = ssd_ref_blocked(xp, dtp, A, Bp, Cp,
                                                     chunk=128,
                                                     lane_fault=fault)
                max_err["mamba2_ssd"] = max(
                    max_err["mamba2_ssd"],
                    compare(f"{tag} y", y, want_y[:, :S], SSD_TOL),
                    compare(f"{tag} state", state, want_state, SSD_TOL))
                if fault is None:   # the token-by-token oracle, unpadded
                    scan_y, scan_state = ssd_scan_ref(x, dt, A, Bm, C)
                    compare(f"{tag} y vs scan", y, scan_y, SSD_TOL)
                    compare(f"{tag} state vs scan", state, scan_state, SSD_TOL)
                    y2, state2 = ssd_chunked_cuda(xp, dtp, A, Bp, Cp,
                                                  chunk=128,
                                                  with_state=True)
                    same = torch.equal(y, y2[:, :S]) and torch.equal(state,
                                                                     state2)
                    out(f"[parity] {tag} two calls bit-identical: {same}")
                    check(same, f"{tag}: two calls differ")

    ssd_parity(SSD_CASES)

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

    def ssd_rank_views(Bt, S):
        """x, B and C as a phase-15 rank passes them: x a view of the
        rank's (B, S, (d_inner + 2N) / 4) conv output (row stride 1056 at
        zamba2-1.2b), B and C the two halves of the stacked tensor the
        gather over the model axis returns (every head reads all N)."""
        H = tp_local_shapes(zamba)["ssd_heads"]
        P, N = zamba.ssm.head_dim, zamba.ssm.state_dim
        m = TP_MESH[1]
        xbc = randn(Bt, S, H * P + 2 * N // m)
        bc = randn(2, Bt, S, N, scale=0.1)
        return (xbc[..., :H * P].reshape(Bt, S, H, P),
                F.softplus(randn(Bt, S, H, dtype=torch.float32) - 1.0),
                -torch.linspace(1.0, 16.0, H, device=dev), bc[0], bc[1])

    def ssd_rank_view_parity():
        """A rank's views, read in place, against contiguous copies."""
        for Bt, S in ((1, 384), (1, 77)):
            xs, dt, A, Bv, Cv = ssd_rank_views(Bt, S)
            check(all(strided_ready(t) for t in (xs, Bv, Cv))
                  and not xs.is_contiguous(),
                  f"mamba2_ssd rank views B={Bt} S={S}: not read in place")
            P = xs.shape[-1]
            for fault in [None] + [LaneFault(kind, (3, 17, P - 1), P)
                                   for kind in KINDS]:
                tag = (f"mamba2_ssd tp rank views B={Bt} S={S} H={xs.shape[2]}"
                       f" fault={fault and fault.kind}")
                got = ssd_chunked_cuda(xs, dt, A, Bv, Cv, chunk=min(128, S),
                                       lane_fault=fault, with_state=True)
                want = ssd_chunked_cuda(xs.contiguous(), dt, A, Bv.contiguous(),
                                        Cv.contiguous(), chunk=min(128, S),
                                        lane_fault=fault, with_state=True)
                torch.cuda.synchronize()
                same = all(torch.equal(g_, w_) for g_, w_ in zip(got, want))
                out(f"[parity] {tag}: bit-identical to contiguous copies: "
                    f"{same}")
                check(same, f"{tag}: differs from contiguous copies")
                ref_y, ref_state = ssd_ref_blocked(xs, dt, A, Bv, Cv,
                                                   chunk=min(128, S),
                                                   lane_fault=fault)
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

    def replica_tiles(M, Ff):
        """``default_tiles``, but a long prefill's rows in one block, not
        M / 8: the replica's row tile only groups rows, and no row's sums
        depend on it."""
        bm, bf, bs = default_tiles(M, Ff)
        return (M if M > 384 else bm), bf, bs

    def swiglu_parity(Dm, Ff, rows, Do=None, tag="", act="silu"):
        w1, w3, w2 = swiglu_weights(Dm, Ff)
        w2 = w2[:, :Do or Dm]           # a narrow w2 is a strided view
        Do = w2.shape[1]
        for M in rows:
            x = randn(M, Dm)
            bm, bf, bs = replica_tiles(M, Ff)
            for kind in (None,) + KINDS:
                fault = None if kind is None else LaneFault(
                    kind, (5, max(0, Do - 60)), Do)
                got = swiglu_fused(x, w1, w3, w2, act=act, lane_fault=fault)
                torch.cuda.synchronize()
                want = swiglu_ref_blocked(x, w1, w3, w2, act=act, bm=bm,
                                          bf=bf, bs=bs, lane_fault=fault)
                max_err["swiglu_mlp"] = max(
                    max_err["swiglu_mlp"],
                    compare(f"swiglu {act} {Dm}->{Ff}->{Do}{tag} M={M} "
                            f"fault={kind}", got, want, SWIGLU_TOL))

    def swiglu_bits(cfg, prefill_rows, act="silu"):
        """Row independence: each row of an M=4 ``row_independent`` call
        equals that row run alone; and the same call twice gives the same
        bits, at decode and at prefill."""
        w1, w3, w2 = swiglu_weights(cfg.d_model, cfg.d_ff)
        x = randn(4, cfg.d_model)
        y = swiglu_fused(x, w1, w3, w2, act=act, row_independent=True)
        rows_ok = all(torch.equal(y[i:i + 1], swiglu_fused(
            x[i:i + 1], w1, w3, w2, act=act, row_independent=True))
            for i in range(4))
        runs_ok = torch.equal(y, swiglu_fused(x, w1, w3, w2, act=act,
                                              row_independent=True))
        xp = randn(prefill_rows, cfg.d_model)
        runs_ok &= torch.equal(swiglu_fused(xp, w1, w3, w2, act=act),
                               swiglu_fused(xp, w1, w3, w2, act=act))
        out(f"[parity] swiglu {cfg.name}: rows of an M=4 row-independent "
            f"call equal M=1 calls bit for bit: {rows_ok}; run to run (M=4 "
            f"and M={prefill_rows}) bit for bit: {runs_ok}")
        check(rows_ok, f"swiglu {cfg.name}: a row depends on the batch")
        check(runs_ok, f"swiglu {cfg.name}: two runs gave other bits")

    for B_, Sq, Skv, H, Hkv, D, Dv, kw in ATTN_CASES:
        attention_parity(B_, Sq, Skv, H, Hkv, D, Dv, kw)
    swiglu_parity(qwen.d_model, qwen.d_ff, (1, 4, 200))
    # phase 15's rank: 2560 -> 1728 -> 2560 (a partial sum), its decode
    # rows and its longest prompt
    swiglu_parity(qwen_tp.d_model, qwen_tp.d_ff, (1, 4, 128),
                  tag=" (tp rank)")
    swiglu_parity(zamba.d_model, zamba.d_ff, (4, 384))
    # a narrow w2 (61 lanes, as DEGRADED_REDUCED slices it) and the canary
    # stage's (64, 64) x (64, 128) x (128, 64)
    swiglu_parity(qwen.d_model, qwen.d_ff, (4, 200), Do=61, tag=" (narrow)")
    swiglu_parity(64, 128, (64,), tag=" (canary)")
    # lane_fault_smoke's reduced-width run: lanes 3 and 7 of 64 sliced out
    swiglu_parity(64, 128, (64,), Do=62, tag=" (lane_fault_smoke reduced)")
    # serve_with_faults: its decode rows and prompt lengths
    sd, sf = SERVE_EXAMPLE["mlp"]
    swiglu_parity(sd, sf, tuple(range(1, SERVE_EXAMPLE["slots"] + 1))
                  + SERVE_EXAMPLE["prompts"], tag=" (serve_with_faults)")
    swiglu_bits(serve_cfg, max(SERVE_EXAMPLE["prompts"]))
    swiglu_bits(qwen, 200)
    swiglu_bits(qwen_tp, 128)
    swiglu_bits(zamba, 384)
    swiglu_parity(mistral.d_model, mistral.d_ff, (4, 16, ZOO_PREFILL))
    swiglu_bits(mistral, ZOO_PREFILL)
    # gemma2-2b's GeGLU (tanh-gelu, act = 1 in csrc/swiglu.cu)
    swiglu_parity(gemma.d_model, gemma.d_ff, (4, ZOO_PREFILL, RING_PROMPT),
                  act="gelu")
    # gemma3-1b's GeGLU 1152 -> 6912 (its ring prefill too) and qwen2-vl-7b's
    # SwiGLU 3584 -> 18944 (its image prefill too: nwg = 3 there)
    swiglu_parity(gemma3.d_model, gemma3.d_ff, (4, ZOO_PREFILL, RING_PROMPT),
                  act="gelu")
    swiglu_bits(gemma3, RING_PROMPT, act="gelu")
    swiglu_parity(qwen_vl.d_model, qwen_vl.d_ff, (4, ZOO_PREFILL, vl_tokens))
    swiglu_bits(qwen_vl, vl_tokens)
    # phase 15's zamba2-1.2b and rwkv6-1.6b ranks, after every case above
    # (the generator's draws of those stay as they were): the WKV at 8
    # heads, the SSD at 16 (contiguous, and on a rank's views), the shared
    # block's attention at 8 heads of 64 and its SwiGLU 2048 -> 2048 ->
    # 2048 (a partial sum) at its decode rows and its unsharded serve's
    # prefill rows
    wkv_parity(TP_WKV_CASES)
    ssd_parity(TP_SSD_CASES)
    ssd_rank_view_parity()
    for B_, Sq, Skv, H, Hkv, D, Dv, kw in TP_ATTN_CASES:
        attention_parity(B_, Sq, Skv, H, Hkv, D, Dv, kw)
    swiglu_parity(zamba_tp.d_model, zamba_tp.d_ff, (4, 384),
                  tag=" (tp rank)")
    swiglu_bits(zamba_tp, 384)
    # phase 15's whisper-base and gemma3-1b ranks, after every case above:
    # attention at their rank shapes, and gemma3-1b's GeGLU 1152 -> 1728
    # -> 1152 (a partial sum) at its decode rows and a 600-token prefill
    for B_, Sq, Skv, H, Hkv, D, Dv, kw in TP_WHISPER_GEMMA3_ATTN_CASES:
        attention_parity(B_, Sq, Skv, H, Hkv, D, Dv, kw)
    swiglu_parity(gemma3_tp.d_model, gemma3_tp.d_ff, (4, TP_GEMMA3_PROMPT),
                  tag=" (tp rank)", act="gelu")
    swiglu_bits(gemma3_tp, TP_GEMMA3_PROMPT, act="gelu")
    # phase 15's zamba2-1.2b rank under attn2d, after every case above:
    # attention at its 16 heads (its SSD's 16 heads and its SwiGLU's 2048
    # -> 2048 -> 2048 are the (1, 4) rank's, held above)
    check((zamba_2d.d_ff, tp_local_shapes(zamba, "attn2d")["ssd_heads"]) ==
          (zamba_tp.d_ff, tp_local_shapes(zamba)["ssd_heads"]),
          f"attn2d rank: d_ff {zamba_2d.d_ff}, SSD heads "
          f"{tp_local_shapes(zamba, 'attn2d')['ssd_heads']}, not the (1, 4) "
          "rank's")
    for B_, Sq, Skv, H, Hkv, D, Dv, kw in TP_ATTN2D_ATTN_CASES:
        attention_parity(B_, Sq, Skv, H, Hkv, D, Dv, kw)
    report["max_abs_err"] = max_err
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    report["nvidia_smi"] = smi
    launches = {name: {} for name in wrappers}

    lap("2 parity")
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
                 "run_ms": time_ms(torch, lambda: acc.run(x), 3),
                 "sw_ms": time_ms(torch, lambda: acc.run_reference(x), 3)}
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
                sig = state.signature(broken.stage_names)
                check(torch.equal(broken.run(x, sig), healthy),
                      f"{name} {label}: the rerouted run differs")
                entry.setdefault("rerouted_ms", time_ms(
                    torch, lambda: broken.run(x, sig), 3))
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
    # the paper's latency model beside the card's times (information, not
    # a check: on the card a stage's HW and SW paths run the same code)
    for name, model, idx in (("fft", latency.fft_model(), 3),
                             ("dct", latency.dct_model(), 4),
                             ("aes11", latency.aes_model(11), 5),
                             ("aes3", latency.aes_model(3), 1)):
        e = cases[name]
        e["latency_model"] = {
            "speedup_vs_sw": latency.speedup_vs_sw(model),
            "speedup_vs_sw_one_fault": latency.speedup_vs_sw(model, [idx])}
        out(f"[cases] {name}: latency model speedup_vs_sw healthy "
            f"{e['latency_model']['speedup_vs_sw']:.3f}, one fault (stage "
            f"{idx}) {e['latency_model']['speedup_vs_sw_one_fault']:.3f}; "
            f"on the card: HW run {e['run_ms']:.3f} ms, all-SW run "
            f"{e['sw_ms']:.3f} ms, rerouted run "
            f"{e.get('rerouted_ms', float('nan')):.3f} ms")
    report["casestudies"] = cases
    out(f"[cases] checksum launches in the case studies: "
        f"{checksum_popcount.launches} (22 per 11-stage AES sweep, 6 per "
        "3-stage sweep)")

    # ------------------------------------------------- 4-5. serve and sw

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

    def served(cfg, *args, f32=False, **kw):
        """``serve_path`` on fresh seeded weights; its launches recorded
        under the model's name."""
        params, params32, init_s = init_weights(cfg, dev, f32=f32)
        out(f"[serve] {cfg.name}: weights ready in {init_s:.1f} s")
        entry, counts = serve_path(cfg, dev, wrappers, params, *args,
                                   params32=params32, **kw)
        entry["init_s"] = init_s
        for s, n in counts.items():
            launches[s][cfg.name] = n
        return entry

    lap("3 cases")
    # qwen1.5-4b at SERVE_LAYERS of its 40 layers (phase 9 serves it at
    # full depth); its ticks are host-bound and scale with the depth
    qwen_served = dataclasses.replace(qwen, num_layers=SERVE_LAYERS)
    Lq, G = SERVE_LAYERS, zamba.num_layers // zamba.shared_attn_every
    report["qwen1.5-4b"] = served(
        qwen_served, QWEN_WORKLOAD, "swiglu_mlp",
        per_prefill={"flash_attention": Lq, "swiglu_mlp": Lq},
        per_tick={"flash_attention": 0, "swiglu_mlp": Lq}, prefill_len=128)
    torch.cuda.empty_cache()
    report["zamba2-1.2b"] = served(
        zamba, dict(min_prompt=96, max_prompt=384, min_new=8, max_new=16,
                    arrival_every=3, per_arrival=2), "mamba2_ssd",
        per_prefill={"flash_attention": G, "swiglu_mlp": G,
                     "mamba2_ssd": zamba.num_layers},
        per_tick={"flash_attention": 0, "swiglu_mlp": G, "mamba2_ssd": 0},
        prefill_len=384)
    torch.cuda.empty_cache()
    report["rwkv6-1.6b"] = served(
        rwkv, dict(min_prompt=64, max_prompt=512, min_new=8, max_new=16,
                   arrival_every=2, per_arrival=2), "rwkv6_wkv",
        per_prefill={"rwkv6_wkv": rwkv.num_layers},
        per_tick={"rwkv6_wkv": 0}, prefill_len=512, f32=True,
        logits_check=rwkv_logits)
    check(all(sum(n.values()) > 0 for n in launches.values()),
          f"a kernel of the paths never launched: {launches}")
    torch.cuda.empty_cache()

    lap("4-5 serve")
    # ---------------------------------------------------------- 6. fleet
    t0 = time.perf_counter()
    report["fleet"], fleet_launches = fleet_phase(
        dataclasses.replace(qwen, num_layers=FLEET_LAYERS), dev, wrappers)
    report["fleet"]["phase_s"] = time.perf_counter() - t0
    out(f"[fleet] phase {report['fleet']['phase_s']:.2f} s "
        f"({FLEET_LAYERS} layers)")
    for name, n in fleet_launches.items():
        launches[name]["fleet"] = n
    check(launches["checksum"]["fleet"] == 0, "the fleet launched the "
          "checksum (its stages compare with tol > 0)")
    report["launches"] = launches

    lap("6 fleet")
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
        for _ in range(PROFILE_TRIES):
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
    # and the plain version get contiguous (B, H, S, D) tensors.  Phase
    # 11's prefills too: mistral-nemo-12b and llama4-scout at P = 128 (GQA
    # 32 -> 8 and 40 -> 8) and mixtral-8x7b's 4200-token ring prompt under
    # its 4096-token window (sdpa takes the window as a boolean mask); with
    # a window the bound counts the (query, key) pairs it admits.
    # gemma2-2b (head dim 256, the attention softcap 50) at a local
    # layer's P = 128 and over the 4200-token ring prompt through a local
    # and a global layer: no PyTorch call applies a tanh softcap, so its
    # library time is sdpa on the same shapes without one.
    attn = {}
    mixtral = next(c for c in zoo if c.window and c.moe is not None)
    llama4 = next(c for c in zoo if c.moe is not None and not c.window)
    # (config, B, Sq, Skv, window, softcap, causal): the causal prefills
    # above, gemma3-1b's (GQA 4 -> 1 at head dim 256, window 512) at a
    # local layer's P = 128 and over the ring prompt, windowed and global,
    # qwen2-vl-7b's (GQA 28 -> 4) at P = 128 and its image prefill's 288,
    # and phase 12's whisper-base calls (B = 4): the encoder's
    # bidirectional attention over 1500 frames and the cross-attention at
    # the prompt's Sq = 4 and a decode step's Sq = 1 over them
    vl = 2 * VL_TEXT + VL_GRID ** 2
    F_, B4 = ENCDEC_FRAMES, ENCDEC_BATCH
    for cfg, B_, Sq, Skv, W, cap, causal in (
            (qwen, 1, 128, 128, 0, 0, True), (zamba, 1, 384, 384, 0, 0, True),
            (qwen_tp, 1, 16, 16, 0, 0, True),
            (qwen_tp, 1, 128, 128, 0, 0, True),
            (zamba_tp, 1, 384, 384, 0, 0, True),
            (qwen, 1, 2048, 2048, 0, 0, True),
            (mistral, 1, 128, 128, 0, 0, True),
            (llama4, 1, 128, 128, 0, 0, True),
            (mixtral, 1, RING_PROMPT, RING_PROMPT, mixtral.window, 0, True),
            (gemma, 1, 128, 128, gemma.window, gemma.attn_softcap, True),
            (gemma, 1, RING_PROMPT, RING_PROMPT, gemma.window,
             gemma.attn_softcap, True),
            (gemma, 1, RING_PROMPT, RING_PROMPT, 0, gemma.attn_softcap,
             True),
            (gemma3, 1, 128, 128, gemma3.window, 0, True),
            (gemma3, 1, RING_PROMPT, RING_PROMPT, gemma3.window, 0, True),
            (gemma3, 1, RING_PROMPT, RING_PROMPT, 0, 0, True),
            (qwen_vl, 1, 128, 128, 0, 0, True),
            (qwen_vl, 1, vl, vl, 0, 0, True),
            (whisper, B4, F_, F_, 0, 0, False),
            (whisper, B4, ENCDEC_PROMPT, F_, 0, 0, False),
            (whisper, B4, 1, F_, 0, 0, False),
            # phase 15's whisper-base and gemma3-1b ranks
            (whisper_tp, B4, F_, F_, 0, 0, False),
            (whisper_tp, B4, ENCDEC_PROMPT, F_, 0, 0, False),
            (whisper_tp, B4, 1, F_, 0, 0, False),
            (gemma3_tp, 1, TP_GEMMA3_PROMPT, TP_GEMMA3_PROMPT,
             gemma3.window, 0, True),
            (gemma3_tp, 1, TP_GEMMA3_PROMPT, TP_GEMMA3_PROMPT, 0, 0,
             True),
            # phase 15's zamba2-1.2b rank under attn2d
            (zamba_2d, 1, 16, 16, 0, 0, True),
            (zamba_2d, 1, 128, 128, 0, 0, True),
            (zamba_2d, 1, 384, 384, 0, 0, True)):
        H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        qs_ = randn(B_, Sq, H, D).transpose(1, 2)
        ks_, vs_ = (randn(B_, Skv, Hkv, D).transpose(1, 2) for _ in range(2))
        q, k, v = (t.contiguous() for t in (qs_, ks_, vs_))
        qp = F.pad(q, (0, 0, 0, -(-Sq // 128) * 128 - Sq))
        kp, vp = (F.pad(t, (0, 0, 0, -(-Skv // 128) * 128 - Skv))
                  for t in (k, v))
        wkw = dict(causal=causal)
        if W:
            wkw["window"] = W
        if cap:
            wkw["softcap"] = cap
        akw = dict(kv_len=Skv, bq=128, bk=128, **wkw)
        pos = torch.arange(Sq, device=dev)
        lkw = dict(is_causal=causal) if not W else dict(
            attn_mask=(pos[None, :] <= pos[:, None])
            & (pos[None, :] > pos[:, None] - W))
        if Hkv != H:
            lkw["enable_gqa"] = True
        flops = (attention_flops(B_, Sq, Skv, H, D, causal=causal)
                 if not W else
                 4 * B_ * H * D * sum(min(i + 1, W) for i in range(Sq)))
        ms, by = bound((2 * q.numel() + 2 * k.numel()) * 2, flops)
        key = (f"B={B_} H={H}" + (f" Hkv={Hkv}" if Hkv != H else "")
               + (f" P={Sq}" if Sq == Skv else f" Sq={Sq} Skv={Skv}")
               + f" D={D} " + ("causal" if causal else "non-causal")
               + (f" window={W}" if W else "")
               + (f" softcap={cap:g}" if cap else ""))
        attn[key] = {
            "ms": time_ms(torch, lambda: flash_attention_bhsd(
                qs_, ks_, vs_, **wkw), 50),
            "plain_ms": time_ms(torch, lambda: attention_ref_blocked(
                qp, kp, vp, **akw), 10 if B_ * Sq * Skv <= 2048 ** 2 else 3),
            "bound_ms": ms, "bound_by": by,
            "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, **lkw), 50)}
        if cap:
            attn[key]["library_note"] = "sdpa without the softcap"
        attn[key].update(device_ms(lambda: flash_attention_bhsd(
            qs_, ks_, vs_, **wkw), "flash_attn_fwd")[0])
        if Sq <= 384 and Skv <= 384:
            # the wrapper's host time without its per-signature cache: every
            # call takes the checked path (the cache emptied before each)
            attn[key]["checked_ms"] = time_ms(torch, lambda: (
                attention_calls.clear(),
                flash_attention_bhsd(qs_, ks_, vs_, **wkw)), 50)
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
    # phase 15's shard shapes (a rank's 5 qwen1.5-4b heads, 8 of zamba2's
    # shared block), beside the main row
    kernels[-1]["tp_shapes"] = {k_: attn[k_] for k_ in (
        "B=1 H=5 P=16 D=128 causal", "B=1 H=5 P=128 D=128 causal",
        "B=1 H=8 P=384 D=64 causal",
        f"B={B4} H=2 P={F_} D=64 non-causal",
        f"B={B4} H=2 Sq={ENCDEC_PROMPT} Skv={F_} D=64 non-causal",
        f"B={B4} H=2 Sq=1 Skv={F_} D=64 non-causal",
        f"B=1 H=1 P={TP_GEMMA3_PROMPT} D=256 causal window={gemma3.window}",
        f"B=1 H=1 P={TP_GEMMA3_PROMPT} D=256 causal",
        "B=1 H=16 P=16 D=64 causal", "B=1 H=16 P=128 D=64 causal",
        "B=1 H=16 P=384 D=64 causal")}

    shapes, swiglu_kernels = {}, {}
    gates = {"silu": F.silu, "gelu": lambda h: F.gelu(h, approximate="tanh")}
    for cfg, M in ((qwen, 4), (qwen, 128), (qwen_tp, 4), (qwen_tp, 128),
                   (zamba, 4), (zamba, 384), (zamba_tp, 4), (zamba_tp, 384),
                   (mistral, 4), (mistral, ZOO_PREFILL), (gemma, 4),
                   (gemma, ZOO_PREFILL), (gemma3, 4), (gemma3, ZOO_PREFILL),
                   (gemma3, RING_PROMPT), (qwen_vl, 4),
                   (qwen_vl, ZOO_PREFILL), (qwen_vl, vl_tokens),
                   (gemma3_tp, 4), (gemma3_tp, TP_GEMMA3_PROMPT)):
        Dm, Ff, act = cfg.d_model, cfg.d_ff, cfg.mlp_act
        w1, w3, w2 = swiglu_weights(Dm, Ff)
        x = randn(M, Dm)
        bm, bf, bs = replica_tiles(M, Ff)
        ms, by = bound((x.numel() + w1.numel() + w3.numel() + w2.numel()
                        + M * Dm) * 2, swiglu_flops(M, Dm, Ff))
        key = f"{cfg.name} M={M}" + (f" {act}" if act != "silu" else "")
        shapes[key] = {
            "ms": time_ms(torch, lambda: swiglu_fused(x, w1, w3, w2,
                                                      act=act), 20),
            "plain_ms": time_ms(torch, lambda: swiglu_ref_blocked(
                x, w1, w3, w2, act=act, bm=bm, bf=bf, bs=bs), 2, warmup=1),
            "library_ms": time_ms(torch, lambda: (
                gates[act](x @ w1) * (x @ w3)) @ w2, 20),
            "bound_ms": ms, "bound_by": by}
        # the kernels' own device time a call (torch.profiler), beside the
        # event time above, which also holds the wrapper's host time
        device_times, names = device_ms(
            lambda: swiglu_fused(x, w1, w3, w2, act=act), "swiglu_")
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
    kernels[-1]["tp_shapes"] = {k_: shapes[k_] for k_ in (
        "qwen1.5-4b tp4 M=4", "qwen1.5-4b tp4 M=128", "zamba2-1.2b tp4 M=4",
        "zamba2-1.2b tp4 M=384", "gemma3-1b tp4 M=4 gelu",
        f"gemma3-1b tp4 M={TP_GEMMA3_PROMPT} gelu")}
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
    # phase 15's rank: 16 of the 64 heads; B and C do not shrink with H
    H = tp_local_shapes(zamba)["ssd_heads"]
    x, dt, A, Bm, C = ssd_inputs(1, S, H, Pd, N)
    ms, by = bound(x.numel() * 2 * 2 + dt.numel() * 4 + A.numel() * 4
                   + 2 * Bm.numel() * 2 + H * N * Pd * 4,
                   ssd_flops(1, S, H, Pd, N, chunk=128))
    xs, dtv, Av, Bv, Cv = ssd_rank_views(1, S)
    ssd_tp_row = scan_row(
        lambda: ssd_chunked_cuda(x, dt, A, Bm, C, chunk=128,
                                 with_state=True),
        lambda: ssd_ref_blocked(x, dt, A, Bm, C, chunk=128),
        "mamba2_ssd", views_fn=lambda: ssd_chunked_cuda(
            xs, dtv, Av, Bv, Cv, chunk=128, with_state=True))
    kernels[-1]["tp_shapes"] = {
        f"B=1 S={S} H={H} P={Pd} N={N} chunk=128, final state": ssd_tp_row}
    report["mamba2_ssd_tp_times"] = ssd_tp_row
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
    # phase 15's rank: 8 of the 32 heads
    H = tp_local_shapes(rwkv)["wkv_heads"]
    r, k, v, lw, u = wkv_inputs(1, S, H, K, K)
    ms, by = bound(4 * r.numel() * 2 + u.numel() * 4 + r.numel() * 2
                   + H * K * K * 4, wkv6_flops(1, S, H, K, K, chunk=16))
    wkv_tp_row = scan_row(
        lambda: wkv6_chunked_cuda(r, k, v, lw, u, chunk=16, with_state=True),
        lambda: wkv6_ref_blocked(r, k, v, lw, u, chunk=16), "rwkv6_wkv")
    kernels[-1]["tp_shapes"] = {
        f"B=1 S={S} H={H} K=V={K} chunk=16, final state": wkv_tp_row}
    report["rwkv6_wkv_tp_times"] = wkv_tp_row
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

    lap("7 times")
    # ---------------------------------------------------------- 8. train
    gc.collect()          # closures of the serve paths hold their weights
    torch.cuda.empty_cache()
    report["train"], train_launches = train_phase(qwen, dev, wrappers)
    for name, n in train_launches.items():
        launches[name]["train"] = n      # 0: training runs the SW route
    report["train"]["nvidia_smi"] = smi

    lap("8 train")
    # ------------------------------------------------------ 9. multihost
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report["multihost"], mh_launches, fleet_params = multihost_phase(
        qwen, dev, wrappers)
    report["multihost"]["phase_s"] = time.perf_counter() - t0
    out(f"[multihost] phase {report['multihost']['phase_s']:.2f} s")
    for name, n in mh_launches.items():
        launches[name]["multihost"] = n
    report["multihost"]["nvidia_smi"] = smi

    lap("9 multihost")
    # ---------------------------------------------------------- 10. chaos
    t0 = time.perf_counter()
    report["chaos"], chaos_launches = chaos_phase(
        dataclasses.replace(qwen, num_layers=FLEET_LAYERS), dev, wrappers,
        {**fleet_params, "layers": tree_map(lambda t: t[:FLEET_LAYERS],
                                            fleet_params["layers"])})
    report["chaos"]["phase_s"] = time.perf_counter() - t0
    out(f"[chaos] phase {report['chaos']['phase_s']:.2f} s")
    del fleet_params
    for name, n in chaos_launches.items():
        launches[name]["chaos"] = n
    check(launches["checksum"]["chaos"] == 0, "chaos: the campaign launched "
          "the checksum (its stages compare with tol > 0)")
    report["chaos"]["nvidia_smi"] = smi

    lap("10 chaos")
    # ---------------------------------------------------------- 11. zoo
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    report["zoo"], zoo_launches = zoo_phase(zoo_configs(), dev, wrappers)
    report["zoo_phase_s"] = time.perf_counter() - t0
    out(f"[zoo] phase {report['zoo_phase_s']:.2f} s")
    for name, by_path in zoo_launches.items():
        launches[name].update(by_path)
    report["zoo_nvidia_smi"] = smi

    lap("11 zoo")
    # --------------------------------------------------------- 12. encdec
    gc.collect()
    torch.cuda.empty_cache()
    report["encdec"], encdec_launches = encdec_phase(whisper, dev, wrappers)
    for name, n in encdec_launches.items():
        launches[name][whisper.name] = n
    report["encdec"]["nvidia_smi"] = smi

    lap("12 encdec")
    # --------------------------------------------------------- 13. tuning
    gc.collect()
    torch.cuda.empty_cache()
    report["tuning"], tuning_launches = tuning_phase(dev, wrappers,
                                                     tuning_dir)
    for name, n in tuning_launches.items():
        launches[name]["tuning"] = n
    report["tuning"]["nvidia_smi"] = smi

    lap("13 tuning")
    # ------------------------------------------------------- 14. examples
    gc.collect()
    torch.cuda.empty_cache()
    report["examples"], example_launches = examples_phase(
        qwen, report["train"]["T1"])
    for name, by_example in example_launches.items():
        launches[name].update(by_example)
    report["examples"]["nvidia_smi"] = smi

    lap("14 examples")
    # --------------------------------------------------------- 15. tp
    gc.collect()
    torch.cuda.empty_cache()
    report["tp"], tp_paths = tp_phase(dev, wrappers, smi)
    for path, by_kernel in tp_paths.items():
        for name, n in by_kernel.items():
            launches[name][path] = n
    for kn in kernels:
        kn["tp_launches"] = {p: n for p, n in launches[kn["name"]].items()
                             if p.startswith("tp ")
                             and not p.endswith("unsharded")}
    lap("15 tp")
    # ------------------------------------------------------ 16. tp_train
    gc.collect()
    torch.cuda.empty_cache()
    report["tp_train"] = tpt_phase(dev, smi)
    lap("16 tp_train")
    report["phase_s"] = phase_s
    out("[times] phases (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in phase_s.items()))
    for kn in kernels:                   # the new paths' launches too
        kn["launches"] = sum(launches[kn["name"]].values())
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
