"""Tensor-parallel serving: one process per rank of a ("data", "model")
mesh, or of a hillclimb variant's (``launch/variants.py``: ``attn2d``'s
("data", "model_h", "model_f"), the ``ep`` family's ("data", "expert",
"tp")), each serving its shard of one model through ``ServeEngine`` under
``launch.spmd.spmd``.

    PYTHONPATH=src python -m repro_torch.launch.tp_serve --mesh 1x2 \\
        --device cpu [--arch zamba2-1.2b] [--hw-route interpret] \\
        [--fault-step 3 --fault-rank 1] [--frames 32] \\
        [--variant attn2d --mesh 1x2x2] [--backend nccl] [--keyed]

starts the ranks over a free local port (``--backend gloo``, the
default: every rank on the one device, its collectives through host
copies; ``--backend nccl``: rank r on ``cuda:r``, ``mesh.rank_device``,
its collectives on the card, so as many cards as ranks), serves a
synthetic workload on each, and checks that every rank emitted the same
tokens and changed route at the same step.  The arch's reduced
config by default; ``--full`` serves it at full width (``--layers`` cuts
the depth).  ``--variant`` takes the variant's mesh axes, logical-axis
rules and param axes (its config overrides and train knobs do not apply
to serving); ``--mesh`` then gives one size per axis.  ``--fault-rank``
arms a lane fault on that rank's stage at
``--fault-step`` and reports what its canary finds; the ranks agree on it
through ``EventChannel`` and demote the stage together.  The stage is the
arch's own kernel's (``fault_stage_for``): SwiGLU for the dense family,
the SSD for the hybrid one (zamba2-1.2b), the WKV for the SSM one
(rwkv6-1.6b), attention for the MoE family (mixtral-8x7b,
llama4-scout-17b-a16e: their FFN is no kernel stage) and the
encoder-decoder one (whisper-base).

A spec with ``keyed`` draws its weights with ``LMModel.init_keyed``: each
rank draws only its own block, layer by layer, so a model that one card
cannot hold whole (mixtral-8x7b, llama4-scout at full depth) is served
over cards that hold a block each.

The encoder-decoder family has no ``ServeEngine`` path, in the reference
or the port: ``drive_encdec`` serves it as ``EncDecModel.prefill`` over a
batch of ``requests`` rows (``frames`` stub frame embeddings and a
``max_prompt``-token prompt each, drawn from ``seed``) and ``max_new``
greedy ``decode_step``s, one engine step each, with the same fault,
canary and agreement.  ``layers`` cuts ``num_layers`` only, so whisper
keeps its encoder and decoder depths.

``serve_rank`` is one rank's work: it joins the group once and serves a
list of jobs in turn, each on its own mesh over the same ranks
(``chip_smoke.py``'s phase 15 serves its models in one launch);
``launch_jobs`` starts and collects the ranks, ``launch_ranks`` for one
job (the CLI and the CPU tests).  They and ``reference_run`` run on the
card unless given ``device="cpu"`` (``device.resolve_device``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import socket
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.device import resolve_device
from repro_torch.launch import partition, spmd
from repro_torch.launch.distributed import (STAGE, EventChannel,
                                            KVCoordinator,
                                            initialize_runtime,
                                            shutdown_runtime)
from repro_torch.launch.mesh import make_mesh, rank_device, rank_devices
from repro_torch.launch.variants import VARIANTS
from repro_torch.models import build_model, compute_params
from repro_torch.serve import ServeConfig, ServeEngine, synthetic_workload
from repro_torch.viscosity import HW, INTERPRET, SW
from repro_torch.viscosity.lang import tree_leaves

AXES = ("data", "model")
RESULT = "RESULT "


@dataclasses.dataclass
class TPServeSpec:
    """What every rank serves: the model (``full`` width or the reduced
    config, ``layers`` deep when given, computing in ``dtype`` when
    given), its weights (``seed``, drawn in ``dtype``), the workload, the
    fault, and the hillclimb ``variant`` whose mesh axes, rules and param
    axes the ranks take (None: ("data", "model"), ``partition.rules_for``
    and ``DEFAULT_AXES``)."""
    arch: str = "qwen1.5-4b"
    full: bool = False
    layers: Optional[int] = None
    dtype: Optional[str] = None          # "bfloat16": weights drawn in it
    seed: int = 0
    requests: int = 4
    slots: int = 4
    min_prompt: int = 4
    max_prompt: int = 16
    min_new: int = 4
    max_new: int = 8
    arrival_every: int = 1
    per_arrival: int = 2
    hw_route: str = SW
    fault_step: int = -1
    fault_rank: int = -1
    fault_stage: str = ""                # "": the arch's (fault_stage_for)
    frames: int = 32                     # encoder-decoder: frames a row
    variant: Optional[str] = None
    keyed: bool = False                  # LMModel.init_keyed's draw

    def __post_init__(self):
        if not self.fault_stage:
            self.fault_stage = fault_stage_for(self.config())

    def config(self):
        cfg = get_config(self.arch)
        if not self.full:
            cfg = cfg.reduced()
        if self.layers:
            cfg = dataclasses.replace(cfg, num_layers=self.layers)
        if self.dtype:
            cfg = dataclasses.replace(cfg, dtype=self.dtype)
        return cfg

    @property
    def max_len(self) -> int:
        return self.max_prompt + self.max_new

    def workload(self, cfg):
        return synthetic_workload(
            cfg.vocab_size, self.requests, np.random.default_rng(self.seed),
            min_prompt=self.min_prompt, max_prompt=self.max_prompt,
            min_new=self.min_new, max_new=self.max_new,
            arrival_every=self.arrival_every, per_arrival=self.per_arrival)

    def weights(self, cfg, device, cut=None):
        """The full tree, drawn on ``device`` from ``seed`` (an
        encoder-decoder model's in f32, then cast); under ``keyed``
        ``init_keyed``'s, of which ``cut`` (``partition.leaf_cutter``)
        keeps a rank's block."""
        dt = getattr(torch, self.dtype) if self.dtype else None
        if self.keyed:
            return build_model(cfg).init_keyed(self.seed, device, dtype=dt,
                                               cut=cut)
        gen = torch.Generator(device=device).manual_seed(self.seed)
        if cfg.is_encdec:
            params = build_model(cfg).init(gen, device=device)
            return params if dt is None else compute_params(params, dt)
        return build_model(cfg).init(gen, device=device, dtype=dt)

    def encdec_inputs(self, cfg, device):
        """An encoder-decoder serve's batch: (B, frames, d_model) stub
        frame embeddings and a (B, max_prompt) prompt, drawn on the CPU
        from ``seed`` (the same on every device)."""
        gen = torch.Generator().manual_seed(self.seed + 1)
        emb = torch.randn((self.requests, self.frames, cfg.d_model),
                          generator=gen)
        toks = torch.randint(0, cfg.vocab_size,
                             (self.requests, self.max_prompt), generator=gen)
        return (emb.to(device=device, dtype=getattr(torch, cfg.dtype)),
                toks.to(device))


def mesh_axes_of(variant: Optional[str]) -> tuple:
    """The mesh axes of a serve under ``variant`` (None: ``AXES``)."""
    return tuple(VARIANTS[variant]["mesh_axes"]) if variant else AXES


def layout_of(variant: Optional[str], cfg, mesh):
    """(logical-axis rules, param axes) of a rank's ``spmd`` under
    ``variant``: the variant's, or ``partition.rules_for`` and
    ``DEFAULT_AXES``."""
    if variant:
        v = VARIANTS[variant]
        return dict(v["rules"]), dict(v["axes"])
    return partition.rules_for(cfg, mesh), dict(partition.DEFAULT_AXES)


def fault_stage_for(cfg) -> str:
    """The stage a tensor-parallel serve faults by default: the kernel the
    family's layers are made of, of the stages the model runs
    (``model_stage_names``): the scan of the hybrid and SSM families, else
    SwiGLU, else attention (the MoE family, whose FFN is no kernel stage,
    and the encoder-decoder one)."""
    from repro_torch.train.runner import model_stage_names
    names = model_stage_names(cfg)
    return next(s for s in ("mamba2_ssd", "rwkv6_wkv", "swiglu_mlp",
                            "flash_attention") if s in names)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _plan_route(plan, stage: str) -> str:
    return plan.target_for(stage) if plan is not None else ""


def drive(engine: ServeEngine, reqs, spec: TPServeSpec, *, rank: int = 0,
          canary=None, rec: Optional[Dict[str, Any]] = None
          ) -> Dict[str, Any]:
    """Serve ``reqs`` through a session; at ``spec.fault_step`` the rank
    ``spec.fault_rank`` arms a lane fault on ``spec.fault_stage`` and, when
    ``canary`` (a ``CanaryChecker`` over that stage) finds it, reports it.
    Returns tokens, per-step routes, timings and per-call collective
    bytes."""
    calls: List[Dict[str, Any]] = []
    now = {"step": 0}
    timed = _timer(engine.device, calls, now)
    engine.admit = timed("prefill", engine.admit, _always)
    engine.decode_tick = timed("tick", engine.decode_tick,
                               lambda res: res["active"])
    sess = engine.session()
    for r in sorted(reqs, key=lambda r: (r.arrival, r.rid)):
        sess.submit(r)
    routes, faulted = [], None
    t0 = time.perf_counter()
    while sess.pending():
        step = now["step"] = sess.step_count
        if rec is not None:
            rec["now"] = step
        if _fault_found(spec, step, rank, canary):
            engine.report_stage_fault(spec.fault_stage)
        tick = sess.step()
        if tick.get("agreed_faults") and faulted is None:
            faulted = step
        routes.append(_plan_route(engine._decode_key(), spec.fault_stage))
    wall = time.perf_counter() - t0
    _clear_fault(spec)
    stats = sess.close()
    done = {c.rid: c for c in sess.poll()}
    return {"tokens": {str(r): done[r].tokens.tolist() for r in sorted(done)},
            "routes": routes, "fault_applied_step": faulted,
            "steps": stats["steps"], "wall_s": wall, "calls": calls}


def _always(_) -> bool:
    return True


def _timer(device, calls: List[Dict[str, Any]], now: Dict[str, int]):
    """``timed(kind, fn, keep)``: ``fn`` timed (the card synchronised
    around it) with the collective bytes it moved, recorded in ``calls``
    at step ``now["step"]`` when ``keep(result)``."""
    log = spmd.collective_log()

    def timed(kind, fn, keep):
        def wrapped(*a, **kw):
            before = dict(log.by_kind("bytes")) if log is not None else {}
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            res = fn(*a, **kw)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            after = log.by_kind("bytes") if log is not None else {}
            if keep(res):
                calls.append({"kind": kind, "step": now["step"],
                              "ms": 1e3 * (time.perf_counter() - t0),
                              "bytes": {k: after[k] - before.get(k, 0.0)
                                        for k in after
                                        if after[k] != before.get(k, 0.0)}})
            return res
        return wrapped
    return timed


def _fault_found(spec: TPServeSpec, step: int, rank: int, canary) -> bool:
    """At ``spec.fault_step`` on ``spec.fault_rank``: arm the lane fault on
    ``spec.fault_stage``; True when its canary (if any) finds it."""
    from repro_torch.viscosity import lanefault
    from repro_torch.viscosity.lanefault import STUCK, LaneFault
    if step != spec.fault_step or rank != spec.fault_rank:
        return False
    lanefault.set_injection(spec.fault_stage, LaneFault(
        STUCK, (1,), _canary_width(spec.fault_stage), value=3.0))
    return canary is None or not canary.check_stage(canary.stages[0])


def _clear_fault(spec: TPServeSpec):
    from repro_torch.viscosity import lanefault
    lanefault.clear_injection(spec.fault_stage)


def drive_encdec(cfg, params, spec: TPServeSpec, device, *, rank: int = 0,
                 canary=None, channel=None,
                 rec: Optional[Dict[str, Any]] = None,
                 on_logits=None) -> Dict[str, Any]:
    """An encoder-decoder serve (see the module docstring) with ``drive``'s
    report, and its final ``state`` (the cross-KV and the self-attention
    cache).  Step 0 is the prefill, step s >= 1 the decode step at
    position ``max_prompt + s - 1``; the model runs on ``spec.hw_route``
    until the step the ranks agree on a fault of ``spec.fault_stage``
    (through ``channel``; without one, the step it is found), then on SW.
    ``on_logits`` as ``ServeEngine.on_logits``."""
    emb, prompt = spec.encdec_inputs(cfg, device)
    B, P = prompt.shape
    calls: List[Dict[str, Any]] = []
    now = {"step": 0}
    timed = _timer(device, calls, now)
    route = spec.hw_route
    model = build_model(cfg, routes={spec.fault_stage: route})

    def prefill(m):
        return m.prefill(params, {"embeds": emb, "dec_tokens": prompt,
                                  "cache": spmd.init_cache(
                                      m, B, spec.max_len, device=device)})

    def decode(m, state, tok, t):
        return m.decode_step(params, state, tok, t)
    routes, faulted, out = [], None, []
    state = tok = None
    t0 = time.perf_counter()
    with torch.no_grad():
        for step in range(spec.max_new + 1):
            now["step"] = step
            if rec is not None:
                rec["now"] = step
            events = ([(STAGE, 0, spec.fault_stage)]
                      if _fault_found(spec, step, rank, canary) else [])
            agreed = ([ev.stage for ev in channel.exchange(step, events)
                       if ev.kind == STAGE] if channel is not None
                      else [ev[2] for ev in events])
            if spec.fault_stage in agreed and route != SW:
                route = SW
                model = build_model(cfg, routes={spec.fault_stage: route})
                faulted = step
            if step == 0:
                lg, state = timed("prefill", prefill, _always)(model)
            else:
                lg, state = timed("tick", decode, _always)(
                    model, state, tok, P + step - 1)
            forced = (on_logits("prefill" if step == 0 else "tick",
                                lg[:, -1]) if on_logits else None)
            tok = (forced.reshape(B, 1) if forced is not None
                   else lg[:, -1].argmax(-1)[:, None])
            out.append(tok)
            routes.append(route)
    wall = time.perf_counter() - t0
    _clear_fault(spec)
    toks = torch.cat(out, 1).tolist()
    return {"tokens": {str(r): toks[r] for r in range(B)}, "routes": routes,
            "fault_applied_step": faulted, "steps": spec.max_new + 1,
            "wall_s": wall, "calls": calls, "state": state}


def _nbytes(tree) -> int:
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(tree)))


def _canary_width(stage: str) -> int:
    from repro_torch.chaos import CANARY_WIDTHS
    return CANARY_WIDTHS[stage]


SHAPES_OF = {"flash_attention": lambda q, k, *a: (q.shape, k.shape),
             "swiglu_mlp": lambda x, w1, w3, w2: (x.shape, w1.shape,
                                                  w2.shape),
             "mamba2_ssd": lambda x, dt, A, B_, C: (x.shape, B_.shape),
             "rwkv6_wkv": lambda r, k, v, lw, u: (r.shape, u.shape)}


@contextlib.contextmanager
def kernel_shapes():
    """Record the operand shapes each Hopper wrapper is called with on
    this rank, and its calls: {"flash_attention": {(q, k) shapes},
    "swiglu_mlp": {(x, w1, w2)}, "mamba2_ssd": {(x, B)}, "rwkv6_wkv":
    {(r, u)}, "calls": {name: n}} (on the card a call is a launch; the
    wrappers' ``launches`` count those)."""
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.mamba2_scan import ops as ssd_ops
    from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
    from repro_torch.kernels.swiglu import ops as swiglu_ops
    sites = {"flash_attention": (attn_ops, "flash_attention_bhsd"),
             "swiglu_mlp": (swiglu_ops, "swiglu_fused"),
             "mamba2_ssd": (ssd_ops, "ssd_chunked_cuda"),
             "rwkv6_wkv": (wkv_ops, "wkv6_chunked_cuda")}
    seen: Dict[str, Any] = {name: set() for name in sites}
    seen["calls"] = {name: 0 for name in sites}
    saved = {name: getattr(mod, attr) for name, (mod, attr) in sites.items()}

    def recorder(name):
        def rec(*a, **kw):
            seen[name].add(tuple(tuple(s) for s in SHAPES_OF[name](*a)))
            seen["calls"][name] += 1
            return saved[name](*a, **kw)
        return rec
    for name, (mod, attr) in sites.items():
        setattr(mod, attr, recorder(name))
    try:
        yield seen
    finally:
        for name, (mod, attr) in sites.items():
            setattr(mod, attr, saved[name])


def logits_recorder(ref: Optional[Dict[str, List]] = None,
                    until_step: int = -1):
    """An ``on_logits`` observer that keeps each call's logits (f32 on the
    host), its greedy tokens and its session step (``rec["now"]``, which
    ``drive`` keeps current).  Given the reference run's record ``ref``,
    each call's max |logits - ref| / max |ref| too, and until
    ``until_step`` the reference's tokens are fed back (teacher forcing:
    a near-tie that rounds the other way must not fork the streams the
    comparison runs on).  Under ``record_router(rec)`` each call's MoE
    router probabilities too, in ``rec["router"]``."""
    rec: Dict[str, Any] = {"logits": [], "kinds": [], "rel": [],
                           "tokens": [], "steps": [], "now": 0,
                           "router": [], "pending": []}

    def on_logits(kind, logits):
        lg = logits.detach().float().cpu()
        i = len(rec["logits"])
        rec["router"].append(rec["pending"])
        rec["pending"] = []
        rec["logits"].append(lg)
        rec["kinds"].append(kind)
        rec["tokens"].append(lg.argmax(-1).tolist())
        rec["steps"].append(rec["now"])
        if ref is None or i >= len(ref["logits"]):
            return None
        r = ref["logits"][i]
        if r.shape == lg.shape:
            rec["rel"].append(float((lg - r).abs().max())
                              / max(float(r.abs().max()), 1e-30))
        if rec["now"] < until_step:
            return torch.tensor(ref["tokens"][i], device=logits.device)
        return None
    return on_logits, rec


@contextlib.contextmanager
def record_router(rec: Dict[str, Any]):
    """Within the body, each MoE FFN call's router probabilities (f32, on
    the host) join ``rec`` (a ``logits_recorder``'s): ``rec["router"]``
    holds each call's list of them, in call order (layer by layer, a
    decode tick's slots within its layer)."""
    from repro_torch.models import moe as moe_mod
    with moe_mod.observe_router(
            lambda probs: rec["pending"].append(probs.detach().cpu())):
        yield


def kernel_wrappers() -> Dict[str, Any]:
    """The Hopper wrappers a served model calls, by stage, and the Fig. 4
    checksum's: each counts its CUDA launches in ``launches``."""
    from repro_torch.kernels.checksum import checksum_popcount
    from repro_torch.kernels.flash_attention import flash_attention_bhsd
    from repro_torch.kernels.mamba2_scan import ssd_chunked_cuda
    from repro_torch.kernels.rwkv6_scan import wkv6_chunked_cuda
    from repro_torch.kernels.swiglu import swiglu_fused
    return {"flash_attention": flash_attention_bhsd,
            "swiglu_mlp": swiglu_fused, "mamba2_ssd": ssd_chunked_cuda,
            "rwkv6_wkv": wkv6_chunked_cuda, "checksum": checksum_popcount}


def layer_probe(cfg, params, probe: Dict[str, List], route: str
                ) -> List[float]:
    """RWKV-6's time-mix layer by layer on this rank's shards (under the
    active ``spmd`` context), each from the unsharded run's input to that
    layer (``probe["x"]``), against the unsharded output (``probe["tm"]``):
    max |got - want| / max |want| per layer."""
    from repro_torch.models import layers as Lm
    from repro_torch.models import rwkv6 as rwkv_mod
    rels = []
    with torch.no_grad():
        for i, (x, want) in enumerate(zip(probe["x"], probe["tm"])):
            p = {k: {n: t[i] for n, t in sub.items()}
                 for k, sub in params["layers"].items()}
            x = x.to(params["embed"]["table"].device)
            h = Lm.norm(p["ln1"], x, eps=cfg.norm_eps)
            got = rwkv_mod.time_mix(p["tm"], h, cfg, route=route).float()
            want = want.to(got.device)
            rels.append(float((got - want).abs().max())
                        / max(float(want.abs().max()), 1e-30))
    return rels


def serve_rank(jobs: Sequence[Dict[str, Any]], rank: int, world: int,
               port: int, mesh_shape, *, backend: str = "gloo",
               device=None, host: Optional[bool] = None
               ) -> List[Dict[str, Any]]:
    """One rank, on its device (``mesh.rank_device``: under NCCL its own
    card): join the group once, then for each job cut its spec's seeded
    weights to the rank's shard, serve under ``spmd`` and report (see
    ``_serve_job``); the jobs' reports in order.  A job's mesh is its
    ``"mesh"`` (``mesh_shape`` without one) over its spec's mesh axes and
    the ranks' devices; the process groups of each mesh are made at its
    first job (``host``: ``spmd.GroupComm``'s, None the backend's
    default)."""
    t_start = time.perf_counter()
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dev = rank_device(rank, world, backend, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    rt = initialize_runtime(f"127.0.0.1:{port}", world, rank,
                            backend=backend, timeout_s=600)
    devices = rank_devices(world, backend, device)
    meshes: Dict[tuple, Any] = {}
    coord = KVCoordinator()
    out = []
    for job in jobs:
        shape = tuple(job.get("mesh") or mesh_shape)
        axes = mesh_axes_of(job["spec"]["variant"])
        fresh = (shape, axes) not in meshes
        if fresh:
            mesh = make_mesh(shape, axes, devices=devices)
            meshes[shape, axes] = (mesh, spmd.GroupComm(mesh, rank,
                                                        host=host))
        mesh, comm = meshes[shape, axes]
        comm.log.reset()
        res = _serve_job(job, rank, dev, mesh, comm, coord)
        res.update({"rank": rank, "world": world, "backend": rt.backend,
                    "device": str(dev), "host_copies": comm.host,
                    "mesh_devices": [str(d) for d in mesh.devices],
                    "groups_s": comm.build_s if fresh else 0.0,
                    "mesh": list(shape), "mesh_axes": list(axes),
                    "joined_s": time.perf_counter() - t_start})
        out.append(res)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    coord.exchange("done")      # rank 0 serves the store: leave together
    shutdown_runtime()
    return out


def _serve_job(job: Dict[str, Any], rank: int, dev, mesh, comm, coord
               ) -> Dict[str, Any]:
    """One job of ``serve_rank``: ``job["spec"]`` (a ``TPServeSpec``)
    served on the rank's shard, reported as ``drive`` or ``drive_encdec``
    does, with the rank's launches, kernel shapes, collectives, bytes and
    ``cache_shapes`` (each leaf of its cache, by path), and its draw:
    seconds and peak (``draw_s``, ``draw_peak_gib``; ``serve_peak_gib``
    after it, ``peak_gib`` the job's).  ``ref_logits`` (a ``torch.save``d
    list) is the unsharded run's logits, call by call; ``out_dir``
    receives this rank's logits as ``logits_<rank>.pt`` (and with
    ``router`` each call's MoE router probabilities as
    ``router_<rank>.pt``, ``record_router``); ``layer_probe_path`` (an
    RWKV-6 model's ``layer_probe`` inputs) adds, after the serve and its
    launch counts, the per-layer time-mix comparison as ``layer_rel``;
    ``checksum_layers`` = k adds the Fig. 4 checksum (``checksum_tree``)
    of the rank's first k layers, before the serve; ``params`` (a
    ``torch.save``d full tree) replaces the spec's draw."""
    from repro_torch.core import CanaryChecker
    from repro_torch.kernels.checksum import checksum_tree
    from repro_torch.train.runner import canary_stages
    t_start = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    spec = TPServeSpec(**job["spec"])
    ref_logits, out_dir = job.get("ref_logits"), job.get("out_dir")
    coords = spmd.rank_coords(mesh, rank)
    cfg = spec.config()
    rules, axes = layout_of(spec.variant, cfg, mesh)
    if spec.keyed:      # the rank's block alone, as it is drawn
        local = spec.weights(cfg, dev, cut=partition.leaf_cutter(
            mesh, coords, axes))
    else:
        full = (torch.load(job["params"], map_location=dev)
                if job.get("params") else spec.weights(cfg, dev))
        specs = partition.params_pspecs(full, mesh, axes)
        local = partition.map_with_path(
            partition.shard_tree(full, specs, mesh, coords,
                                 layout=partition.packed_layout(cfg)),
            lambda _, t: t.clone())
        del full
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    draw = {"draw_s": time.perf_counter() - t_start, "draw_peak_gib": None}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        draw["draw_peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        torch.cuda.reset_peak_memory_stats(dev)
    reqs = spec.workload(cfg)
    ref = torch.load(ref_logits) if ref_logits else None
    # the reference's tokens are fed back until the fault (all along
    # without one)
    on_logits, rec = logits_recorder(
        ref, until_step=spec.fault_step if spec.fault_step >= 0
        else sys.maxsize)
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    if job.get("checksum_layers"):
        k = job["checksum_layers"]
        draw["checksum_layers"] = checksum_tree(
            {n: t[:k] for n, t in partition.flatten(local["layers"]).items()})
    routers = (record_router(rec) if job.get("router")
               else contextlib.nullcontext())
    with spmd.spmd(mesh, rules, axes, coords, comm,
                   dims=spmd.logical_sizes(cfg)), kernel_shapes() as seen, \
            routers:
        canary = None
        if rank == spec.fault_rank:
            canary = CanaryChecker(
                [s for s in canary_stages(cfg, device=dev)
                 if s.name == spec.fault_stage], route_hw=spec.hw_route)
        if cfg.is_encdec:
            local = compute_params(local, getattr(torch, cfg.dtype))
            res = drive_encdec(cfg, local, spec, dev, rank=rank,
                               canary=canary, channel=EventChannel(coord),
                               rec=rec, on_logits=on_logits)
            held, served = res.pop("state"), local
        else:
            eng = ServeEngine(cfg, local, ServeConfig(
                max_len=spec.max_len, max_slots=spec.slots,
                hw_route=spec.hw_route), device=dev,
                channel=EventChannel(coord))
            eng.on_logits = on_logits
            res = drive(eng, reqs, spec, rank=rank, canary=canary, rec=rec)
            held, served = eng._caches, eng.params
    launches = {n: w.launches for n, w in wrappers.items()}
    collectives = comm.log.snapshot()
    if job.get("layer_probe_path"):
        with spmd.spmd(mesh, rules, axes, coords, comm,
                       dims=spmd.logical_sizes(cfg)):
            res["layer_rel"] = layer_probe(
                cfg, served, torch.load(job["layer_probe_path"]),
                spec.hw_route)
    serve_peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                  if dev.type == "cuda" else None)
    res.update(draw)
    res.update({
        "coords": coords, "launches": launches,
        "kernel_calls": seen.pop("calls"),
        "kernel_shapes": {k: sorted(map(list, v)) for k, v in seen.items()},
        "logits_rel": rec["rel"], "logit_kinds": rec["kinds"],
        "call_tokens": rec["tokens"],
        "collectives": collectives,
        "local_bytes": {"params": _nbytes(local), "cache": _nbytes(held)},
        "cache_shapes": {path: list(t.shape) for path, t in
                         partition.flatten(held).items()},
        "process_s": time.perf_counter() - t_start,
        "serve_peak_gib": serve_peak,
        "peak_gib": (max(draw["draw_peak_gib"], serve_peak)
                     if dev.type == "cuda" else None)})
    if out_dir:
        torch.save(rec["logits"], os.path.join(out_dir, f"logits_{rank}.pt"))
        if job.get("router"):
            torch.save(rec["router"],
                       os.path.join(out_dir, f"router_{rank}.pt"))
    return res


WORKER = ("import sys, json; sys.path.insert(0, sys.argv[1]); "
          "from repro_torch.launch import tp_serve; "
          "sys.exit(tp_serve.worker(sys.argv[2:]))")


def worker(argv) -> int:
    """One rank from the command line ``launch_jobs`` builds: prints one
    ``RESULT {json}`` line, the list of its jobs' reports."""
    a = json.loads(argv[0])
    res = serve_rank(a["jobs"], a["rank"], a["world"], a["port"], a["mesh"],
                     backend=a["backend"], device=a["device"],
                     host=a.get("host"))
    sys.stdout.write(RESULT + json.dumps(res) + "\n")
    sys.stdout.flush()
    return 0


def make_job(spec: TPServeSpec, *, mesh=None,
             ref_logits: Optional[str] = None, out_dir: Optional[str] = None,
             layer_probe_path: Optional[str] = None, router: bool = False,
             checksum_layers: int = 0,
             params: Optional[str] = None) -> Dict[str, Any]:
    """One job of ``launch_jobs`` (see ``_serve_job`` for the paths and
    options): served on ``mesh`` (one size per axis of
    ``mesh_axes_of(spec.variant)``; None: the launch's mesh)."""
    axes = mesh_axes_of(spec.variant)
    if mesh is not None and len(mesh) != len(axes):
        raise ValueError(f"mesh {tuple(mesh)} for the axes {axes}")
    return {"spec": dataclasses.asdict(spec), "ref_logits": ref_logits,
            "out_dir": out_dir, "layer_probe_path": layer_probe_path,
            "router": router, "checksum_layers": checksum_layers,
            "params": params,
            "mesh": list(mesh) if mesh is not None else None}


def launch_jobs(jobs: Sequence[Dict[str, Any]], mesh_shape, *,
                device=None, backend: str = "gloo",
                host: Optional[bool] = None,
                timeout: float = 600.0, src: Optional[str] = None,
                env=None) -> List[List[Dict]]:
    """Start one process per rank of ``mesh_shape``, each on its device
    (``mesh.rank_device``: under NCCL rank r on ``cuda:r``, refused
    without a card a rank), which joins the group once and serves
    ``jobs`` (``make_job(...)``) in turn, each on its own mesh of as many
    ranks; wait for all and return, per job, its results by rank.  The
    kernels are built here first, not by every rank.  A rank that fails
    raises with its stderr."""
    world = int(np.prod(mesh_shape))
    devs = rank_devices(world, backend, device)
    for job in jobs:
        if job.get("mesh") and int(np.prod(job["mesh"])) != world:
            raise ValueError(f"a job's mesh {job['mesh']} is not "
                             f"{world} ranks")
    if devs[0].type == "cuda":
        from repro_torch.kernels import _build
        _build.build()
    port = free_port()
    args = [json.dumps({"jobs": list(jobs), "rank": rank, "world": world,
                        "port": port, "mesh": list(mesh_shape),
                        "backend": backend, "device": str(devs[rank]),
                        "host": host})
            for rank in range(world)]
    results = run_ranks(WORKER, args, timeout=timeout, src=src, env=env)
    return [[r[i] for r in results] for i in range(len(jobs))]


def run_ranks(worker: str, args: Sequence[str], *, timeout: float = 600.0,
              src: Optional[str] = None, env=None) -> List[Any]:
    """Start ``python -c worker src arg`` for each of ``args`` (one rank
    each, ``src`` on ``PYTHONPATH``), wait for all and return each rank's
    last ``RESULT {json}`` line, parsed, in rank order.  A rank that
    fails, prints no result or outlives ``timeout`` raises with its
    stderr; every process is gone when this returns."""
    src = src or os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(env or os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, src, arg], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arg in args]
    results, failures = [], []
    t0 = time.perf_counter()
    try:
        for rank, p in enumerate(procs):
            try:
                out, err = p.communicate(
                    timeout=max(1.0, timeout - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                failures.append(f"rank {rank} timed out after {timeout} s")
                continue
            lines = [ln for ln in out.splitlines() if ln.startswith(RESULT)]
            if p.returncode != 0 or not lines:
                failures.append(f"rank {rank} exited {p.returncode}:\n"
                                f"{err[-3000:]}")
                continue
            results.append(json.loads(lines[-1][len(RESULT):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if failures:
        raise RuntimeError("tensor-parallel ranks failed:\n"
                           + "\n".join(failures))
    return results


def launch_ranks(spec: TPServeSpec, mesh_shape, *, device=None,
                 backend: str = "gloo", host: Optional[bool] = None,
                 ref_logits: Optional[str] = None,
                 out_dir: Optional[str] = None,
                 layer_probe_path: Optional[str] = None,
                 timeout: float = 600.0,
                 src: Optional[str] = None, env=None) -> List[Dict]:
    """``launch_jobs`` of one job: its results by rank."""
    return launch_jobs([make_job(spec, ref_logits=ref_logits,
                                 out_dir=out_dir,
                                 layer_probe_path=layer_probe_path)],
                       mesh_shape, device=device, backend=backend,
                       host=host, timeout=timeout, src=src, env=env)[0]


def reference_run(spec: TPServeSpec, device=None,
                  path: Optional[str] = None,
                  router: bool = False) -> Dict[str, Any]:
    """The same workload on one unsharded engine of the same weights; its
    logits and greedy tokens, call by call (and with ``router`` each
    call's MoE router probabilities, ``record_router``), are saved to
    ``path`` when given (what ``serve_rank``'s ``ref_logits`` reads).
    Its ``peak_gib`` on the card."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = spec.config()
    on_logits, rec = logits_recorder()
    routers = record_router(rec) if router else contextlib.nullcontext()
    with routers:
        res = _reference_serve(spec, cfg, spec.weights(cfg, dev), dev, rec,
                               on_logits)
    if path:
        torch.save({"logits": rec["logits"], "tokens": rec["tokens"],
                    "router": rec["router"]}, path)
    res["logit_kinds"] = rec["kinds"]
    res["call_tokens"] = rec["tokens"]
    res["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                       if dev.type == "cuda" else None)
    return res


def _reference_serve(spec, cfg, params, dev, rec, on_logits):
    """``reference_run``'s serve of ``params`` (the engine keeps what it
    needs of them)."""
    if cfg.is_encdec:
        res = drive_encdec(cfg, params, spec, dev, rec=rec,
                           on_logits=on_logits)
        del res["state"]
    else:
        eng = ServeEngine(cfg, params, ServeConfig(
            max_len=spec.max_len, max_slots=spec.slots,
            hw_route=spec.hw_route), device=dev)
        eng.on_logits = on_logits
        del params
        res = drive(eng, spec.workload(cfg), spec, rec=rec)
    return res


def check_agreement(results: Sequence[Dict]) -> List[str]:
    """What the ranks disagree on (empty: they agree): tokens (emitted,
    and each call's greedy ones), the route of the faulted stage at each
    step, the step a fault took effect."""
    bad = []
    r0 = results[0]
    for r in results[1:]:
        for key in ("tokens", "call_tokens", "routes",
                    "fault_applied_step", "steps"):
            if r[key] != r0[key]:
                bad.append(f"rank {r['rank']} {key} differs from rank 0's")
    return bad


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen1.5-4b", choices=list(ARCH_NAMES))
    ap.add_argument("--mesh", default="1x2",
                    help="DxM: data x model ranks; under --variant one "
                         "size per variant axis (attn2d: 1x2x2)")
    ap.add_argument("--variant", default=None,
                    choices=[n for n, v in VARIANTS.items()
                             if "mesh_axes" in v],
                    help="serve under this variant's mesh axes, rules and "
                         "param axes")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--hw-route", default=SW, choices=[HW, SW, INTERPRET])
    ap.add_argument("--fault-step", type=int, default=-1)
    ap.add_argument("--fault-rank", type=int, default=-1)
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the card)")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=32,
                    help="encoder-decoder: stub frame embeddings a request")
    ap.add_argument("--keyed", action="store_true",
                    help="each rank draws only its block (LMModel."
                         "init_keyed): mixtral-8x7b and llama4-scout at "
                         "full depth")
    args = ap.parse_args(argv)
    shape = tuple(int(v) for v in args.mesh.lower().split("x"))
    spec = TPServeSpec(arch=args.arch, full=args.full, layers=args.layers,
                       requests=args.requests, slots=args.slots,
                       hw_route=args.hw_route, fault_step=args.fault_step,
                       fault_rank=args.fault_rank, seed=args.seed,
                       frames=args.frames, variant=args.variant,
                       keyed=args.keyed)
    if len(shape) != len(mesh_axes_of(spec.variant)):
        raise SystemExit(f"--mesh {args.mesh}: one size per axis of "
                         f"{mesh_axes_of(spec.variant)}")
    results = launch_ranks(spec, shape, device=args.device,
                           backend=args.backend)
    for r in results:
        per = [c["ms"] for c in r["calls"] if c["kind"] == "tick"]
        sys.stdout.write(
            f"rank {r['rank']} {r['coords']} on {r['device']} "
            f"({r['backend']}): {r['steps']} steps, "
            f"{sum(map(len, r['tokens'].values()))} tokens, median tick "
            f"{np.median(per) if per else 0.0:.2f} ms, fault applied at "
            f"step {r['fault_applied_step']}; launches {r['launches']}\n")
    bad = check_agreement(results)
    if bad:
        raise SystemExit("ranks disagree: " + "; ".join(bad))
    sys.stdout.write(f"OK: {len(results)} ranks agree on tokens and routes\n")


if __name__ == "__main__":
    main()
