"""The sharded train step: one rank's step under the tensor-parallel
runtime (``launch/spmd.py``), the counterpart of the step the reference's
dry run lowers (``launch/dryrun.py``'s ``build_lowered``) and of
``examples/elastic_train.py``'s ``jit_step``.

    params, opt, stats = train_step(model, ocfg, params, opt, batch,
                                    specs=specs, k=4, zero1=True)

runs under ``spmd.spmd(...)`` on this rank's shards (``partition.
shard_tree``; ``specs`` the full tree's ``params_pspecs``) and its rows of
the batch: ``k`` microbatches, their grads accumulated in f32 and
averaged, reduced over the batch axes in one of three ways:

  * per microbatch (the baseline): each microbatch's grads all-reduced
    (``spmd.sync_grads``);
  * once (``grad_unreduced``): the accumulated grads all-reduced once;
  * ZeRO-1 (``zero1``, which implies ``grad_unreduced``, as in the
    reference): each microbatch's grads reduce-scattered into the
    data-extended layout (``partition.zero1_specs``: a leaf's first whole
    dim that the data axes divide), where the AdamW moments live
    (``init_opt``: a rank holds 1/dp of them).  ``optim.update`` runs on
    the rank's block of each param under the extended specs, so the
    clip's norm stays the global one, and the updated blocks are
    all-gathered over the data axes once.  A leaf with no such dim is
    all-reduced and updated whole, its moments whole, as the reference
    leaves it.

Outside ``spmd`` it is the unsharded step (every reduction the identity).
``meter`` lets the dry run count each part of the step on meta
(``launch/dryrun.py``): it wraps the grads, the accumulation and the
update in spans.

A rank joins its group with ``join`` over a free local port (gloo: every
rank on the one device, collectives through host copies; nccl: rank r on
``cuda:r``, ``mesh.rank_device``, collectives on the cards), takes its
rows of each batch (``batch_rows``) and trains under ``rank_context``;
``leave`` ends it.
``launch_ranks`` runs ``TPTrainSpec`` jobs (qwen1.5-4b) as one process per
rank of a ("data", "model") mesh (``worker``), and ``reference_run`` is
the same training unsharded, in this process: ``chip_smoke.py``'s phase 16
holds the ranks, without and with ZeRO-1, to it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import optim
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch import partition, spmd
from repro_torch.launch.sharding import axis_size, mesh_sizes
from repro_torch.train.runner import value_and_grad
from repro_torch.viscosity.lang import tree_leaves, tree_map

AXES = ("data", "model")
RESULT = "RESULT "
READY_TIMEOUT_S = 600
# a rank's params against the unsharded run's, each leaf against its
# largest magnitude (float32 sums in another order)
PARAM_REL = 1e-4


# ------------------------------------------------------------------ layout
def global_shapes(params, specs, mesh):
    """Meta tensors at each leaf's global shape: the rank's shard grown by
    the ranks its spec cuts each dim over."""
    sizes = mesh_sizes(mesh)
    flat = partition.flatten(specs)
    return partition.map_with_path(params, lambda path, t: torch.empty(
        [n * axis_size(sizes, flat[path][d] if d < len(flat[path])
                       else None) for d, n in enumerate(t.shape)],
        device="meta"))


def zero_layout(params, specs):
    """Under the active ``spmd`` context: ``({path: (dim, axis) or None},
    zero1 specs)``, the dim and the data axes each leaf's ZeRO-1 block is
    cut along (None: the leaf stays whole, no dim the data axes divide or
    one rank along them)."""
    c = spmd.current()
    zspecs = partition.zero1_specs(
        specs, global_shapes(params, specs, c.mesh), c.mesh)
    flat, zflat = partition.flatten(specs), partition.flatten(zspecs)
    lay = {}
    for path in partition.flatten(params):
        d = partition.zero1_dim(flat[path], zflat[path])
        ax = zflat[path][d] if d is not None else None
        lay[path] = (d, ax) if d is not None and c.size(ax) > 1 else None
    return lay, zspecs


def _block(t, z):
    """The rank's ZeRO-1 block of ``t`` (a view), ``t`` when whole."""
    if z is None:
        return t
    c = spmd.current()
    d, ax = z
    n = t.shape[d] // c.size(ax)
    return t.narrow(d, c.index(ax) * n, n)


def init_opt(params, specs=None, *, zero1: bool = False):
    """AdamW state for the rank's ``params``: moments at the params'
    shapes, or under ZeRO-1 (inside ``spmd``) at their blocks'."""
    if not zero1 or spmd.current() is None:
        return optim.init(params)
    lay, _ = zero_layout(params, specs)
    blocks = partition.map_with_path(params,
                                     lambda p, t: _block(t, lay[p]))
    return optim.init(blocks)


def microbatches(batch, k: int) -> List[Dict[str, torch.Tensor]]:
    """``batch`` cut along its rows into ``k`` microbatches (views)."""
    rows = next(iter(batch.values())).shape[0]
    if rows % k:
        raise ValueError(f"{rows} rows do not cut into {k} microbatches")
    n = rows // k
    return [{key: v.narrow(0, i * n, n) for key, v in batch.items()}
            for i in range(k)]


# -------------------------------------------------------------------- step
class _Meter:
    """Counts nothing (``train_step``'s default)."""

    @contextlib.contextmanager
    def span(self, name: str, i: Optional[int]):
        yield


def _reduce_zero(grads, lay):
    """ZeRO-1's reduction of one microbatch's grads: each leaf's block
    reduce-scattered over its data axes (f32), a whole leaf all-reduced
    over the batch axes."""
    c = spmd.current()
    bax = c.batch_axis()

    def red(path, g):
        z = lay[path]
        if z is None:
            return g if bax is None else \
                c.comm.all_reduce(g.float(), bax).to(g.dtype)
        return c.comm.reduce_scatter(g.float(), z[1], z[0])
    return partition.map_with_path(grads, red)


def train_step(model, ocfg, params, opt, batch, *, specs=None, k: int = 1,
               grad_unreduced: bool = False, zero1: bool = False,
               meter=None) -> Tuple[Any, Any, Dict[str, Any]]:
    """One training step on this rank (see the module docstring): updates
    ``params`` and ``opt`` in place and returns them with ``{"loss",
    "grad_norm", "lr", "metrics"}``.  ``opt`` is ``init_opt``'s with the
    same ``zero1``."""
    meter = meter or _Meter()
    zero = zero1 and spmd.current() is not None
    lay, zspecs = zero_layout(params, specs) if zero else ({}, None)
    acc = loss = metrics = None
    for i, mb in enumerate(microbatches(batch, k)):
        with meter.span("grads", i):
            (l, metrics), g = value_and_grad(model.forward, params, mb)
            if zero:
                g = _reduce_zero(g, lay)
            elif not grad_unreduced:
                spmd.sync_grads(g)
        with meter.span("accumulate", i):
            if k == 1:
                acc = g
            else:
                if acc is None:
                    acc = tree_map(lambda t: torch.zeros(
                        t.shape, dtype=torch.float32, device=t.device), g)
                torch._foreach_add_(tree_leaves(acc), tree_leaves(g))
            del g
        loss = l if loss is None else loss + l
    with meter.span("update", None):
        if k > 1:
            torch._foreach_div_(tree_leaves(acc), float(k))
            loss = loss / k
        if zero:
            blocks = partition.map_with_path(
                params, lambda p, t: _block(t, lay[p]))
            _, opt, stats = optim.update(ocfg, acc, opt, blocks,
                                         specs=zspecs)
            _gather_blocks(params, blocks, lay)
        else:
            if grad_unreduced:
                spmd.sync_grads(acc)
            params, opt, stats = optim.update(ocfg, acc, opt, params,
                                              specs=specs)
    return params, opt, {"loss": loss, "grad_norm": stats["grad_norm"],
                         "lr": stats["lr"], "metrics": metrics}


@torch.no_grad()
def _gather_blocks(params, blocks, lay):
    """Each updated block all-gathered over its data axes into its
    param."""
    c = spmd.current()
    fp, fb = partition.flatten(params), partition.flatten(blocks)
    for path, z in lay.items():
        if z is not None:
            fp[path].copy_(c.comm.all_gather(fb[path], z[1], z[0]))


def moment_bytes(opt) -> int:
    return int(sum(t.numel() * t.element_size()
                   for t in tree_leaves((opt.mu, opt.nu))))


# ---------------------------------------------------------------- the ranks
def join(port: int, world: int, rank: int, shape, dev, *,
         backend: str = "gloo", host: Optional[bool] = None,
         timed: bool = False):
    """Join the group of ``world`` ranks at a local ``port`` (rank 0
    serves its store): the ("data", "model") mesh of ``shape`` over the
    ranks' devices (``mesh.rank_devices`` of ``dev``: under nccl rank r's
    is ``cuda:r``), its communicator (``spmd.GroupComm``'s ``host`` and
    ``timed``) and this rank's coordinates."""
    from repro_torch.launch.distributed import initialize_runtime
    from repro_torch.launch.mesh import make_mesh, rank_devices
    initialize_runtime(f"127.0.0.1:{port}", world, rank, backend=backend,
                       timeout_s=READY_TIMEOUT_S)
    mesh = make_mesh(tuple(shape), AXES,
                     devices=rank_devices(world, backend, dev))
    return mesh, spmd.GroupComm(mesh, rank, host=host, timed=timed), \
        spmd.rank_coords(mesh, rank)


def leave(coord=None):
    """Leave the group together (rank 0 serves its store); ``coord`` the
    rank's ``KVCoordinator`` where it has exchanged over one."""
    from repro_torch.launch.distributed import (KVCoordinator,
                                                shutdown_runtime)
    (coord or KVCoordinator()).exchange("leave")
    shutdown_runtime()


def batch_rows(batch: int, mesh, coords) -> slice:
    """This rank's rows of a global batch of ``batch`` rows: its block
    along the batch axes."""
    sizes = mesh_sizes(mesh)
    dax = tuple(a for a in ("pod", "data") if a in sizes)
    n = batch // axis_size(sizes, dax)
    i = partition.axis_index(sizes, coords, dax)
    return slice(i * n, (i + 1) * n)


def rank_context(cfg, mesh, coords, comm):
    """The ``spmd`` context a rank of ``mesh`` trains ``cfg`` under."""
    return spmd.spmd(mesh, partition.rules_for(cfg, mesh),
                     partition.DEFAULT_AXES, coords, comm,
                     dims=spmd.logical_sizes(cfg))


# AdamW for ``TPTrainSpec``: a clip that binds, and an eps at the clipped
# gradient's scale, so that each element's step is a smooth function of
# its gradient and the ranks agree with the unsharded run to rounding (at
# 1e-8 the first step is lr * sign(g), which a gradient at rounding level
# may flip; tests/test_torch_spmd.py)
OCFG = optim.AdamWConfig(lr=1e-3, warmup_steps=1, clip_norm=1.0, eps=1.0)
ARCH = "qwen1.5-4b"


@dataclasses.dataclass
class TPTrainSpec:
    """What every rank trains: ``ARCH`` (``full`` width or the reduced
    config, ``layers`` deep when given; f32 params), its weights (drawn
    from seed 0, or a job's ``init`` file), the data (``SyntheticLM`` of
    ``batch`` rows of ``seq`` tokens, each rank its rows of its data
    coordinate), and the step: ``zero1`` or the baseline's reduction,
    AdamW as ``OCFG``."""
    full: bool = False
    layers: Optional[int] = None
    batch: int = 4
    seq: int = 32
    steps: int = 2
    zero1: bool = False

    def config(self):
        cfg = get_config(ARCH)
        if not self.full:
            cfg = cfg.reduced()
        if self.layers:
            cfg = dataclasses.replace(cfg, num_layers=self.layers)
        return dataclasses.replace(cfg, dtype="float32")

    def batch_at(self, cfg, step: int, rows: slice, device):
        from repro_torch.data import DataConfig, SyntheticLM
        b = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                   batch=self.batch, seq_len=self.seq)
                        ).batch_at(step)
        return {k: torch.from_numpy(v[rows]).to(device)
                for k, v in b.items()}


def make_job(spec: TPTrainSpec, name: str, *, init: Optional[str] = None,
             want: Optional[str] = None, compare: Optional[str] = None,
             ready: Optional[str] = None) -> Dict[str, Any]:
    """One job of ``launch_ranks``: ``spec`` trained from the full params
    in ``init`` (a ``torch.save``d tree; else drawn from seed 0); the
    rank's final params and first moments held against their shards of
    ``want`` (``reference_run``'s; under ZeRO-1 the moments' blocks), and
    its params against job ``compare``'s (an earlier job of the same
    launch), each as the max over leaves of max |a - b| / max |b|.  With
    ``ready`` the rank waits for that file before it starts the job (the
    files above are written while the ranks start)."""
    return {"spec": dataclasses.asdict(spec), "name": name, "init": init,
            "want": want, "compare": compare, "ready": ready}


def _draw(cfg, device):
    from repro_torch.models import build_model
    gen = torch.Generator(device=device).manual_seed(0)
    return build_model(cfg).init(gen, device=device)


def max_rel(got, want) -> float:
    """The max over leaves of max |got - want| / max |want| (trees of the
    same structure)."""
    worst = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        b = b.to(a.device)
        scale = max(float(b.abs().max()), 1e-30)
        worst = max(worst, float((a.float() - b.float()).abs().max())
                    / scale)
    return worst


def _vs_want(path, params, opt, specs, mesh, coords, layout, zero1):
    """Under the rank's context: its params and first moments against
    their shards of ``reference_run``'s ``want`` file (the moments' ZeRO-1
    blocks under ``zero1``)."""
    want = torch.load(path, mmap=True, map_location="cpu")
    mu = partition.shard_tree(want["mu"], specs, mesh, coords,
                              layout=layout)
    if zero1:
        lay, _ = zero_layout(params, specs)
        mu = partition.map_with_path(mu, lambda p, t: _block(t, lay[p]))
    return {"params": max_rel(params, partition.shard_tree(
                want["params"], specs, mesh, coords, layout=layout)),
            "mu": max_rel(opt.mu, mu)}


def train_job(job, rank: int, dev, mesh, comm, held: Dict[str, Any]
              ) -> Dict[str, Any]:
    """One job on this rank: its shard of the job's params trained
    ``spec.steps`` steps under ``rank_context``; per step the loss, the
    grad norm, the ms (the card synchronised) and the collectives (by
    kind, by axis; with a ``timed`` communicator each kind's count and ms
    too, "collective_ms"); the rank's param and moment bytes, its peak,
    and the comparisons of ``make_job`` ("vs_want": {"params", "mu"};
    "vs_compare").  Its final shards stay in ``held``."""
    from repro_torch.models import build_model
    spec = TPTrainSpec(**job["spec"])
    cfg = spec.config()
    coords = spmd.rank_coords(mesh, rank)
    t0 = time.perf_counter()
    while job.get("ready") and not os.path.exists(job["ready"]):
        if time.perf_counter() - t0 > READY_TIMEOUT_S:
            raise TimeoutError(f"{job['ready']} did not appear in "
                               f"{READY_TIMEOUT_S} s")
        time.sleep(0.05)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    full = (torch.load(job["init"], mmap=True, map_location="cpu")
            if job.get("init") else _draw(cfg, dev))
    specs = partition.params_pspecs(full, mesh)
    layout = partition.packed_layout(cfg)
    params = partition.map_with_path(
        partition.shard_tree(full, specs, mesh, coords, layout=layout),
        lambda _, t: t.to(dev, copy=True,
                          memory_format=torch.contiguous_format))
    del full
    model = build_model(cfg)
    rows = batch_rows(spec.batch, mesh, coords)
    steps = []
    log = comm.log
    res = {"name": job["name"], "coords": coords}
    with rank_context(cfg, mesh, coords, comm):
        opt = init_opt(params, specs, zero1=spec.zero1)
        for s in range(spec.steps):
            batch = spec.batch_at(cfg, s, rows, dev)
            before = log.copy()
            if comm.timed:
                comm.times()
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            params, opt, st = train_step(model, OCFG, params, opt, batch,
                                         specs=specs, zero1=spec.zero1)
            loss = float(st["loss"])
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ms = 1e3 * (time.perf_counter() - t0)
            steps.append({"loss": loss, "grad_norm": float(st["grad_norm"]),
                          "ms": ms, "collectives": _since(log, before)})
            if comm.timed:
                steps[-1]["collective_ms"] = comm.times()
        if job.get("want"):
            res["vs_want"] = _vs_want(job["want"], params, opt, specs, mesh,
                                      coords, layout, spec.zero1)
    res.update({"steps": steps, "param_bytes": _nbytes(params),
                "moment_bytes": moment_bytes(opt),
                "opt_count": int(opt.count),
                "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                             if dev.type == "cuda" else None)})
    if job.get("compare"):
        res["vs_compare"] = max_rel(params, held[job["compare"]])
    held[job["name"]] = params
    return res


def _since(log, before) -> Dict[str, Dict[str, float]]:
    """What ``log`` recorded since ``before`` (a ``copy()``), by kind:
    calls, payload bytes and link bytes; and payload bytes by
    "kind|axis"."""
    zero = {"n": 0, "bytes": 0.0, "link_bytes": 0.0}
    out: Dict[str, Dict[str, float]] = {"n": {}, "bytes": {},
                                        "link_bytes": {}, "by_axis": {}}
    for key, e in log.copy().items():
        kind, ax = key[:2]
        b = before.get(key, zero)
        for f in ("n", "bytes", "link_bytes"):
            out[f][kind] = out[f].get(kind, 0) + e[f] - b[f]
        k = f"{kind}|{ax}"
        out["by_axis"][k] = out["by_axis"].get(k, 0.0) + e["bytes"] \
            - b["bytes"]
    return {f: {k: v for k, v in d.items() if v} for f, d in out.items()}


def _nbytes(tree) -> int:
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(tree)))


def train_rank(jobs: Sequence[Dict[str, Any]], rank: int, world: int,
               port: int, mesh_shape, *, backend: str = "gloo",
               device=None, host: Optional[bool] = None,
               timed: bool = False) -> List[Dict[str, Any]]:
    """One rank, on its device (``mesh.rank_device``): join the group
    once, run the jobs in turn (``train_job``); their reports in order."""
    from repro_torch.launch.mesh import rank_device
    t_start = time.perf_counter()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dev = rank_device(rank, world, backend, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    mesh, comm, _ = join(port, world, rank, mesh_shape, device,
                         backend=backend, host=host, timed=timed)
    held: Dict[str, Any] = {}
    out = []
    for job in jobs:
        comm.log.reset()
        res = train_job(job, rank, dev, mesh, comm, held)
        res.update({"rank": rank, "world": world, "backend": backend,
                    "device": str(dev), "host_copies": comm.host,
                    "groups_s": comm.build_s, "mesh": list(mesh_shape),
                    "process_s": time.perf_counter() - t_start})
        out.append(res)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    leave()
    return out


WORKER = ("import sys, json; sys.path.insert(0, sys.argv[1]); "
          "from repro_torch.launch import tp_train; "
          "sys.exit(tp_train.worker(sys.argv[2:]))")


def worker(argv) -> int:
    """One rank from the command line ``launch_ranks`` builds: prints one
    ``RESULT {json}`` line, the list of its jobs' reports."""
    a = json.loads(argv[0])
    res = train_rank(a["jobs"], a["rank"], a["world"], a["port"], a["mesh"],
                     backend=a["backend"], device=a["device"],
                     host=a.get("host"), timed=a.get("timed", False))
    sys.stdout.write(RESULT + json.dumps(res) + "\n")
    sys.stdout.flush()
    return 0


def launch_ranks(jobs: Sequence[Dict[str, Any]], mesh_shape, *,
                 device=None, backend: str = "gloo",
                 host: Optional[bool] = None, timed: bool = False,
                 timeout: float = 600.0, src: Optional[str] = None,
                 env=None) -> List[List[Dict]]:
    """Start one process per rank of ``mesh_shape``, each on its device
    (``mesh.rank_device``: under nccl rank r on ``cuda:r``, refused
    without a card a rank), which joins the group once and runs ``jobs``
    (``make_job(...)``) in turn; per job, its reports by rank.  ``host``
    and ``timed``: the ranks' ``spmd.GroupComm``.  A rank that fails
    raises with its stderr."""
    from repro_torch.launch.mesh import rank_devices
    from repro_torch.launch.tp_serve import free_port, run_ranks
    world = int(np.prod(mesh_shape))
    devs = rank_devices(world, backend, device)
    port = free_port()
    args = [json.dumps({"jobs": list(jobs), "rank": r, "world": world,
                        "port": port, "mesh": list(mesh_shape),
                        "backend": backend, "device": str(devs[r]),
                        "host": host, "timed": timed})
            for r in range(world)]
    results = run_ranks(WORKER, args, timeout=timeout, src=src, env=env)
    return [[r[i] for r in results] for i in range(len(jobs))]


def _host(tree):
    return tree_map(lambda t: t.cpu(), tree)


def reference_run(spec: TPTrainSpec, device=None, *,
                  init: Optional[str] = None, want: Optional[str] = None,
                  rows: slice = slice(None),
                  against: Optional[str] = None) -> Dict[str, Any]:
    """``spec`` trained unsharded in this process (``rows`` of every batch,
    ``train_step`` outside ``spmd``).  Its initial params are saved to
    ``init`` and its final params and first moments to ``want`` when given
    (on the host); with ``against`` (another run's ``want``) its final ones
    are held against those (``max_rel``, "vs").  Returns the losses, the
    grad norms, each step's ms and the peak."""
    from repro_torch.models import build_model
    dev = resolve_device(device)
    cfg = spec.config()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = _draw(cfg, dev)
    if init:
        torch.save(_host(params), init)
    model = build_model(cfg)
    opt = init_opt(params)
    losses, norms, ms = [], [], []
    for s in range(spec.steps):
        batch = spec.batch_at(cfg, s, rows, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, opt, st = train_step(model, OCFG, params, opt, batch)
        losses.append(float(st["loss"]))
        norms.append(float(st["grad_norm"]))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
    if want:
        torch.save({"params": _host(params), "mu": _host(opt.mu)}, want)
    out = {"losses": losses, "grad_norms": norms, "ms": ms,
           "param_bytes": _nbytes(params), "moment_bytes": moment_bytes(opt),
           "peak_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                        if dev.type == "cuda" else None)}
    if against:
        other = torch.load(against, mmap=True, map_location="cpu")
        out["vs"] = {"params": max_rel(params, other["params"]),
                     "mu": max_rel(opt.mu, other["mu"])}
        del other
    del params, opt
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out
