"""Dry run on the H100: every (arch x shape x chips) cell's step, built on
``torch.device("meta")``, so nothing is allocated and no card is needed.

The port's counterpart of the reference's compile-only dry run over a
TPU pod.  For each cell the step runs eagerly on meta tensors under
``launch/op_analysis.py``'s dispatch mode, on the SW route (``build_model
(cfg)``, routes None), and records:

  * the parameter and active-parameter counts and ``model_flops`` (the
    reference's formulas);
  * the counted FLOPs, the HBM-traffic proxy and the SW attention's
    score-tensor bytes, per device;
  * bytes: params, optimiser state, cache, and the peak of live tensors,
    against the card's memory less a reserve (``HBM_LIMIT``): ``fits``;
  * the roofline terms in seconds with the dominant one, and the HW-route
    projection (the traffic less the score tensors, which the Hopper
    attention kernel keeps in shared memory).

The step of each kind:
  * train: ``launch/tp_train.py``'s ``train_step`` (``value_and_grad``
    of ``model.forward``, then ``optim.update``; no NaN guard, which reads
    the loss on the host) with f32 params and AdamW.  With k > 1
    microbatches the grads of each microbatch are summed into an f32
    accumulator, as the reference's dry run does; k follows its rule:
    start at max(1, rows / 4) and double until the peak fits or k reaches
    the rows.  On meta every microbatch is the same, so two run and the
    rest are counted as the second (``_DryMeter``);
  * prefill: ``model.prefill`` on the params as the serving engine holds
    them (``compute_params``: the compute dtype) and a cache of
    ``seq_len`` slots;
  * decode: one ``decode_step`` at the last position of a ``seq_len``
    cache.

``--chips`` 1 or 4: the port's data-parallel fleet, every device holding
the whole model, the global batch split over the chips (max(1, B //
chips) rows a device); its collective term is 0 (``COLLECTIVE_REASON``).

``--mesh single|multi|DxM`` (the reference's ``--mesh``: (16, 16)
("data", "model") or (2, 16, 16) ("pod", "data", "model"), and small
meshes such as ``1x4``): a sharded cell runs one rank's local step under
the tensor-parallel runtime (``launch/spmd.py``) with the counting
communicator on meta: its params, optimiser state and cache are the
rank's shards (``partition.params_pspecs``, ``make_cache_pspec_fn``),
its rows the batch over the batch axes, and the collectives the runtime
calls are counted by kind, axis and bytes (a sequence-cut KV cache's
decode among them: its query heads and softmax partials gathered per
slot and layer; a train step's grads all-reduced per microbatch, once
under ``grad_unreduced``, or under ``zero1`` reduce-scattered into
``partition.zero1_specs``, where its moments live, 1/dp of them a rank,
and the updated params all-gathered once). The collective term prices
each axis's ring link bytes (all-reduce 2(m-1)/m, all-gather and
reduce-scatter (m-1)/m) at NVLink's rate when the axis's group fits one
8-GPU node, else at the network's (``launch/mesh.py``). An
encoder-decoder decode state's cross-KV is the rank's kv heads, as the
runtime projects it
(``make_cache_pspec_fn`` cuts its batch only).  A variant that cuts the
cache otherwise than the params (Mamba2's state under ``attn2d`` and the
``ep`` family) counts the step's moves between the two cuts.  What the
runtime does not shard (a Mamba2 component that does not divide the
``ssm`` axis or the cache's; a KV cache whose heads and slots both do
not divide) is a ``skip`` with the reason and its spec-derived
per-device bytes.

Usage:
  python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--chips 1|4|both] [--force]
  python -m repro_torch.launch.dryrun --all --mesh 1x4

Records are cached as JSON under ``artifacts/dryrun_torch/``
(``<arch>__<shape>__<chips>chip.json``, ``<arch>__<shape>__<mesh>.json``);
``launch/reanalyze.py`` recomputes their roofline and ``fits`` when a
constant changes.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch import optim
from repro_torch.configs import ARCH_NAMES, SHAPES, applicable, get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import partition, spmd, tp_train
from repro_torch.launch.mesh import (GPUS_PER_NODE, NET_BW, NVLINK_BW,
                                     make_mesh, make_production_mesh)
from repro_torch.launch.op_analysis import OpAnalysis, OpStats
from repro_torch.launch.sharding import PartitionSpec, axis_size, mesh_sizes
from repro_torch.models import (build_model, compute_params,
                                decode_state_specs, params_specs,
                                prefill_batch_specs, train_batch_specs)
from repro_torch.obs.logging import configure as obs_configure, get_logger
from repro_torch.viscosity.lang import tree_leaves

log = get_logger("launch.dryrun")

ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "artifacts", "dryrun_torch")

# The card (NVIDIA data sheet, H100 SXM5, dense): the roofline's rates
DEVICE = "NVIDIA H100 80GB HBM3"
POWER_LIMIT_W = 700.0
PEAK_FLOPS_BF16 = 989e12      # FLOP/s
HBM_BW = 3.35e12              # bytes/s
# the card's memory as torch reports it (``torch.cuda.get_device_properties
# (0).total_memory`` on an H100 80GB HBM3: 79.18 GiB)
HBM_BYTES = 85_017_493_504
# what it leaves a step: 4 GiB go to the CUDA context, cuBLAS workspaces
# and the caching allocator's free blocks
HBM_RESERVE = 4 * 2 ** 30
HBM_LIMIT = HBM_BYTES - HBM_RESERVE
COLLECTIVE_REASON = (
    "0 (a --chips cell; a --mesh cell counts the tensor-parallel "
    "runtime's collectives): the port's data-parallel fleet runs no "
    "collective; its logical "
    "devices run one after another and sum their shard grads into one "
    "accumulator (train/runner.py FleetTrainRunner), and launch/"
    "distributed.py exchanges only plans and completions, not tensors")
HW_ROUTE_TRAIN = ("none: the HW route is forward-only (the kernels have "
                  "no backward), so training runs SW")


SHARDED_REASON = (
    "the tensor-parallel runtime's collectives, counted on one rank: "
    "per axis, ring link bytes over NVLink within an 8-GPU node, else "
    "over the network")
META = torch.device("meta")


class SkipCell(Exception):
    """A cell that does not run; ``extra`` joins its record (a sharded
    skip's spec-derived bytes)."""

    def __init__(self, reason, extra=None):
        super().__init__(reason)
        self.extra = extra or {}


def _count(tree) -> int:
    return int(sum(t.numel() for t in tree_leaves(tree)))


def _nbytes(tree) -> int:
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                   if isinstance(t, torch.Tensor)))


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (str(k),))
    else:
        yield prefix, tree


def _active_params(cfg, params) -> int:
    """The reference's rule: MoE expert weights (a ``w1``/``w2``/``w3``
    under ``moe``) count top_k / num_experts of their size."""
    total = _count(params)
    if cfg.moe is None:
        return total
    expert = sum(leaf.numel() for keys, leaf in _paths(params)
                 if "moe" in keys and keys[-1] in ("w1", "w2", "w3"))
    return total - expert + expert * cfg.moe.top_k // cfg.moe.num_experts


def model_flops(cfg, shape: ShapeSpec, params) -> float:
    n = _active_params(cfg, params)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def roofline_terms(flops: float, hbm_bytes: float, score_bytes: float,
                   n_chips: int, mfl: float, kind: str,
                   collectives: Optional[Mapping[str, Any]] = None
                   ) -> Dict[str, Any]:
    """Per-device seconds of compute, memory and collectives, the
    dominant term, and the HW-route projection (train: none).
    ``collectives`` (a sharded cell's) prices its link bytes by axis."""
    coll_s = collective_seconds(collectives) if collectives else 0.0

    def terms(mem_bytes):
        t = {"compute_s": flops / PEAK_FLOPS_BF16,
             "memory_s": mem_bytes / HBM_BW, "collective_s": coll_s}
        bound = max(t.values())
        return {**t, "dominant": max(t, key=t.get),
                "roofline_fraction": (mfl / n_chips / PEAK_FLOPS_BF16) / bound
                if bound > 0 else 0.0}
    sw = terms(hbm_bytes)
    sw["useful_flops_ratio"] = (mfl / n_chips) / max(flops, 1.0)
    sw["collective_reason"] = (SHARDED_REASON if collectives
                               else COLLECTIVE_REASON)
    sw["score_bytes_per_dev"] = score_bytes
    sw["hw_route"] = (HW_ROUTE_TRAIN if kind == "train" else
                      terms(max(hbm_bytes - score_bytes, 0.0)))
    return sw


def collective_seconds(coll: Mapping[str, Any]) -> float:
    """Seconds of a sharded cell's collectives: each axis's ring link
    bytes at NVLink's rate within a node, else the network's."""
    return sum(b / (NVLINK_BW if coll["within_node"][ax] else NET_BW)
               for ax, b in coll["link_bytes_by_axis"].items())


def _rows(shape: ShapeSpec, chips: int) -> int:
    return max(1, shape.global_batch // chips)


def mesh_for(name: str):
    """"single", "multi" or "DxM" -> the mesh on meta devices."""
    if name in ("single", "multi"):
        return make_production_mesh(multi_pod=name == "multi",
                                    devices=[META] * 512)
    shape = tuple(int(v) for v in name.lower().split("x"))
    if len(shape) != 2:
        raise ValueError(f"--mesh {name!r}: single, multi or DxM")
    return make_mesh(shape, ("data", "model"),
                     devices=[META] * (shape[0] * shape[1]))


def _within_node(mesh, axis) -> bool:
    return len({r // GPUS_PER_NODE
                for r in spmd.devices_spanned(mesh, axis)}) == 1


class _DryMeter:
    """``tp_train.train_step``'s meter on meta, where the step runs two
    of the k microbatches (every microbatch is the same there): each part
    is counted, and the second's counts and collectives stand for the
    k - 1 after the first."""

    def __init__(self, oa: OpAnalysis, params, k: int):
        self.oa, self.params, self.k = oa, params, k
        self.log = spmd.collective_log()
        self.st: Dict[Any, OpStats] = {}
        self.before = None

    @contextlib.contextmanager
    def span(self, name: str, i: Optional[int]):
        if name == "grads" and i == 1 and self.log is not None:
            self.before = self.log.copy()
        with self.oa.counting() as st:
            if name == "grads":
                self.oa.read_once(self.params)
            yield
        self.st[(name, i)] = st
        if name == "accumulate" and i == 1 and self.log is not None:
            self.log.repeat_since(self.before, self.k - 2)

    def total(self) -> OpStats:
        first = self.st[("grads", 0)].scaled_add(self.st[("accumulate", 0)])
        if self.k > 1:
            first = first.scaled_add(self.st[("grads", 1)].scaled_add(
                self.st[("accumulate", 1)]), self.k - 1)
        return first.scaled_add(self.st[("update", None)])


def _train_step(oa: OpAnalysis, model, params, opt, cfg, rows, S, k, *,
                grad_unreduced: bool = False, zero1: bool = False,
                specs=None):
    """``tp_train.train_step`` on meta, k microbatches of rows / k: the
    step takes two of them (one when k = 1) and ``_DryMeter`` counts the
    rest; returns the step's OpStats.  Under ``spmd`` the grads are
    reduced as ``grad_unreduced`` and ``zero1`` say (``opt`` then
    ``tp_train.init_opt``'s) and the clip's norm is the global one
    (``specs``: the params' PartitionSpecs)."""
    if rows % k:
        raise ValueError(f"{rows} rows do not cut into {k} microbatches")
    meter = _DryMeter(oa, params, k)
    runs = min(k, 2)
    tp_train.train_step(model, optim.AdamWConfig(), params, opt,
                        train_batch_specs(cfg, rows // k * runs, S),
                        specs=specs, k=runs, grad_unreduced=grad_unreduced,
                        zero1=zero1, meter=meter)
    return meter.total()


def _local(tree, specs, mesh):
    """Meta tensors at each leaf's local shape under ``specs``."""
    flat = partition.flatten(specs)
    return partition.map_with_path(tree, lambda path, t: torch.empty(
        partition.local_shape(t.shape, flat[path], mesh), dtype=t.dtype,
        device=META))


def _cross_kv_specs(cfg, specs, rules, mesh):
    """The specs of an encoder-decoder decode state's cross-KV ((L, B,
    S_enc, Hkv, Dh) each) as the runtime holds it: its kv heads cut as
    ``rules`` cut "kv_heads" (``EncDecModel.cross_kv_cache`` under
    ``spmd``), where ``make_cache_pspec_fn`` cuts the batch only."""
    ax = rules.get("kv_heads")
    m = axis_size(mesh_sizes(mesh), ax)
    if m == 1 or cfg.num_kv_heads % m:
        return specs
    return type(specs)(PartitionSpec(*s[:-2], ax, s[-1]) for s in specs)


def _sharded_inputs(cfg, model, shape: ShapeSpec, mesh, rules, axes,
                    zero1: bool = False):
    """The rank's params (and optimiser state: under ``zero1`` its
    moments at ``partition.zero1_specs``, 1/dp of them) or serving params
    and cache, as meta shards of the specs, and the params' specs; raises
    ``SkipCell`` with their bytes where the runtime does not shard the
    cell (``spmd.check_runtime``, ``spmd.cache_specs``)."""
    p_full = params_specs(model)
    pspecs = partition.params_pspecs(p_full, mesh, axes)
    params = _local(p_full, pspecs, mesh)
    B, S = shape.global_batch, shape.seq_len
    opt = cache = None
    if shape.kind == "train":
        with spmd.spmd(mesh, rules, axes):
            opt = tp_train.init_opt(params, pspecs, zero1=zero1)
    else:
        params = compute_params(params, model.compute_dtype)
        full = (prefill_batch_specs(cfg, model, B, S)["cache"]
                if shape.kind == "prefill"
                else decode_state_specs(cfg, model, B, S)[0])
        cspecs = partition.tree_pspecs(full, mesh, partition.
                                       make_cache_pspec_fn(
                                           B, mesh, attn_axis=axes["attn"]))
        if cfg.is_encdec and shape.kind == "decode":
            cspecs["cross"] = _cross_kv_specs(cfg, cspecs["cross"], rules,
                                              mesh)
        cache = _local(full, cspecs, mesh)
    spec_bytes = {"params": _nbytes(params),
                  "opt_state": _nbytes(opt) if opt is not None else 0,
                  "cache": _nbytes(cache) if cache is not None else 0}
    why = None
    with spmd.spmd(mesh, rules, axes):
        try:
            spmd.check_runtime(cfg)
            if cache is not None:
                spmd.cache_specs(model, B, S)
        except NotImplementedError as e:
            why = str(e)
    if why is not None:
        raise SkipCell(why, {"bytes": spec_bytes, "spec_bytes": spec_bytes})
    return params, opt, cache, spec_bytes, pspecs


def analyze_cell(cfg, shape: ShapeSpec, chips: int = 1,
                 microbatch: Optional[int] = None, *, mesh=None,
                 rules: Optional[Mapping[str, Any]] = None,
                 axes: Optional[Mapping[str, Any]] = None,
                 grad_unreduced: bool = False,
                 zero1: bool = False) -> Dict[str, Any]:
    """One cell's record (no cache, no status): the step of
    ``shape.kind`` at ``max(1, B // chips)`` rows on meta, or with
    ``mesh`` one rank's local step under the tensor-parallel runtime
    (``rules``/``axes``: a variant's, else ``rules_for`` and
    ``DEFAULT_AXES``; ``grad_unreduced`` and ``zero1`` the step's grad
    reduction, ``tp_train.train_step``)."""
    ok, why = applicable(cfg, shape)
    if not ok:
        raise SkipCell(why)
    if mesh is not None:
        return _analyze_sharded(cfg, shape, mesh, microbatch, rules, axes,
                                grad_unreduced, zero1)
    model = build_model(cfg)
    rows, S = _rows(shape, chips), shape.seq_len
    p_meta = params_specs(model)
    rec: Dict[str, Any] = {
        "kind": shape.kind, "seq_len": S, "global_batch": shape.global_batch,
        "chips": chips, "rows_per_device": rows,
        "fleet": "data-parallel: every device holds the whole model, the "
                 "global batch is split over the chips",
        "device": DEVICE, "power_limit_w": POWER_LIMIT_W,
        "params": _count(p_meta),
        "active_params": _active_params(cfg, p_meta),
        "model_flops": model_flops(cfg, shape, p_meta),
        "microbatch": None}
    k = microbatch or max(1, rows // 4)
    while True:
        # the inputs are made outside the mode and held: what a deployment
        # keeps resident (nothing of how it was built counts)
        opt = cache = None
        if shape.kind == "train":
            params = p_meta
            opt = optim.init(params)
            inputs = (params, opt)
        else:
            params = compute_params(p_meta, model.compute_dtype)
            if shape.kind == "prefill":
                batch = prefill_batch_specs(cfg, model, rows, S)
                cache = batch["cache"]
                inputs = (params, batch)
            else:
                cache, tok, t = decode_state_specs(cfg, model, rows, S)
                inputs = (params, cache, tok)
        with OpAnalysis() as oa:
            oa.hold(inputs)
            if shape.kind == "train":
                st = _train_step(oa, model, params, opt, cfg, rows, S, k)
            else:
                with oa.counting() as st:
                    oa.read_once(params)
                    if shape.kind == "prefill":
                        model.prefill(params, batch)
                    else:
                        model.decode_step(params, cache, tok, t)
        peak = oa.peak_bytes
        if (shape.kind != "train" or peak <= HBM_LIMIT or k >= rows
                or microbatch):
            break
        k = min(rows, 2 * k)
    if shape.kind == "train":
        rec["microbatch"] = k
    rec["bytes"] = {"params": _nbytes(params),
                    "opt_state": _nbytes(opt) if opt is not None else 0,
                    "cache": _nbytes(cache) if cache is not None else 0,
                    "peak": peak}
    rec.update(_derived(rec, st))
    return rec


def _analyze_sharded(cfg, shape: ShapeSpec, mesh, microbatch, rules, axes,
                     grad_unreduced, zero1) -> Dict[str, Any]:
    sizes = mesh_sizes(mesh)
    n_chips = int(np.prod(list(sizes.values())))
    dp = int(np.prod([sizes[a] for a in ("pod", "data") if a in sizes]))
    B, S = shape.global_batch, shape.seq_len
    rows = B // dp if B % dp == 0 else B      # batch_pspec's rule
    rules = dict(rules if rules is not None
                 else partition.rules_for(cfg, mesh))
    axes = dict(axes or partition.DEFAULT_AXES)
    model = build_model(cfg)
    p_meta = params_specs(model)
    rec: Dict[str, Any] = {
        "kind": shape.kind, "seq_len": S, "global_batch": B,
        "chips": n_chips, "mesh_shape": sizes, "rows_per_device": rows,
        "fleet": "tensor-parallel: one rank's shards and local step under "
                 "launch/spmd.py",
        "rules": {k: (list(v) if isinstance(v, tuple) else v)
                  for k, v in rules.items()},
        "axes": {k: (list(v) if isinstance(v, tuple) else v)
                 for k, v in axes.items()},
        "device": DEVICE, "power_limit_w": POWER_LIMIT_W,
        "params": _count(p_meta),
        "active_params": _active_params(cfg, p_meta),
        "model_flops": model_flops(cfg, shape, p_meta),
        "microbatch": None, "grad_unreduced": grad_unreduced or zero1,
        "zero1": zero1}
    try:
        params, opt, cache, spec_bytes, pspecs = _sharded_inputs(
            cfg, model, shape, mesh, rules, axes, zero1)
    except SkipCell as e:
        e.extra = {**rec, **e.extra}
        raise
    coords = {a: 0 for a in sizes}
    # decode at the last slot of the cache (whisper's: of max_target_len)
    t_last = (min(S, cfg.max_target_len) if cfg.is_encdec else S) - 1
    # a variant's microbatch count past the rank's rows takes one row each
    k = min(microbatch or max(1, rows // 4), rows)
    while True:
        comm = spmd.CountingComm(mesh)
        with spmd.spmd(mesh, rules, axes, coords, comm,
                       dims=spmd.logical_sizes(cfg)):
            if shape.kind == "prefill":
                batch = dict(prefill_batch_specs(cfg, model, rows, S))
                batch["cache"] = cache
                inputs = (params, batch)
            elif shape.kind == "decode":
                tok = torch.empty((rows, 1), dtype=torch.int32, device=META)
                inputs = (params, cache, tok)
            else:
                inputs = (params, opt)
            with OpAnalysis() as oa:
                oa.hold(inputs)
                if shape.kind == "train":
                    st = _train_step(oa, model, params, opt, cfg, rows, S, k,
                                     grad_unreduced=grad_unreduced,
                                     zero1=zero1, specs=pspecs)
                else:
                    with oa.counting() as st:
                        oa.read_once(params)
                        if shape.kind == "prefill":
                            model.prefill(params, batch)
                        else:
                            model.decode_step(params, cache, tok, t_last)
        peak = oa.peak_bytes
        if (shape.kind != "train" or peak <= HBM_LIMIT or k >= rows
                or microbatch):
            break
        k = min(rows, 2 * k)
    if shape.kind == "train":
        rec["microbatch"] = k
    rec["bytes"] = {**spec_bytes, "peak": peak}
    rec["spec_bytes"] = spec_bytes
    log = comm.log
    rec["collectives"] = {
        "bytes_by_kind": log.by_kind("bytes"),
        "link_bytes_by_kind": log.by_kind("link_bytes"),
        "link_bytes_by_axis": log.by_axis("link_bytes"),
        "link_bytes_by_kind_axis": _by_kind_axis(log),
        "n_by_kind": {kd: n for kd, n in log.by_kind("n").items()},
        "within_node": {ax: _within_node(mesh, tuple(ax.split("+"))
                                         if "+" in ax else ax)
                        for ax in log.by_axis()},
        "entries": log.snapshot()}
    rec.update(_derived(rec, st))
    return rec


def _by_kind_axis(log) -> Dict[str, float]:
    """Link bytes per "kind|axis" (every dtype together)."""
    out: Dict[str, float] = {}
    for (kind, ax, _), e in sorted(log.entries.items()):
        out[f"{kind}|{ax}"] = out.get(f"{kind}|{ax}", 0.0) + e["link_bytes"]
    return out


def _derived(rec: Mapping[str, Any], st: OpStats) -> Dict[str, Any]:
    return {
        "flops_per_dev": st.flops,
        "traffic": {"hbm_bytes_per_dev": st.bytes_hbm,
                    "score_bytes_per_dev": st.score_bytes,
                    "n_ops": st.n_ops,
                    "top_ops": [[name, b] for name, b in st.top_ops()]},
        "hbm_limit_bytes": HBM_LIMIT,
        "fits": rec["bytes"]["peak"] <= HBM_LIMIT,
        "roofline": roofline_terms(st.flops, st.bytes_hbm, st.score_bytes,
                                   rec["chips"], rec["model_flops"],
                                   rec["kind"], rec.get("collectives"))}


def cell_path(out_dir: str, arch: str, shape_name: str, chips: int,
              mesh: Optional[str] = None, tag: str = "") -> str:
    name = (f"{arch}__{shape_name}__{mesh}{tag}" if mesh
            else f"{arch}__{shape_name}__{chips}chip{tag}")
    return os.path.join(out_dir, name + ".json")


def run_cell(arch: str, shape_name: str, chips: int = 1,
             out_dir: str = ART_DIR, force: bool = False,
             shapes: Mapping[str, ShapeSpec] = SHAPES, *,
             mesh: Optional[str] = None, mesh_obj=None,
             rules: Optional[Mapping[str, Any]] = None,
             axes: Optional[Mapping[str, Any]] = None,
             overrides: Optional[Mapping[str, Any]] = None,
             microbatch: Optional[int] = None,
             grad_unreduced: bool = False, zero1: bool = False,
             tag: str = "") -> Dict[str, Any]:
    """The cell's record, from the cache unless ``force`` (a failed cell
    runs again); ``arch`` may be a ``-smoke`` name.  ``mesh`` ("single",
    "multi", "DxM") runs it sharded (``mesh_obj`` a variant's mesh in its
    place, named by ``mesh``); ``rules``, ``axes``, ``overrides`` (config
    fields), ``microbatch``, ``grad_unreduced`` and ``zero1`` are a
    hillclimb variant's, ``tag`` names its records."""
    os.makedirs(out_dir, exist_ok=True)
    path = cell_path(out_dir, arch, shape_name, chips, mesh, tag)
    if os.path.exists(path) and not force:
        with open(path) as f:
            cached = json.load(f)
        if cached.get("status") != "fail":
            return cached
    t0 = time.time()
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "chips": chips}
    if mesh:
        rec["mesh"] = mesh
    try:
        cfg = get_config(arch)
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        m = mesh_obj if mesh_obj is not None else (
            mesh_for(mesh) if mesh else None)
        rec.update(analyze_cell(cfg, shapes[shape_name], chips,
                                microbatch, mesh=m, rules=rules, axes=axes,
                                grad_unreduced=grad_unreduced,
                                zero1=zero1))
        rec["status"] = "ok"
    except SkipCell as e:
        rec.update({**e.extra, "status": "skip", "reason": str(e)})
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec.update({"status": "fail", "error": f"{type(e).__name__}: {e}",
                    "trace": traceback.format_exc()[-4000:]})
    rec["wall_s"] = round(time.time() - t0, 2)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    obs_configure(stream=sys.stdout)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCH_NAMES))
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--chips", default="both", choices=["1", "4", "both"])
    ap.add_argument("--mesh", default=None,
                    help="single | multi | DxM (e.g. 1x4): run each cell "
                         "sharded on that mesh instead of --chips")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=ART_DIR)
    args = ap.parse_args(argv)
    archs = ARCH_NAMES if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    chips = [1, 4] if args.chips == "both" else [int(args.chips)]
    if args.mesh:
        mesh_for(args.mesh)                  # a bad name fails here
        chips = [None]
    cells = [(a, s, c) for a in archs for s in shapes for c in chips]
    t0 = time.time()
    n = {"ok": 0, "skip": 0, "fail": 0}
    for i, (arch, shape, c) in enumerate(cells):
        rec = run_cell(arch, shape, c or 1, out_dir=args.out,
                       force=args.force, mesh=args.mesh)
        n[rec["status"]] += 1
        log.info("cell", i=f"{i + 1}/{len(cells)}", arch=arch, shape=shape,
                 chips=rec["chips"], mesh=args.mesh or "-",
                 status=rec["status"], wall_s=rec["wall_s"],
                 fits=rec.get("fits", "-"),
                 peak_gib=(round(rec["bytes"]["peak"] / 2 ** 30, 2)
                           if "peak" in rec.get("bytes", {}) else "-"),
                 microbatch=rec.get("microbatch") or "-",
                 dom=rec.get("roofline", {}).get("dominant", "-"))
        if rec["status"] == "fail":
            log.error("cell_failed", arch=arch, shape=shape,
                      error=rec["error"][:300])
    log.info("done", wall_s=round(time.time() - t0), **n)
    if n["fail"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
