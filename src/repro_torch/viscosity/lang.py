"""Viscosity: one op description, two lowerings (paper §III-B).

Port of the reference's ``viscosity/lang.py``.  The route strings keep the
reference's values, so plans are interchangeable between the packages:

  * the **software** lowering (``ref``) is a plain PyTorch oracle;
  * the **hardware** lowering (``kernel``) is a CUDA C++ kernel written by
    hand for Hopper — on a CPU tensor its wrapper runs the kernel's plain
    blocked version instead;
  * ``interpret`` is the kernel's blocked algorithm replayed in PyTorch on
    the CPU (Pallas interpret mode has no GPU twin).

A route is a target string, a ``core.routing.RoutingPlan`` (duck-typed via
``target_for``) or a ``core.routing.ResidentRoute`` (duck-typed via
``select``): the hot-spare lowering that picks HW or SW per call from a
host-side health bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

# Routes (per-stage state in a FaultSignature); same strings as the
# reference.
HW = "hw"              # optimized path: the Hopper kernel
SW = "sw"              # software fallback: the PyTorch oracle
INTERPRET = "interpret"  # the kernel's blocked algorithm, on the CPU

# The DEGRADED route family (partial degradation, paper §III-A).
DEGRADED_REMAP = "degraded_remap"      # HW full width; oracle heals dead lanes
DEGRADED_REDUCED = "degraded_reduced"  # kernel shrunk to surviving lanes
DEGRADED_TARGETS = (DEGRADED_REMAP, DEGRADED_REDUCED)


@dataclass(frozen=True)
class OpSpec:
    """One op described once; lowered to hardware and software paths."""
    name: str
    ref: Callable[..., Any]                       # the single source of truth
    kernel: Optional[Callable[..., Any]] = None   # Hopper kernel path
    interpret: Optional[Callable[..., Any]] = None
    valid: Optional[Callable[[Any], Any]] = None  # validity predicate on outputs
    tol: float = 2e-2                             # hw-vs-sw allclose contract (bf16)
    flops: Optional[Callable[..., int]] = None    # analytic flop model
    # Reduced-width support (DEGRADED_REDUCED): (args, kw, keep_lanes) ->
    # (args, kw) with the lane-axis operands sliced to the surviving lanes.
    lane_slicer: Optional[Callable[..., Any]] = None

    def lower(self, target) -> Callable[..., Any]:
        if hasattr(target, "target_for"):   # RoutingPlan: my stage's entry
            target = target.target_for(self.name)
        if hasattr(target, "select"):       # ResidentRoute: per-call pick
            return target.select(self)
        if target == SW or self.kernel is None:
            return self.ref
        if target == HW:
            return self.kernel
        if target == INTERPRET:
            return self.interpret or self.kernel
        if target in DEGRADED_TARGETS:      # lane-mapped partial degradation
            from repro_torch.viscosity import lanefault
            return lanefault.lower_degraded(self, target)
        raise ValueError(f"unknown lowering target {target!r} for op {self.name}")

    def __call__(self, *args, route=SW, **kw):
        return self.lower(route)(*args, **kw)


class Registry:
    def __init__(self):
        self._ops: Dict[str, OpSpec] = {}

    def register(self, spec: OpSpec) -> OpSpec:
        if spec.name in self._ops:
            raise ValueError(f"duplicate viscosity op {spec.name!r}")
        self._ops[spec.name] = spec
        return spec

    def get(self, name: str) -> OpSpec:
        return self._ops[name]

    def names(self):
        return sorted(self._ops)

    def __contains__(self, name):
        return name in self._ops


REGISTRY = Registry()


def defop(name: str, *, ref, kernel=None, interpret=None, valid=None,
          tol: float = 2e-2, flops=None, lane_slicer=None) -> OpSpec:
    """Declare an op once; both lowerings become available framework-wide."""
    return REGISTRY.register(OpSpec(name=name, ref=ref, kernel=kernel,
                                    interpret=interpret, valid=valid,
                                    tol=tol, flops=flops,
                                    lane_slicer=lane_slicer))


def tree_leaves(tree):
    """Leaves of a nested tuple/list/dict of tensors (the port's pytrees) in
    ``jax.tree_util.tree_leaves`` order: dict keys sorted, tuples and lists
    in order, ``None`` skipped.  The checksum's fold over leaves depends on
    that order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure, keeping it."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (tuple, list)):
        return type(t0)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def finite_valid(out) -> torch.Tensor:
    """Default validity predicate: every floating leaf is finite."""
    ok = torch.tensor(True)
    for leaf in tree_leaves(out):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            ok = ok & torch.isfinite(leaf).all().cpu()
    return ok
