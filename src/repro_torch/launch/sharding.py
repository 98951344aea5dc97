"""Logical-axis sharding (t5x-style rules) and fleet-aware batch
partitioning (the port's ``launch/sharding.py``).

Model code annotates activations with *logical* axis names
(``constrain(x, "batch", "seq", "embed")``).  Inside an ``axis_rules``
context those names map to mesh axes (``resolve``); outside it
``constrain`` returns its input.  The rules are the perf-iteration control
surface the hillclimb variants edit (``launch/variants.py``).

There is no partitioner to hand a layout hint to: the tensor-parallel
runtime (``launch/spmd.py``) runs each rank's shard of the step and calls
its collectives where a row-sharded product ends.  ``constrain`` never
changes a value; inside an active ``spmd`` context it checks the local
shape against the global shape cut by ``resolve(*names)`` and logs a
mismatch, as the reference logs a spec its partitioner refuses.

``shard_bounds`` splits a global batch over a data-parallel fleet's
serving devices.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.obs.logging import get_logger

log = get_logger("launch.sharding")

Axis = Union[None, str, Tuple[str, ...]]


def _norm_axis(ax: Axis) -> Axis:
    """A one-name tuple is that name, an empty one None (as JAX's
    ``PartitionSpec`` normalises them)."""
    if isinstance(ax, (tuple, list)):
        ax = tuple(ax)
        if not ax:
            return None
        return ax[0] if len(ax) == 1 else ax
    return ax


class PartitionSpec(tuple):
    """Per dimension of a tensor: ``None`` (replicated), a mesh axis name,
    or a tuple of names (sharded over their product, row-major)."""

    def __new__(cls, *parts: Axis):
        return super().__new__(cls, tuple(_norm_axis(p) for p in parts))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# Baseline rules for the production mesh ("pod" present only multi-pod).
DEFAULT_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",     # dropped per-arch when kv % model != 0
    "kv_seq": None,
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": None,
    "expert_cap": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "ssm_heads": "model",
}

_state = threading.local()


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` of a port ``Mesh``, a mapping, or any object with
    a ``shape`` mapping (the reference's ``Mesh`` and stand-ins for it)."""
    if mesh is None:
        return {}
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    if hasattr(mesh, "axes"):
        return dict(zip(mesh.axes, mesh.shape))
    return {str(k): int(v) for k, v in dict(mesh.shape).items()}


def axis_size(sizes: Mapping[str, int], axis: Axis) -> int:
    """Ranks along ``axis`` (the product over a tuple; 1 for None or an
    axis the mesh lacks)."""
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= sizes.get(a, 1)
        return out
    return sizes.get(axis, 1)


def _rules() -> Optional[Dict[str, Axis]]:
    return getattr(_state, "rules", None)


def _mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def axis_rules(rules: Dict[str, Axis], mesh=None):
    """Activate ``rules`` (and ``mesh``) for this thread; the previous
    ones come back on exit."""
    prev = (_rules(), _mesh())
    _state.rules, _state.mesh = dict(rules), mesh
    try:
        yield
    finally:
        _state.rules, _state.mesh = prev


def resolve(*names: Optional[str]) -> PartitionSpec:
    """Logical names -> PartitionSpec under the active rules; with a mesh
    active, axes it lacks drop out."""
    rules = _rules() or {}
    mesh = _mesh()
    mesh_axes = set(mesh_sizes(mesh)) if mesh is not None else None
    out = []
    for n in names:
        ax = rules.get(n) if n else None
        if isinstance(ax, tuple) and mesh_axes is not None:
            ax = tuple(a for a in ax if a in mesh_axes) or None
            if isinstance(ax, tuple) and len(ax) == 1:
                ax = ax[0]
        elif isinstance(ax, str) and mesh_axes is not None \
                and ax not in mesh_axes:
            ax = None
        out.append(ax)
    return PartitionSpec(*out)


def check_layout(x, names: Sequence[Optional[str]]) -> None:
    """Raise ``ValueError`` when ``x``'s local shape is not its global
    shape cut by ``resolve(*names)``; a no-op outside an active ``spmd``
    context.  Only the dims whose global size the context knows are held
    (``spmd.logical_sizes``: heads, kv heads, mlp, vocab, ...)."""
    from repro_torch.launch import spmd
    ctx = spmd.current()
    if ctx is None:
        return
    if len(names) != x.dim():
        raise ValueError(f"{len(names)} names for a {x.dim()}-d tensor")
    spec = resolve(*names)
    for d, (name, ax) in enumerate(zip(names, spec)):
        full = ctx.dims.get(name) if name else None
        if full is None:
            continue
        m = axis_size(ctx.sizes, ax)
        want = full // m if full % m == 0 else full
        if x.shape[d] != want:
            raise ValueError(
                f"dim {d} ({name}): local {x.shape[d]}, the global {full} "
                f"cut by {ax!r} ({m} ranks) is {want}")


def constrain(x, *names: Optional[str]):
    """The layout hint at a logical-axis point: returns ``x`` itself.
    Inside ``axis_rules`` its layout is checked (``check_layout``); only
    the expected spec errors are swallowed (and logged) — anything else
    is a real bug and propagates."""
    if _rules() is None:
        return x
    try:
        check_layout(x, names)
    except (ValueError, TypeError) as e:
        log.debug("constrain_unsharded", names=names,
                  error=type(e).__name__, detail=str(e))
    return x


def named_sharding(mesh, *names: Optional[str]):
    """``(mesh, spec)``: the port's counterpart of ``NamedSharding``."""
    return mesh, resolve(*names)


# ----------------------------------------------------- fleet health view
def shard_bounds(n_items: int, device_mask: Sequence[bool], *,
                 owned: Optional[Sequence[int]] = None
                 ) -> Dict[int, Tuple[int, int]]:
    """Partition ``n_items`` rows across the *serving* devices of a fleet.

    ``device_mask`` is the FleetPlan/FleetMeshView health mask (True =
    serving).  Returns ``{device_index: (start, stop)}`` covering
    [0, n_items) contiguously, remainder spread one row at a time over the
    first shards — quarantined devices and idle spares get no slice, so a
    shrinking fleet automatically rebalances the same global batch.

    ``owned`` makes the split host-aware: the bounds are still computed
    over the *global* mask (every host agrees on the same partition of
    the same batch), but only the listed device indices are returned —
    a multi-host process passes its HostTopology block and executes
    exactly its slice.
    """
    serving = [i for i, ok in enumerate(device_mask) if ok]
    if not serving:
        raise ValueError("no serving devices: the whole fleet is "
                         "quarantined or idle spares")
    base, rem = divmod(n_items, len(serving))
    bounds: Dict[int, Tuple[int, int]] = {}
    start = 0
    for k, dev in enumerate(serving):
        size = base + (1 if k < rem else 0)
        bounds[dev] = (start, start + size)
        start += size
    if owned is not None:
        bounds = {d: b for d, b in bounds.items() if d in set(owned)}
    return bounds
