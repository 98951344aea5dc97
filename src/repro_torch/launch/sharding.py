"""Fleet-aware batch partitioning (the port's ``launch/sharding.py``).

Only ``shard_bounds`` is ported: it is plain Python over a fleet's health
mask.  The reference's logical-axis rules (``axis_rules``, ``resolve``,
``constrain``, ``named_sharding``) are JAX mesh tooling for SPMD programs,
which the port's data-parallel fleet does not run; they belong with the
XLA-only tooling (ROADMAP queue 1 item 14).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple


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
