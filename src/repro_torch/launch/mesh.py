"""The fleet-health device view (the port's ``launch/mesh.py``).

``FleetMeshView`` is the fleet layer's device view: a ``FleetPlan``'s
explicit health mask (serving / quarantined / idle-spare) applied to a
list of ``torch.device``s, so schedulers only ever place work on devices
that are taking traffic.

The reference's mesh builders (``make_mesh``, ``make_production_mesh``,
``FleetMeshView.submesh``) make ``jax.sharding.Mesh`` objects; their
counterpart is a ``torch.distributed`` ``DeviceMesh``, which waits for the
multi-host slice (ROADMAP queue 1 item 9).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch


def cuda_devices() -> List[torch.device]:
    """Every CUDA device of this process, in index order (empty without
    CUDA)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclass(frozen=True)
class FleetMeshView:
    """A fleet's health state projected onto this process's devices.

    ``mask[i]`` is True iff logical device ``i`` is serving traffic;
    quarantined devices and idle spares are carried explicitly (never
    silently dropped), so schedulers can reason about capacity and
    recovery.
    """

    mask: Tuple[bool, ...]
    quarantined: Tuple[int, ...] = ()
    idle_spares: Tuple[int, ...] = ()

    @staticmethod
    def from_plan(fleet_plan) -> "FleetMeshView":
        """Project a FleetPlan's device table onto the device layer."""
        return FleetMeshView(
            mask=tuple(fleet_plan.device_mask()),
            quarantined=tuple(fleet_plan.quarantined),
            idle_spares=tuple(fleet_plan.pool.free()))

    @property
    def n_devices(self) -> int:
        return len(self.mask)

    def serving(self) -> Tuple[int, ...]:
        return tuple(i for i, ok in enumerate(self.mask) if ok)

    def serving_devices(self, devices: Optional[Sequence[torch.device]]
                        = None) -> List[torch.device]:
        """The physical devices behind the serving logical indices; the
        view must fit the device list (loud error otherwise).

        ``devices`` defaults to every CUDA device of this process
        (``cuda_devices()``), so logical fleet index i maps to
        ``cuda:i``."""
        devices = list(cuda_devices() if devices is None else devices)
        if self.n_devices > len(devices):
            raise RuntimeError(
                f"fleet view covers {self.n_devices} devices, process has "
                f"{len(devices)}: short {self.n_devices - len(devices)} "
                "device(s)")
        return [devices[i] for i in self.serving()]
