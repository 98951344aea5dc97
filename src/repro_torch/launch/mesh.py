"""Device meshes, the production mesh shapes, the H100 link rates and
the fleet-health device view (the port's ``launch/mesh.py``).

``FleetMeshView`` is the fleet layer's device view: a ``FleetPlan``'s
explicit health mask (serving / quarantined / idle-spare) applied to a
list of ``torch.device``s, so schedulers only ever place work on devices
that are taking traffic, and ``submesh`` only ever builds meshes over
serving hardware.

``Mesh`` is the counterpart of the reference's ``jax.sharding.Mesh``: a
frozen ``(shape, axes, devices)`` grid.  The tensor-parallel runtime
(``launch/spmd.py``) runs one rank per mesh position, each rank holding
its coordinates and one communicator per axis.  ``rank_device`` says
which device a rank runs on: under NCCL rank r owns ``cuda:r``, one card a
rank; under gloo the ranks may share a device, and the dry run builds
meshes over ``torch.device("meta")``.  ``make_production_mesh`` gives the
reference's pod shapes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.device import resolve_device


def cuda_devices() -> List[torch.device]:
    """Every CUDA device of this process, in index order (empty without
    CUDA)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def rank_device(rank: int, world: int, backend: str,
                device=None) -> torch.device:
    """The device rank ``rank`` of ``world`` runs on.  ``nccl``: ``cuda:
    rank``, one card a rank; it raises when ``device`` is not the card
    (the CPU, or another rank's card) or when this process sees fewer
    cards than ``world``.  ``gloo``: ``resolve_device(device)`` for every
    rank, so ranks may share a card (their collectives go through host
    copies)."""
    dev = resolve_device(device)
    if backend != "nccl":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"nccl runs one card a rank: rank {rank} cannot "
                         f"run on {dev}")
    if dev.index is not None and dev.index != rank:
        raise ValueError(f"nccl runs rank {rank} on cuda:{rank}, not {dev}")
    seen = torch.cuda.device_count()
    if seen < world:
        raise RuntimeError(f"nccl runs one card a rank: {world} ranks need "
                           f"{world} cards, this process sees {seen}")
    return torch.device("cuda", rank)


def rank_devices(world: int, backend: str, device=None
                 ) -> List[torch.device]:
    """``rank_device`` of every rank, in rank order: a mesh's devices
    (under nccl ``device`` names the card type: a rank's own card
    passes)."""
    if backend == "nccl":
        device = resolve_device(device).type
    return [rank_device(r, world, backend, device) for r in range(world)]


@dataclass(frozen=True)
class Mesh:
    """A named device grid: ``devices`` in row-major order over
    ``shape``, one axis name per dimension."""

    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    devices: Tuple[torch.device, ...]

    @property
    def axis_sizes(self):
        """``{axis: size}``, the reference's ``mesh.shape``."""
        return dict(zip(self.axes, self.shape))

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"mesh shape {self.shape} has {len(self.shape)} "
                             f"dim(s), axes {self.axes} name {len(self.axes)}")
        if math.prod(self.shape) != len(self.devices):
            raise ValueError(f"mesh {self.shape} holds "
                             f"{math.prod(self.shape)} device(s), given "
                             f"{len(self.devices)}")


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
          devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    n = math.prod(shape)
    devices = list(cuda_devices() if devices is None else devices)
    if len(devices) < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, have {len(devices)}: short "
            f"{n - len(devices)} device(s)")
    return Mesh(tuple(shape), tuple(axes), tuple(devices[:n]))


def make_production_mesh(*, multi_pod: bool = False,
                         devices: Optional[Sequence[torch.device]] = None
                         ) -> Mesh:
    """The reference's production meshes: (16, 16) ("data", "model"), or
    (2, 16, 16) ("pod", "data", "model") multi-pod.  ``devices`` defaults
    to every CUDA device of this process (the error names the shortfall);
    the dry run passes ``torch.device("meta")`` devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, devices)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """Arbitrary mesh over ``devices`` (default: every CUDA device of this
    process); the error names the shortfall."""
    return _mesh(tuple(shape), tuple(axes), devices)


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

    def submesh(self, axes: Sequence[str] = ("data",), *, model: int = 1,
                devices: Optional[Sequence[torch.device]] = None) -> Mesh:
        """Health-masked mesh over the serving devices only.

        1-D by default (pure data parallel); ``model > 1`` folds the
        serving devices into a (data, model) grid — serving count must be
        divisible, and the error names the shortfall."""
        devs = self.serving_devices(devices)
        n = len(devs)
        if model > 1:
            if n % model:
                raise RuntimeError(
                    f"{n} serving device(s) do not fold into model={model} "
                    f"groups: short {model - n % model} device(s) (or "
                    f"quarantine {n % model} more)")
            return _mesh((n // model, model), tuple(axes), devices=devs)
        return _mesh((n,), tuple(axes), devices=devs)


# Link rates for the dry run's collective term (datasheet figures, not
# measured).  NVLink 4 within an 8-GPU HGX H100 node: 900 GB/s total per
# GPU, 450 GB/s each way (NVIDIA H100 datasheet).  Beyond the node: one
# 400 Gb/s ConnectX-7 NDR InfiniBand port per GPU, 50 GB/s each way (the
# DGX H100 user guide's compute fabric).
NVLINK_BW = 450e9             # bytes/s each way per GPU, within a node
NET_BW = 50e9                 # bytes/s each way per GPU, between nodes
GPUS_PER_NODE = 8
