"""Stage: the Oobleck sub-accelerator abstraction (paper §III-A).

Port of the reference's ``core/stage.py``.  A Stage wraps one step of
``f = f_n ∘ … ∘ f_1`` with the two interfaces the paper prescribes:

  * the *fast path* (``hw``): the optimized lowering — a Hopper kernel;
  * the *software-visible path* (``sw``): the PyTorch oracle — logically
    equivalent (a Viscosity contract), runnable anywhere.

``ports`` are the latency-insensitive interface (``Port`` specs in place
of ``jax.ShapeDtypeStruct``); the runtime draws canaries from them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.viscosity.lang import HW, INTERPRET, SW, OpSpec


@dataclass(frozen=True)
class Port:
    """One stage input: shape, dtype and, for a floating port, ``draw``,
    which maps a standard-normal float32 draw into the port's domain (a
    scale, a softplus, a sign) before the cast to ``dtype``."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    draw: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


@dataclass
class Stage:
    name: str
    spec: Optional[OpSpec] = None            # viscosity op (preferred)
    hw: Optional[Callable] = None            # explicit pair (case studies)
    sw: Optional[Callable] = None
    ports: Tuple[Port, ...] = ()
    tol: float = 2e-2
    device: DeviceLike = None                # where canaries are placed

    def __post_init__(self):
        if self.spec is not None:
            self.hw = self.hw or (lambda *a, **k: self.spec(*a, route=HW, **k))
            self.sw = self.sw or (lambda *a, **k: self.spec(*a, route=SW, **k))
        if self.sw is None:
            raise ValueError(f"stage {self.name} needs a software path")
        if self.hw is None:
            self.hw = self.sw   # pure-sw stage (no optimized lowering)
        self.device = resolve_device(self.device)

    def run(self, *args, route=HW, **kw):
        """Run one stage under a route: a target string or a RoutingPlan
        (the stage resolves its own entry)."""
        if hasattr(route, "target_for"):
            route = route.target_for(self.name)
        if route == INTERPRET and self.spec is not None:
            return self.spec(*args, route=INTERPRET, **kw)
        fn = self.hw if route == HW else self.sw
        return fn(*args, **kw)

    def canary_inputs(self, seed: int = 0) -> Tuple[torch.Tensor, ...]:
        """Deterministic inputs drawn from the port specs: a CPU generator
        seeded with ``seed``, so every device sees the same canary bytes,
        then moved to the stage's device.  Floating ports draw N(0, 1)
        through their ``draw``; the others (integers, and complex, as in
        the reference) draw integers in [0, 128)."""
        gen = torch.Generator().manual_seed(seed)
        outs = []
        for p in self.ports:
            if p.dtype.is_floating_point:
                z = torch.randn(p.shape, generator=gen)
                x = (p.draw(z) if p.draw is not None else z).to(p.dtype)
            else:
                x = torch.randint(0, 128, p.shape, generator=gen).to(p.dtype)
            outs.append(x.to(self.device))
        return tuple(outs)
