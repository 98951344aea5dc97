"""The Oobleck methodology: staged accelerators + fault routing (paper §III).

Port of the reference's ``core/oobleck.py``.  ``StagedAccelerator``
composes Stages ``f = f_n ∘ … ∘ f_1``.  Two failover mechanisms, mirroring
the paper:

  * **static routing** (the paper's queue reconfiguration): ``run`` takes
    a FaultSignature or RoutingPlan; the ``Dispatcher`` builds once per
    plan (per-plan LRU; in eager PyTorch a "compile" is one build).
  * **resident routing** (the hot-spare analogue): ``run_resident`` reads
    a host-side health mask per stage on every call and runs that stage's
    HW or SW lowering; failover flips a bit and rebuilds nothing (the
    reference's ``lax.cond`` on a traced mask).

The Dispatcher builds each plan under ``tuning.plan_scope`` and returns the
build scoped to the plan's key, so the kernels it runs look up launch
knobs tuned for that plan first (a degraded plan can carry its own).
"""
from __future__ import annotations

import collections
import hashlib
import time
from dataclasses import dataclass
from typing import Callable, Hashable, List, Optional, Sequence

from repro_torch.core.fault import FaultSignature
from repro_torch.core.routing import RoutingPlan
from repro_torch.core.stage import Stage
from repro_torch.kernels import tuning
from repro_torch.obs import metrics
from repro_torch.viscosity.lang import HW, SW


def _key_digest(cache_key: Hashable) -> str:
    """Stable short digest of a cache key (telemetry label)."""
    return hashlib.sha256(repr(cache_key).encode()).hexdigest()[:10]


class StagedAccelerator:
    """f = f_n ∘ … ∘ f_1 with per-stage dual paths."""

    def __init__(self, name: str, stages: Sequence[Stage]):
        self.name = name
        self.stages = list(stages)
        names = [s.name for s in self.stages]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stages: {names}")

    @property
    def stage_names(self) -> List[str]:
        return [s.name for s in self.stages]

    def healthy_signature(self) -> FaultSignature:
        return FaultSignature.healthy(self.stage_names)

    def healthy_plan(self, target: str = HW) -> RoutingPlan:
        return RoutingPlan.for_stages(self.stage_names, target=target,
                                      default=HW)

    def plan_for(self, signature: Optional[FaultSignature]) -> RoutingPlan:
        """Signature -> RoutingPlan (also accepts a plan, passed through)."""
        if signature is None:
            return self.healthy_plan()
        if isinstance(signature, RoutingPlan):
            return signature
        return RoutingPlan.from_signature(signature, default=HW).validate(
            stages=self.stage_names)

    def run(self, x, signature=None):
        """Run under a FaultSignature or a RoutingPlan (one IR, one path)."""
        plan = self.plan_for(signature)
        for s in self.stages:
            x = s.run(x, route=plan)
        return x

    def run_reference(self, x):
        """All-software oracle (the paper's 'purely software' baseline)."""
        for s in self.stages:
            x = s.run(x, route=SW)
        return x

    def run_resident(self, x, health_mask: Sequence[bool]):
        """Hot-spare variant: ``health_mask`` (n_stages,) of host-side
        bools, read per stage on every call; both paths stay resident and
        failover rebuilds nothing."""
        if len(health_mask) != len(self.stages):
            raise ValueError(f"health mask of {len(health_mask)} bits for "
                             f"{len(self.stages)} stages")
        for s, healthy in zip(self.stages, health_mask):
            x = s.run(x, route=HW if bool(healthy) else SW)
        return x


@dataclass
class _Entry:
    fn: Callable
    n_calls: int = 0


class Dispatcher:
    """Build-per-plan LRU cache (the paper's reconfiguration engine).

    ``build(key) -> callable`` is user-supplied (a function, or a model
    whose methods are called).  A key exposing ``compile_key()`` is
    canonicalized through it.  The build runs under
    ``tuning.plan_scope(cache_key)`` and is returned ``tuning.scoped`` to
    it: every call of it, or of its methods, looks up tuned launch knobs
    under this plan's key first.  Eviction is LRU at ``capacity``.
    """

    def __init__(self, build: Callable[[Hashable], Callable],
                 capacity: int = 8):
        self.build = build
        self.capacity = capacity
        self._cache: "collections.OrderedDict[Hashable, _Entry]" = \
            collections.OrderedDict()
        self.compiles = 0

    def get(self, key: Hashable) -> Callable:
        cache_key = (key.compile_key()
                     if hasattr(key, "compile_key") else key)
        if cache_key in self._cache:
            self._cache.move_to_end(cache_key)
            e = self._cache[cache_key]
            e.n_calls += 1
            metrics.inc("dispatch_cache_hits_total",
                        key=_key_digest(cache_key))
            return e.fn
        metrics.inc("dispatch_cache_misses_total",
                    key=_key_digest(cache_key))
        t0 = time.perf_counter()
        with tuning.plan_scope(cache_key):
            fn = tuning.scoped(cache_key, self.build(key))
        metrics.observe("dispatch_compile_seconds",
                        time.perf_counter() - t0,
                        key=_key_digest(cache_key))
        self.compiles += 1
        self._cache[cache_key] = _Entry(fn=fn, n_calls=1)
        if len(self._cache) > self.capacity:
            self._cache.popitem(last=False)
        return fn

    def cached_keys(self) -> List[Hashable]:
        return list(self._cache)

    def __call__(self, key: Hashable, *args, **kw):
        return self.get(key)(*args, **kw)
