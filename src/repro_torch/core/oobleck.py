"""Plan-keyed dispatch (paper §III queue reconfiguration).

Port of the reference's ``Dispatcher`` (``core/oobleck.py``).  In eager
PyTorch a "compile" is one build of the model under a plan: the cache
keeps the per-plan LRU and the ``compiles`` count the engine's
recompile statistics read.  There is no tuning scope yet (Hopper tuning
spaces are ROADMAP queue 1 item 13).
"""
from __future__ import annotations

import collections
import hashlib
import time
from dataclasses import dataclass
from typing import Callable, Hashable, List

from repro_torch.obs import metrics


def _key_digest(cache_key: Hashable) -> str:
    """Stable short digest of a cache key (telemetry label)."""
    return hashlib.sha256(repr(cache_key).encode()).hexdigest()[:10]


@dataclass
class _Entry:
    fn: Callable
    n_calls: int = 0


class Dispatcher:
    """Build-per-plan LRU cache (the paper's reconfiguration engine).

    ``build(key) -> callable`` is user-supplied.  A key exposing
    ``compile_key()`` is canonicalized through it.  Eviction is LRU at
    ``capacity``.
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
        fn = self.build(key)
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
