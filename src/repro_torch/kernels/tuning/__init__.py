"""Tuned launch knobs for the Hopper kernels (the port's autotuner).

Port of the reference's ``kernels/tuning``.  Three pieces:

  * ``space``  — per-(kernel, lowering-kind) search spaces + the card's
    admissibility predicate;
  * ``cache``  — deterministic on-disk JSON cache keyed by backend
    fingerprint (and, per entry, by shape/dtype/routing-plan digest);
  * ``tuner``  — sweep + hillclimb search, and ``cuda_measure``.

This module is the facade the kernel wrappers consult:

    cfg = tuning.lookup("swiglu_mlp", "hw", (M, D, F), x.dtype)

``lookup`` is **fail-open by construction**: no cache file, no entry,
corrupt JSON, a different backend, an inadmissible stale entry — every
failure mode returns None and the kernel keeps its default plan.  A
missing tuning entry costs performance, never correctness.

Plan-aware tuning: the Dispatcher builds each plan under
``plan_scope(plan_key)`` and returns its build ``scoped`` to that key, so a
lookup made inside tries the plan-specific entry first, then the
plan-agnostic ``default`` entry.  A kernel running under a degraded
RoutingPlan can therefore carry knobs of its own.

The port is eager: a lookup on every kernel call would cost host time on
every layer.  The wrappers resolve a call signature's plan once per plan
key and keep it in a ``memo()`` dict; ``set_cache``, ``reset`` and
``tune_kernel`` empty every memo, so the next call resolves again.  Code
that writes the process cache directly, or sets ``REPRO_TUNER`` after
calls were made, calls ``set_cache(get_cache())`` to make the change
take effect.
"""
from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.kernels.tuning import tuner as _tuner
from repro_torch.kernels.tuning.cache import (DEFAULT_PLAN, STATS,
                                              TuningCache,
                                              backend_fingerprint,
                                              plan_digest)
from repro_torch.kernels.tuning.space import SPACES, admissible, space_for

__all__ = [
    "DEFAULT_PLAN", "SPACES", "TuningCache", "admissible",
    "backend_fingerprint", "current_plan_key", "get_cache", "lookup",
    "lookup_once", "memo", "plan_digest", "plan_scope", "reset",
    "resolve_plan", "scoped", "set_cache", "space_for", "stats",
    "tune_kernel",
]

# ------------------------------------------------------------ plan scope
_PLAN: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_tuning_plan", default=None)


@contextlib.contextmanager
def plan_scope(plan_key):
    """Tag tuner lookups made inside with the active routing-plan key."""
    token = _PLAN.set(plan_key)
    try:
        yield
    finally:
        _PLAN.reset(token)


def current_plan_key():
    return _PLAN.get()


class _Scoped:
    """A build whose calls, and whose methods' calls, run under
    ``plan_scope(plan_key)``: the port's builds are models (``prefill``,
    ``decode_step``, ...) as well as plain functions."""

    def __init__(self, plan_key, fn):
        self._plan_key = plan_key
        self._fn = fn

    def __call__(self, *args, **kw):
        with plan_scope(self._plan_key):
            return self._fn(*args, **kw)

    def __getattr__(self, name):
        attr = getattr(self._fn, name)
        if not callable(attr) or isinstance(attr, type):
            return attr

        def call(*args, **kw):
            with plan_scope(self._plan_key):
                return attr(*args, **kw)

        return call


def scoped(plan_key, fn: Any) -> Any:
    """``fn`` with every invocation (and every method call, for an object)
    run under ``plan_scope(plan_key)`` (how the Dispatcher threads its
    compile key to kernel lookups)."""
    return _Scoped(plan_key, fn)


# --------------------------------------------------------- cache handle
_CACHE: Optional[TuningCache] = None
_MEMOS: List[Dict] = []


def memo() -> Dict:
    """A dict for a wrapper's resolved plans, emptied whenever the process
    cache changes (``set_cache``, ``reset``, ``tune_kernel``)."""
    d: Dict = {}
    _MEMOS.append(d)
    return d


def _forget() -> None:
    for d in _MEMOS:
        d.clear()


def get_cache() -> TuningCache:
    global _CACHE
    if _CACHE is None:
        _CACHE = TuningCache()
    return _CACHE


def set_cache(cache: Optional[TuningCache]) -> None:
    """Swap the process cache (tests point it at tmp dirs; None resets);
    every wrapper resolves its plans again."""
    global _CACHE
    _CACHE = cache
    _forget()


def reset() -> None:
    """Drop cache handle + stats (test isolation)."""
    set_cache(None)
    STATS.reset()


def _enabled() -> bool:
    return os.environ.get("REPRO_TUNER", "on").lower() not in (
        "off", "0", "false")


# -------------------------------------------------------------- lookups
def lookup(kernel: str, kind: str, shape: Sequence[int], dtype
           ) -> Optional[Dict[str, int]]:
    """Tuned config for this call site, or None (use the defaults).

    Tries the active plan-scope entry first, then the plan-agnostic
    entry.  Counts hits/misses in ``stats()``.  Never raises.
    """
    if not _enabled():
        return None
    try:
        cache = get_cache()
        plan = plan_digest(current_plan_key())
        cfg = cache.get(kernel, kind, shape, dtype, plan)
        if cfg is None and plan != DEFAULT_PLAN:
            cfg = cache.get(kernel, kind, shape, dtype, DEFAULT_PLAN)
        if cfg is not None and not admissible(kernel, kind, cfg, shape):
            cfg = None  # stale entry from an older space: ignore it
        if cfg is None:
            STATS.misses += 1
        else:
            STATS.hits += 1
        return cfg
    except Exception:
        STATS.misses += 1
        return None


def _device():
    """The current CUDA device (whose section a lookup reads), None before
    CUDA is initialised: the CPU paths never touch it."""
    import torch
    return torch.cuda.current_device() if torch.cuda.is_initialized() \
        else None


_LOOKUPS = memo()


def lookup_once(kernel: str, kind: str, shape: Tuple[int, ...], dtype
                ) -> Optional[Dict[str, int]]:
    """``lookup``, made once per (kernel, kind, shape, dtype, plan key,
    device) until the cache changes: the scans' chunk and attention's SW
    ``kv_chunk`` take it on every call."""
    key = (kernel, kind, shape, dtype, current_plan_key(), _device())
    try:
        return _LOOKUPS[key]
    except KeyError:
        cfg = _LOOKUPS[key] = lookup(kernel, kind, shape, dtype)
        return cfg


_PLANS = memo()


def resolve_plan(kernel: str, shape: Tuple[int, ...], dtype,
                 make: Callable[..., Any], extra: Tuple = ()) -> Any:
    """A CUDA call's launch plan: ``make(**entry)`` for the ``hw`` entry of
    (kernel, shape, dtype) under the active plan key where ``make`` takes
    it (it raises ValueError for knobs it cannot run at the call's real
    widths), else ``make()``, the default plan.  Made once per (kernel,
    shape, ``extra``: the rest of ``make``'s arguments, dtype, plan key)
    until the cache changes."""
    key = (kernel, shape, extra, dtype, current_plan_key(), _device())
    plan = _PLANS.get(key)
    if plan is None:
        cfg = lookup(kernel, "hw", shape, dtype)
        try:
            plan = make(**cfg) if cfg else None
        except ValueError:
            plan = None
        plan = _PLANS[key] = plan or make()
    return plan


def stats() -> Dict[str, int]:
    return STATS.as_dict()


# --------------------------------------------------------------- tuning
def tune_kernel(kernel: str, kind: str, shape: Sequence[int], dtype, *,
                measure: Callable[[Dict[str, int]], float],
                plan_key=None, budget: int = 24, persist: bool = True,
                cache: Optional[TuningCache] = None,
                log: Optional[Callable[[str], None]] = None
                ) -> Tuple[Dict[str, int], float]:
    """Run the sweep+hillclimb search and record the winner in the cache.

    ``measure(cfg) -> us`` is the scoring callable (``tuner.cuda_measure``
    on the card).  Returns ``(best_cfg, best_us)``.
    """
    cache = cache or get_cache()
    seed = cache.get(kernel, kind, shape, dtype, plan_digest(plan_key))
    best_cfg, best_us, evals = _tuner.tune(
        kernel, kind, shape, measure=measure,
        seed_cfgs=(seed,) if seed else (), budget=budget, log=log)
    cache.put(kernel, kind, shape, dtype, best_cfg,
              plan=plan_digest(plan_key), us=best_us, evals=evals,
              persist=persist)
    STATS.tuned += 1
    _forget()
    return best_cfg, best_us
