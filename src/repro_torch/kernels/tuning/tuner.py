"""Sweep + hillclimb autotuner for the kernels' launch knobs.

Port of the reference's ``kernels/tuning/tuner.py``:

  1. **sweep**: measure every admissible config on the space's grid,
     capped by ``budget``;
  2. **hillclimb**: from the sweep's argmin, walk one-knob/one-step
     neighbors until no move improves (coordinate descent over the
     choice lattice) or the budget runs out.

The kernel's *current default* config (``space.default(shape)``: the plan
the wrapper picks with no entry) is always seeded into the sweep, so a
persisted tuned config is never worse than the default up to measurement
noise.  ``tune`` takes an injectable ``measure`` callable (tests drive the
search with synthetic cost surfaces; no card needed); ``cuda_measure`` is
the standard one on the card.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.kernels.tuning.space import KernelSpace, space_for

# The H100's L2: operands whose bytes fit stay there between back-to-back
# reps of one call.
L2_BYTES = 50 * 2 ** 20
# cycles of ``torch.cuda._sleep`` queued ahead of the timed reps (about
# 2.7 ms at 1.83 GHz): the host enqueues every rep before the device
# reaches the first, so an event pair holds the rep's kernels, not the
# host's launch
SLEEP_CYCLES = 5_000_000


def measure_wall_us(fn: Callable[[], object], *, reps: int = 5,
                    warmup: int = 1) -> float:
    """Best-of-``reps`` wall time of ``fn()`` in microseconds.

    ``fn`` must block until its result is ready; best-of suppresses
    scheduler noise, which matters more than averaging for comparisons.
    """
    for _ in range(warmup):
        fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best * 1e6


def _as_key(cfg: Mapping[str, int]) -> Tuple[Tuple[str, int], ...]:
    return tuple(sorted((k, int(v)) for k, v in cfg.items()))


def tune(kernel: str, kind: str, shape: Sequence[int], *,
         space: Optional[KernelSpace] = None,
         measure: Callable[[Dict[str, int]], float],
         seed_cfgs: Sequence[Mapping[str, int]] = (),
         budget: int = 24,
         log: Optional[Callable[[str], None]] = None
         ) -> Tuple[Dict[str, int], float, int]:
    """Search ``space`` for the fastest admissible config.

    ``measure(cfg) -> us`` scores one config (lower is better); a config
    whose measurement raises is discarded — a crashing config must never
    abort the search, the kernel simply keeps its default.

    Returns ``(best_cfg, best_us, evals)``.  Raises only when *no*
    config could be measured at all.
    """
    space = space or space_for(kernel, kind)
    if space is None:
        raise KeyError(f"no declared search space for ({kernel}, {kind})")
    shape = tuple(int(d) for d in shape)

    seen: Dict[Tuple, float] = {}
    evals = 0

    def score(cfg: Dict[str, int]) -> Optional[float]:
        nonlocal evals
        key = _as_key(cfg)
        if key in seen:
            return seen[key]
        if evals >= budget:
            return None
        evals += 1
        try:
            us = float(measure(cfg))
        except Exception as e:  # noqa: BLE001 - bad config != failed search
            if log:
                log(f"tune[{kernel}/{kind}]: {cfg} failed: {e!r}")
            seen[key] = float("inf")
            return None
        seen[key] = us
        if log:
            log(f"tune[{kernel}/{kind}]: {cfg} -> {us:.1f}us")
        return us

    # ----------------------------------------------------------- sweep
    candidates = [dict(cfg) for cfg in seed_cfgs
                  if space.admissible(cfg, shape)]
    default = space.default(shape)
    if default and space.admissible(default, shape):
        candidates.append(default)
    candidates.extend(space.configs(shape))

    best_cfg: Optional[Dict[str, int]] = None
    best_us = float("inf")
    for cfg in candidates:
        us = score(cfg)
        if us is not None and us < best_us:
            best_cfg, best_us = cfg, us
        if evals >= budget:
            break
    if best_cfg is None:
        raise RuntimeError(
            f"tuner measured no admissible config for {kernel}/{kind} "
            f"shape={shape} within budget={budget}")

    # ------------------------------------------------------- hillclimb
    improved = True
    while improved and evals < budget:
        improved = False
        for cand in space.neighbors(best_cfg, shape):
            us = score(cand)
            if us is not None and us < best_us:
                best_cfg, best_us = cand, us
                improved = True
                break  # greedy: re-propose around the new optimum
    return best_cfg, best_us, evals


def cuda_measure(make_fn: Callable[[Dict[str, int]], Callable],
                 args: Tuple, *, reps: int = 20, warmup: int = 3
                 ) -> Callable[[Dict[str, int]], float]:
    """The standard measure closure on the card: ``make_fn(cfg)`` returns a
    callable over ``args`` that launches with the config's knobs; the score
    is the median, in microseconds, of ``reps`` per-rep CUDA-event times,
    after ``warmup`` calls.

    The reps run back to back behind a ``torch.cuda._sleep`` of
    ``SLEEP_CYCLES``, so each event pair times the device's work for one
    call, not the host's launch.  No rep flushes the L2: operands that
    together fit in the H100's 50 MB L2 (``L2_BYTES``) stay there from rep
    to rep (a warm read), and larger ones are read from HBM on every rep.
    The closure's ``warm_l2`` says which holds for ``args``: at qwen1.5-4b's
    SwiGLU (2560 -> 6912: 106 MB of bf16 weights) the weights come from
    HBM each rep; at attention's P = 128 (about 2 MB of q, k and v) every
    rep reads them from L2.
    """
    import torch

    nbytes = sum(a.numel() * a.element_size() for a in args
                 if isinstance(a, torch.Tensor))

    def _measure(cfg: Dict[str, int]) -> float:
        fn = make_fn(cfg)
        for _ in range(warmup):
            fn(*args)
        torch.cuda.synchronize()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(reps)]
        torch.cuda._sleep(SLEEP_CYCLES)
        for start, end in events:
            start.record()
            fn(*args)
            end.record()
        torch.cuda.synchronize()
        return 1e3 * statistics.median(s.elapsed_time(e)
                                       for s, e in events)

    _measure.warm_l2 = nbytes <= L2_BYTES
    return _measure
