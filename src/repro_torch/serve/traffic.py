"""Open-loop traffic generators (ROADMAP "open-loop traffic").

A copy of the reference's ``serve/traffic.py`` (numpy only): the same
parameters and seed draw the same requests in both packages.

The paper's datacenter claim (§II Fig. 2) is about *aggregate* throughput
under faults; showing that tail latency survives a mid-burst quarantine
needs open-loop load — arrivals that do not wait for the system.  This
module generates those workloads as data: every ``Workload`` is a frozen
dataclass whose ``build(seed)`` returns a plain ``List[Request]``,
deterministic given the seed, so a bench scenario is replayable from its
parameters alone.

The family:

  * ``ClosedLoop`` — the legacy staggered fixed list (arrival measured in
    engine steps, no virtual-clock times): a degenerate arrival process.
    ``synthetic_workload`` (the old ``serve.engine`` helper) builds
    exactly this, bit-identical to the historical draws.
  * ``Poisson`` — memoryless arrivals at a constant rate.
  * ``Diurnal`` — inhomogeneous Poisson under a raised-cosine day curve
    (Lewis–Shedler thinning, still one rng stream).
  * ``FlashCrowd`` — baseline Poisson plus a rate-multiplied burst
    window: the mid-burst-quarantine scenario.

Prompt/output lengths come from a ``LengthModel``: uniform (the legacy
distribution) or bounded-Pareto (heavy-tailed, inverse-CDF sampled).
Arrival times are drawn *before* per-request lengths, so two workloads
differing only in arrival process still decode the same sequences.

Deadlines are attached by the workload (``slack_s`` +
``slack_per_token_s`` × budget past the arrival), giving the admission
front end (``serve.frontend``) per-request SLOs to schedule against.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serve.engine import Request

__all__ = [
    "LengthModel", "Workload", "ClosedLoop", "Poisson", "Diurnal",
    "FlashCrowd", "bounded_pareto", "with_deadlines", "synthetic_workload",
]


def _as_rng(seed_or_rng) -> np.random.Generator:
    if isinstance(seed_or_rng, np.random.Generator):
        return seed_or_rng
    return np.random.default_rng(seed_or_rng)


def bounded_pareto(rng: np.random.Generator, lo: int, hi: int,
                   alpha: float) -> int:
    """One draw from a bounded Pareto(alpha) on [lo, hi] via inverse CDF
    — the standard heavy-tail model for prompt/output lengths (most
    requests short, a fat tail of near-``hi`` ones)."""
    if hi <= lo:
        return int(lo)
    u = float(rng.random())
    ratio = (lo / hi) ** alpha
    x = lo / (1.0 - u * (1.0 - ratio)) ** (1.0 / alpha)
    return int(min(hi, max(lo, math.floor(x))))


@dataclass(frozen=True)
class LengthModel:
    """Per-request prompt/budget sampler.

    ``dist="uniform"`` reproduces the legacy ``synthetic_workload``
    draws (and their exact rng order: prompt-size, prompt tokens,
    budget); ``dist="pareto"`` makes both lengths heavy-tailed with
    index ``alpha``.  ``clamp_len`` caps prompt+budget to an engine's
    ``max_len`` without disturbing the draw sequence."""

    vocab_size: int = 331
    min_prompt: int = 4
    max_prompt: int = 20
    min_new: int = 3
    max_new: int = 10
    dist: str = "uniform"            # "uniform" | "pareto"
    alpha: float = 1.5               # pareto tail index
    clamp_len: Optional[int] = None  # cap prompt+budget (engine max_len)

    def __post_init__(self):
        if self.dist not in ("uniform", "pareto"):
            raise ValueError(f"unknown length dist {self.dist!r}; "
                             f"expected 'uniform' or 'pareto'")

    def _draw(self, rng, lo: int, hi: int) -> int:
        if self.dist == "pareto":
            return bounded_pareto(rng, lo, hi, self.alpha)
        return int(rng.integers(lo, hi + 1))

    def sample(self, rng: np.random.Generator):
        """-> (prompt ndarray, max_new_tokens).  Draw order is part of
        the contract (ClosedLoop bit-compatibility)."""
        plen = self._draw(rng, self.min_prompt, self.max_prompt)
        prompt = rng.integers(0, self.vocab_size, size=plen
                              ).astype(np.int32)
        budget = self._draw(rng, self.min_new, self.max_new)
        if self.clamp_len is not None and plen + budget > self.clamp_len:
            budget = max(1, self.clamp_len - plen)
        return prompt, budget


@dataclass(frozen=True)
class Workload:
    """Base workload: subclasses define the arrival process.

    ``build(seed)`` draws arrivals first, then per-request lengths, and
    returns ``Request``s sorted by arrival.  When ``slack_s`` is set,
    every open-loop request gets ``deadline = arrival_time + slack_s +
    slack_per_token_s * budget`` — a size-aware SLO the front end
    schedules EDF on."""

    n_requests: int = 16
    lengths: LengthModel = LengthModel()
    slack_s: Optional[float] = None
    slack_per_token_s: float = 0.0
    rid_base: int = 0

    # -- subclass hooks ----------------------------------------------
    def _arrival_times(self, rng) -> Optional[Sequence[float]]:
        """Virtual-clock arrival seconds (None: closed-loop, step-based
        arrivals via ``_arrival_step``).  Called before any length
        draw."""
        raise NotImplementedError

    def _arrival_step(self, i: int) -> int:
        return 0

    # -- builder ------------------------------------------------------
    def build(self, seed_or_rng=0) -> List[Request]:
        rng = _as_rng(seed_or_rng)
        times = self._arrival_times(rng)
        reqs: List[Request] = []
        for i in range(self.n_requests):
            prompt, budget = self.lengths.sample(rng)
            t = None if times is None else float(times[i])
            deadline = None
            if t is not None and self.slack_s is not None:
                deadline = t + self.slack_s + \
                    self.slack_per_token_s * budget
            reqs.append(Request(
                rid=self.rid_base + i, prompt=prompt,
                max_new_tokens=budget, arrival=self._arrival_step(i),
                arrival_time=t, deadline=deadline))
        return sorted(reqs, key=lambda r: (r.arrival_time or 0.0,
                                           r.arrival, r.rid))


@dataclass(frozen=True)
class ClosedLoop(Workload):
    """The legacy staggered fixed list: ``per_arrival`` requests every
    ``arrival_every`` engine steps, no virtual-clock times — a
    closed-loop workload is just a degenerate arrival process."""

    arrival_every: int = 2
    per_arrival: int = 1

    def _arrival_times(self, rng):
        return None                  # no draw: keeps legacy rng order

    def _arrival_step(self, i: int) -> int:
        return (i // self.per_arrival) * self.arrival_every


@dataclass(frozen=True)
class Poisson(Workload):
    """Memoryless open-loop arrivals at ``rate`` requests/second."""

    rate: float = 10.0

    def _arrival_times(self, rng):
        if self.rate <= 0:
            raise ValueError(f"Poisson rate must be > 0, got {self.rate}")
        gaps = rng.exponential(1.0 / self.rate, size=self.n_requests)
        return np.cumsum(gaps)


def _thinned_arrivals(rng, n: int, rate_fn, rate_max: float
                      ) -> np.ndarray:
    """First ``n`` arrivals of an inhomogeneous Poisson process with
    intensity ``rate_fn(t) <= rate_max`` (Lewis–Shedler thinning)."""
    out: List[float] = []
    t = 0.0
    while len(out) < n:
        t += float(rng.exponential(1.0 / rate_max))
        if float(rng.random()) * rate_max <= rate_fn(t):
            out.append(t)
    return np.asarray(out)


@dataclass(frozen=True)
class Diurnal(Workload):
    """Inhomogeneous Poisson under a raised-cosine day curve: intensity
    swings ``base_rate`` -> ``peak_rate`` -> ``base_rate`` over each
    ``period_s`` (peak at period/2)."""

    base_rate: float = 2.0
    peak_rate: float = 20.0
    period_s: float = 10.0

    def _arrival_times(self, rng):
        if not 0 < self.base_rate <= self.peak_rate:
            raise ValueError(
                f"need 0 < base_rate <= peak_rate, got "
                f"{self.base_rate}/{self.peak_rate}")
        base, peak, period = self.base_rate, self.peak_rate, self.period_s

        def rate(t):
            phase = 0.5 * (1.0 - math.cos(2.0 * math.pi * t / period))
            return base + (peak - base) * phase

        return _thinned_arrivals(rng, self.n_requests, rate, peak)


@dataclass(frozen=True)
class FlashCrowd(Workload):
    """Baseline Poisson plus a flash-crowd burst: intensity jumps to
    ``base_rate * burst_factor`` on ``[burst_start_s, burst_start_s +
    burst_dur_s)`` — the arrival pattern for the mid-burst-quarantine
    scenario."""

    base_rate: float = 5.0
    burst_factor: float = 8.0
    burst_start_s: float = 1.0
    burst_dur_s: float = 2.0

    def _arrival_times(self, rng):
        if self.base_rate <= 0 or self.burst_factor < 1:
            raise ValueError(
                f"need base_rate > 0 and burst_factor >= 1, got "
                f"{self.base_rate}/{self.burst_factor}")
        lo, hi = self.burst_start_s, self.burst_start_s + self.burst_dur_s
        base, burst = self.base_rate, self.base_rate * self.burst_factor

        def rate(t):
            return burst if lo <= t < hi else base

        return _thinned_arrivals(rng, self.n_requests, rate, burst)


def with_deadlines(requests: Sequence[Request], *, slack_s: float,
                   slack_per_token_s: float = 0.0) -> List[Request]:
    """Attach size-aware deadlines to an already-built request list
    (whatever its source): ``arrival_time + slack_s +
    slack_per_token_s * budget``."""
    out = []
    for r in requests:
        t0 = r.arrival_time if r.arrival_time is not None else 0.0
        out.append(replace(
            r, deadline=t0 + slack_s +
            slack_per_token_s * r.max_new_tokens))
    return out


def synthetic_workload(vocab_size: int, n_requests: int, rng, *,
                       min_prompt: int = 4, max_prompt: int = 20,
                       min_new: int = 3, max_new: int = 10,
                       arrival_every: int = 2, per_arrival: int = 1
                       ) -> List[Request]:
    """Staggered random workload (legacy builder, now ``ClosedLoop``):
    ``n_requests`` requests with prompt lengths in [min_prompt,
    max_prompt], budgets in [min_new, max_new], arriving
    ``per_arrival`` at a time every ``arrival_every`` engine steps.
    Request lists are bit-identical to the pre-traffic-layer builder
    for the same rng state."""
    wl = ClosedLoop(
        n_requests=n_requests,
        lengths=LengthModel(vocab_size=vocab_size, min_prompt=min_prompt,
                            max_prompt=max_prompt, min_new=min_new,
                            max_new=max_new),
        arrival_every=arrival_every, per_arrival=per_arrival)
    return wl.build(rng)
