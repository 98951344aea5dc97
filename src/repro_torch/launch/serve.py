"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Drives the continuous-batching engine on a synthetic workload: requests
with independent prompt lengths and staggered arrivals stream through a
fixed slot pool, with optional mid-stream fault injection under either
failover mode (plan-keyed rebuild or resident health mask).  With
``--verify`` every completion is checked bit for bit against a
single-request reference decode.

The flags and defaults are the reference CLI's (the arch's reduced config,
random params from seed 0), plus ``--device``: the card (``cuda``) unless
given another, e.g. ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.obs.logging import configure as obs_configure, get_logger
from repro_torch.serve import (RECOMPILE, RESIDENT, ServeConfig, ServeEngine,
                               percentile, reference_decode,
                               synthetic_workload)
from repro_torch.viscosity import HW, INTERPRET, SW

log = get_logger("launch.serve")


def main(argv=None):
    obs_configure(stream=sys.stdout)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-4b", choices=list(ARCH_NAMES))
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="max prompt length (lengths are drawn in "
                         "[4, prompt-len])")
    ap.add_argument("--new-tokens", type=int, default=32,
                    help="max token budget (budgets drawn in "
                         "[4, new-tokens])")
    ap.add_argument("--arrival-every", type=int, default=2,
                    help="one request arrives every N engine steps")
    ap.add_argument("--failover", default=RECOMPILE,
                    choices=[RECOMPILE, RESIDENT])
    ap.add_argument("--hw-route", default=SW, choices=[HW, SW, INTERPRET])
    ap.add_argument("--fault-at", type=int, default=-1,
                    help="engine step at which to quarantine --fault-stage")
    ap.add_argument("--fault-stage", default="flash_attention")
    ap.add_argument("--verify", action="store_true",
                    help="check every request against single-request "
                         "reference decode")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the card, "
                         "cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    params = build_model(cfg).init(0, device=dev)
    reqs = synthetic_workload(cfg.vocab_size, args.requests,
                              np.random.default_rng(args.seed),
                              max_prompt=args.prompt_len, min_new=4,
                              max_new=args.new_tokens,
                              arrival_every=args.arrival_every)
    max_len = args.prompt_len + args.new_tokens + 1
    eng = ServeEngine(cfg, params, ServeConfig(
        max_len=max_len, max_slots=args.slots, hw_route=args.hw_route,
        failover=args.failover), device=dev)
    fault = ((args.fault_at, args.fault_stage)
             if args.fault_at >= 0 else None)
    t0 = time.perf_counter()
    done, stats = eng.serve(reqs, fault_at_step=fault)
    dt = time.perf_counter() - t0
    n_tok = sum(len(c.tokens) for c in done.values())
    lat = [c.latency_s for c in done.values()]
    log.info("served", requests=f"{len(done)}/{len(reqs)}", tokens=n_tok,
             wall_s=round(dt, 2), tok_s=round(n_tok / dt, 1),
             steps=stats["steps"], device=str(dev),
             occupancy=round(float(np.mean(stats["occupancy"]))
                             if stats["occupancy"] else 0.0, 2))
    log.info("latency", failover=args.failover,
             recompiles=stats["recompiles"],
             p50_ms=round(percentile(lat, 0.50) * 1e3),
             p99_ms=round(percentile(lat, 0.99) * 1e3))
    if args.verify:
        if args.hw_route != SW:
            raise SystemExit(
                "--verify requires --hw-route sw: across lowerings tokens "
                "are only tol-equivalent (Viscosity contract), not "
                "bit-exact against the SW reference decode")
        for r in reqs:
            ref = reference_decode(cfg, params, r.prompt, r.max_new_tokens,
                                   max_len=max_len)
            if not np.array_equal(done[r.rid].tokens, ref):
                raise SystemExit(f"request {r.rid}: tokens diverge from "
                                 f"reference decode")
        log.info("verified", requests=len(reqs),
                 detail="bit-identical-to-reference-decode")


if __name__ == "__main__":
    main()
