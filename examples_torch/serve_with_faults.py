"""Continuous-batching serving under faults: the paper's guarantee, live,
on the port.

A staggered stream of requests (unequal prompt lengths, unequal token
budgets) flows through a 3-slot continuous-batching engine.  Mid-stream,
the attention stage is quarantined.

Part 1 routes healthy stages through the kernel lowering so the fault is a
real reroute (kernel -> SW oracle): on the card that is the HW route (the
Hopper kernels), on the CPU the INTERPRET route (each kernel's PyTorch
replica).  It runs under both failover modes:

  * recompile (queue reconfiguration): the dispatcher builds the
    rerouted decode program exactly once; in-flight sequences continue;
  * resident (hot-spare): the same program keeps running — failover is
    one flipped bit in the health list, zero builds.

Both modes apply the same routing history, so their tokens are identical.

Part 2 runs the production SW config (healthy route == SW oracle): there
the fault does not change the RoutingPlan at all (plan-keyed dispatch
dedupes it) and every completion is bit-identical to a single-request
reference decode — the end-to-end Viscosity guarantee.

Run:  PYTHONPATH=src python examples_torch/serve_with_faults.py
      [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serve import (RECOMPILE, RESIDENT, ServeConfig, ServeEngine,
                               reference_decode, synthetic_workload)
from repro_torch.viscosity import HW, INTERPRET

ARCH = "qwen1.5-4b"         # reduced
WORKLOAD = dict(min_prompt=6, max_prompt=23, min_new=6, max_new=15,
                arrival_every=2)
SLOTS = 3


def requests(cfg):
    """The staggered stream: 8 requests drawn from seed 7."""
    return synthetic_workload(cfg.vocab_size, 8, np.random.default_rng(7),
                              **WORKLOAD)


def main(device=None) -> dict:
    dev = resolve_device(device)
    cfg = get_config(ARCH).reduced()
    params = build_model(cfg).init(0, device=dev)
    reqs = requests(cfg)
    kernel_route = HW if dev.type == "cuda" else INTERPRET
    summary = {"arch": cfg.name, "device": str(dev),
               "kernel_route": kernel_route, "requests": len(reqs)}

    # Part 1: a real reroute (kernel -> SW), both failover mechanisms.
    outs = {}
    for mode in (RECOMPILE, RESIDENT):
        eng = ServeEngine(cfg, params, ServeConfig(max_len=64,
                                                   max_slots=SLOTS,
                                                   hw_route=kernel_route,
                                                   failover=mode),
                          device=dev)
        t0 = time.perf_counter()
        done, stats = eng.serve(reqs, fault_at_step=(9, "flash_attention"))
        dt = time.perf_counter() - t0
        outs[mode] = done
        n_tok = sum(len(c.tokens) for c in done.values())
        print(f"[{mode:9s}] route {kernel_route}: {len(done)}/{len(reqs)} "
              f"requests, {n_tok} tokens in {dt:.2f}s, occupancy "
              f"{float(np.mean(stats['occupancy'])):.2f}/{SLOTS}, "
              f"recompiles {stats['recompiles']}")
        assert len(done) == len(reqs)
        assert stats["recompiles"] == (1 if mode == RECOMPILE else 0)
        summary[mode] = {"tokens": n_tok, "wall_s": dt,
                         "recompiles": stats["recompiles"]}
    same = all(np.array_equal(outs[RECOMPILE][r.rid].tokens,
                              outs[RESIDENT][r.rid].tokens) for r in reqs)
    print(f"recompile and resident tokens identical: {same}")
    assert same
    summary["modes_identical"] = same

    # Part 2: production SW config — bit-identity with reference decode.
    eng = ServeEngine(cfg, params, ServeConfig(max_len=64, max_slots=SLOTS),
                      device=dev)
    done, stats = eng.serve(reqs, fault_at_step=(9, "flash_attention"))
    exact = all(
        np.array_equal(done[r.rid].tokens,
                       reference_decode(cfg, params, r.prompt,
                                        r.max_new_tokens, max_len=64))
        for r in reqs)
    print(f"[sw-route ] fault plan deduped (recompiles "
          f"{stats['recompiles']}), bit-identical to single-request "
          f"reference decode: {exact}")
    assert exact and stats["recompiles"] == 0
    summary["sw"] = {"recompiles": stats["recompiles"],
                     "bit_identical": exact}
    print("OK: mid-stream stage faults rerouted in-flight decodes under "
          "both failover modes.")
    return summary


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda)")
    args = ap.parse_args(argv)
    main(device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
