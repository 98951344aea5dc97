"""One lane-fault scenario, end to end, on the port — the fault smoke.

A stuck-at lane fault is injected into the swiglu kernel's optimized
path, the canary checker detects AND lane-localizes it, routing walks
the degradation ladder (DEGRADED remap, then reduced-width on a second
fault), and the remapped output is checked bit-identical to an
uninjected run under the same plan — the paper's partial-degradation
claim (§III-A) exercised through the real registries, not mocks.

The optimized path is the HW route on the card (``csrc/swiglu.cu``, the
lane fault compiled into its epilogue) and the INTERPRET route on the CPU
(the kernel's blocked PyTorch replica).  The stage's ports are the
reference's shapes in bf16, the dtype the Hopper kernel takes, drawn at
1/sqrt(fan_in) so that healthy outputs sit well inside the stage's
absolute tolerance, which the canary applies.  Against outputs of that
scale an absolute bound says little, so the healthy, remapped and
reduced outputs are also held against the SW oracle relative to its
largest value (``REL_TOL``), and a wrong reduced-width result (lanes 3
and 7 dropped, not remapped) must fail that bound.

Run:  PYTHONPATH=src python examples_torch/lane_fault_smoke.py
      [--device cpu]

Prints a JSON summary and an OK line; exits nonzero on any failed check.
"""
import argparse
import json
import sys

import torch

from repro_torch.core import CanaryChecker, FaultState, Port, RoutingPlan, \
    Stage
from repro_torch.device import resolve_device
from repro_torch.kernels.swiglu import ops as _swiglu_ops  # noqa: F401 — registers
from repro_torch.viscosity import (DEGRADED_REDUCED, DEGRADED_REMAP, HW,
                                   INTERPRET, REGISTRY, lanefault)

STAGE = "swiglu_mlp"
# max |out - sw| / max |sw|: a few ulps of bf16's 8-bit mantissa (2^-8)
REL_TOL = 2e-2


def _scaled(s):
    def draw(z):
        return z * s
    return draw


PORTS = (Port((64, 64), torch.bfloat16, _scaled(0.5)),
         Port((64, 128), torch.bfloat16, _scaled(64 ** -0.5)),
         Port((64, 128), torch.bfloat16, _scaled(64 ** -0.5)),
         Port((128, 64), torch.bfloat16, _scaled(128 ** -0.5)))


def main(device=None) -> dict:
    """The scenario on ``device`` (default: the card); returns the summary
    (``checks`` and ``ok``)."""
    dev = resolve_device(device)
    target = HW if dev.type == "cuda" else INTERPRET
    lanefault.reset()
    spec = REGISTRY.get(STAGE)
    stage = Stage(name=STAGE, spec=spec, ports=PORTS,
                  tol=max(spec.tol, 1e-3), device=dev)
    x = stage.canary_inputs(seed=7)
    fault = lanefault.LaneFault(kind=lanefault.STUCK, lanes=(3, 7), width=64)
    summary = {"stage": STAGE, "device": str(dev), "route": target,
               "injected_lanes": list(fault.lanes), "tol": stage.tol,
               "rel_tol": REL_TOL}
    checks = {}
    rel_err = {}

    plan = RoutingPlan.for_stages([STAGE], target=target)
    sw = stage.run(*x, route=lanefault.SW)
    clean = stage.run(*x, route=plan)

    def rung(p):
        """The stage under a degraded plan, through the op's DEGRADED
        lowering: ``Stage.run`` sends every target but HW and INTERPRET to
        the oracle (as the reference's does), which would hold the oracle
        against itself."""
        return spec(*x, route=p)

    def err(a, b):
        return (a.float() - b.float()).abs().max().item()

    def close(label, out):
        """``out`` within the stage's absolute tol and REL_TOL of SW."""
        rel_err[label] = err(out, sw) / sw.float().abs().max().item()
        return err(out, sw) <= stage.tol and rel_err[label] <= REL_TOL

    checks["clean_close_to_oracle"] = close("clean", clean)

    with lanefault.inject(STAGE, fault):
        # 1) the fault is real: the optimized path's output is corrupted
        bad = stage.run(*x, route=plan)
        checks["injection_corrupts"] = err(bad, clean) > 0

        # 2) canary detects and lane-localizes it
        state = FaultState()
        chk = CanaryChecker([stage], route_hw=target, localize=True)
        found = chk.sweep(state, step=1)
        located = lanefault.fault_map(STAGE)
        checks["canary_detects"] = found == [STAGE]
        checks["canary_localizes"] = (
            located is not None and located.lanes == fault.lanes
            and state.log[-1]["kind"] == "canary_localized")
        if located is None:
            lanefault.reset()
            summary.update(checks=checks, rel_err=rel_err, ok=False)
            print(json.dumps(summary))
            return summary

        # 3) fault 1 -> DEGRADED remap; healed output is bit-identical to
        #    an uninjected run under the SAME degraded plan
        dplan = lanefault.degraded_plan(
            plan, state.counts([STAGE])).validate(registry=REGISTRY)
        checks["routes_degraded_remap"] = (
            dplan.target_for(STAGE) == DEGRADED_REMAP)
        healed = rung(dplan)
        checks["remap_close_to_oracle"] = close("remap", healed)

        # 4) fault 2 -> reduced-width execution, still within tolerance
        state.mark(STAGE, kind="canary_localized", step=2)
        dplan2 = lanefault.degraded_plan(
            plan, state.counts([STAGE])).validate(registry=REGISTRY)
        checks["routes_degraded_reduced"] = (
            dplan2.target_for(STAGE) == DEGRADED_REDUCED)
        reduced = rung(dplan2)
        checks["reduced_close_to_oracle"] = close("reduced", reduced)
        # the bound tells a wrong reduced-width result from a right one
        dropped = reduced.clone()
        dropped[..., list(fault.lanes)] = 0
        checks["bound_rejects_dropped_lanes"] = not close("dropped_lanes",
                                                          dropped)

    # bit-identity across injection: corruption confined to mapped lanes
    # is healed exactly (run afresh on both sides of the context)
    healed_clean = rung(dplan)
    checks["remap_bit_identical"] = bool(torch.equal(healed, healed_clean))

    # 5) deterministic log stamps: logical (step, origin, seq), no wall clock
    checks["log_is_logical"] = all(
        set(e) == {"stage", "replica", "kind", "step", "origin", "seq"}
        for e in state.log)

    lanefault.reset()
    ok = all(checks.values())
    summary.update(checks=checks, rel_err=rel_err, ok=ok)
    print(json.dumps(summary, indent=2))
    if ok:
        print(f"OK: the lane fault was detected, localized, remapped "
              f"bit-identically and run at reduced width within tolerance "
              f"(max rel err vs SW: clean {rel_err['clean']:.2e}, remap "
              f"{rel_err['remap']:.2e}, reduced "
              f"{rel_err['reduced']:.2e}, dropped lanes "
              f"{rel_err['dropped_lanes']:.2e}; bound {REL_TOL}).")
    return summary


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda)")
    args = ap.parse_args(argv)
    return 0 if main(device=args.device)["ok"] else 1


if __name__ == "__main__":
    sys.exit(cli())
