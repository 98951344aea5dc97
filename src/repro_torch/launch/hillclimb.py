"""Hillclimb runner: baseline vs variant roofline comparison over the
port's dry run (the port's ``launch/hillclimb.py``).

Usage:
  python -m repro_torch.launch.hillclimb --arch mixtral-8x7b \\
      --shape train_4k --variant moe_combine_first [--microbatch 8] [--multi]

The baseline is the cell on the production mesh (``dryrun.run_cell(...,
mesh="single"|"multi")``), the variant the same cell under the
variant's mesh, rules, param axes, config overrides and train knobs, all
passed to ``run_cell`` as arguments.  Records are tagged ``@<variant>``
next to the baselines; the comparison prints the three roofline terms and
the dominant-term change, as the reference's does.  A knob the port's
step lacks raises ``ValueError`` naming it (``check_knobs``).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Any, Dict, Mapping, Optional

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.variants import VARIANTS, variant_mesh
from repro_torch.obs.logging import configure as obs_configure, get_logger

log = get_logger("launch.hillclimb")

# train_kw knobs the port's step takes (launch/tp_train.py): one data
# all-reduce a step; ZeRO-1's moments, 1/dp of them a rank
TRAIN_KNOBS = ("grad_unreduced", "zero1")
REMAT_POLICIES = ("none", "full", "dots", "collectives")


def check_knobs(v: Mapping[str, Any], cfg) -> None:
    """Raise ``ValueError`` naming the first knob of variant ``v`` that
    the port's step lacks (listed in ROADMAP)."""
    fields = {f.name for f in dataclasses.fields(cfg)}
    for k in v.get("overrides", {}):
        if k not in fields:
            raise ValueError(f"override {k!r}: the port's ModelConfig has "
                             "no such field")
    pol = v.get("overrides", {}).get("remat_policy")
    if pol is not None and pol not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {pol!r}: the port's remat knows "
                         f"{REMAT_POLICIES}")
    for k in v.get("train_kw", {}):
        if k not in TRAIN_KNOBS:
            raise ValueError(f"train_kw {k!r}: the port's training step "
                             "has no such knob yet (ROADMAP)")
    if v.get("moe_combine_first") and cfg.moe is None:
        raise ValueError(f"moe_combine_first: {cfg.name} has no MoE")


def run_variant(arch: str, shape: str, variant: str, *,
                multi_pod: bool = False, microbatch: Optional[int] = None,
                force: bool = False, out_dir: str = dryrun.ART_DIR,
                shapes=SHAPES) -> Dict[str, Any]:
    v = VARIANTS[variant]
    cfg = get_config(arch)
    check_knobs(v, cfg)
    overrides = dict(v.get("overrides", {}))
    if v.get("moe_combine_first"):
        overrides["moe"] = dataclasses.replace(cfg.moe, combine_first=True)
    return dryrun.run_cell(
        arch, shape, out_dir=out_dir, force=force, shapes=shapes,
        mesh="multi" if multi_pod else "single",
        mesh_obj=variant_mesh(v, multi_pod), rules=v.get("rules"),
        axes=v.get("axes"), overrides=overrides or None,
        microbatch=microbatch or v.get("microbatch"),
        grad_unreduced=bool(v.get("train_kw", {}).get("grad_unreduced")),
        zero1=bool(v.get("train_kw", {}).get("zero1")),
        tag=f"@{variant}")


def compare(base, var, label):
    rows = []
    for k in ("compute_s", "memory_s", "collective_s"):
        b = base["roofline"][k]
        w = var["roofline"][k]
        rows.append(f"  {k:14s} {b:9.3e} -> {w:9.3e}  "
                    f"({(w/b - 1)*100 if b else 0:+.1f}%)")
    bf = base["roofline"]["roofline_fraction"]
    wf = var["roofline"]["roofline_fraction"]
    sys.stdout.write("\n".join(
        [f"== {label}"] + rows +
        [f"  roofline_frac  {bf:.4f} -> {wf:.4f} "
         f"({(wf/bf if bf else 0):.2f}x)",
         f"  dominant       {base['roofline']['dominant']} -> "
         f"{var['roofline']['dominant']}"]) + "\n")
    return wf, bf


def main(argv=None):
    obs_configure(stream=sys.stdout)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", required=True, choices=list(VARIANTS))
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=dryrun.ART_DIR)
    args = ap.parse_args(argv)

    base = dryrun.run_cell(args.arch, args.shape, out_dir=args.out,
                           mesh="multi" if args.multi else "single")
    if base["status"] != "ok":
        raise SystemExit(f"baseline not ok: {base.get('reason') or base}")
    var = run_variant(args.arch, args.shape, args.variant,
                      multi_pod=args.multi, microbatch=args.microbatch,
                      force=args.force, out_dir=args.out)
    if var["status"] != "ok":
        log.error("variant_failed", error=var.get("error") or
                  var.get("reason"), trace=var.get("trace", "")[-2000:])
        raise SystemExit(1)
    compare(base, var, f"{args.arch}/{args.shape} + {args.variant}")


if __name__ == "__main__":
    main()
