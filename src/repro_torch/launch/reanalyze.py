"""Recompute the roofline and ``fits`` of cached dry-run records from
their recorded counts (no step runs again).

The port's counterpart of the reference's ``launch/reanalyze.py``.  There
is no program text to re-parse: a record keeps what ``launch/dryrun.py``
counted (FLOPs, traffic and score bytes per device, the peak of live
bytes), so when a constant of the card changes (its rates, the memory
limit or reserve, the power cap it is run at, the link rates that price a
sharded cell's collectives) the derived fields are recomputed from
those; sharded records (``<arch>__<shape>__<mesh>.json``) keep their
collective link bytes by axis for this.  The microbatch count is not searched again: a
train cell's ``fits`` is its recorded peak against the new limit.

Usage: PYTHONPATH=src python -m repro_torch.launch.reanalyze [--out DIR]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Any, Dict

from repro_torch.launch import dryrun
from repro_torch.obs.logging import configure as obs_configure, get_logger

log = get_logger("launch.reanalyze")


def reanalyze(rec: Dict[str, Any]) -> Dict[str, Any]:
    """``rec`` with ``fits``, ``hbm_limit_bytes``, the card's name and
    power limit and ``roofline`` recomputed (a copy; other records come
    back as they are)."""
    if rec.get("status") != "ok":
        return dict(rec)
    tr = rec["traffic"]
    return {**rec, "device": dryrun.DEVICE,
            "power_limit_w": dryrun.POWER_LIMIT_W,
            "hbm_limit_bytes": dryrun.HBM_LIMIT,
            "fits": rec["bytes"]["peak"] <= dryrun.HBM_LIMIT,
            "roofline": dryrun.roofline_terms(
                rec["flops_per_dev"], tr["hbm_bytes_per_dev"],
                tr["score_bytes_per_dev"], rec["chips"],
                rec["model_flops"], rec["kind"], rec.get("collectives"))}


def reanalyze_one(json_path: str) -> bool:
    with open(json_path) as f:
        rec = json.load(f)
    if rec.get("status") != "ok":
        return False
    with open(json_path, "w") as f:
        json.dump(reanalyze(rec), f, indent=1)
    return True


def main(argv=None):
    obs_configure(stream=sys.stdout)
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=dryrun.ART_DIR)
    args = ap.parse_args(argv)
    n = 0
    for jp in sorted(glob.glob(os.path.join(args.out, "*.json"))):
        if reanalyze_one(jp):
            n += 1
            log.info("reanalyzed", cell=os.path.basename(jp)[:-5])
    log.info("done", cells=n)


if __name__ == "__main__":
    main()
