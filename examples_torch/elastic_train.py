"""Elastic re-shard on the fleet API, on the port: train on a fleet of 8
logical devices, lose a "pod" of four (FleetPlan device faults), rebuild
the mesh view from the surviving fleet, restore the checkpoint onto it,
and continue with the optimiser's step count preserved.

The reference forces 8 host devices and jits one SPMD step over a
(2, 4) (data, model) mesh, its params sharded over "model" by
``launch/partition.py``'s ``params_pspecs``.  The port has the same specs
and a tensor-parallel runtime (``launch/spmd.py``: one process per rank,
``launch/tp_serve.py`` serves through it), but this example does not run
its step on it yet (ROADMAP): its fleet is data-parallel, every logical
device holds the whole model and takes its ``shard_bounds`` slice of the
global batch, and the shards' grads are summed, weighted by their rows,
into one step.  The mesh is 1-D over "data", (8,) and then (4,), and the
8 logical devices all map to the one device this runs on.

Run:  PYTHONPATH=src python examples_torch/elastic_train.py [--device cpu]
"""
import argparse
import tempfile

import numpy as np
import torch

from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.routing import FleetPlan
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import FleetMeshView
from repro_torch.launch.sharding import shard_bounds
from repro_torch.models import build_model
from repro_torch.train.runner import model_stage_names, value_and_grad
from repro_torch.viscosity.lang import tree_leaves, tree_map

N_DEVICES = 8
POD = (4, 5, 6, 7)
STEPS = 10           # on the whole fleet, then as many on the survivors


def fleet_step(model, ocfg, params, opt, batch, view):
    """One data-parallel step over the view's serving devices: each takes
    its rows, the grads are averaged by rows, AdamW updates in place."""
    B = batch["tokens"].shape[0]
    total = tree_map(torch.zeros_like, params)
    loss = 0.0
    for lo, hi in shard_bounds(B, view.mask).values():
        shard = {k: v[lo:hi] for k, v in batch.items()}
        (l, _), grads = value_and_grad(model.forward, params, shard)
        torch._foreach_add_(tree_leaves(total), tree_leaves(grads),
                            alpha=float(hi - lo))
        loss += float(l) * (hi - lo)
    torch._foreach_div_(tree_leaves(total), float(B))
    params, opt, _ = optim.update(ocfg, total, opt, params)
    return params, opt, loss / B


def main(device=None) -> dict:
    dev = resolve_device(device)
    cfg = get_config("gemma3-1b").reduced()
    model = build_model(cfg)
    ocfg = optim.AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=100)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, batch=8,
                                  seq_len=32))
    stages = model_stage_names(cfg)
    logical = [dev] * N_DEVICES
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = CheckpointManager(tmp)

        # --- phase 1: full healthy fleet -> an (8,) data mesh ---
        fleet = FleetPlan.healthy(N_DEVICES, stages)
        view1 = FleetMeshView.from_plan(fleet)
        mesh1 = view1.submesh(("data",), devices=logical)
        print(f"phase 1 fleet: serving {view1.serving()} -> mesh "
              f"{mesh1.shape}")
        params = model.init(0, device=dev)
        opt = optim.init(params)
        losses = []
        for s in range(STEPS):
            params, opt, loss = fleet_step(
                model, ocfg, params, opt, data.device_batch(s, device=dev),
                view1)
            losses.append(loss)
        ckpt.save(STEPS, {"params": params, "opt": opt})
        print(f"phase 1 ({mesh1.shape} mesh): loss {losses[0]:.3f} -> "
              f"{losses[-1]:.3f}; checkpoint saved at step {STEPS}")

        # --- phase 2: a "pod" of 4 devices fails; the FleetPlan carries
        # the quarantine and the mesh view re-folds the survivors ---
        for d in POD:
            fleet = fleet.with_device_fault(d)
        view2 = FleetMeshView.from_plan(fleet)
        assert view2.quarantined == POD
        mesh2 = view2.submesh(("data",), devices=logical)
        print(f"phase 2 fleet: quarantined {view2.quarantined}, serving "
              f"{view2.serving()} -> mesh {mesh2.shape}")
        home = mesh2.devices[0]
        restored = ckpt.restore(STEPS, {"params": params, "opt": opt},
                                shardings={"params": tree_map(
                                    lambda _: home, params), "opt": None})
        params2, opt2 = restored["params"], restored["opt"]
        assert int(opt2.count) == STEPS   # optimizer state continued
        losses2 = []
        for s in range(STEPS, 2 * STEPS):
            params2, opt2, loss = fleet_step(
                model, ocfg, params2, opt2,
                data.device_batch(s, device=dev), view2)  # same stream
            losses2.append(loss)
        print(f"phase 2 ({mesh2.shape} mesh after pod loss): loss "
              f"{losses2[0]:.3f} -> {losses2[-1]:.3f}")
        assert np.isfinite(losses + losses2).all()
        assert int(opt2.count) == 2 * STEPS
        print("OK: FleetPlan carried the pod loss as an explicit mask, the "
              "health-masked mesh view re-folded the survivors, and "
              "training continued from the checkpoint (optimizer step "
              "count preserved).")
        return {"device": str(dev), "arch": cfg.name,
                "mesh": [list(mesh1.shape), list(mesh2.shape)],
                "quarantined": list(view2.quarantined),
                "losses": [losses, losses2],
                "opt_count": int(opt2.count)}


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda)")
    args = ap.parse_args(argv)
    main(device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(cli())
