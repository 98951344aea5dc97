"""Elastic re-shard on the fleet API, on the port: train on a health-masked
(2, 4) ("data", "model") mesh of eight ranks, lose a "pod" of four
devices (FleetPlan device faults), re-fold the surviving fleet into
(1, 4), restore the checkpoint onto it, and continue with the
optimiser's step count preserved.

As the reference, the model is the reduced gemma3-1b, its params cut by
``launch/partition.py``'s ``params_pspecs`` (its four query heads split
over "model", its one kv head replicated) and its batch over "data".
Where the reference jits one SPMD step over eight forced host devices,
the port runs one process per rank, each joining its group and taking
``launch/tp_train.py``'s ``train_step`` on its shards and rows
(``join``, ``batch_rows``, ``rank_context``: gloo over a free local port,
payloads through the host; on the card every rank shares ``cuda:0``).
After 10 steps the shards go through ``unshard_tree`` and rank 0 saves
the whole tree through ``CheckpointManager``.  Devices 4-7 are then
quarantined: their ranks exit, and ranks 0-3 leave the group and join a
fresh one of four at another port, as an elastic restart does, restore
the checkpoint, cut it onto (1, 4) (each survivor's shards bit-identical
to those it held) and train 10 more steps on the same data stream; their
final params are gathered whole the same way.

Run:  PYTHONPATH=src python examples_torch/elastic_train.py [--device cpu]
"""
import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.routing import FleetPlan
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import FleetMeshView
from repro_torch.models import build_model
from repro_torch.train.runner import model_stage_names

N_DEVICES = 8
MODEL = 4            # the model axis of both meshes
POD = (4, 5, 6, 7)
STEPS = 10           # on the whole fleet, then as many on the survivors
BATCH, SEQ = 8, 32
TIMEOUT_S = 600
RESULT = "RESULT "
WORKER = ("import sys, json, importlib.util as u; "
          "sys.path.insert(0, sys.argv[1]); a = json.loads(sys.argv[2]); "
          "s = u.spec_from_file_location('elastic_train', a['file']); "
          "m = u.module_from_spec(s); s.loader.exec_module(m); "
          "sys.exit(m.rank_main(a))")


def config(dtype=None):
    """The reduced gemma3-1b, computing in ``dtype`` when given (else the
    config's)."""
    cfg = get_config("gemma3-1b").reduced()
    return dataclasses.replace(cfg, dtype=dtype) if dtype else cfg


def ocfg():
    from repro_torch import optim
    return optim.AdamWConfig(lr=5e-3, warmup_steps=5, total_steps=100)


def _train(cfg, model, params, opt, specs, mesh, comm, coords, first, dev):
    """``STEPS`` steps of ``tp_train.train_step`` from step ``first``, the
    rank's rows of each ``SyntheticLM`` batch; the losses."""
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import tp_train
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, batch=BATCH,
                                  seq_len=SEQ))
    rows = tp_train.batch_rows(BATCH, mesh, coords)
    losses = []
    with tp_train.rank_context(cfg, mesh, coords, comm):
        for s in range(first, first + STEPS):
            batch = {k: torch.from_numpy(v[rows]).to(dev)
                     for k, v in data.batch_at(s).items()}
            params, opt, st = tp_train.train_step(model, ocfg(), params,
                                                  opt, batch, specs=specs)
            losses.append(float(st["loss"]))
    return params, opt, losses


def _whole(trees, specs, mesh, rank, world, tmp, tag, coord):
    """Every rank's shards of ``trees`` (a dict of trees) through the disk;
    on rank 0 the whole trees (``unshard_tree``), elsewhere None."""
    from repro_torch.launch import partition
    torch.save({k: partition.map_with_path(v, lambda _, t: t.cpu())
                for k, v in trees.items()},
               os.path.join(tmp, f"{tag}_{rank}.pt"))
    coord.exchange(tag)
    if rank:
        return None
    shards = [torch.load(os.path.join(tmp, f"{tag}_{r}.pt"))
              for r in range(world)]
    return {k: partition.unshard_tree([s[k] for s in shards], specs, mesh)
            for k in trees}


def rank_main(a) -> int:
    """One rank of the drill (``a``: what ``main`` passes it); prints one
    ``RESULT {json}`` line."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import partition, tp_train
    from repro_torch.launch.distributed import KVCoordinator
    from repro_torch.optim import AdamWState
    rank, dev = a["rank"], torch.device(a["device"])
    torch.set_num_threads(1)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    cfg = config(a["dtype"])
    model = build_model(cfg)
    full = torch.load(a["init"], map_location="cpu")
    tmp = a["tmp"]

    # --- phase 1: rank of the (2, 4) mesh ---
    mesh1, comm, coords = tp_train.join(a["ports"][0], N_DEVICES, rank,
                                        a["mesh"][0], dev)
    specs1 = partition.params_pspecs(full, mesh1)
    params = partition.map_with_path(
        partition.shard_tree(full, specs1, mesh1, coords),
        lambda _, t: t.to(dev, copy=True))
    opt = tp_train.init_opt(params)
    params, opt, losses1 = _train(cfg, model, params, opt, specs1, mesh1,
                                  comm, coords, 0, dev)
    held = {"params": params, "mu": opt.mu, "nu": opt.nu}
    coord = KVCoordinator()
    whole = _whole(held, specs1, mesh1, rank, N_DEVICES, tmp, "shards",
                   coord)
    ckpt = CheckpointManager(os.path.join(tmp, "ckpt"))
    if rank == 0:           # the whole tree, from every rank's shards
        ckpt.save(STEPS, {"params": whole["params"], "opt": AdamWState(
            opt.count.cpu(), whole["mu"], whole["nu"])})
    coord.exchange("checkpointed")
    res = {"rank": rank, "coords1": coords, "losses1": losses1,
           "count1": int(opt.count)}
    tp_train.leave(coord)
    if rank in POD:         # quarantined: this rank's device left the fleet
        print(RESULT + json.dumps(res), flush=True)
        return 0

    # --- phase 2: a survivor, restarted into a group of four ---
    world = N_DEVICES - len(POD)
    mesh2, comm, coords = tp_train.join(a["ports"][1], world, rank,
                                        a["mesh"][1], dev)
    like = {"params": full, "opt": AdamWState(
        torch.zeros((), dtype=torch.int32), full, full)}
    restored = ckpt.restore(STEPS, like)
    specs2 = partition.params_pspecs(full, mesh2)
    got = {k: partition.shard_tree(t, specs2, mesh2, coords) for k, t in (
        ("params", restored["params"]), ("mu", restored["opt"].mu),
        ("nu", restored["opt"].nu))}
    same = all(torch.equal(x.cpu(), y) for k in held for x, y in zip(
        partition.flatten(held[k]).values(),
        partition.flatten(got[k]).values()))
    params = partition.map_with_path(got["params"],
                                     lambda _, t: t.to(dev, copy=True))
    opt = AdamWState(restored["opt"].count.to(dev),
                     *(partition.map_with_path(got[k], lambda _, t: t.to(
                         dev, copy=True)) for k in ("mu", "nu")))
    count2 = int(opt.count)
    params, opt, losses2 = _train(cfg, model, params, opt, specs2, mesh2,
                                  comm, coords, STEPS, dev)
    coord = KVCoordinator()
    whole = _whole({"params": params}, specs2, mesh2, rank, world, tmp,
                   "final", coord)
    if rank == 0:
        torch.save(whole["params"], os.path.join(tmp, "final.pt"))
    res.update({"coords2": coords, "losses2": losses2,
                "restored_count": count2, "bit_identical": same,
                "count2": int(opt.count)})
    tp_train.leave(coord)
    print(RESULT + json.dumps(res), flush=True)
    return 0


def main(device=None, params=None, dtype=None) -> dict:
    """The drill on ``device`` (default: the card); ``params`` the full
    initial tree (default: the reduced gemma3-1b's ``init(0)``), ``dtype``
    the compute dtype (default: the config's).  Returns the summary, the
    final params gathered whole among it."""
    from repro_torch.launch.tp_serve import free_port, run_ranks
    dev = resolve_device(device)
    cfg = config(dtype)
    stages = model_stage_names(cfg)
    logical = [dev] * N_DEVICES

    # --- phase 1: full healthy fleet -> (2, 4) health-masked mesh ---
    fleet = FleetPlan.healthy(N_DEVICES, stages)
    view1 = FleetMeshView.from_plan(fleet)
    mesh1 = view1.submesh(("data", "model"), model=MODEL, devices=logical)
    print(f"phase 1 fleet: serving {view1.serving()} -> mesh "
          f"{list(mesh1.shape)}")

    # --- phase 2's view: a "pod" of 4 devices fails; the FleetPlan
    # carries the quarantine and the mesh view re-folds the survivors ---
    for d in POD:
        fleet = fleet.with_device_fault(d)
    view2 = FleetMeshView.from_plan(fleet)
    assert view2.quarantined == POD
    mesh2 = view2.submesh(("data", "model"), model=MODEL, devices=logical)
    if params is None:
        params = build_model(cfg).init(0, device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        init = os.path.join(tmp, "init.pt")
        torch.save(params, init)
        ports = [free_port(), free_port()]
        args = [json.dumps({"rank": r, "file": os.path.abspath(__file__),
                            "device": str(dev), "init": init, "tmp": tmp,
                            "mesh": [list(mesh1.shape), list(mesh2.shape)],
                            "ports": ports, "dtype": dtype})
                for r in range(N_DEVICES)]
        res = run_ranks(WORKER, args, timeout=TIMEOUT_S,
                        env={**os.environ, "OMP_NUM_THREADS": "1"})
        final = torch.load(os.path.join(tmp, "final.pt"))
    r0 = res[0]
    losses, losses2 = r0["losses1"], r0["losses2"]
    for r in res:
        assert np.allclose(r["losses1"], losses, rtol=1e-6), r["rank"]
    survivors = [r for r in res if r["rank"] not in POD]
    assert len(survivors) == N_DEVICES - len(POD)
    for r in survivors:
        assert r["bit_identical"], f"rank {r['rank']}'s restored shards"
        assert r["restored_count"] == STEPS   # optimizer state continued
        assert np.allclose(r["losses2"], losses2, rtol=1e-6), r["rank"]
    print(f"phase 1 ({mesh1.shape[0]}x{mesh1.shape[1]} mesh, "
          f"{N_DEVICES} ranks): loss {losses[0]:.3f} -> {losses[-1]:.3f}; "
          f"checkpoint saved at step {STEPS}")
    print(f"phase 2 fleet: quarantined {view2.quarantined}, serving "
          f"{view2.serving()} -> mesh {list(mesh2.shape)}; the survivors' "
          "restored shards equal those they held")
    print(f"phase 2 ({mesh2.shape[0]}x{mesh2.shape[1]} mesh after pod loss): "
          f"loss {losses2[0]:.3f} -> {losses2[-1]:.3f}")
    assert np.isfinite(losses + losses2).all()
    opt_count = survivors[0]["count2"]
    assert opt_count == 2 * STEPS
    print("OK: FleetPlan carried the pod loss as an explicit mask, the "
          "health-masked mesh view re-folded the survivors, and "
          "training continued from the checkpoint (optimizer step "
          "count preserved).")
    return {"device": str(dev), "arch": cfg.name,
            "mesh": [list(mesh1.shape), list(mesh2.shape)],
            "quarantined": list(view2.quarantined),
            "losses": [losses, losses2], "opt_count": opt_count,
            "ranks": [len(res), len(survivors)],
            "restored_count": survivors[0]["restored_count"],
            "restored_bit_identical": [r["bit_identical"]
                                       for r in survivors],
            "params": final}


def cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda)")
    args = ap.parse_args(argv)
    main(device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
