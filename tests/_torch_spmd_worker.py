"""One gloo rank of ``tests/test_torch_spmd.py`` (started by that module,
one process per rank, as ``tests/test_torch_distributed.py`` starts its
two).

    python -c "import _torch_spmd_worker as w; w.main(sys.argv[1:])" JSON

JSON: rank, world, port, mesh (one size per mesh axis), out (a
directory), cases.  Each case names a reduced config (optionally cut to
``layers``), a ``torch.save``d full param tree (the reference's, converted
by ``params_from_jax``; its packed Mamba2 leaves cut by component,
``partition.packed_layout``), a route, optionally the param axes
(``partition.DEFAULT_AXES`` by default) or a hillclimb ``variant`` (its
mesh axes, rules and param axes; ("data", "model") and
``partition.rules_for`` without one: the rank keeps one mesh per set of
axes) and what to run (prefill + teacher-forced decode, with the
collectives of each decode step, the cache's leaf shapes and, with
``keep_state``, its recurrent-state leaves; a train step's loss and
gradients, the step of
``launch/tp_train.py`` on the same batch under a clip that binds, its
ZeRO-1 step with ``k`` microbatches, the teacher-forced logits);
an encoder-decoder config takes ``frames`` stub frame embeddings and
runs the encoder, prefill (keeping the cross-KV) and decode, and the
train step.  The rank runs it on its shards under ``launch.spmd.spmd``
and saves what it got to ``out/rank<r>.pt``.
"""
import dataclasses
import json
import sys

import numpy as np
import torch


def _tokens(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 512, size=shape).astype(np.int64))


def _embeds(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _decode_steps(model, params, state, toks, P, T, out):
    """T teacher-forced decode steps from position P; each step's logits
    and collectives (calls and bytes by kind) into ``out``."""
    from repro_torch.launch import spmd
    log = spmd.collective_log()
    out["step_collectives"] = []
    for i in range(T):
        n0, b0 = (dict(log.by_kind("n")), dict(log.by_kind("bytes"))) \
            if log is not None else ({}, {})
        lg, state = model.decode_step(params, state,
                                      toks[:, P + i:P + i + 1], P + i)
        out[f"decode{i}"] = lg
        if log is not None:
            out["step_collectives"].append({
                what: {k: v - before.get(k, 0)
                       for k, v in log.by_kind(what).items()}
                for what, before in (("n", n0), ("bytes", b0))})
    return state


def _cache_record(cache, out):
    from repro_torch.launch import partition
    from repro_torch.viscosity.lang import tree_leaves
    out["cache_bytes"] = sum(t.numel() * t.element_size()
                             for t in tree_leaves(cache))
    out["cache_shapes"] = {path: tuple(t.shape) for path, t in
                           partition.flatten(cache).items()}


def run_encdec(case, model, params, rows):
    """An encoder-decoder case on ``params`` (the rank's shards under
    ``spmd``)."""
    from repro_torch.launch import spmd
    from repro_torch.train.runner import value_and_grad
    cfg = model.cfg
    B, P, T = case["batch"], case["prompt"], case["decode"]
    emb = _embeds(case["seed"], (B, case["frames"], cfg.d_model))[rows]
    toks = _tokens(case["seed"], (B, P + T))[rows]
    out = {}
    if "prefill" in case["run"]:
        out["encode"] = model.encode(params, emb)
        lg, state = model.prefill(params, {
            "embeds": emb, "dec_tokens": toks[:, :P],
            "cache": spmd.init_cache(model, toks.shape[0], P + T,
                                     device=torch.device("cpu"))})
        out["prefill"], out["cross"] = lg, state["cross"]
        state = _decode_steps(model, params, state, toks, P, T, out)
        _cache_record(state, out)
    if "train" in case["run"]:
        tgt = _tokens(case["seed"] + 2, (B, P + T))[rows]
        (loss, metrics), grads = value_and_grad(
            model.forward, params, {"embeds": emb, "dec_tokens": toks,
                                    "dec_targets": tgt})
        spmd.sync_grads(grads)
        out["loss"], out["metrics"], out["grads"] = loss, metrics, grads
    return out


def case_layout(case, cfg, mesh):
    """(logical-axis rules, param axes) of a case on ``mesh``: its
    variant's, or ``partition.rules_for`` and its ``axes``."""
    from repro_torch.launch.tp_serve import layout_of
    rules, axes = layout_of(case.get("variant"), cfg, mesh)
    return rules, (case.get("axes") or axes)


def run_case(case, mesh, coords):
    from repro_torch.configs import get_config
    from repro_torch.core.routing import RoutingPlan
    from repro_torch.launch import partition, spmd
    from repro_torch.models import build_model
    from repro_torch.train.runner import model_stage_names, value_and_grad

    cfg = dataclasses.replace(get_config(case["arch"]), dtype="float32")
    if case.get("layers"):
        cfg = dataclasses.replace(cfg, num_layers=case["layers"])
    routes = None
    if case["route"] != "sw":
        routes = RoutingPlan.for_stages(model_stage_names(cfg),
                                        target=case["route"])
    model = build_model(cfg, routes=routes)
    full = torch.load(case["params"])
    specs = partition.params_pspecs(full, mesh,
                                    case_layout(case, cfg, mesh)[1])
    local = partition.shard_tree(full, specs, mesh, coords,
                                 layout=partition.packed_layout(cfg))
    local = partition.map_with_path(local, lambda _, t: t.clone())
    nd = mesh.axis_sizes["data"]
    B, P, T = case["batch"], case["prompt"], case["decode"]
    rows = slice(coords["data"] * (B // nd), (coords["data"] + 1) * (B // nd))
    if cfg.is_encdec:
        return run_encdec(case, model, local, rows)
    out = {}
    if "prefill" in case["run"]:
        toks = _tokens(case["seed"], (B, P + T))[rows]
        cache = spmd.init_cache(model, B, P + T,
                                device=torch.device("cpu"))
        lg, cache = model.prefill(local, {"tokens": toks[:, :P],
                                          "cache": cache})
        out["prefill"] = lg
        cache = _decode_steps(model, local, cache, toks, P, T, out)
        _cache_record(cache, out)
        if case.get("keep_state"):
            out["state"] = {k: t.clone() for k, t in cache["mamba"].items()}
    if "train" in case["run"]:
        toks = _tokens(case["seed"] + 1, (B, P))[rows]
        tgt = _tokens(case["seed"] + 2, (B, P))[rows]
        (loss, metrics), grads = value_and_grad(
            model.forward, local, {"tokens": toks, "targets": tgt})
        spmd.sync_grads(grads)
        out["loss"], out["metrics"], out["grads"] = loss, metrics, grads
        if "update" in case["run"]:
            from repro_torch import optim
            from repro_torch.launch import tp_train
            params = partition.map_with_path(local, lambda _, t: t.clone())
            state = tp_train.init_opt(params, specs)
            _, state, stats = tp_train.train_step(
                model, optim.AdamWConfig(clip_norm=case["clip"],
                                         eps=case["eps"]),
                params, state, {"tokens": toks, "targets": tgt},
                specs=specs)
            out["update"] = {"params": params, "mu": state.mu,
                             "nu": state.nu, "grad_norm": stats["grad_norm"]}
    if "zero1" in case["run"]:
        from repro_torch import optim
        from repro_torch.launch import tp_train
        toks = _tokens(case["seed"] + 1, (B, P))[rows]
        tgt = _tokens(case["seed"] + 2, (B, P))[rows]
        params = partition.map_with_path(local, lambda _, t: t.clone())
        state = tp_train.init_opt(params, specs, zero1=True)
        _, state, stats = tp_train.train_step(
            model, optim.AdamWConfig(clip_norm=case["clip"], eps=case["eps"]),
            params, state, {"tokens": toks, "targets": tgt}, specs=specs,
            k=case.get("k", 1), zero1=True)
        out["zero1"] = {"params": params, "mu": state.mu, "nu": state.nu,
                        "grad_norm": stats["grad_norm"], "loss": stats["loss"],
                        "moment_bytes": tp_train.moment_bytes(state)}
    if "logits" in case["run"]:
        toks = _tokens(case["seed"] + 3, (B, P))[rows]
        out["logits"] = model.logits_all(local, {"tokens": toks})
    return out


def main(argv):
    a = json.loads(argv[0])
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.launch import spmd
    from repro_torch.launch.distributed import (initialize_runtime,
                                                shutdown_runtime)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.tp_serve import mesh_axes_of

    rank, world = a["rank"], a["world"]
    initialize_runtime(f"127.0.0.1:{a['port']}", world, rank,
                       backend="gloo", timeout_s=300)
    meshes = {}
    res = {}
    for case in a["cases"]:
        cfg = get_config(case["arch"])
        names = mesh_axes_of(case.get("variant"))
        if names not in meshes:
            mesh = make_mesh(tuple(a["mesh"]), names,
                             devices=[torch.device("cpu")] * world)
            meshes[names] = (mesh, spmd.GroupComm(mesh, rank))
        mesh, comm = meshes[names]
        coords = spmd.rank_coords(mesh, rank)
        res.setdefault("coords", coords)
        rules, axes = case_layout(case, cfg, mesh)
        comm.log.reset()
        with spmd.spmd(mesh, rules, axes, coords, comm,
                       dims=spmd.logical_sizes(cfg)):
            res[case["name"]] = run_case(case, mesh, coords)
        res[case["name"]]["coords"] = coords
        res[case["name"]]["collectives"] = comm.log.snapshot()
    torch.save(res, f"{a['out']}/rank{rank}.pt")
    dist.barrier()
    shutdown_runtime()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
