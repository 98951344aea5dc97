"""One card a rank: the rank -> device map of the tensor-parallel
launchers, ``GroupComm`` without host copies, and the keyed draw a rank
makes of its own block.

Under NCCL rank r runs on ``cuda:r`` (``mesh.rank_device``) and its
collectives run on the tensors where they lie (``GroupComm(host=False)``);
gloo keeps every rank on the one device and copies through the host.
Here, on the CPU, the NCCL map is checked against a faked card count,
and ``host=False`` runs over four gloo CPU ranks, where it must give the
host copies' bits.  ``LMModel.init_keyed`` draws layer l from a key of
its own: a rank's block is the slice of the one-rank draw bit for bit,
and a cut model's layers are the full model's first layers.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch import partition, spmd, tp_serve, tp_train
from repro_torch.launch.mesh import make_mesh, rank_device, rank_devices
from repro_torch.models import build_model
from _torch_threads import one_torch_thread  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
WORKER = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
          "import test_torch_nccl_ranks as t; "
          "sys.exit(t.comm_worker(sys.argv[3:]))")
COMM_MESH = (2, 2)
AXES = ("model", "data", ("data", "model"))


# ---------------------------------------------------------------- devices
def test_gloo_keeps_every_rank_on_the_one_device():
    assert rank_devices(4, "gloo", "cpu") == [torch.device("cpu")] * 4
    assert rank_device(3, 4, "gloo", "cpu") == torch.device("cpu")


def test_nccl_refuses_the_cpu():
    with pytest.raises(ValueError, match="one card a rank"):
        rank_device(0, 4, "nccl", "cpu")
    with pytest.raises(ValueError, match="one card a rank"):
        tp_serve.launch_jobs([], (1, 4), device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="one card a rank"):
        tp_train.launch_ranks([], (2, 2), device="cpu", backend="nccl")


def _cards(monkeypatch, n):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)


def test_nccl_gives_rank_r_card_r(monkeypatch):
    _cards(monkeypatch, 4)
    want = [torch.device("cuda", r) for r in range(4)]
    assert rank_devices(4, "nccl") == want
    assert rank_devices(4, "nccl", "cuda:2") == want     # a rank's own card
    assert [rank_device(r, 4, "nccl", f"cuda:{r}") for r in range(4)] == want
    with pytest.raises(ValueError, match="rank 1 on cuda:1, not cuda:0"):
        rank_device(1, 4, "nccl", "cuda:0")
    mesh = make_mesh((1, 4), ("data", "model"), devices=rank_devices(4, "nccl"))
    assert list(mesh.devices) == want


def test_nccl_refuses_fewer_cards_than_ranks(monkeypatch):
    _cards(monkeypatch, 2)
    with pytest.raises(RuntimeError, match="4 ranks need 4 cards, this "
                                           "process sees 2"):
        rank_devices(4, "nccl")
    with pytest.raises(RuntimeError, match="sees 2"):
        rank_device(0, 4, "nccl")


# ------------------------------------------------------------ collectives
def _inputs(rank):
    gen = torch.Generator().manual_seed(100 + rank)
    return {"f32": torch.randn((3, 8, 5), generator=gen),
            "bf16": torch.randn((3, 8, 5), generator=gen).to(torch.bfloat16)}


def comm_worker(argv) -> int:
    """One gloo CPU rank: every collective over each axis of the (2, 2)
    mesh through ``GroupComm(host=True)`` and ``host=False``; saves the
    results and both logs."""
    from repro_torch.launch.distributed import (initialize_runtime,
                                                shutdown_runtime)
    a = json.loads(argv[0])
    rank, world = a["rank"], a["world"]
    torch.set_num_threads(1)
    initialize_runtime(f"127.0.0.1:{a['port']}", world, rank,
                       backend="gloo")
    mesh = make_mesh(COMM_MESH, ("data", "model"),
                     devices=[torch.device("cpu")] * world)
    out = {}
    for host in (True, False):
        comm = spmd.GroupComm(mesh, rank, host=host, timed=True)
        x = _inputs(rank)
        for ax in AXES:
            name = spmd.axis_name(ax)
            out[host, "all-reduce", name] = comm.all_reduce(x["f32"], ax)
            for dt in ("f32", "bf16"):
                out[host, f"all-gather {dt}", name] = comm.all_gather(
                    x[dt], ax, 1)
            out[host, "reduce-scatter", name] = comm.reduce_scatter(
                x["f32"], ax, 1)
        out[host, "log"] = comm.log.snapshot()
        out[host, "times"] = comm.times()
        out[host, "host"] = comm.host
    torch.save(out, os.path.join(a["out"], f"rank{rank}.pt"))
    shutdown_runtime()
    return 0


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    out = tmp_path_factory.mktemp("comm")
    world, port = 4, tp_serve.free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, SRC, HERE,
         json.dumps({"rank": r, "world": world, "port": port,
                     "out": str(out)})],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    errs = []
    for p in procs:
        _, err = p.communicate(timeout=120)
        if p.returncode:
            errs.append(err[-3000:])
    assert not errs, "\n".join(errs)
    return [torch.load(out / f"rank{r}.pt") for r in range(world)]


def _group(rank, ax):
    """The global ranks of ``rank``'s group over ``ax`` on the (2, 2)
    mesh, in its order (rank = 2 * data + model)."""
    d, m = divmod(rank, 2)
    return {"model": [2 * d, 2 * d + 1], "data": [m, 2 + m],
            "data+model": [0, 1, 2, 3]}[ax]


def test_host_false_gives_the_host_copies_bits(collectives):
    """Over four gloo CPU ranks, ``GroupComm(host=False)`` (NCCL's path:
    no host copy, no float16 view) gives ``host=True``'s results bit for
    bit, and both are the collectives' sums and blocks; the two logs
    count the same bytes."""
    for rank, got in enumerate(collectives):
        assert got[True, "host"] and not got[False, "host"]
        assert got[True, "log"] == got[False, "log"]
        for kind in ("all-reduce", "all-gather f32", "all-gather bf16",
                     "reduce-scatter"):
            for ax in map(spmd.axis_name, AXES):
                a, b = got[True, kind, ax], got[False, kind, ax]
                assert a.dtype == b.dtype and torch.equal(a, b), (kind, ax)
                members = _group(rank, ax)
                xs = [_inputs(r)["bf16" if "bf16" in kind else "f32"]
                      for r in members]
                if kind == "all-reduce":
                    torch.testing.assert_close(a, sum(xs))
                elif kind.startswith("all-gather"):
                    assert torch.equal(a, torch.cat(xs, 1))
                else:
                    n = 8 // len(members)
                    i = members.index(rank)
                    torch.testing.assert_close(
                        a, sum(xs).narrow(1, i * n, n))
        times = got[False, "times"]
        assert {k: v["n"] for k, v in times.items()} == {
            "all-reduce": 3, "all-gather": 6, "reduce-scatter": 3}
        assert all(v["ms"] >= 0 for v in times.values())


# ---------------------------------------------------------- the keyed draw
ARCHS = ("qwen1.5-4b-smoke", "mixtral-8x7b-smoke",
         "llama4-scout-17b-a16e-smoke")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
def test_a_ranks_draw_is_its_slice_of_the_whole(arch, shape):
    cfg = get_config(arch)
    model = build_model(cfg)
    whole = model.init_keyed(7, device="cpu", dtype=torch.bfloat16)
    n = shape[0] * shape[1]
    mesh = make_mesh(shape, ("data", "model"),
                     devices=[torch.device("cpu")] * n)
    specs = partition.params_pspecs(whole, mesh)
    for rank in range(n):
        coords = spmd.rank_coords(mesh, rank)
        mine = partition.flatten(model.init_keyed(
            7, device="cpu", dtype=torch.bfloat16,
            cut=partition.leaf_cutter(mesh, coords)))
        want = partition.flatten(partition.shard_tree(whole, specs, mesh,
                                                      coords))
        assert mine.keys() == want.keys()
        cut = 0
        for path, t in mine.items():
            assert t.dtype == want[path].dtype, path
            assert torch.equal(t, want[path]), (rank, path)
            cut += t.shape != whole_shape(whole, path)
        assert cut > 0          # the rank holds a block, not the tree


def whole_shape(tree, path):
    return partition.flatten(tree)[path].shape


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_l_is_the_same_at_every_depth(arch):
    import dataclasses
    cfg = dataclasses.replace(get_config(arch), num_layers=6)
    deep = partition.flatten(build_model(cfg).init_keyed(3, device="cpu"))
    for k in (1, 4):
        cut = partition.flatten(build_model(dataclasses.replace(
            cfg, num_layers=k)).init_keyed(3, device="cpu"))
        assert cut.keys() == deep.keys()
        for path, t in cut.items():
            want = deep[path][:k] if path.startswith("layers/") else \
                deep[path]
            assert torch.equal(t, want), (k, path)
    other = partition.flatten(build_model(cfg).init_keyed(4, device="cpu"))
    assert not torch.equal(other["layers/attn/wq"], deep["layers/attn/wq"])


def test_the_keyed_draw_has_inits_layout():
    """The same leaves, shapes and dtypes as ``init(dtype=...)``; the
    families with packed or recurrent layers are not covered."""
    for arch in ARCHS:
        model = build_model(get_config(arch))
        a = partition.flatten(model.init(0, device="cpu",
                                         dtype=torch.bfloat16))
        b = partition.flatten(model.init_keyed(0, device="cpu",
                                               dtype=torch.bfloat16))
        assert {k: (t.shape, t.dtype) for k, t in a.items()} == \
            {k: (t.shape, t.dtype) for k, t in b.items()}
    with pytest.raises(NotImplementedError, match="keyed draw"):
        build_model(get_config("zamba2-1.2b-smoke")).init_keyed(
            0, device="cpu")
