"""The port's multi-host runtime on the CPU, against the reference.

* ``make_mesh`` and ``FleetMeshView.submesh`` name the shortfall as the
  reference's do (the jax-free cases of ``tests/test_sharding_mesh.py``),
  and ``HostView.local_submesh`` builds the host's serving mesh.
* ``initialize_runtime``: the single-process no-op, the explicit backend,
  a one-rank gloo group whose store carries ``KVCoordinator``'s default
  client, ``HostTopology.current``.
* ``KVCoordinator`` over a real ``TCPStore`` with two clients on one
  server: a lockstep exchange, a stalled peer surfacing as
  ``HostTimeoutError(1)`` within ``max_attempts`` gets, ``mark_dead``, the
  deletion of round r-2's keys, the retry metrics; and the same drill
  over the chaos layer's ``StallingKVClient``, against the reference's
  coordinator.
* The reference's two-process acceptance test
  (``tests/test_distributed_fleet.py``) on the port: two processes join
  one gloo group, each owns half of a 4-device fleet, a device fault seen
  only by process 0 reaches process 1 through the shared event log, both
  fold the same ``FleetPlan``, the faulted device's work re-admits on
  process 1's spare, and the merged completions equal the reference's
  ``reference_decode`` on the same weights.
"""
import concurrent.futures
import dataclasses
import json
import os
import socket
import subprocess
import sys
import textwrap
import time
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as tdist

from repro.chaos.campaign import StallingKVClient as RefStallingKVClient
from repro.configs import get_config as ref_get_config
from repro.core.routing import FleetPlan as RefFleetPlan
from repro.launch import distributed as ref_dist
from repro.launch.mesh import FleetMeshView as RefMeshView
from repro.launch.mesh import make_mesh as ref_make_mesh
from repro.models import build_model as ref_build_model
from repro.serve import reference_decode as ref_reference_decode
from repro.serve import synthetic_workload as ref_synthetic_workload

from repro_torch.chaos import StallingKVClient
from repro_torch.convert import params_from_jax
from repro_torch.core.routing import FleetPlan
from repro_torch.launch import distributed as dist
from repro_torch.launch.mesh import FleetMeshView, Mesh, make_mesh
from repro_torch.obs import logging as obs_logging
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import report as obs_report
from _torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
ARCH = "qwen1.5-4b-smoke"
MAX_LEN = 48
LOGITS_TOL = 2e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cpus(n):
    return [torch.device("cpu", i) for i in range(n)]


@pytest.fixture(autouse=True)
def _own_log_fields(monkeypatch):
    """``initialize_runtime`` binds ``host=<rank>`` into every logger of
    the process; keep that binding inside each test."""
    monkeypatch.setattr(obs_logging, "_global_fields", {})


# ----------------------------------------------------------------- meshes
def test_mesh_shortfall_error_names_the_gap():
    """Both packages name the same shortfall: a (2, 4) mesh over one
    device is short 7 (the reference's process has one CPU device)."""
    with pytest.raises(RuntimeError, match=r"short 7 device\(s\)"):
        ref_make_mesh((2, 4), ("data", "model"))
    with pytest.raises(RuntimeError, match=r"short 7 device\(s\)"):
        make_mesh((2, 4), ("data", "model"), devices=_cpus(1))
    mesh = make_mesh((2, 4), ("data", "model"), devices=_cpus(9))
    assert mesh.shape == (2, 4) and len(mesh.devices) == 8
    assert mesh.axes == ("data", "model") and mesh.devices == tuple(_cpus(8))
    with pytest.raises(ValueError):
        Mesh((2,), ("data", "model"), tuple(_cpus(2)))
    if not torch.cuda.is_available():    # default: this process's cards
        with pytest.raises(RuntimeError, match=r"short 1 device\(s\)"):
            make_mesh((1,), ("data",))


def test_submesh_folds_serving_devices_and_names_fold_errors():
    """8 devices, 2 spares, faults on 1 and 4: the submesh holds exactly
    the serving devices (the reference's 8-device mesh-view test, without
    its XLA computation), and a fold that does not divide names the
    shortfall in the reference's words."""
    fp = FleetPlan.healthy(8, ["flash_attention"], n_spares=2)
    fp = fp.with_device_fault(1).with_device_fault(4)
    view = FleetMeshView.from_plan(fp)
    ref_view = RefMeshView.from_plan(
        RefFleetPlan.healthy(8, ["flash_attention"], n_spares=2)
        .with_device_fault(1).with_device_fault(4))
    assert (view.mask, view.quarantined, view.idle_spares) == \
        (ref_view.mask, ref_view.quarantined, ref_view.idle_spares)
    devs = _cpus(8)
    mesh = view.submesh(("data", "model"), model=2, devices=devs)
    assert mesh.shape == (3, 2)
    assert [d.index for d in mesh.devices] == [0, 2, 3, 5, 6, 7]
    assert view.submesh(devices=devs).shape == (6,)
    msgs = []
    for v, kw in ((view, dict(devices=devs)), (ref_view, {})):
        with pytest.raises(RuntimeError) as ei:
            # the reference's serving devices come first from jax, so
            # only the fold arithmetic is compared: 6 into groups of 4
            if v is ref_view:
                v.submesh.__func__(_FakeView(v), ("data", "model"), model=4)
            else:
                v.submesh(("data", "model"), model=4, **kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    assert "short 2 device(s) (or quarantine 2 more)" in msgs[0]
    with pytest.raises(RuntimeError, match="short"):
        view.submesh(devices=_cpus(4))           # view covers 8


class _FakeView:
    """The reference view's submesh over six stand-in devices: its fold
    check runs before any jax mesh is built."""

    def __init__(self, view):
        self._view = view

    def serving_devices(self, devices=None):
        return list(range(len(self._view.serving())))


def test_local_submesh_is_this_hosts_serving_block():
    fp = FleetPlan.healthy(4, ["flash_attention"], n_spares=1)
    fp = fp.with_device_fault(0)                    # migrates to spare 3
    h0 = dist.HostView.of(fp, dist.HostTopology(2, 2, host_id=0))
    h1 = dist.HostView.of(fp, dist.HostTopology(2, 2, host_id=1))
    assert h0.local_submesh(devices=_cpus(2)).devices == (_cpus(2)[1],)
    m1 = h1.local_submesh(devices=_cpus(2))
    assert m1.shape == (2,) and m1.axes == ("data",)
    assert m1.devices == tuple(_cpus(2))
    lost = dist.HostView.of(fp.with_host_fault((0, 1)),
                            dist.HostTopology(2, 2, host_id=0))
    with pytest.raises(RuntimeError, match="no serving devices"):
        lost.local_submesh(devices=_cpus(2))
    with pytest.raises(RuntimeError, match="short"):
        h1.local_submesh(devices=_cpus(1))


# ---------------------------------------------------------------- runtime
def test_initialize_runtime_single_process_and_explicit_backend():
    rt = dist.initialize_runtime()
    assert rt == dist.DistributedRuntime(num_processes=1, process_id=0)
    assert not tdist.is_initialized()
    with pytest.raises(ValueError, match="explicit backend"):
        dist.initialize_runtime("127.0.0.1:1", 2, 0)
    with pytest.raises(ValueError, match="host:port"):
        dist.initialize_runtime("localhost", 2, 0, backend="gloo")
    with pytest.raises(RuntimeError, match="initialize_runtime"):
        dist.KVCoordinator()
    with pytest.raises(RuntimeError, match="initialize_runtime"):
        dist.HostTopology.current(devices_per_host=2)


def test_one_rank_gloo_runtime_carries_the_coordinator():
    """A one-rank group over a real store: the coordinator's default
    client is the runtime's store, and ``HostTopology.current`` reads the
    group (on the CPU only with ``devices_per_host`` given)."""
    rt = dist.initialize_runtime(f"127.0.0.1:{_free_port()}", 1, 0,
                                 backend="gloo", timeout_s=30)
    try:
        assert (rt.num_processes, rt.process_id, rt.backend) == \
            (1, 0, "gloo")
        coord = dist.KVCoordinator()
        assert (coord.num_hosts, coord.host_id) == (1, 0)
        assert coord.exchange("x") == ["x"]
        assert dist.HostTopology.current(devices_per_host=3) == \
            dist.HostTopology(1, 3, 0)
        if torch.cuda.device_count() == 0:
            with pytest.raises(RuntimeError, match="devices_per_host"):
                dist.HostTopology.current()
        t = torch.tensor([5])
        tdist.all_reduce(t)
        assert int(t) == 5
    finally:
        dist.shutdown_runtime()
    assert not tdist.is_initialized()


def test_client_errors_cover_the_stores_timeouts():
    errs = dist.coordination_client_errors()
    assert errs[0] is RuntimeError and errs == tuple(dict.fromkeys(errs))
    assert tdist.DistStoreError in errs
    server = tdist.TCPStore("127.0.0.1", 0, 1, True,
                            timeout=timedelta(seconds=10))
    t0 = time.perf_counter()
    with pytest.raises(errs):
        dist.StoreClient(server).blocking_key_value_get("fleet/none", 30)
    assert time.perf_counter() - t0 < 5.0         # the attempt's budget


class _CountingClient(dist.StoreClient):
    def __init__(self, store):
        super().__init__(store)
        self.gets = 0

    def blocking_key_value_get(self, key, timeout_ms):
        self.gets += 1
        return super().blocking_key_value_get(key, timeout_ms)


@pytest.fixture
def two_clients():
    server = tdist.TCPStore("127.0.0.1", 0, 2, True,
                            timeout=timedelta(seconds=20),
                            wait_for_workers=False)
    peer = tdist.TCPStore("127.0.0.1", server.port, 2, False,
                          timeout=timedelta(seconds=20))
    return server, peer


def _coords(server, peer, **kw):
    kw = dict(dict(timeout_ms=10_000, attempt_timeout_ms=2_000), **kw)
    return (dist.KVCoordinator(2, 0, client=_CountingClient(server), **kw),
            dist.KVCoordinator(2, 1, client=_CountingClient(peer), **kw))


def _lockstep(a, b, payloads):
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        fa = ex.submit(a.exchange, payloads[0])
        fb = ex.submit(b.exchange, payloads[1])
        return fa.result(timeout=30), fb.result(timeout=30)


def test_kv_coordinator_over_a_tcp_store(two_clients):
    server, peer = two_clients
    a, b = _coords(server, peer)
    for r in range(3):
        ra, rb = _lockstep(a, b, [f"a{r}", f"b{r}"])
        assert ra == rb == [f"a{r}", f"b{r}"]
    # round 2 deleted both hosts' round-0 keys; round 1's stay
    assert not server.check(["fleet/x0/0"]) and not server.check(
        ["fleet/x0/1"])
    assert server.check(["fleet/x1/0", "fleet/x1/1", "fleet/x2/0"])
    # the namespace keeps two fleets on one store apart
    c, d = _coords(server, peer, namespace="other")
    assert _lockstep(c, d, ["c", "d"]) == (["c", "d"], ["c", "d"])


def test_stalled_peer_times_out_typed_within_budget(two_clients):
    server, peer = two_clients
    reg = obs_metrics.Registry()
    a, _ = _coords(server, peer, attempt_timeout_ms=50, max_attempts=3,
                   backoff_base_s=0.001)
    t0 = time.perf_counter()
    with obs_metrics.use(reg), pytest.raises(dist.HostTimeoutError) as ei:
        a.exchange("payload")
    wall = time.perf_counter() - t0
    assert ei.value.host_id == 1
    assert a._client.gets == 3                  # bounded retry budget
    assert wall < 5.0                           # nowhere near 120 s
    snap = reg.snapshot()
    assert obs_report.counter_value(snap, "kv_retries_total", op="get") == 3
    assert obs_report.counter_value(snap, "coord_timeouts_total",
                                    host="1") == 1
    assert obs_report.gauge_value(snap, "coord_attempt_timeout_seconds",
                                  host="1") == 0.05
    a.mark_dead(1)
    a._client.gets = 0
    assert a.exchange("again") == ["again", None]
    assert a._client.gets == 0                  # dead peer not polled


def test_stalling_client_drill_matches_reference():
    """The same stall over the chaos layer's fake client in both
    packages: the same typed host, the same gets, the same deletions."""
    seen = []
    for client_cls, coord_cls in ((StallingKVClient, dist.KVCoordinator),
                                  (RefStallingKVClient,
                                   ref_dist.KVCoordinator)):
        client = client_cls(stalled=[2])
        coord = coord_cls(num_hosts=3, host_id=0, client=client,
                          timeout_ms=5_000, attempt_timeout_ms=10,
                          max_attempts=3, backoff_base_s=0.001)
        client.key_value_set("fleet/x0/1", "peer")
        with pytest.raises(Exception) as ei:
            coord.exchange("p0")
        coord.mark_dead(ei.value.host_id)
        rounds = []
        for r in (1, 2, 3):
            client.key_value_set(f"fleet/x{r}/1", f"peer{r}")
            rounds.append(coord.exchange(f"p{r}"))
        seen.append((type(ei.value).__name__, ei.value.host_id, client.gets,
                     rounds, client.deletes, sorted(client.store)))
    assert seen[0] == seen[1]
    assert seen[0][:3] == ("HostTimeoutError", 2, 4 + 3)


# ----------------------------------------------- 2-process acceptance
WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    pid, port, weights = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    from repro_torch.launch.distributed import (HostTopology, KVCoordinator,
                                                fleet_fingerprint,
                                                initialize_runtime,
                                                shutdown_runtime)
    rt = initialize_runtime(f"127.0.0.1:{port}", 2, pid, backend="gloo",
                            timeout_s=120)
    import dataclasses
    import torch.distributed as tdist
    from repro_torch.configs import get_config
    from repro_torch.serve import (FleetConfig, FleetServeEngine,
                                   ServeConfig, reference_decode,
                                   synthetic_workload)

    cfg = dataclasses.replace(get_config("qwen1.5-4b-smoke"),
                              dtype="float32")
    params = torch.load(weights, weights_only=True)
    topo = HostTopology(num_hosts=2, devices_per_host=2,
                        host_id=rt.process_id)
    coord = KVCoordinator()
    # host 0: workers 0,1; host 1: worker 2 + hot spare 3
    eng = FleetServeEngine(
        cfg, params, ServeConfig(max_len=48, max_slots=2),
        FleetConfig(n_devices=4, n_spares=1, topology=topo),
        coordinator=coord, device="cpu")
    reqs = synthetic_workload(cfg.vocab_size, 6, np.random.default_rng(0),
                              min_prompt=6, max_prompt=8, min_new=4,
                              max_new=7, arrival_every=1, per_arrival=2)
    # ONLY process 0 observes the fault; the shared ordered event log
    # must carry it to process 1
    events = {3: [("device", 0)]} if rt.process_id == 0 else {}
    done, stats = eng.serve(reqs, events=events)
    mismatched = [r.rid for r in reqs if not np.array_equal(
        done[r.rid].tokens, reference_decode(cfg, params, r.prompt,
                                             r.max_new_tokens, max_len=48))]
    gathered = [torch.zeros(1, dtype=torch.int64) for _ in range(2)]
    tdist.all_gather(gathered, torch.tensor([rt.process_id]))
    out = {
        "pid": rt.process_id,
        "world": tdist.get_world_size(),
        "backend": rt.backend,
        "fingerprints": coord.exchange(fleet_fingerprint(eng.fleet)),
        "quarantined": list(eng.fleet.quarantined),
        "spare_for_0": eng.fleet.pool.spare_for(0),
        "completed": sorted(done),
        "devices_by_rid": {str(rid): done[rid].device
                           for rid in sorted(done)},
        "tokens": {str(rid): done[rid].tokens.tolist()
                   for rid in sorted(done)},
        "mismatched": mismatched,
        "requeued": stats["requeued"],
        "late_events": stats["late_events"],
        "per_device_tokens": stats["per_device_tokens"],
        "fleet_fingerprint": stats["fleet_fingerprint"],
        "allgather": [int(t) for t in gathered],
    }
    # one last exchange: rank 0 serves the store, so neither rank leaves
    # while the other still reads it
    coord.exchange("done")
    shutdown_runtime()
    print("RESULT " + json.dumps(out))
""")


def _result(proc_out: str) -> dict:
    lines = [ln for ln in proc_out.splitlines() if ln.startswith("RESULT ")]
    assert lines, f"no RESULT line in output:\n{proc_out[-2000:]}"
    return json.loads(lines[-1][len("RESULT "):])


def _ref_top2_gap(cfg, params, prompt, tokens, j):
    """The reference model's top-2 logit gap at completion step ``j``,
    teacher-forced on the reference's own tokens."""
    model = ref_build_model(cfg)
    P = len(prompt)
    logits, cache = model.prefill(params, {
        "tokens": jnp.asarray(prompt, jnp.int32)[None],
        "cache": model.init_cache(1, MAX_LEN)})
    for i in range(j):
        logits, cache = model.decode_step(
            params, cache, jnp.asarray([[tokens[i]]], jnp.int32),
            jnp.int32(P + i))
    top = np.sort(np.asarray(logits[0, -1], np.float32))[-2:]
    return float(top[1] - top[0])


def test_two_process_fleet_shares_one_plan_and_migrates_across_hosts(
        tmp_path):
    """Two gloo processes, one FleetPlan from the shared event log,
    cross-host migration to the other process's spare, merged
    completions equal to the reference's ``reference_decode`` of the same
    (float32) weights."""
    rcfg = dataclasses.replace(ref_get_config(ARCH), dtype="float32")
    jparams = ref_build_model(rcfg).init(jax.random.PRNGKey(0))
    weights = tmp_path / "params.pt"
    torch.save(params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu"), weights)
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(pid), str(port), str(weights)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in (0, 1)]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=300)
            assert p.returncode == 0, stderr[-3000:]
            outs.append(_result(stdout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    r0, r1 = sorted(outs, key=lambda r: r["pid"])

    # one runtime: a two-rank gloo group whose all-gather really crosses
    # the processes
    assert r0["world"] == r1["world"] == 2
    assert r0["backend"] == r1["backend"] == "gloo"
    assert r0["allgather"] == r1["allgather"] == [0, 1]

    # one FleetPlan: the fault published by process 0 reached process 1
    # through the event log and both folded the same final plan
    assert r0["fleet_fingerprint"] == r1["fleet_fingerprint"]
    assert r0["fingerprints"] == r1["fingerprints"]
    assert len(set(r0["fingerprints"])) == 1
    for r in (r0, r1):
        assert r["quarantined"] == [0]
        assert r["spare_for_0"] == 3           # migrated to host 1's spare
        assert r["late_events"] == 0

    # migration moved in-flight work across the process boundary
    assert r0["devices_by_rid"] == r1["devices_by_rid"]
    assert r0["requeued"] == r1["requeued"] > 0
    assert r0["per_device_tokens"][3] > 0
    assert 3 in set(r0["devices_by_rid"].values())

    # merged completions: complete, equal on both hosts and to the port's
    # single-request decode in each process
    assert r0["completed"] == r1["completed"] == list(range(6))
    assert r0["mismatched"] == r1["mismatched"] == []
    assert r0["tokens"] == r1["tokens"]
    # ... and to the reference's reference_decode of the same weights; a
    # differing token may only sit on a near-tie of the reference's logits
    reqs = ref_synthetic_workload(rcfg.vocab_size, 6,
                                  np.random.default_rng(0), min_prompt=6,
                                  max_prompt=8, min_new=4, max_new=7,
                                  arrival_every=1, per_arrival=2)
    for r in reqs:
        want = np.asarray(ref_reference_decode(rcfg, jparams, r.prompt,
                                               r.max_new_tokens,
                                               max_len=MAX_LEN))
        got = np.asarray(r0["tokens"][str(r.rid)])
        diff = np.flatnonzero(got != want)
        if diff.size:
            gap = _ref_top2_gap(rcfg, jparams, r.prompt, want, diff[0])
            assert gap < LOGITS_TOL, (r.rid, diff[0], gap)
