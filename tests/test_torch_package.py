"""The PyTorch port stands alone: no JAX and no reference package at run
time, entry points on the card unless asked, and stdlib copies that match
the reference they were copied from."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro.obs.logging as ref_logging
import repro.obs.metrics as ref_metrics
import repro.obs.trace as ref_trace
import repro_torch
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.obs import logging as obs_logging
from repro_torch.obs import metrics, trace
from repro_torch.viscosity.lanefault import LaneFault

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _foreign(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_import_leaves_no_jax_or_reference_module():
    code = (
        "import pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "new = ['repro_torch.core.datacenter', 'repro_torch.launch.mesh',\n"
        "       'repro_torch.launch.sharding', 'repro_torch.launch.serve',\n"
        "       'repro_torch.launch.distributed', 'repro_torch.serve.traffic',\n"
        "       'repro_torch.serve.frontend', 'repro_torch.optim.adamw',\n"
        "       'repro_torch.optim.compression', 'repro_torch.data.pipeline',\n"
        "       'repro_torch.checkpoint.manager', 'repro_torch.train.runner',\n"
        "       'repro_torch.launch.train']\n"
        "assert all(n in sys.modules for n in new), new\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) > 20   # every module was imported


def test_no_file_imports_jax_or_reference_statically():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    offenders = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            offenders += [f"{f.relative_to(ROOT)}: {n}" for n in names
                          if _foreign(n)]
    assert offenders == []


def test_entry_points_refuse_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    from repro_torch.convert import params_from_jax
    from repro_torch.models import build_model
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serve import (FleetConfig, FleetServeEngine, Frontend,
                                   ServeConfig, ServeEngine)
    cfg = get_config("qwen1.5-4b-smoke")
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg).init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, {}, ServeConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        FleetServeEngine(cfg, {}, ServeConfig(), FleetConfig())
    with pytest.raises(RuntimeError, match="CUDA"):     # a Frontend's
        Frontend(FleetServeEngine(cfg, {}, ServeConfig(),  # engine
                                  FleetConfig(n_devices=1)))
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_cli.main(["--requests", "1"])
    from repro_torch import optim
    from repro_torch.convert import opt_state_from_jax
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.launch import train as train_cli
    from repro_torch.train import TrainConfig, TrainRunner
    from repro_torch.train.runner import FleetTrainConfig, FleetTrainRunner
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, batch=2,
                                  seq_len=8))
    with pytest.raises(RuntimeError, match="CUDA"):
        data.device_batch(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        TrainRunner(cfg, optim.AdamWConfig(), TrainConfig(), data)
    with pytest.raises(RuntimeError, match="CUDA"):
        FleetTrainRunner(cfg, optim.AdamWConfig(), TrainConfig(), data,
                         FleetTrainConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        opt_state_from_jax(optim.AdamWState(np.zeros((), np.int32), {}, {}))
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main(["--steps", "1"])
    assert repro_torch.resolve_device("cpu").type == "cpu"


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "qwen1.5-4b-smoke",
                                  "zamba2-1.2b", "zamba2-1.2b-smoke",
                                  "rwkv6-1.6b", "rwkv6-1.6b-smoke"])
def test_config_copy_matches_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(ref_configs.get_config(arch))


@pytest.mark.parametrize("arch", ["gemma2-2b", "mixtral-8x7b",
                                  "gemma3-1b-smoke", "whisper-base"])
def test_unported_arch_names_its_roadmap_item(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config(arch)


def test_metrics_copy_matches_reference():
    assert metrics.SCHEMA == ref_metrics.SCHEMA
    assert metrics.DEFAULT_BUCKETS == ref_metrics.DEFAULT_BUCKETS
    # the trace copy: the same emissions serialize, merge and pair alike
    logs = []
    for tr in (ref_trace, trace):
        hosts = [tr.Tracer(origin=0), tr.Tracer(origin=1)]
        for step, host in ((3, 1), (1, 0), (1, 1), (2, 0)):
            hosts[host].span_start(step, "req", rid=step)
            hosts[host].annotate(step, "probation", verdict="persistent",
                                 stage="swiglu_mlp", x=1.5)
            hosts[host].span_end(step + 1, "req", rid=step)
        merged = tr.merge(hosts[1].events, hosts[0].events,
                          hosts[1].events[:2])
        logs.append((tr.to_jsonl(merged),
                     [(sp.name, sp.steps) for sp in tr.spans_of(merged)]))
    assert logs[0] == logs[1]
    assert trace.from_jsonl(logs[1][0]) == trace.merge(
        trace.from_jsonl(logs[1][0]))
    # the logger copy renders records alike (under its own namespace)
    fields = dict(stage="swiglu_mlp", detail="a b", stamp=(4, "h0", 2))
    assert obs_logging.get_logger("core.fault", host_id=1).render(
        "canary", fields) == ref_logging.get_logger(
        "core.fault", host_id=1).render("canary", fields)
    assert obs_logging.get_logger("x")._log.name == "repro_torch.x"


def test_build_rejects_unknown_source_and_keys_by_sources():
    with pytest.raises(ValueError, match="unknown kernel sources"):
        _build.build(["no_such_kernel"])
    d = _build.build_dir()
    assert d.parent == _build.BUILD_ROOT and d == _build.build_dir()
    assert {p.stem for p in _build.CSRC.glob("*.cu")} == set(_build.SOURCES)


def test_lane_fault_args_bitmask():
    f = LaneFault("gain", (0, 31, 32, 2559), 2560, gain=2.0)
    kind, mask, value, gain = _build.lane_fault_args(f, 2560,
                                                     torch.device("cpu"))
    words = mask.numpy().view(np.uint32)
    assert kind == _build.FAULT_KINDS["gain"] and gain == 2.0
    assert words.shape == (80,)
    bits = [w * 32 + b for w in range(80) for b in range(32)
            if (int(words[w]) >> b) & 1]
    assert bits == [0, 31, 32, 2559]
    # another output width takes the healthy instantiation
    assert _build.lane_fault_args(f, 2559, torch.device("cpu"))[0] == -1
    assert _build.lane_fault_args(None, 2560, torch.device("cpu"))[0] == -1
