"""Fault-aware training runner: the Oobleck methodology applied to a
training step (detection -> quarantine -> reroute -> continue).

Port of the reference's ``train/runner.py``.  Per step:
  * the step for the current routing comes from the Dispatcher (one build
    per RoutingPlan, LRU): forward, backward and the optimizer update;
  * StepGuard checks loss/grad finiteness; a trip restores the last
    checkpoint and re-runs;
  * CanaryChecker sweeps each Viscosity stage's HW path against its SW
    oracle every ``canary_every`` steps, with probation when configured;
  * StragglerWatchdog records step times.

Only the SW route is differentiated: every other lowering is forward-only
and refuses to run under autograd (``viscosity.lang._forward_only``), as
``jax.grad`` through the reference's Pallas kernels fails.  The step is
plain PyTorch autograd (``value_and_grad``) with the optimizer update in
place (``optim.update``); its time is read after the loss reaches the
host.  Checkpoints are async and checksummed, in the reference's format.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Union

import torch
import torch.nn.functional as F

import repro_torch.models  # noqa: F401  (registers the stages' ops)
from repro_torch import optim
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.core.fault import (CanaryChecker, FaultClassifier,
                                    FaultSignature, FaultState,
                                    ProbationPolicy, StepGuard,
                                    StragglerWatchdog)
from repro_torch.core.oobleck import Dispatcher
from repro_torch.core.routing import FleetPlan, RoutingPlan
from repro_torch.core.stage import Port, Stage
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.distributed import (FleetEvent, HostTopology,
                                            HostView, fleet_fingerprint)
from repro_torch.launch.sharding import shard_bounds
from repro_torch.models import build_model
from repro_torch.obs import metrics as obs_metrics
from repro_torch.viscosity import REGISTRY, SW, lanefault
from repro_torch.viscosity.lang import tree_leaves, tree_map

PyTree = Any
Seed = Union[int, torch.Generator, None]
_BF16, _F32 = torch.bfloat16, torch.float32


def model_stage_names(cfg: ModelConfig) -> List[str]:
    """The Viscosity stages this architecture actually exercises."""
    names = []
    if not cfg.attn_free or cfg.shared_attn_every:
        names.append("flash_attention")
    if cfg.gated_mlp and cfg.moe is None:
        names.append("swiglu_mlp")
    if cfg.family == "hybrid":
        names.append("mamba2_ssd")
    if cfg.family == "ssm" and cfg.layer_pattern and cfg.layer_pattern[0] == 3:
        names.append("rwkv6_wkv")
    return names


def _scaled(s: float):
    def draw(z):
        return z * s
    return draw


def _neg_exp(z):
    return -torch.exp(z)


def _log_decay(z):
    return -4.0 * torch.sigmoid(z)


# The reference's port shapes; each port in the dtype its Hopper kernel
# takes (bf16 activations and weights, f32 for the SSD's dt and A and the
# WKV's u) and drawn inside the op's domain at a scale that keeps healthy
# outputs near 1, where one bf16 ulp (<= 2^-7 below 2) is under the
# compare's 2e-2: weights at 1/sqrt(fan_in), the SwiGLU and SSD inputs and
# the attention values at 1/2, dt = softplus > 0, A < 0, lw in (-4, 0).  The reference draws every port
# N(0, 1) in f32, which leaves the scans' domain (ROADMAP queue 3).
_PORTS = {
    "flash_attention": (Port((2, 64, 4, 32), _BF16),
                        Port((2, 64, 2, 32), _BF16),
                        Port((2, 64, 2, 32), _BF16, _scaled(0.5))),
    "swiglu_mlp": (Port((64, 64), _BF16, _scaled(0.5)),
                   Port((64, 128), _BF16, _scaled(64 ** -0.5)),
                   Port((64, 128), _BF16, _scaled(64 ** -0.5)),
                   Port((128, 64), _BF16, _scaled(128 ** -0.5))),
    "mamba2_ssd": (Port((2, 64, 2, 16), _BF16, _scaled(0.5)),
                   Port((2, 64, 2), _F32, F.softplus),
                   Port((2,), _F32, _neg_exp),
                   Port((2, 64, 8), _BF16, _scaled(8 ** -0.5)),
                   Port((2, 64, 8), _BF16, _scaled(8 ** -0.5))),
    "rwkv6_wkv": (Port((2, 32, 2, 16), _BF16, _scaled(16 ** -0.5)),
                  Port((2, 32, 2, 16), _BF16, _scaled(16 ** -0.5)),
                  Port((2, 32, 2, 16), _BF16),
                  Port((2, 32, 2, 16), _BF16, _log_decay),
                  Port((2, 16), _F32, _scaled(16 ** -0.5))),
}


def canary_stages(cfg: ModelConfig, *, device: DeviceLike = None
                  ) -> List[Stage]:
    """Small-port canary stages for the arch's Viscosity ops, their
    canaries on ``device`` (default: the card)."""
    stages = []
    for name in model_stage_names(cfg):
        spec = REGISTRY.get(name)
        stages.append(Stage(name=name, spec=spec, ports=_PORTS[name],
                            tol=max(spec.tol, 1e-3), device=device))
    return stages


def _restore_latest(ckpt: CheckpointManager, params, opt_state):
    """The latest checkpoint onto the devices of the live state.  Returns
    (params, opt_state, its step)."""
    ckpt.wait()
    s = ckpt.latest_step()
    r0 = time.perf_counter()
    restored = ckpt.restore(s, {"params": params, "opt": opt_state})
    obs_metrics.observe("ckpt_restore_seconds", time.perf_counter() - r0)
    return restored["params"], restored["opt"], s


def value_and_grad(forward: Callable, params: PyTree, batch
                   ) -> tuple:
    """``((loss, metrics), grads)`` of ``forward(params, batch)`` with
    respect to every param leaf, as ``jax.value_and_grad(has_aux=True)``.
    The forward sees aliases of the leaves that require grad (the
    caller's tensors keep their flags); a leaf the loss does not reach
    gets a zero grad.  Metrics come back detached."""
    tracked = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_leaves(tracked)
    with torch.enable_grad():
        loss, metrics = forward(tracked, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    by_leaf = {id(t): g for t, g in zip(leaves, grads)}
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_map(lambda t: by_leaf[id(t)],
                                              tracked)


@dataclass
class TrainConfig:
    steps: int = 100
    log_every: int = 10
    ckpt_every: int = 50
    canary_every: int = 0          # 0 = disabled
    canary_localize: bool = False  # lane-localize canary faults (DEGRADED)
    ckpt_dir: Optional[str] = None
    compression: bool = False      # int8 EF gradient compression
    hw_route: str = SW             # only SW trains: other routes are forward-only
    seed: int = 0
    # Probation (transient-vs-persistent classification): a detection
    # re-executes under backoff before any capacity is surrendered.
    # 0 retries = disabled (every detection is persistent).
    probation_retries: int = 0
    probation_backoff_s: float = 0.0

    def probation_policy(self) -> Optional[ProbationPolicy]:
        if self.probation_retries <= 0:
            return None
        return ProbationPolicy(retries=self.probation_retries,
                               backoff_base_s=self.probation_backoff_s)


class TrainRunner:
    """Single-device training under the fault state's RoutingPlan, on
    ``device`` (default: the card)."""

    def __init__(self, cfg: ModelConfig, opt_cfg: optim.AdamWConfig,
                 tcfg: TrainConfig, data: SyntheticLM, *,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.data = data
        self.device = resolve_device(device)
        self.fault_state = FaultState()
        self.stage_names = model_stage_names(cfg)
        self.dispatcher = Dispatcher(self._build)
        self.guard_trips = 0
        self.watchdog = StragglerWatchdog()
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir)
                     if tcfg.ckpt_dir else None)
        self.history: List[Dict[str, float]] = []

    # ------------------------------------------------------------ build
    def _build(self, plan: RoutingPlan) -> Callable:
        model = build_model(self.cfg, routes=plan)
        use_comp = self.tcfg.compression

        def step(params, opt_state, err, batch):
            """One training step; ``params`` and ``opt_state`` are updated
            in place (the reference donates them)."""
            (loss, metrics), grads = value_and_grad(model.forward, params,
                                                    batch)
            if use_comp:
                grads, err = optim.compress_tree(grads, err)
            params, opt_state, om = optim.update(self.opt_cfg, grads,
                                                 opt_state, params)
            return params, opt_state, err, {**metrics, **om}

        return step

    # ------------------------------------------------------------ state
    def _no_error(self, params):
        return (optim.init_error(params) if self.tcfg.compression
                else torch.zeros((), device=self.device))

    def init_state(self, seed: Seed = None):
        """(params, opt_state, err) on the runner's device; params from
        ``seed`` (an int or a generator; default ``tcfg.seed``)."""
        seed = self.tcfg.seed if seed is None else seed
        params = build_model(self.cfg).init(seed, device=self.device)
        return params, optim.init(params), self._no_error(params)

    def signature(self) -> FaultSignature:
        return self.fault_state.signature(self.stage_names)

    def plan(self) -> RoutingPlan:
        """The RoutingPlan for the current fault state: healthy stages take
        the deployment's target; quarantined ones walk the degradation
        ladder when a lane map is localized (remap -> reduced width -> SW),
        or drop straight to the SW oracle without one.  Hashable — it is
        the Dispatcher cache key."""
        base = RoutingPlan.from_signature(
            self.signature(), healthy=self.tcfg.hw_route)
        return lanefault.degraded_plan(
            base, self.fault_state.counts(self.stage_names)).validate(
                registry=REGISTRY)

    def inject_fault(self, stage: str, kind: str = "injected"):
        if stage not in self.stage_names:
            raise ValueError(f"unknown stage {stage!r}; this model's stages:"
                             f" {self.stage_names}")
        self.fault_state.mark(stage, 0, kind=kind)

    # -------------------------------------------------------------- run
    def run(self, params, opt_state, err, *, start_step: int = 0,
            steps: Optional[int] = None,
            on_step: Optional[Callable[[int, dict], None]] = None):
        tcfg = self.tcfg
        steps = steps if steps is not None else tcfg.steps
        step_i = start_step
        last_good = start_step - 1
        while step_i < start_step + steps:
            batch = self.data.device_batch(step_i, device=self.device)
            fn = self.dispatcher.get(self.plan())
            t0 = time.perf_counter()
            params, opt_state, err, metrics = fn(params, opt_state, err,
                                                 batch)
            loss = float(metrics["loss"])       # waits for the step
            dt = time.perf_counter() - t0
            obs_metrics.observe("train_step_seconds", dt)
            self.watchdog.record(0, dt)
            if not StepGuard.ok({"loss": metrics["loss"],
                                 "grad_norm": metrics["grad_norm"]}):
                self.guard_trips += 1
                # Logical (step, origin, seq) stamp — never wall clock:
                # the fault log is a deterministic function of the run.
                self.fault_state.note("<step>", kind="nan_guard",
                                      step=step_i)
                if self.ckpt:
                    self.ckpt.wait()        # list a save still in flight
                if self.ckpt and last_good >= 0 and self.ckpt.steps():
                    # the step overwrote params and moments in place (the
                    # reference's were donated): rewind to the checkpoint
                    params, opt_state, step_i = _restore_latest(
                        self.ckpt, params, opt_state)
                    err = self._no_error(params)
                    continue
                raise FloatingPointError("non-finite step with no checkpoint")
            row = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
            row.update(loss=loss, step=step_i, dt=dt,
                       n_faults=self.signature().n_faults(),
                       compiles=self.dispatcher.compiles)
            self.history.append(row)
            if on_step:
                on_step(step_i, row)
            if tcfg.canary_every and (step_i + 1) % tcfg.canary_every == 0:
                chk = CanaryChecker(canary_stages(self.cfg,
                                                  device=self.device),
                                    route_hw=tcfg.hw_route,
                                    localize=tcfg.canary_localize)
                found = chk.sweep(self.fault_state, step=step_i)
                policy = tcfg.probation_policy()
                if found and policy is not None:
                    # Probation: re-canary each detection under backoff.
                    # Transient (clean re-run) clears the quarantine — the
                    # next plan() restores the HW route; persistent walks
                    # the ladder.
                    clf = FaultClassifier(chk, policy)
                    for name in found:
                        res = clf.classify(name, step=step_i,
                                           state=self.fault_state)
                        if res.transient:
                            self.fault_state.clear(name, step=step_i)
            if self.ckpt and (step_i + 1) % tcfg.ckpt_every == 0:
                s0 = time.perf_counter()
                self.ckpt.save_async(step_i + 1,
                                     {"params": params, "opt": opt_state},
                                     extra={"data_step": step_i + 1})
                obs_metrics.observe("ckpt_save_seconds",
                                    time.perf_counter() - s0)
                last_good = step_i + 1
            step_i += 1
        if self.ckpt:
            self.ckpt.wait()
        return params, opt_state, err


# ==========================================================================
# Fleet layer (paper §II Fig. 2, §V Fig. 8): data-parallel steps where each
# shard consults its own RoutingPlan out of a shared FleetPlan.
# ==========================================================================
@dataclass
class FleetTrainConfig:
    n_devices: int = 2
    n_spares: int = 0
    # Host axis (multi-host fleets): devices partition into contiguous
    # per-host blocks; a host loss quarantines the whole block in one
    # FleetPlan transition and the survivors re-fold the mesh.
    topology: Optional[HostTopology] = None


class FleetTrainRunner:
    """Data-parallel training across a device-indexed fleet.

    Per step the global batch shards across the FleetPlan's *serving*
    devices (``launch.sharding.shard_bounds`` — quarantined devices and
    idle spares get no slice); each shard's gradients come from a step
    keyed by that shard's own ``RoutingPlan`` in one shared Dispatcher,
    so devices with equal routing share a single build.  Detection follows
    the Oobleck loop per shard: a non-finite shard quarantines that device
    (detect), its work migrates to a hot spare when one is free or its
    slice redistributes over the survivors, and the step re-runs
    (continue).  The fleet's logical devices run one after another on
    ``device`` (default: the card); the shards' grads are summed, weighted
    by their rows, into one accumulator.
    """

    def __init__(self, cfg: ModelConfig, opt_cfg: optim.AdamWConfig,
                 tcfg: TrainConfig, data: SyntheticLM,
                 fcfg: FleetTrainConfig, *, device: DeviceLike = None):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.data = data
        self.fcfg = fcfg
        if fcfg.topology is not None and \
                fcfg.topology.n_devices != fcfg.n_devices:
            raise ValueError(
                f"topology covers {fcfg.topology.n_devices} device(s), "
                f"fleet has {fcfg.n_devices}")
        self.device = resolve_device(device)
        self.stage_names = model_stage_names(cfg)
        self.fleet = FleetPlan.healthy(fcfg.n_devices, self.stage_names,
                                       target=tcfg.hw_route,
                                       n_spares=fcfg.n_spares)
        self.dispatcher = Dispatcher(self._build_grads)
        self.guard_trips = 0
        self.history: List[Dict[str, float]] = []
        # Ordered transition log (the multi-host runtime replays this):
        # every quarantine/migration the runner performs is one event.
        self.fleet_log: List[FleetEvent] = []
        self.fault_state = FaultState()
        self.classifier: Optional[FaultClassifier] = None
        policy = tcfg.probation_policy()
        if policy is not None:
            self.classifier = FaultClassifier(
                CanaryChecker(canary_stages(cfg, device=self.device),
                              route_hw=tcfg.hw_route), policy)
        # Fleet-owned checkpoints: checksummed async saves on the
        # ckpt_every cadence; host-fault recovery restores the latest
        # onto the survivors (restore-then-continue).
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir)
                     if tcfg.ckpt_dir else None)

    # ------------------------------------------------------------ build
    def _build_grads(self, plan: RoutingPlan) -> Callable:
        model = build_model(self.cfg, routes=plan)

        def grads_fn(params, batch):
            (loss, metrics), grads = value_and_grad(model.forward, params,
                                                    batch)
            return grads, loss, metrics

        return grads_fn

    def _update(self, grads, opt_state, params):
        return optim.update(self.opt_cfg, grads, opt_state, params)

    # ------------------------------------------------------------ state
    def init_state(self, seed: Seed = None):
        seed = self.tcfg.seed if seed is None else seed
        params = build_model(self.cfg).init(seed, device=self.device)
        return params, optim.init(params)

    def _log_event(self, step: int, kind: str, device: int,
                   stage: str = ""):
        topo = self.fcfg.topology
        origin = 0 if topo is None or topo.host_id is None else topo.host_id
        self.fleet_log.append(FleetEvent(step=step, origin=origin,
                                         seq=len(self.fleet_log),
                                         kind=kind, device=device,
                                         stage=stage))

    def inject_stage_fault(self, device: int, stage: str, *,
                           step: int = -1):
        if stage not in self.stage_names:
            raise ValueError(f"unknown stage {stage!r}; this model's stages:"
                             f" {self.stage_names}")
        self.fleet = self.fleet.with_stage_fault(device, stage)
        self._log_event(step, "stage", device, stage)

    def inject_device_fault(self, device: int, *, step: int = -1):
        self.fleet = self.fleet.with_device_fault(device)
        self._log_event(step, "device", device)

    def inject_host_fault(self, host: int, *, step: int = -1):
        """A whole host drops out: quarantine its device block in ONE
        FleetPlan transition (spares outside the block absorb what they
        can); the next step re-folds the mesh over the survivors."""
        if self.fcfg.topology is None:
            raise ValueError("host faults need FleetTrainConfig.topology")
        self.fleet = self.fleet.with_host_fault(
            self.fcfg.topology.devices_of(host))
        self._log_event(step, "host", host)

    def host_view(self) -> HostView:
        """The fleet's health projected onto the host partition."""
        if self.fcfg.topology is None:
            raise ValueError("host_view needs FleetTrainConfig.topology")
        return HostView.of(self.fleet, self.fcfg.topology)

    # -------------------------------------------------------------- run
    def _shard(self, params, batch, device: int, lo: int, hi: int,
               poison_device: Optional[int]):
        shard = {k: v[lo:hi] for k, v in batch.items()}
        fn = self.dispatcher.get(self.fleet.plan_for(device))
        grads, loss, _metrics = fn(params, shard)
        if device == poison_device:      # emulated datapath blowup
            loss = loss * float("nan")
        return grads, loss

    def _shard_step(self, params, batch, poison_device: Optional[int]):
        """Grads per serving shard; returns (avg_grads, metrics, tripped)
        where ``tripped`` is the first device whose shard failed the
        StepGuard (None when the step is clean)."""
        B = batch["tokens"].shape[0]
        bounds = shard_bounds(B, self.fleet.device_mask())
        total = tree_map(torch.zeros_like, params)
        losses, n_rows = [], 0
        for d, (lo, hi) in bounds.items():
            if hi == lo:
                continue
            grads, loss = self._shard(params, batch, d, lo, hi,
                                      poison_device)
            if not StepGuard.ok({"loss": loss, "grads": grads}):
                return None, {"device": d}, d
            w = float(hi - lo)
            torch._foreach_add_(tree_leaves(total), tree_leaves(grads),
                                alpha=w)
            del grads
            losses.append(w * float(loss))
            n_rows += hi - lo
        torch._foreach_div_(tree_leaves(total), float(n_rows))
        return total, {"loss": sum(losses) / n_rows}, None

    def _probe_shard(self, params, batch, device: int,
                     poison_device: Optional[int]) -> bool:
        """Probation probe: re-execute just ``device``'s shard and guard
        the result (re-execution on demand).  True = clean."""
        B = batch["tokens"].shape[0]
        lo, hi = shard_bounds(B, self.fleet.device_mask()).get(device,
                                                               (0, 0))
        if hi == lo:
            return True
        grads, loss = self._shard(params, batch, device, lo, hi,
                                  poison_device)
        return StepGuard.ok({"loss": loss, "grads": grads})

    def run(self, params, opt_state, *, steps: Optional[int] = None,
            poison: Optional[Mapping[int, int]] = None,
            transient: Optional[Mapping[int, int]] = None,
            host_loss: Optional[Mapping[int, int]] = None):
        """``poison[step] = device`` injects a non-finite shard loss at
        that step (detect -> quarantine -> migrate).  ``transient[step] =
        device`` poisons only the *first* execution of that step, so with
        probation (``TrainConfig.probation_retries > 0``) the re-executed
        shard comes back clean and the fleet keeps its capacity — logged
        ``transient_recovered``, zero quarantines.  ``host_loss[step] =
        host`` drops a whole host just before that step: its device block
        quarantines in one transition and the surviving hosts' shards
        absorb the batch; with a CheckpointManager attached, the latest
        checkpoint restores first (restore-then-continue).
        """
        steps = steps if steps is not None else self.tcfg.steps
        poison = dict(poison or {})
        transient = dict(transient or {})
        host_loss = dict(host_loss or {})
        step_i = 0
        while step_i < steps:
            if step_i in host_loss:
                self.inject_host_fault(host_loss.pop(step_i), step=step_i)
                if self.ckpt:
                    # an async save still in flight is not listed yet (the
                    # reference checks steps() before waiting: a race)
                    self.ckpt.wait()
                if self.ckpt and self.ckpt.steps():
                    # restore onto whatever survives: params are
                    # replicated, so the re-fold is shard_bounds following
                    # the new mask
                    self.fault_state.note("<ckpt>", kind="checkpoint_restored",
                                          step=step_i)
                    params, opt_state, step_i = _restore_latest(
                        self.ckpt, params, opt_state)
                    continue
            batch = self.data.device_batch(step_i, device=self.device)
            t0 = time.perf_counter()
            pd = poison.get(step_i)
            if pd is None and step_i in transient:
                pd = transient.pop(step_i)   # upset hits one execution only
            grads, metrics, tripped = self._shard_step(params, batch, pd)
            if tripped is not None:
                # detect -> probate -> quarantine-or-recover; a transient
                # verdict re-runs the step with no capacity surrendered,
                # persistent migrates to a spare / reroutes the survivors.
                self.guard_trips += 1
                if self.classifier is not None:
                    res = self.classifier.probate(
                        lambda: self._probe_shard(params, batch, tripped,
                                                  poison.get(step_i)),
                        stage="<step>", replica=tripped, step=step_i,
                        state=self.fault_state)
                    if res.transient:
                        continue
                poison.pop(step_i, None)     # the bad device is now gone
                self.fleet = self.fleet.with_device_fault(tripped)
                self._log_event(step_i, "device", tripped)
                continue
            params, opt_state, _om = self._update(grads, opt_state, params)
            del grads
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            fleet_dt = time.perf_counter() - t0
            obs_metrics.observe("train_step_seconds", fleet_dt)
            row = {
                "step": step_i, "loss": metrics["loss"],
                "dt": fleet_dt,
                "n_serving": len(self.fleet.serving()),
                "n_quarantined": len(self.fleet.quarantined),
                "compiles": self.dispatcher.compiles}
            if self.fcfg.topology is not None:
                row["hosts_serving"] = len(self.host_view().hosts_serving())
            self.history.append(row)
            step_i += 1
            if self.ckpt and step_i % self.tcfg.ckpt_every == 0:
                s0 = time.perf_counter()
                self.ckpt.save_async(
                    step_i, {"params": params, "opt": opt_state},
                    extra={"data_step": step_i,
                           "fingerprint": fleet_fingerprint(self.fleet)})
                obs_metrics.observe("ckpt_save_seconds",
                                    time.perf_counter() - s0)
        if self.ckpt:
            self.ckpt.wait()
        return params, opt_state
