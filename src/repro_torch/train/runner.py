"""Port of ``model_stage_names`` and ``canary_stages`` from the reference's
``train/runner.py``; ``TrainRunner`` waits for the training slice."""
from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

import repro_torch.models  # noqa: F401  (registers the stages' ops)
from repro_torch.configs.base import ModelConfig
from repro_torch.core.stage import Port, Stage
from repro_torch.device import DeviceLike
from repro_torch.viscosity import REGISTRY

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
