"""Telemetry of the port: the metrics registry (a copy of the reference's)."""
from repro_torch.obs import metrics  # noqa: F401

__all__ = ["metrics"]
