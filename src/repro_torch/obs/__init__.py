"""Telemetry of the port: copies of the reference's metrics registry,
trace spans and structured logger."""
from repro_torch.obs import logging, metrics, trace  # noqa: F401

__all__ = ["logging", "metrics", "trace"]
