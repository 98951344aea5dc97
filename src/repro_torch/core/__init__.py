"""Oobleck core of the port: staged accelerators, fault routing, detection
and the fleet models (the reference's ``repro.core`` names)."""
from repro_torch.core.fault import (CanaryChecker, FaultInjector,
                                    FaultSignature, FaultState, StepGuard,
                                    StragglerWatchdog, inject)
from repro_torch.core.oobleck import Dispatcher, StagedAccelerator
from repro_torch.core.routing import (FleetPlan, ResidentRoute, RoutingPlan,
                                     SparePool)
from repro_torch.core.stage import Port, Stage

__all__ = ["Stage", "Port", "StagedAccelerator", "Dispatcher",
           "FaultSignature", "FaultState", "FaultInjector", "CanaryChecker",
           "StepGuard", "StragglerWatchdog", "inject", "RoutingPlan",
           "ResidentRoute", "FleetPlan", "SparePool"]
