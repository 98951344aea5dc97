"""Serving: the continuous-batching engine, the fleet, open-loop traffic
and the admission front end (the reference's ``repro.serve`` names)."""
from repro_torch.serve.engine import (RECOMPILE, RESIDENT, Completion,
                                      EngineSession, FleetConfig,
                                      FleetServeEngine, FleetSession,
                                      Request, ServeConfig, ServeEngine,
                                      ServeSession, percentile,
                                      reference_decode, validate_requests)
from repro_torch.serve.frontend import (BLOCK, EDF, FIFO, REJECT,
                                        SHED_LATEST, Frontend,
                                        FrontendConfig, summarize)
from repro_torch.serve.traffic import (ClosedLoop, Diurnal, FlashCrowd,
                                       LengthModel, Poisson, Workload,
                                       bounded_pareto, synthetic_workload,
                                       with_deadlines)

__all__ = ["ServeConfig", "ServeEngine", "Request", "Completion",
           "RECOMPILE", "RESIDENT", "reference_decode",
           "synthetic_workload", "percentile", "FleetConfig",
           "FleetServeEngine", "validate_requests",
           # streaming session API
           "ServeSession", "EngineSession", "FleetSession",
           # traffic generators
           "Workload", "ClosedLoop", "Poisson", "Diurnal", "FlashCrowd",
           "LengthModel", "bounded_pareto", "with_deadlines",
           # admission front end
           "Frontend", "FrontendConfig", "summarize",
           "BLOCK", "REJECT", "SHED_LATEST", "EDF", "FIFO"]
