from repro_torch.serve.engine import (RECOMPILE, RESIDENT, Completion,
                                      EngineSession, Request, ServeConfig,
                                      ServeEngine, ServeSession, percentile,
                                      reference_decode, synthetic_workload,
                                      validate_requests)

__all__ = ["RECOMPILE", "RESIDENT", "Completion", "EngineSession", "Request",
           "ServeConfig", "ServeEngine", "ServeSession", "percentile",
           "reference_decode", "synthetic_workload", "validate_requests"]
