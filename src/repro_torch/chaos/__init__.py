"""Chaos campaign layer: seeded randomized fault schedules soaked
against live serve / train fleets, with invariant checkers and
per-event MTTR metrics.

``schedule``   -- the fault taxonomy + seeded schedule generator
``invariants`` -- post-campaign checkers (drops, fingerprints, ladder,
                  transients, closure); violations raise or report
``campaign``   -- drives schedules through FleetServeEngine-under-
                  traffic and FleetTrainRunner, plus the coordinator
                  stall harness
"""
from repro_torch.chaos.schedule import (ALL_KINDS, COORD_STALL, DEVICE_LOSS,
                                        HOST_LOSS, LANE_FAULT,
                                        PERSISTENT_STAGE, SERVE_KINDS,
                                        SPARE_EXHAUSTION, TRAIN_KINDS,
                                        TRANSIENT_STAGE, ChaosEvent,
                                        draw_schedule)
from repro_torch.chaos.invariants import (InvariantViolation, check_closure,
                                          check_fingerprints, check_ladder,
                                          check_no_dropped, check_transients,
                                          verdict)
from repro_torch.chaos.campaign import (CANARY_WIDTHS, ChaosCanary,
                                        StallingKVClient, canary_fault,
                                        coordinator_campaign, run_campaign,
                                        serve_campaign, train_campaign)

__all__ = [
    "ALL_KINDS", "COORD_STALL", "DEVICE_LOSS", "HOST_LOSS", "LANE_FAULT",
    "PERSISTENT_STAGE", "SERVE_KINDS", "SPARE_EXHAUSTION", "TRAIN_KINDS",
    "TRANSIENT_STAGE", "ChaosEvent", "draw_schedule",
    "InvariantViolation", "check_closure", "check_fingerprints",
    "check_ladder", "check_no_dropped", "check_transients", "verdict",
    "CANARY_WIDTHS", "ChaosCanary", "StallingKVClient", "canary_fault",
    "coordinator_campaign", "run_campaign", "serve_campaign",
    "train_campaign",
]
