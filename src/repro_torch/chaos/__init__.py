"""Chaos layer of the port: only ``ChaosCanary`` so far, which arms a
value-level lane fault around each canary probe.  The schedule, the
invariant checkers and the campaigns are ROADMAP queue 1 item 10."""
from repro_torch.chaos.campaign import (CANARY_WIDTHS, ChaosCanary,
                                        canary_fault)

__all__ = ["CANARY_WIDTHS", "ChaosCanary", "canary_fault"]
