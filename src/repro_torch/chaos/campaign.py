"""Campaign-controlled canary faults.

Port of ``ChaosCanary``, ``CANARY_WIDTHS`` and ``canary_fault`` from the
reference's ``chaos/campaign.py``; the serve, train and coordinator
campaigns wait for the rest of the chaos layer.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core.fault import CanaryChecker
from repro_torch.viscosity import lanefault
from repro_torch.viscosity.lanefault import STUCK, LaneFault

#: minor-axis lane width of each kernel family's *canary* port
#: (``train.runner.canary_stages``) -- a LaneFault only applies where
#: widths match, so chaos injections must use these
CANARY_WIDTHS = {"flash_attention": 32, "swiglu_mlp": 64,
                 "mamba2_ssd": 16, "rwkv6_wkv": 16}


def canary_fault(stage_name: str, *, lane: int = 1,
                 value: float = 7.5) -> LaneFault:
    """A stuck-lane fault sized to the stage family's canary width."""
    width = CANARY_WIDTHS.get(stage_name)
    if width is None:
        raise ValueError(f"no canary width for stage {stage_name!r}; "
                         f"known: {sorted(CANARY_WIDTHS)}")
    return LaneFault(kind=STUCK, lanes=(lane % width,), width=width,
                     value=value)


class ChaosCanary:
    """Canary checker with campaign-controlled value-level faults.

    The injection registry is process-global and keyed by stage *name*,
    so a fault armed for the whole run would corrupt production compute
    wherever canary and serving widths collide.  This wrapper arms the
    ``LaneFault`` only around each canary probe: detection is genuinely
    value-level -- the canary's HW lane really is stuck against the SW
    oracle -- while serving kernels never observe the injection.

    ``fails=N`` models a transient upset: the fault clears itself after
    N failing probes (probation then finds a clean canary -> HW route
    restored).  ``fails=None`` is a hard fault: every probe fails until
    the ladder routes the stage away.  Repeated ``arm`` calls *queue*,
    and a probation episode's successive probes drain the queue in
    order -- so never stack a second spec behind a transient on the same
    stage (the episode's later probes would hit it and earn a spurious
    persistent verdict).
    """

    def __init__(self, checker: CanaryChecker):
        self.checker = checker
        # name -> FIFO of [fault, fails-left]; head is the live fault
        self._faults: Dict[str, List[list]] = {}

    @property
    def stages(self):
        return self.checker.stages

    def arm(self, stage_name: str, fault: LaneFault, *,
            fails: Optional[int] = None):
        self._faults.setdefault(stage_name, []).append([fault, fails])

    def disarm(self, stage_name: str):
        self._faults.pop(stage_name, None)

    def armed(self) -> List[str]:
        return sorted(self._faults)

    def check_stage(self, stage) -> bool:
        queue = self._faults.get(stage.name)
        if not queue:
            return self.checker.check_stage(stage)
        fault, fails = queue[0]
        lanefault.set_injection(stage.name, fault)
        try:
            ok = self.checker.check_stage(stage)
        finally:
            lanefault.clear_injection(stage.name)
        if not ok and fails is not None:
            queue[0][1] = fails - 1
            if queue[0][1] <= 0:
                queue.pop(0)
                if not queue:
                    self._faults.pop(stage.name, None)
        return ok
