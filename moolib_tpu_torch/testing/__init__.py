"""Testing utilities: deterministic fault injection for the RPC stack,
the env-worker tier and the disk, and the seeded scenarios that drive
it; the counterpart of :mod:`moolib_tpu.testing`.

Kept outside the production packages so importing
:mod:`moolib_tpu_torch.rpc` never pays for (or accidentally enables)
chaos machinery; see :mod:`moolib_tpu_torch.testing.chaos`. The
reference's dynamic tracers (``hotwatch``, ``locktrace``, ``paritywatch``
and ``restrack``) are not ported yet: ROADMAP.md queue A, item 12.
"""

from .chaos import (ChaosNet, Event, FaultPlan, ProcChaos, ProcFaultPlan,
                    ResourceChaos, ResourceFaultPlan)

__all__ = ["ChaosNet", "Event", "FaultPlan", "ProcChaos", "ProcFaultPlan",
           "ResourceChaos", "ResourceFaultPlan", "SCENARIOS"]


def __getattr__(name):
    # Scenarios pull in the Accumulator and the fleet lazily — importing
    # the chaos engine alone must not drag the parallel package (and
    # torch) in.
    if name == "SCENARIOS":
        from .scenarios import SCENARIOS

        return SCENARIOS
    raise AttributeError(
        f"module 'moolib_tpu_torch.testing' has no attribute {name!r}"
    )
