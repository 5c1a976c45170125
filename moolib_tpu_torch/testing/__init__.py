"""Testing utilities: deterministic fault injection for the RPC stack,
the env-worker tier and the disk, the seeded scenarios that drive it, a world
of SPMD worker processes (``spmd``) and the dynamic tracers ``locktrace``
(lock order), ``restrack`` (resource lifecycles), ``paritywatch``
(bitwise replay) and ``hotwatch`` (synchronous reads in a steady-state
window); the counterpart of :mod:`moolib_tpu.testing`.

Kept outside the production packages so importing
:mod:`moolib_tpu_torch.rpc` never pays for (or accidentally enables)
chaos machinery; see :mod:`moolib_tpu_torch.testing.chaos`. Every name
is imported lazily, as the package root's are: an env worker unpickling
:class:`~moolib_tpu_torch.testing.chaos_env.ChaosStepEnv` imports this
package and must not pull in torch or the RPC stack.
"""

import importlib

# Exported name -> the module that defines it.
_EXPORTS = {
    **dict.fromkeys(("ChaosNet", "Event", "FaultPlan", "ProcChaos",
                     "ProcFaultPlan", "ResourceChaos", "ResourceFaultPlan"),
                    "chaos"),
    **dict.fromkeys(("Hotwatch", "HotwatchViolation", "hotwatch_enabled"),
                    "hotwatch"),
    **dict.fromkeys(("LockOrderViolation", "LockTrace"), "locktrace"),
    **dict.fromkeys(("ParityViolation", "ParityWatch", "parity_enabled"),
                    "paritywatch"),
    **dict.fromkeys(("ResourceLeak", "ResourceTracker"), "restrack"),
    "ChaosStepEnv": "chaos_env",
    "SCENARIOS": "scenarios",
    "SpmdWorld": "spmd",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'moolib_tpu_torch.testing' has no attribute {name!r}"
        )
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
