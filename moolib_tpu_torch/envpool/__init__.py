"""The env tier of the port: the shared-memory ``EnvPool`` (also
``EnvStepper`` and ``EnvRunner``) and the RPC stepper pair
``EnvPoolServer``/``RemoteEnvStepper``; the counterpart of
:mod:`moolib_tpu.envpool`.

The RPC pair is imported lazily: an env worker imports
:mod:`.pool` through this package and must not pay for the RPC core."""

from .pool import (EnvPool, EnvStepper, EnvStepperFuture, WorkerDied,
                   step_with_retry)

# Import-parity alias (the reference exports EnvRunner): the worker loop
# lives inside the pool's spawned processes, and the pool object is the
# handle for both roles.
EnvRunner = EnvPool

__all__ = [
    "EnvPool",
    "EnvPoolServer",
    "EnvRunner",
    "EnvStepper",
    "EnvStepperFuture",
    "RemoteEnvStepper",
    "WorkerDied",
    "step_with_retry",
]


def __getattr__(name):
    if name in ("EnvPoolServer", "RemoteEnvStepper"):
        from . import stepper

        return getattr(stepper, name)
    raise AttributeError(
        f"module 'moolib_tpu_torch.envpool' has no attribute {name!r}")
