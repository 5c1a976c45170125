"""Fleet tier: declarative cohort control for every survivability piece;
the counterpart of :mod:`moolib_tpu.fleet`.

``spec`` (the cohort shape as a validated, JSON-round-trippable value)
-> ``controller`` (materialize + supervise + adopt) -> ``rollout``
(canary / SLO gates / promote-or-rollback). The controller's replicas
serve on the card unless it is given ``device="cpu"``.
"""

from .controller import AdoptError, Cohort, Controller, RoleHandle
from .rollout import Rollout, RolloutError
from .spec import (BrokerSpec, EnvSpec, FleetSpec, LearnerSpec,
                   RolloutSpec, ServingSpec, SpecError, StateStoreSpec,
                   SupervisionSpec)

__all__ = [
    "AdoptError",
    "BrokerSpec",
    "Cohort",
    "Controller",
    "EnvSpec",
    "FleetSpec",
    "LearnerSpec",
    "RoleHandle",
    "Rollout",
    "RolloutError",
    "RolloutSpec",
    "ServingSpec",
    "SpecError",
    "StateStoreSpec",
    "SupervisionSpec",
]
