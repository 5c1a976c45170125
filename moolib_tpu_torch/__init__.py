"""moolib_tpu_torch: the PyTorch and CUDA port of :mod:`moolib_tpu` for
one NVIDIA H100.

The port grows slice by slice beside the JAX package, which stays the
reference each ported part is tested against. The slices so far:

- serving the ``TransformerNet`` policy: the attention ops with the
  hand-written CUDA flash-attention forward, the model and its weight
  converter, the acting step, and the serving replica with its admission
  queue;
- training it: the flash-attention backward kernels behind a
  ``torch.autograd.Function``, V-trace, the IMPALA loss and train steps,
  and the clipped-RMSprop optimizer of the reference's experiment;
- the flash kernels redesigned for Hopper;
- training the IMPALA ResNet agent (``ImpalaNet``, its LSTM core, its
  weight converter), the clipped-Adam chain of the reference's
  benchmark, and the timing and FLOP accounting of ``bench_torch.py``;
- the observability plane: the metrics registry, trace spans,
  ``StepScope`` phase ledgers (the learner factories' ``stepscope=``,
  the replica's ``{service}_replica`` loop), the flight recorder and
  incident bundles, and the serving tier's ``serving_*`` series;
- the RPC core (``Rpc``, its wire codec and native extension, the
  tcp/unix/shm transports, the ``Broker``), wire-compatible with the
  reference's, and the serving tier on it: ``Replica(rpc, ...)``, health
  gating and the ``Router``;
- the elastic gradient plane: ``Group`` and its tree allreduce, the
  ``Accumulator`` (leader election, virtual batches, state hand-off to
  joiners), the ``GlobalStatsAccumulator`` and ``Stats``, and the
  ``Checkpointer``.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

import secrets

from .flightrec import FlightRecorder, capture_incident, enable_auto_capture
from .learner import (
    ImpalaConfig,
    TrainState,
    impala_loss,
    make_act_step,
    make_apply_step,
    make_grad_step,
    make_impala_train_step,
    make_train_state,
)
from .models import (
    ImpalaNet,
    LSTMCore,
    TransformerNet,
    impala_params_from_flax,
    space_to_depth,
    transformer_params_from_flax,
    widen_impala_params,
)
from .ops import attention, stage_batch, vtrace
from .optim import ClippedAdam, ClippedRMSprop, global_norm
from .parallel import Accumulator, GlobalStatsAccumulator
from .rpc import (
    AllReduce,
    Broker,
    Future,
    Group,
    Queue,
    Rpc,
    RpcDeferredReturn,
    RpcError,
)
from .serving import (
    AdmissionQueue,
    CircuitBreaker,
    DeadlineExceeded,
    Overloaded,
    Replica,
    ReplicaHealth,
    Router,
    ServingError,
    error_kind,
)
from .telemetry import Telemetry, global_telemetry, publish_metrics
from .utils import (
    Checkpointer,
    StatMax,
    StatMean,
    Stats,
    StatSum,
    nest,
    resolve_device,
    set_log_level,
    set_logging,
)

__all__ = [
    "Accumulator",
    "AdmissionQueue",
    "AllReduce",
    "Broker",
    "Checkpointer",
    "CircuitBreaker",
    "ClippedAdam",
    "ClippedRMSprop",
    "DeadlineExceeded",
    "FlightRecorder",
    "Future",
    "GlobalStatsAccumulator",
    "Group",
    "ImpalaConfig",
    "ImpalaNet",
    "LSTMCore",
    "Overloaded",
    "Queue",
    "Replica",
    "ReplicaHealth",
    "Router",
    "Rpc",
    "RpcDeferredReturn",
    "RpcError",
    "ServingError",
    "StatMax",
    "StatMean",
    "StatSum",
    "Stats",
    "Telemetry",
    "TrainState",
    "TransformerNet",
    "attention",
    "capture_incident",
    "create_uid",
    "enable_auto_capture",
    "error_kind",
    "get_max_threads",
    "global_norm",
    "global_telemetry",
    "impala_loss",
    "impala_params_from_flax",
    "make_act_step",
    "make_apply_step",
    "make_grad_step",
    "make_impala_train_step",
    "make_train_state",
    "nest",
    "publish_metrics",
    "resolve_device",
    "set_log_level",
    "set_logging",
    "set_max_threads",
    "space_to_depth",
    "stage_batch",
    "transformer_params_from_flax",
    "vtrace",
    "widen_impala_params",
]


def create_uid() -> str:
    """Random unique peer-name suffix (the reference's ``create_uid``)."""
    return secrets.token_hex(16)


_max_threads: int | None = None


def set_max_threads(n: int) -> None:
    """Cap the worker threads of the host runtime: each ``Rpc`` created
    afterwards sizes its handler executor from it (the reference's
    ``set_max_threads``)."""
    global _max_threads
    if n <= 0:
        raise ValueError("set_max_threads requires n >= 1")
    _max_threads = n


def get_max_threads() -> int | None:
    return _max_threads
