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
  ``Checkpointer``;
- the acting plane and the experiment loop: the ``EnvPool`` and its
  remote stepper, the ``Batcher``, the examples' envs and rollout
  bookkeeping, the ``A2CNet``, and the elastic V-trace experiment
  (``examples/vtrace/experiment.py``) with its ``bench_e2e_torch.py``
  twin;
- the remaining model families and example entry points: the
  mixture-of-experts FFN (``parallel.moe``) and
  ``TransformerNet(mlp="moe")``, the ``NetHackNet``, the A2C example
  (``examples/a2c.py``) and the remote-actors example
  (``examples/remote_actors.py``);
- durable state and the fault engine: the ``StateStore`` (content-hashed
  chunked bundles, push replication, quorum restore) and its
  ``Replicator`` on the ``Accumulator``, the seeded chaos engine
  (``testing``), and the fleet controller (``fleet``: spec, supervision,
  standby adoption, canary rollout);
- the rest of the fault engine's scenarios and the runtime tracers
  (``testing.restrack``, ``testing.paritywatch``), with the
  ``chaos_soak`` and ``serving_load`` tools;
- multi-device layouts on ``torch.distributed``: the ``(dp, tp, sp, pp,
  ep)`` ``DeviceMesh`` (``parallel.mesh``), its collectives, the
  data-parallel learner step, ring and zigzag attention
  (``ops.ring_attention``), tensor and pipeline parallelism and the
  sharded MoE FFN;
- the perfwatch plane: the bench harness, trend store and budgets
  (``bench``), the ``perf`` CLI and its suites, ``testing.hotwatch``
  and the batch-size finder;
- the operator plane: the launcher and plotter (``examples.launch``,
  ``examples.plot``) and the operator tools (``tools``), with
  ``testing.locktrace``;
- static analysis (``analysis``): the moolint engine, its ten rule
  families (the reference's six that never touched JAX, and torch
  counterparts of its four JAX families), the ``moolint`` CLI
  (``python -m moolib_tpu_torch.tools.moolint``) and
  ``analysis.recompile_guard`` on kernel-library builds.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

import importlib
import secrets

# Exported name -> the module that defines it. Imports are lazy, as the
# reference's are: a process that needs only part of the package (an env
# worker of the EnvPool, which must not pay for torch) imports only that.
_EXPORTS = {
    **dict.fromkeys(("FlightRecorder", "capture_incident",
                     "enable_auto_capture"), "moolib_tpu_torch.flightrec"),
    **dict.fromkeys(("ImpalaConfig", "TrainState", "impala_loss",
                     "make_act_step", "make_apply_step", "make_grad_step",
                     "make_impala_train_step", "make_train_state"),
                    "moolib_tpu_torch.learner"),
    **dict.fromkeys(("A2CNet", "ImpalaNet", "LSTMCore", "NetHackNet",
                     "TransformerNet", "a2c_params_from_flax",
                     "impala_params_from_flax", "nethack_params_from_flax",
                     "space_to_depth", "transformer_params_from_flax",
                     "widen_impala_params"), "moolib_tpu_torch.models"),
    **dict.fromkeys(("Batcher", "attention", "stage_batch", "vtrace"),
                    "moolib_tpu_torch.ops"),
    **dict.fromkeys(("ClippedAdam", "ClippedRMSprop", "global_norm"),
                    "moolib_tpu_torch.optim"),
    **dict.fromkeys(("Accumulator", "GlobalStatsAccumulator"),
                    "moolib_tpu_torch.parallel"),
    **dict.fromkeys(("AllReduce", "Broker", "Future", "Group", "Queue",
                     "Rpc", "RpcDeferredReturn", "RpcError"),
                    "moolib_tpu_torch.rpc"),
    **dict.fromkeys(("Replicator", "StateStore", "StateStoreError"),
                    "moolib_tpu_torch.statestore"),
    **dict.fromkeys(("EnvPool", "EnvPoolServer", "EnvRunner", "EnvStepper",
                     "EnvStepperFuture", "RemoteEnvStepper", "WorkerDied",
                     "step_with_retry"), "moolib_tpu_torch.envpool"),
    **dict.fromkeys(("AdmissionQueue", "CircuitBreaker", "DeadlineExceeded",
                     "Overloaded", "Replica", "ReplicaHealth", "Router",
                     "ServingError", "error_kind"),
                    "moolib_tpu_torch.serving"),
    **dict.fromkeys(("Telemetry", "global_telemetry", "publish_metrics"),
                    "moolib_tpu_torch.telemetry"),
    **dict.fromkeys(("Checkpointer", "StatMax", "StatMean", "Stats",
                     "StatSum", "nest", "resolve_device", "set_log_level",
                     "set_logging"), "moolib_tpu_torch.utils"),
}

__version__ = "0.1.0"

__all__ = sorted([*_EXPORTS, "__version__", "create_uid", "get_max_threads",
                  "set_max_threads"])


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if name.startswith("__"):
        raise AttributeError(name)
    if mod is not None:
        return getattr(importlib.import_module(mod), name)
    try:  # a subpackage not imported yet: moolib_tpu_torch.rpc, ...
        return importlib.import_module(f"{__name__}.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{name}":
            raise
    raise AttributeError(
        f"module 'moolib_tpu_torch' has no attribute {name!r}")


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
