"""The training services of the port: the elastic gradient
``Accumulator`` and the cluster-wide ``GlobalStatsAccumulator``; the
counterpart of :mod:`moolib_tpu.parallel`. The device layouts of the
reference's package (``mesh``, ``tp``, ``pipeline``, ``moe``) are not
ported yet and raise ``AttributeError`` naming their roadmap item."""

from .accumulator import Accumulator
from .stats import GlobalStatsAccumulator

__all__ = ["Accumulator", "GlobalStatsAccumulator"]

# Unported names of the reference's package -> ROADMAP.md queue A item.
_NOT_PORTED = {
    **dict.fromkeys(
        ("make_mesh", "data_parallel_spec", "replicated_spec",
         "psum_gradients", "pmean_gradients", "dp_average_grads",
         "shard_batch", "count_sharded_leaves", "impala_tp_specs",
         "shard_params", "sharded_init_opt_state", "transformer_tp_specs",
         "MICRO_SPEC", "pipeline_apply", "shard_microbatches",
         "stack_stage_params", "unshard_microbatches", "moe_ffn_sharded"),
        "item 11, multi-device"),
    **dict.fromkeys(("moe_ffn", "moe_params"), "item 9, MoE blocks"),
}


def __getattr__(name):
    item = _NOT_PORTED.get(name)
    if item is not None:
        raise AttributeError(
            f"moolib_tpu_torch.parallel.{name} is not ported yet "
            f"(ROADMAP queue A, {item})"
        )
    raise AttributeError(
        f"module 'moolib_tpu_torch.parallel' has no attribute {name!r}"
    )
