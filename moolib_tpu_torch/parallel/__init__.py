"""The training services of the port: the elastic gradient
``Accumulator``, the cluster-wide ``GlobalStatsAccumulator`` and the
one-device mixture-of-experts FFN (``moe_params``, ``moe_ffn``); the
counterpart of :mod:`moolib_tpu.parallel`. The device layouts of the
reference's package (``mesh``, ``tp``, ``pipeline``, the expert-sharded
``moe_ffn_sharded``) are not ported yet and raise, naming their roadmap
item."""

from .accumulator import Accumulator
from .moe import moe_ffn, moe_ffn_sharded, moe_params
from .stats import GlobalStatsAccumulator

__all__ = ["Accumulator", "GlobalStatsAccumulator", "moe_ffn",
           "moe_ffn_sharded", "moe_params"]

# Unported names of the reference's package -> ROADMAP.md queue A item.
_NOT_PORTED = {
    **dict.fromkeys(
        ("make_mesh", "data_parallel_spec", "replicated_spec",
         "psum_gradients", "pmean_gradients", "dp_average_grads",
         "shard_batch", "count_sharded_leaves", "impala_tp_specs",
         "shard_params", "sharded_init_opt_state", "transformer_tp_specs",
         "MICRO_SPEC", "pipeline_apply", "shard_microbatches",
         "stack_stage_params", "unshard_microbatches"),
        "item 11, multi-device"),
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
