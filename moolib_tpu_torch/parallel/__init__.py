"""The training services and device layouts of the port; the counterpart
of :mod:`moolib_tpu.parallel`: the elastic gradient ``Accumulator``, the
cluster-wide ``GlobalStatsAccumulator``, the (dp, tp, sp, pp, ep) mesh on
``torch.distributed`` (``mesh``, ``distributed``, ``collectives``),
tensor parallelism (``tp``), pipelines (``pipeline``) and the
mixture-of-experts FFN with its expert-sharded variant (``moe``).

Imports are lazy: a name loads its module on first use."""

import importlib

_EXPORTS = {
    "Accumulator": "accumulator",
    "GlobalStatsAccumulator": "stats",
    **dict.fromkeys(("make_mesh", "data_parallel_spec", "replicated_spec",
                     "psum_gradients", "pmean_gradients", "dp_average_grads",
                     "shard_batch"), "mesh"),
    **dict.fromkeys(("moe_ffn", "moe_ffn_sharded", "moe_params"), "moe"),
    **dict.fromkeys(("MICRO_SPEC", "pipeline_apply", "pipeline_train_1f1b",
                     "shard_microbatches", "stack_stage_params",
                     "unshard_microbatches"), "pipeline"),
    **dict.fromkeys(("count_sharded_leaves", "impala_tp_specs",
                     "shard_params", "sharded_init_opt_state",
                     "transformer_tp_specs"), "tp"),
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(
            f"module 'moolib_tpu_torch.parallel' has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
