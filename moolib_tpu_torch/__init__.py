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
  benchmark, and the timing and FLOP accounting of ``bench_torch.py``.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

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
from .serving import (
    AdmissionQueue,
    DeadlineExceeded,
    Overloaded,
    Replica,
    RpcError,
    ServingError,
    error_kind,
)
from .utils import nest, resolve_device

__all__ = [
    "AdmissionQueue",
    "ClippedAdam",
    "ClippedRMSprop",
    "DeadlineExceeded",
    "ImpalaConfig",
    "ImpalaNet",
    "LSTMCore",
    "Overloaded",
    "Replica",
    "RpcError",
    "ServingError",
    "TrainState",
    "TransformerNet",
    "attention",
    "error_kind",
    "global_norm",
    "impala_loss",
    "impala_params_from_flax",
    "make_act_step",
    "make_apply_step",
    "make_grad_step",
    "make_impala_train_step",
    "make_train_state",
    "nest",
    "resolve_device",
    "space_to_depth",
    "stage_batch",
    "transformer_params_from_flax",
    "vtrace",
    "widen_impala_params",
]
