"""moolib_tpu_torch: the PyTorch and CUDA port of :mod:`moolib_tpu` for
one NVIDIA H100.

The port grows slice by slice beside the JAX package, which stays the
reference each ported part is tested against. This slice serves the
``TransformerNet`` policy: the attention ops with the hand-written CUDA
flash-attention forward, the model and its weight converter, the acting
step, and the serving replica with its admission queue.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from .learner import make_act_step
from .models import TransformerNet, transformer_params_from_flax
from .ops import attention, stage_batch
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
    "DeadlineExceeded",
    "Overloaded",
    "Replica",
    "RpcError",
    "ServingError",
    "TransformerNet",
    "attention",
    "error_kind",
    "make_act_step",
    "nest",
    "resolve_device",
    "stage_batch",
    "transformer_params_from_flax",
]
