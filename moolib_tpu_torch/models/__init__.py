"""Agent models of the port."""

from .a2c import A2CNet
from .convert import (
    a2c_params_from_flax,
    impala_params_from_flax,
    transformer_params_from_flax,
)
from .core import LSTMCore
from .impala import (
    ConvSequence,
    ImpalaNet,
    ResidualBlock,
    space_to_depth,
    widen_impala_params,
)
from .transformer import TransformerNet, segment_ids_from_done

__all__ = [
    "A2CNet",
    "ConvSequence",
    "ImpalaNet",
    "LSTMCore",
    "ResidualBlock",
    "TransformerNet",
    "a2c_params_from_flax",
    "impala_params_from_flax",
    "segment_ids_from_done",
    "space_to_depth",
    "transformer_params_from_flax",
    "widen_impala_params",
]
