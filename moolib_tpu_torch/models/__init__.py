"""Agent models of the port."""

from .convert import transformer_params_from_flax
from .transformer import TransformerNet, segment_ids_from_done

__all__ = [
    "TransformerNet",
    "segment_ids_from_done",
    "transformer_params_from_flax",
]
