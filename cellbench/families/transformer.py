"""The program's ``TransformerNet`` built from a configuration of the
``transformer`` family."""

import torch

from ..flops.flash import visible_pairs

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build(cfg: dict, device):
    from moolib_tpu_torch import TransformerNet

    return TransformerNet(cfg["num_actions"], tuple(cfg["obs_shape"]),
                          d_model=cfg["d_model"],
                          num_layers=cfg["num_layers"],
                          num_heads=cfg["num_heads"],
                          mlp_ratio=cfg["mlp_ratio"],
                          max_len=cfg["max_len"],
                          attention_backend=cfg["attention_backend"],
                          compute_dtype=DTYPES[cfg["compute_dtype"]],
                          device=device)


def shapes(cfg: dict, mix: dict, done) -> dict:
    """The sizes the counts in ``flops/transformer.py`` read; ``done`` is
    one batch's [T+1, B] flags on the host."""
    return {"frames": (mix["unroll"] + 1) * mix["batch"],
            "batch": mix["batch"], "pairs": visible_pairs(done)}
