"""The program's ``ImpalaNet`` built from a configuration of the
``impala`` family."""

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build(cfg: dict, device):
    from moolib_tpu_torch import ImpalaNet

    if cfg.get("use_lstm"):
        raise ValueError("the impala family's cells run no LSTM")
    return ImpalaNet(cfg["num_actions"], tuple(cfg["obs_shape"]),
                     channels=tuple(cfg["channels"]),
                     hidden_size=cfg["hidden_size"], use_lstm=False,
                     compute_dtype=DTYPES[cfg["compute_dtype"]],
                     device=device)


def shapes(cfg: dict, mix: dict, done) -> dict:
    """The sizes the counts in ``flops/impala.py`` read."""
    return {"frames": (mix["unroll"] + 1) * mix["batch"],
            "batch": mix["batch"]}
