"""The plain reference of the benchmark's learner cells: the models'
forwards, V-trace, the IMPALA loss and clipped Adam, written from the
published descriptions in plain PyTorch, f32 with TF32 off. It imports
nothing of the program: the benchmark hands it the same weights and
batches it hands the program, and it works every step out again.

A model family's reference is ``reference/<family>.py`` with
``param_specs(cfg)`` (name, shape, initializer) and ``forward(params,
obs, done, cfg, prec)`` -> (logits [T+1, B, A], baseline [T+1, B], the
heads' input [T+1, B, F]).
"""

import importlib


def for_family(family: str):
    return importlib.import_module(f"cellbench.reference.{family}")
