"""The followers' side of tests/test_torch_local_dp.py: module-level
builders that a :class:`moolib_tpu_torch.parallel.local_dp.LocalDP`
follower calls by name (spawned workers import this module, never the
test file, so they never load JAX)."""

import os

import torch

from moolib_tpu_torch import learner as tlearner
from moolib_tpu_torch.models import TransformerNet
from moolib_tpu_torch.optim import ClippedRMSprop


def transformer(device, obs_shape, seed=0):
    """The narrow two-layer TransformerNet of the parity tests (d_model
    32, two heads, dense attention) with experiment.py's RMSprop chain."""
    net = TransformerNet(6, obs_shape, attention_backend="dense",
                         device=device, d_model=32, num_layers=2, num_heads=2,
                         generator=torch.Generator(device).manual_seed(seed))
    opt = ClippedRMSprop(net.parameters(), 6e-4, decay=0.99, eps=0.01,
                         max_norm=40.0)
    return tlearner.make_train_state(net, opt)


def build_transformer(device, mesh, obs_shape, seed=0):
    """A follower's ``(state, grad_step, apply_step)``: its own seed, so
    its weights differ from rank 0's until a STATE."""
    return (transformer(device, obs_shape, seed),
            tlearner.make_grad_step(mesh=mesh), tlearner.make_apply_step())


def build_raising(device, mesh):
    raise ValueError("a follower whose build raises")


def build_exiting(device, mesh):
    os._exit(7)  # no report, no traceback: the pipe just closes
