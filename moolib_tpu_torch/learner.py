"""Learner steps; this slice ports the acting step only (the counterpart
of :func:`moolib_tpu.learner.make_act_step`)."""

from __future__ import annotations

from typing import Callable

import torch

from .utils import nest

__all__ = ["make_act_step"]


def make_act_step(model: Callable, temperature: float = 1.0) -> Callable:
    """Acting step for the actor loop and the serving replica.

    ``model(obs_TB, done_TB, core_state) -> ((logits, baseline), state)``
    is a :class:`~moolib_tpu_torch.models.TransformerNet` or any module of
    the same calling convention. Returns

        act(obs_B, done_B, core_state, generator)
            -> (actions_B, logits_B, new_core_state)

    which adds the T=1 axis (per leaf, for dict observations), divides the
    logits by ``temperature`` and samples one action per lane from their
    softmax with ``generator`` (a :class:`torch.Generator` on the logits'
    device). The returned logits are the temperature-scaled ones: they
    describe the distribution the action was drawn from, which is what
    V-trace's behaviour logits must be."""

    @torch.no_grad()
    def act(obs, done, core_state, generator: torch.Generator):
        obs_t = nest.map_structure(lambda x: x[None], obs)
        (logits, _), core_state = model(obs_t, done[None], core_state)
        logits = logits[0] / temperature
        probs = torch.softmax(logits.float(), dim=-1)
        actions = torch.multinomial(probs, 1, generator=generator)[:, 0]
        return actions, logits, core_state

    return act
