"""Port parity: moolib_tpu_torch.ops.vtrace against moolib_tpu.ops.vtrace.

Mirrors tests/test_vtrace.py (which holds the reference against a naive
oracle of the paper's eq. 1): the same numpy inputs go through both
packages in f32. Tolerance 1e-5: the two run the same recursion, the
reference as a lax.scan, the port as a loop over T.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moolib_tpu.ops import vtrace as jvtrace
from moolib_tpu_torch.ops import vtrace as tvtrace

TOL = dict(rtol=1e-5, atol=1e-5)


def _f32(*xs):
    return [np.asarray(x, np.float32) for x in xs]


def _both(fn_name, *args, **kw):
    j = getattr(jvtrace, fn_name)(*(jnp.asarray(a) for a in args), **kw)
    t = getattr(tvtrace, fn_name)(*(torch.from_numpy(a) for a in args), **kw)
    return j, t


def _iw_inputs(seed, T=7, B=5):
    rng = np.random.default_rng(seed)
    return _f32(
        rng.uniform(-1.5, 1.5, (T, B)),
        # Mid-episode terminations (discount 0) and continuations.
        0.99 * (rng.uniform(size=(T, B)) > 0.2),
        rng.standard_normal((T, B)),
        rng.standard_normal((T, B)),
        rng.standard_normal(B),
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("lambda_", [1.0, 0.9])
def test_from_importance_weights_matches_reference(seed, lambda_):
    j, t = _both("from_importance_weights", *_iw_inputs(seed),
                 lambda_=lambda_)
    np.testing.assert_allclose(t.vs.numpy(), np.asarray(j.vs), **TOL)
    np.testing.assert_allclose(t.pg_advantages.numpy(),
                               np.asarray(j.pg_advantages), **TOL)


def test_no_clipping_thresholds():
    """clip_*=None: rho unclipped in both deltas and advantages, c still
    clipped at 1 (cs is lambda * min(1, rho), never min(clip, rho))."""
    args = _iw_inputs(3, T=5, B=3)
    args[0] = args[0] + 1.0  # rhos well above 1
    kw = dict(clip_rho_threshold=None, clip_pg_rho_threshold=None)
    j, t = _both("from_importance_weights", *args, **kw)
    np.testing.assert_allclose(t.vs.numpy(), np.asarray(j.vs), **TOL)
    np.testing.assert_allclose(t.pg_advantages.numpy(),
                               np.asarray(j.pg_advantages), **TOL)
    # A clip threshold above every rho leaves the advantages as None does.
    _, t2 = _both("from_importance_weights", *args, clip_rho_threshold=None,
                  clip_pg_rho_threshold=100.0)
    np.testing.assert_allclose(t2.pg_advantages.numpy(),
                               t.pg_advantages.numpy(), rtol=0, atol=0)


def test_from_logits_on_policy_and_off_policy():
    rng = np.random.default_rng(4)
    T, B, A = 6, 4, 9
    target = rng.standard_normal((T, B, A)).astype(np.float32)
    behavior = rng.standard_normal((T, B, A)).astype(np.float32)
    actions = rng.integers(0, A, (T, B)).astype(np.int32)
    discounts, rewards, values, bootstrap = _f32(
        np.full((T, B), 0.95), rng.standard_normal((T, B)),
        rng.standard_normal((T, B)), rng.standard_normal(B))
    # On-policy: behaviour == target, so every rho is 1.
    _, t = _both("from_logits", target, target, actions, discounts, rewards,
                 values, bootstrap)
    np.testing.assert_allclose(t.log_rhos.numpy(), 0.0, atol=1e-6)
    j, t = _both("from_logits", behavior, target, actions, discounts,
                 rewards, values, bootstrap, lambda_=0.9)
    for field in jvtrace.VTraceFromLogitsReturns._fields:
        np.testing.assert_allclose(getattr(t, field).numpy(),
                                   np.asarray(getattr(j, field)), **TOL,
                                   err_msg=field)


def test_gradients_stop_where_the_reference_stops_them():
    """vs and pg_advantages carry no gradient (from_importance_weights
    stops all its inputs); target_action_log_probs keeps its own, which
    the policy-gradient loss is built from."""
    rng = np.random.default_rng(5)
    T, B, A = 4, 2, 3
    logits = torch.from_numpy(
        rng.standard_normal((T, B, A)).astype(np.float32)).requires_grad_()
    values = torch.from_numpy(
        rng.standard_normal((T, B)).astype(np.float32)).requires_grad_()
    out = tvtrace.from_logits(
        torch.zeros((T, B, A)), logits,
        torch.from_numpy(rng.integers(0, A, (T, B))), torch.full((T, B), 0.9),
        torch.ones((T, B)), values, values[-1].detach(),
    )
    assert not out.vs.requires_grad
    assert not out.pg_advantages.requires_grad
    assert out.target_action_log_probs.requires_grad
    (g,) = torch.autograd.grad(out.target_action_log_probs.sum(), logits)
    assert float(g.abs().sum()) > 0
    iw = tvtrace.from_importance_weights(
        torch.zeros((T, B)), torch.full((T, B), 0.9), torch.ones((T, B)),
        values, torch.zeros(B))
    assert not iw.vs.requires_grad
