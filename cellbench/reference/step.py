"""The reference's learner steps: forward, the IMPALA loss, the
gradients, the clip and Adam, from given weights over given batches,
in a given precision. What it returns is what the comparison reads of
the program: each step's loss, the first step's clipped gradients, the
first moment after each step and the parameters' change after the last
step."""

import torch
from torch.func import grad, vmap

from . import for_family
from .adam import ClippedAdam
from .loss import impala_loss
from .precision import Precision

#: Frames a chunk of :func:`leaf_terms` takes at once.
TERM_CHUNK = 128


def half_batch(batch: dict) -> dict:
    """The first half of the lanes (a fault the comparison must catch)."""
    B = batch["done"].shape[1]
    return {k: v[:, :B // 2] for k, v in batch.items()
            if torch.is_tensor(v)}


def run_steps(cfg: dict, params0: dict, batches, precision: str = "f32",
              fault: str = "") -> dict:
    """``len(batches)`` learner steps from ``params0`` (left untouched).
    A control (any ``precision`` but "f32") also keeps Adam's moments in
    bf16, one step below the f32 the configuration states for them.
    ``fault`` plants a fault in the steps: "half_batch" (the loss of half
    the lanes). Returns {"losses": [float], "loss_scales": [float] (each
    loss's terms' magnitudes summed), "grad1": {name: tensor},
    "moments": [{name: mu after step k}], "delta": {name: tensor},
    "clip1": the first step's clip factor, "terms": see
    :func:`leaf_terms`, "params0": ``params0``}."""
    ref = for_family(cfg["family"])
    prec = Precision(precision)
    params = {k: v.detach().clone().float() for k, v in params0.items()}
    opt = ClippedAdam(params, cfg["optimizer"],
                      torch.float32 if precision == "f32" else torch.bfloat16)
    losses, scales, moments, grad1 = [], [], [], None
    extra = {}
    for batch in batches:
        if fault == "half_batch":
            batch = half_batch(batch)
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        with prec.flags():
            logits, baseline, features = ref.forward(
                leaves, batch["obs"], batch["done"], cfg, prec)
            loss, scale = impala_loss(logits, baseline, batch, cfg["loss"])
            *grads, dlogits, dbaseline = torch.autograd.grad(
                loss, list(leaves.values()) + [logits, baseline])
        for v in params.values():
            v.requires_grad_(False)
        grads, factor = opt.clip(dict(zip(leaves, grads)))
        if grad1 is None:
            grad1 = {k: g.clone() for k, g in grads.items()}
            extra = {"clip1": factor,
                     "terms": leaf_terms(cfg, params0, batch["obs"],
                                         features, dlogits, dbaseline)}
        opt.step(grads)
        moments.append({k: m.float().clone() for k, m in opt.mu.items()})
        losses.append(float(loss.detach()))
        scales.append(scale)
        del logits, baseline, features, loss, grads
    delta = {k: params[k] - params0[k].float() for k in params}
    return {"losses": losses, "loss_scales": scales, "grad1": grad1,
            "moments": moments, "delta": delta, "params0": params0,
            **extra}


def leaf_terms(cfg: dict, params: dict, obs, features, dlogits,
               dbaseline) -> dict:
    """{leaf: the root of the sum over frames of the squared norms of
    the leaf's per-frame gradient terms}, in f32.

    Where each frame's outputs depend on that frame alone (the family's
    ``FRAMES_INDEPENDENT``), a leaf's gradient is the sum over frames of
    J_f^T d_f, with d_f the loss's gradient at frame f's logits and
    baseline: every leaf is counted. Otherwise only the policy head's
    weight, whose terms are the outer products d_f (x) features_f. That
    root is the size of the gradient's rounding noise, which, unlike the
    sum itself, no cancellation between frames shrinks."""
    ref = for_family(cfg["family"])
    if not getattr(ref, "FRAMES_INDEPENDENT", False):
        f = features.detach().reshape(-1, features.shape[-1]).float()
        d = dlogits.detach().reshape(-1, dlogits.shape[-1]).float()
        return {"policy.weight": float(torch.sqrt(torch.sum(
            f.pow(2).sum(-1) * d.pow(2).sum(-1))))}
    prec = Precision("f32")
    p = {k: v.detach().float() for k, v in params.items()}

    def frame(p, o, dl, db):
        logits, baseline, _ = ref.forward(p, o[None, None], None, cfg, prec)
        return (logits[0, 0] * dl).sum() + baseline[0, 0] * db

    per_frame = vmap(grad(frame), in_dims=(None, 0, 0, 0))
    o = obs.reshape(-1, *obs.shape[2:])
    dl = dlogits.detach().reshape(-1, dlogits.shape[-1]).float()
    db = dbaseline.detach().reshape(-1).float()
    sq = {k: torch.zeros((), device=o.device) for k in p}
    with prec.flags(), torch.no_grad():
        for s in range(0, o.shape[0], TERM_CHUNK):
            e = s + TERM_CHUNK
            for k, g in per_frame(p, o[s:e], dl[s:e], db[s:e]).items():
                sq[k] += g.pow(2).sum()
    return {k: float(v.sqrt()) for k, v in sq.items()}
