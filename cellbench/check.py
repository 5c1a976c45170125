"""The comparison that decides ``correct`` for a learner cell.

The program's first three steps (the window's own call, on three
distinct batches) against the reference's three steps from the same
weights and batches:

- ``loss_gap``: the largest gap of a step's loss, over the sum of the
  magnitudes of the reference loss's terms (policy gradient, baseline,
  entropy), which can cancel.
- ``grad_gap``: the first step's gradient as the optimizer got it (its
  first moment after one step over 1 - b1), by the worst leaf: the gap
  between the program's norm and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf.
- ``change_gap``: the parameters' change after the three steps, the
  same way, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (Adam moves a leaf of no gradient by
  round-off alone).
- ``first_loss_gap``: ``loss_gap`` of the first step alone.
- ``median_grad_noise``: for each leaf, the norm of the difference of
  the first gradient, each side's clip undone, over the root of the sum
  of the squared norms of the leaf's per-frame terms (the reference's
  ``terms``), a size that cancellation in the sum does not shrink; the
  median over the leaves. The trunk's leaves are most of them, and
  rounding moves their gradients through relu and max-pool flips, which
  grow as the root of the rounding unit: the median is steady from seed
  to seed where the worst leaf is not.
- ``policy_grad_noise``: the same of the policy head's weight alone,
  which the backward reaches through no relu or max-pool, so rounding
  moves it in proportion to the rounding unit.
- ``update_gap``: the optimizer's three updates on their own: the
  program's change after the three steps against the reference's clipped
  Adam fed the gradients the program's optimizer took (each step's, from
  its first moments: g_k = (mu_k - b1 mu_(k-1)) / (1 - b1)), by the worst
  leaf, the norm of the difference over the larger of the leaf's change
  and the median leaf's. It follows the program from the program's own
  gradients; ``grad_gap`` and the two noises check those.
- ``nonfinite_losses``: window steps whose loss was not finite (exact,
  limit 0).

A cell compares the numbers its ``limits/<cell>.json`` gives a limit,
each read from the program's and a control's runs (``calibrate.py``);
a number passes when it is at most its limit.
"""

import math
import statistics

import torch

from cellbench.reference.adam import ClippedAdam

#: The rule that keeps a leaf in ``change_gap``.
MOVED_LEAF = 1e-3
#: The policy head's weight (``policy_grad_noise``).
POLICY = "policy.weight"


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in
            tree.items()}


def leaf_gaps(prog: dict, ref: dict, keep=None, diff=False) -> dict:
    """{leaf: gap of its norms (``diff``: the norm of the difference)
    over the larger of its reference norm and the median leaf's}."""
    rn = _norms(ref)
    if diff:
        pn = {k: float(torch.linalg.vector_norm((prog[k] - ref[k]).float()))
              for k in rn}
    else:
        pn = _norms(prog)
    names = [k for k in rn if keep is None or k in keep]
    median = statistics.median(rn[k] for k in names)
    return {k: (pn[k] if diff else abs(pn[k] - rn[k]))
            / max(rn[k], median, 1e-30) for k in names}


def worst_leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    return max(leaf_gaps(prog, ref, keep).values())


def moved_leaves(ref_grad1: dict) -> set:
    norms = _norms(ref_grad1)
    median = statistics.median(norms.values())
    return {k for k, v in norms.items() if v >= MOVED_LEAF * median}


def step_loss_gaps(prog: dict, ref: dict) -> list:
    return [abs(p - r) / max(s, 1e-30) for p, r, s in
            zip(prog["losses"], ref["losses"], ref["loss_scales"])]


def detail(prog: dict, ref: dict, top: int = 3) -> dict:
    """What lies under the numbers: each step's loss and its gap, the
    worst leaves of the two leaf gaps, and the norms of the differences
    of the gradient's worst leaf and of the policy head's."""
    def worst(gaps):
        return sorted(gaps.items(), key=lambda kv: -kv[1])[:top]

    return {"grad_diff": max(leaf_gaps(prog["grad1"], ref["grad1"],
                                       diff=True).values()),
            "policy_grad_diff": leaf_gaps(prog["grad1"], ref["grad1"],
                                          [POLICY], diff=True)[POLICY],
            "clip": [prog["clip1"], ref["clip1"]],
            "grad_norms": prog.get("grad_norms"),
            "noise_all": grad_noise(prog, ref),
            "unchanged_noise_all": grad_noise(unchanged(prog), ref),
            "losses": [prog["losses"], ref["losses"], ref["loss_scales"]],
            "step_loss_gaps": step_loss_gaps(prog, ref),
            "grad_leaves": worst(leaf_gaps(prog["grad1"], ref["grad1"])),
            "change_leaves": worst(leaf_gaps(prog["delta"], ref["delta"],
                                             moved_leaves(ref["grad1"])))}


def numbers(prog: dict, ref: dict, cfg: dict) -> dict:
    """The candidate numbers from the program's readings ({"losses",
    "grad1", "moments", "delta", "clip1"}) and the reference's
    (``run_steps``); ``cfg`` is the configuration (its optimizer)."""
    noise = grad_noise(prog, ref)
    loss_gap = max(step_loss_gaps(prog, ref))
    if any(not math.isfinite(p) for p in prog["losses"]):
        loss_gap = math.inf
    return {
        "loss_gap": loss_gap,
        "first_loss_gap": step_loss_gaps(prog, ref)[0],
        "grad_gap": worst_leaf_gap(prog["grad1"], ref["grad1"]),
        "change_gap": worst_leaf_gap(prog["delta"], ref["delta"],
                                     moved_leaves(ref["grad1"])),
        "median_grad_noise": statistics.median(noise.values()),
        "policy_grad_noise": noise[POLICY],
        "update_gap": update_gap(prog, ref, cfg),
    }


def grad_noise(prog: dict, ref: dict) -> dict:
    """{leaf: the norm of the difference of its first gradient, each
    side's clip undone, over the root of the sum of the squared norms of
    its per-frame terms}, over the leaves the reference's ``terms``
    counts."""
    out = {}
    for k, size in ref["terms"].items():
        gp = prog["grad1"][k].float() / prog["clip1"]
        gr = ref["grad1"][k].float() / ref["clip1"]
        out[k] = float(torch.linalg.vector_norm(gp - gr)) / max(size, 1e-30)
    return out


def taken_grads(moments: list, b1: float) -> list:
    """Each step's gradient as the optimizer took it, from the first
    moment after each step (mu_0 = 0)."""
    out, prev = [], None
    for mu in moments:
        out.append({k: (m - (0 if prev is None else b1 * prev[k])) / (1 - b1)
                    for k, m in mu.items()})
        prev = mu
    return out


def update_gap(prog: dict, ref: dict, cfg: dict) -> float:
    """The program's change against the reference's clipped Adam fed the
    program's own gradients from the same start, by the worst leaf."""
    start = {k: ref["params0"][k].float().clone() for k in ref["params0"]}
    adam = ClippedAdam(start, cfg["optimizer"])
    for g in taken_grads(prog["moments"], cfg["optimizer"]["b1"]):
        adam.step(g)
    want = {k: start[k] - ref["params0"][k].float() for k in start}
    return max(leaf_gaps(prog["delta"], want, diff=True).values())


def unchanged(prog: dict) -> dict:
    """``prog``'s readings as a step that returns its state unchanged
    would give them: no moment and no change."""
    def zeros(tree):
        return {k: torch.zeros_like(v) for k, v in tree.items()}

    return dict(prog, grad1=zeros(prog["grad1"]), delta=zeros(prog["delta"]),
                moments=[zeros(m) for m in prog["moments"]])


def judge(found: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) over the numbers that
    ``limits`` compares; a limit without its number is not correct, and
    neither is a cell without limits."""
    table, ok = {}, bool(limits)
    for name in sorted(limits):
        value = found.get(name)
        limit = limits[name]["limit"]
        table[name] = {"value": value, "limit": limit}
        if value is None or limit is None or not value <= limit:
            ok = False
    return ok, table
