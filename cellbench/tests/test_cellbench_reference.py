"""The plain reference held to the port at a small size on the CPU: the
same weights and batches give the same forward, loss, gradients and
clipped-Adam steps (the port computing in f32, where the two differ
only in summation order)."""

import math

import pytest
import torch

from cellbench import check, generate, reference, seeds
from cellbench.reference.loss import impala_loss as ref_loss
from cellbench.reference.precision import Precision
from cellbench.reference.step import leaf_terms, run_steps
from cellbench.tests.pending import cell as find_cell

CELLS = ["impala_learn_b256", "transformer_learn_t2048"]


def _small(name, compute_dtype=None):
    cell = find_cell(name)
    cell.traffic = dict(cell.traffic, unroll=3, batch=2, ring=3,
                        done_rate=0.25)
    if compute_dtype is not None and cell.config["family"] == "impala":
        cell.config = dict(cell.config, compute_dtype=compute_dtype)
    return cell


def _inputs(cell, seed=7):
    ref = reference.for_family(cell.config["family"])
    w = seeds.make_weights(ref.param_specs(cell.config), seed, "cpu")
    batches = generate.make_batches(cell.config, cell.traffic, seed, "cpu")
    for b in batches:
        b["core_state"] = ()
    return ref, w, batches


def _port(cell, w):
    model = cell.family().build(cell.config, "cpu")
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(w[n])
    return model


@pytest.mark.parametrize("name", CELLS)
def test_reference_names_every_parameter_of_the_port(name):
    cell = _small(name)
    ref, w, _ = _inputs(cell)
    model = cell.family().build(cell.config, "cpu")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert shapes == {n: tuple(s) for n, s, _ in ref.param_specs(cell.config)}


@pytest.mark.parametrize("name", CELLS)
def test_forward_matches_the_port(name):
    cell = _small(name, "float32")
    ref, w, batches = _inputs(cell)
    model = _port(cell, w)
    b = batches[0]
    with torch.no_grad():
        (logits, baseline), _ = model(b["obs"], b["done"], ())
        r_logits, r_base, _ = ref.forward(w, b["obs"], b["done"], cell.config,
                                       Precision("f32"))
    torch.testing.assert_close(logits, r_logits, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(baseline, r_base, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", CELLS)
def test_loss_and_gradients_match_the_port(name):
    from moolib_tpu_torch import ImpalaConfig, impala_loss

    cell = _small(name, "float32")
    ref, w, batches = _inputs(cell)
    model = _port(cell, w)
    b = batches[1]
    loss_cfg = dict(cell.config["loss"])
    loss_cfg["lambda_"] = loss_cfg.pop("lambda")
    total, _ = impala_loss(model, lambda m, o, d, c: m(o, d, c), b,
                           ImpalaConfig(**loss_cfg))
    grads = torch.autograd.grad(total, list(model.parameters()))
    leaves = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    logits, base, _ = ref.forward(leaves, b["obs"], b["done"], cell.config,
                               Precision("f32"))
    r_total, scale = ref_loss(logits, base, b, cell.config["loss"])
    r_grads = torch.autograd.grad(r_total, list(leaves.values()))
    assert float(total.detach()) == pytest.approx(float(r_total.detach()),
                                                  rel=1e-5, abs=1e-7)
    assert scale >= abs(float(r_total.detach()))
    names = [n for n, _ in model.named_parameters()]
    r_by_name = dict(zip(leaves, r_grads))
    for n, g in zip(names, grads):
        torch.testing.assert_close(g, r_by_name[n], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", CELLS)
def test_three_clipped_adam_steps_match_the_ports_learner(name):
    from cellbench.loops import learn

    cell = _small(name, "float32")
    _, w, batches = _inputs(cell)
    learner = learn.Learner(cell, w, torch.device("cpu"))
    prog = learn.check_steps(learner, w, batches)
    ref = run_steps(cell.config, w, batches[:learn.CHECK_STEPS])
    found = check.numbers(prog, ref, cell.config)
    for key in ("loss_gap", "first_loss_gap", "grad_gap", "change_gap",
                "median_grad_noise", "policy_grad_noise", "update_gap"):
        assert found[key] < 1e-4, (key, found)


def test_clipping_follows_optax():
    from cellbench.reference.adam import ClippedAdam

    opt = {"lr": 1.0, "b1": 0.9, "b2": 0.999, "eps": 1e-8, "eps_root": 0.0,
           "max_norm": 5.0}
    adam = ClippedAdam({"a": torch.zeros(2)}, opt)
    big, factor = adam.clip({"a": torch.tensor([6.0, 8.0])})
    assert torch.allclose(big["a"], torch.tensor([3.0, 4.0]))
    assert factor == pytest.approx(0.5)
    small, factor = adam.clip({"a": torch.tensor([3.0, 0.0])})
    assert torch.equal(small["a"], torch.tensor([3.0, 0.0])) and factor == 1


def test_the_control_rounds_the_trunk_to_fp8():
    x = torch.linspace(-3, 3, 101)
    w = torch.eye(101)
    y = Precision("fp8").linear(x[None], w)
    err = (y - x).abs().max()
    # e4m3 keeps 3 mantissa bits: a relative error up to 2**-4.
    assert 0 < err <= 3 * 2 ** -4
    assert torch.equal(Precision("f32").linear(x[None], w)[0], x)


def test_tf32_control_switches_tf32_on_and_back():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    with Precision("tf32").flags():
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    with Precision("f32").flags():
        assert not torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before


def test_half_batch_fault_drops_half_the_lanes():
    from cellbench.reference.step import half_batch

    cell = _small("impala_learn_b256")
    _, _, batches = _inputs(cell)
    half = half_batch(batches[0])
    assert half["obs"].shape[1] == 1 and half["done"].shape[1] == 1
    assert math.isclose(half["rewards"].numel() * 2,
                        batches[0]["rewards"].numel())


def test_per_frame_terms_of_the_heads_have_their_closed_forms():
    """The heads are linear in each frame's features, so their per-frame
    terms are known: d_f (x) features_f, d_f and the baseline's d_f."""
    cell = _small("impala_learn_b256")
    ref, w, batches = _inputs(cell)
    b = batches[0]
    leaves = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    logits, base, feats = ref.forward(leaves, b["obs"], b["done"],
                                      cell.config, Precision("f32"))
    loss, _ = ref_loss(logits, base, b, cell.config["loss"])
    dl, db = torch.autograd.grad(loss, [logits, base])
    terms = leaf_terms(cell.config, w, b["obs"], feats, dl, db)
    assert set(terms) == set(w)
    f = feats.detach().reshape(-1, feats.shape[-1])
    d = dl.reshape(-1, dl.shape[-1])
    want = {"policy.weight": (f.pow(2).sum(-1) * d.pow(2).sum(-1)).sum(),
            "policy.bias": d.pow(2).sum(),
            "baseline.bias": db.pow(2).sum()}
    for k, v in want.items():
        assert terms[k] == pytest.approx(float(v.sqrt()), rel=1e-5), k
    assert all(v > 0 for v in terms.values())


def test_taken_gradients_come_back_from_the_moments():
    g = [{"a": torch.tensor([1.0, -2.0])}, {"a": torch.tensor([0.5, 3.0])}]
    mu, moments = torch.zeros(2), []
    for step in g:
        mu = 0.9 * mu + 0.1 * step["a"]
        moments.append({"a": mu.clone()})
    for got, want in zip(check.taken_grads(moments, 0.9), g):
        torch.testing.assert_close(got["a"], want["a"])


def test_the_control_keeps_adams_moments_in_bf16_and_fails_the_update():
    """The control's optimizer runs one step below f32: its update, fed
    back its own gradients, lies far from f32 Adam's."""
    cell = _small("impala_learn_b256")
    _, w, batches = _inputs(cell)
    first = batches[:3]
    ref = run_steps(cell.config, w, first)
    sound = check.numbers(ref, ref, cell.config)
    control = check.numbers(run_steps(cell.config, w, first, "fp8"), ref,
                            cell.config)
    assert sound["update_gap"] < 1e-5
    assert control["update_gap"] > 100 * max(sound["update_gap"], 1e-7)
