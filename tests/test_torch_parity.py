"""Port parity: ParityWatch (moolib_tpu_torch.testing.paritywatch),
mirroring the reference's tests/test_parity.py.

The divergence report (first leaf path, dtype, ULP distance), the replay
gate, the environment switch, a seeded train step of the port's A2CNet
replayed bit for bit on the CPU, and the Group allreduce's arrival-order
invariance on the port's Group and Broker. Beyond the reference's cases:
torch leaves (a bf16 tensor has no numpy dtype, so it is compared through
a same-width integer view), and the payload and fold helpers giving the
reference's bytes.
"""

import copy

import numpy as np
import pytest
import torch

from moolib_tpu.testing import paritywatch as ref_pw
from moolib_tpu_torch.testing.paritywatch import (
    ParityViolation,
    ParityWatch,
    allreduce_order_parity,
    flatten_with_paths,
    order_sensitive_payloads,
    parity_enabled,
    tree_fixed_fold,
    ulp_distance,
)


# -- flatten / ulp primitives -------------------------------------------------


def test_flatten_paths_canonical_dict_order():
    tree = {"b": np.ones(2), "a": [np.zeros(1), {"z": np.ones(1)}]}
    paths = [p for p, _ in flatten_with_paths(tree)]
    # dict keys sorted (the reference's canonical order), sequences
    # positional.
    assert paths == ["['a'][0]", "['a'][1]['z']", "['b']"]
    assert paths == [p for p, _ in ref_pw.flatten_with_paths(tree)]


def test_flatten_none_is_empty_subtree():
    assert flatten_with_paths({"a": None, "b": np.ones(1)}) \
        == flatten_with_paths({"b": np.ones(1), "a": None})
    assert len(flatten_with_paths({"a": None})) == 0


def test_ulp_distance_adjacent_and_zero():
    one = np.array([1.0], np.float32)
    nxt = np.nextafter(one, np.float32(2.0))
    assert ulp_distance(one, one) == 0
    assert ulp_distance(one, nxt) == 1
    # -0.0 and +0.0 are adjacent ranks, not equal bits.
    assert ulp_distance(np.array([-0.0], np.float32),
                        np.array([0.0], np.float32)) == 1


def test_ulp_distance_fp16_and_dtype_guard():
    a = np.array([1.0], np.float16)
    assert ulp_distance(a, np.nextafter(a, np.float16(2.0))) == 1
    with pytest.raises(ValueError):
        ulp_distance(a, a.astype(np.float32))
    with pytest.raises(ValueError):
        ulp_distance(np.array([1], np.int32), np.array([1], np.int32))


# -- compare: the divergence report -------------------------------------------


def test_compare_reports_first_divergent_leaf():
    ref = {"params": {"w": np.ones((2, 3), np.float32)},
           "step": np.int64(3)}
    other = {"params": {"w": np.ones((2, 3), np.float32)},
             "step": np.int64(3)}
    other["params"]["w"] = np.nextafter(
        other["params"]["w"], np.float32(2.0)
    )
    with pytest.raises(ParityViolation) as e:
        ParityWatch(label="t", enabled=True).compare(ref, other)
    msg = str(e.value)
    assert "['params']['w']" in msg          # the leaf path
    assert "dtype=float32" in msg
    assert "6/6 element(s) differ" in msg
    assert "max ULP distance 1" in msg
    assert "first at index (0, 0)" in msg
    with pytest.raises(ref_pw.ParityViolation) as r:
        ref_pw.ParityWatch(label="t", enabled=True).compare(ref, other)
    assert msg == str(r.value)  # the reference's report, word for word


def test_compare_structure_and_dtype_and_shape_mismatch():
    w = ParityWatch(enabled=True)
    with pytest.raises(ParityViolation, match="STRUCTURE"):
        w.compare({"a": np.ones(1)}, {"a": np.ones(1), "b": np.ones(1)})
    with pytest.raises(ParityViolation, match="changed dtype"):
        w.compare({"a": np.ones(1, np.float32)},
                  {"a": np.ones(1, np.float64)})
    with pytest.raises(ParityViolation, match="changed shape"):
        w.compare({"a": np.ones(2)}, {"a": np.ones(3)})


def test_compare_int_leaf_has_no_ulp_clause():
    with pytest.raises(ParityViolation) as e:
        ParityWatch(enabled=True).compare(
            np.array([1, 2], np.int32), np.array([1, 3], np.int32)
        )
    assert "ULP" not in str(e.value)
    assert "1/2 element(s) differ" in str(e.value)


def test_compare_distinct_nan_bits_flagged():
    # A bitwise gate must see through NaN == NaN being False AND NaN
    # bit-pattern drift: two different NaN payloads are a divergence.
    a = np.array([np.uint32(0x7FC00000)]).view(np.float32)
    b = np.array([np.uint32(0x7FC00001)]).view(np.float32)
    with pytest.raises(ParityViolation):
        ParityWatch(enabled=True).compare(a, b)
    ParityWatch(enabled=True).compare(a, a.copy())  # same bits: clean


def test_tolerance_opt_out():
    a = np.ones(4, np.float32)
    b = a * np.float32(1.000001)
    with pytest.raises(ParityViolation):
        ParityWatch(enabled=True).compare(a, b)  # bitwise: differs
    ParityWatch(rtol=1e-4, enabled=True).compare(a, b)  # opted out: ok
    with pytest.raises(ParityViolation) as e:
        ParityWatch(rtol=1e-9, atol=0.0, enabled=True).compare(a, b)
    assert "rtol=1e-09" in str(e.value)  # the opt-out stays visible


# -- torch leaves ---------------------------------------------------------------


def test_torch_bf16_leaf_compare_and_ulp_distance():
    """bf16 has no numpy dtype: its bits are viewed as int16, its ULP
    distance computed on that view, its pair printed as floats."""
    a = torch.tensor([1.0, -2.0, 0.5], dtype=torch.bfloat16)
    bits = a.view(torch.int16).clone()
    bits[1] += 1  # one step up in magnitude: the next bf16 below -2
    b = bits.view(torch.bfloat16)
    assert b[1].item() == -2.015625
    assert ulp_distance(a, a) == 0
    assert ulp_distance(a, b) == 1
    # -0.0 and +0.0 adjacent, as for the numpy floats.
    assert ulp_distance(torch.tensor([-0.0], dtype=torch.bfloat16),
                        torch.tensor([0.0], dtype=torch.bfloat16)) == 1
    w = ParityWatch(label="bf16", enabled=True)
    w.compare({"x": a}, {"x": a.clone()})
    with pytest.raises(ParityViolation) as e:
        w.compare({"x": a}, {"x": b})
    msg = str(e.value)
    assert "['x']" in msg and "dtype=bfloat16" in msg
    assert "1/3 element(s) differ" in msg
    assert "first at index (1,): -2.0 vs -2.015625" in msg
    assert "max ULP distance 1" in msg
    with pytest.raises(ParityViolation, match="changed dtype"):
        w.compare({"x": a}, {"x": a.float()})
    with pytest.raises(ValueError):
        ulp_distance(a, a.float())


def test_torch_f32_leaf_reads_like_its_numpy_twin():
    t = torch.ones(2, 3)
    n = np.ones((2, 3), np.float32)
    w = ParityWatch(enabled=True)
    w.compare({"w": t}, {"w": n})  # one dtype name, one set of bits
    with pytest.raises(ParityViolation) as e:
        w.compare({"w": t}, {"w": torch.nextafter(t, torch.tensor(2.0))})
    assert "dtype=float32" in str(e.value)
    assert "6/6 element(s) differ" in str(e.value)


# -- check: the replay gate ---------------------------------------------------


def test_check_runs_twice_and_returns_first():
    calls = []

    def fn():
        calls.append(1)
        return {"x": np.arange(4, dtype=np.float32)}

    out = ParityWatch(enabled=True).check(fn)
    assert len(calls) == 2
    np.testing.assert_array_equal(out["x"], np.arange(4, dtype=np.float32))
    calls.clear()
    ParityWatch(runs=4, enabled=True).check(fn)
    assert len(calls) == 4


def test_check_flags_nondeterministic_callable():
    rng = np.random.default_rng(7)

    def fn():
        return rng.standard_normal(8).astype(np.float32)

    with pytest.raises(ParityViolation, match="run 2 vs run 1"):
        ParityWatch(label="nondet", enabled=True).check(fn)


def test_env_gate_disables_the_window(monkeypatch):
    monkeypatch.setenv("MOOLIB_TPU_PARITYWATCH", "0")
    assert not parity_enabled()
    calls = []

    def fn():
        calls.append(1)
        return np.ones(1)

    ParityWatch().check(fn)  # enabled=None consults the env
    assert len(calls) == 1  # single plain call, nothing compared
    monkeypatch.setenv("MOOLIB_TPU_PARITYWATCH", "1")
    assert parity_enabled()


# -- the seeded A2C update, bitwise -------------------------------------------


def test_seeded_a2c_update_bitwise_replay():
    """One IMPALA/A2C update of the port's A2CNet from a fixed seeded
    state, run twice in one process: bit-identical parameters, optimizer
    state AND metrics. The model is updated in place, so each run starts
    from a copy of the seeded one."""
    from moolib_tpu_torch.learner import (ImpalaConfig,
                                          make_impala_train_step,
                                          make_train_state)
    from moolib_tpu_torch.models import A2CNet

    t_dim, b_dim, f_dim, a_dim = 4, 4, 5, 3
    net0 = A2CNet(a_dim, f_dim, hidden_sizes=(32,), device="cpu",
                  generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    batch = {
        "obs": torch.randn((t_dim + 1, b_dim, f_dim), generator=gen),
        "done": torch.rand((t_dim + 1, b_dim), generator=gen) < 0.1,
        "rewards": torch.randn((t_dim + 1, b_dim), generator=gen),
        "actions": torch.randint(0, a_dim, (t_dim, b_dim), generator=gen),
        "behavior_logits": torch.zeros((t_dim, b_dim, a_dim)),
        "core_state": (),
    }
    step = make_impala_train_step(config=ImpalaConfig())

    def update():
        net = copy.deepcopy(net0)
        opt = torch.optim.SGD(net.parameters(), lr=1e-3, momentum=0.9)
        state, metrics = step(make_train_state(net, opt), batch)
        return {"params": dict(state.model.named_parameters()),
                "opt": {n: opt.state[p] for n, p in
                        state.model.named_parameters()},
                "metrics": metrics}

    out = ParityWatch(label="a2c-update", enabled=True).check(update)
    assert np.isfinite(out["metrics"]["total_loss"].item())
    assert len(flatten_with_paths(out["opt"])) == len(out["params"])
    # And the update did something: params moved.
    moved = any(not torch.equal(p, out["params"][n])
                for n, p in net0.named_parameters())
    assert moved


# -- allreduce arrival-order invariance ---------------------------------------


def test_payloads_and_fixed_fold_are_the_references_bytes():
    for n, size, seed in ((4, 1024, 0), (3, 17, 5), (7, 64, 2)):
        port = order_sensitive_payloads(n, size, seed)
        ref = ref_pw.order_sensitive_payloads(n, size, seed)
        assert [p.tobytes() for p in port] == [r.tobytes() for r in ref]
        assert tree_fixed_fold(port).tobytes() == \
            ref_pw.tree_fixed_fold(ref).tobytes()
        assert tree_fixed_fold(port, np.maximum).tobytes() == \
            ref_pw.tree_fixed_fold(ref, np.maximum).tobytes()


def test_payloads_are_order_sensitive():
    """Meta-check: the payloads the invariance test reduces MUST be
    order-sensitive on the host too, or the cohort check would pass
    vacuously (a symmetric payload hides an order bug)."""
    d = order_sensitive_payloads(4)
    fixed = tree_fixed_fold(d)                   # (d0 + (d1 + d3)) + d2
    arrival = ((d[2] + d[0]) + (d[1] + d[3]))    # one arrival reordering
    assert fixed.tobytes() != arrival.tobytes()
    # ...and ParityWatch.compare is the instrument that sees it.
    with pytest.raises(ParityViolation, match="ULP distance"):
        ParityWatch(label="order", enabled=True).compare(fixed, arrival)


@pytest.mark.integration
def test_allreduce_arrival_order_invariance():
    """A real 4-peer loopback cohort of the port's Group, one reduce
    round per arrival permutation: every peer in every round must get the
    SAME BITS, and those bits must equal the documented fixed fold over
    the actual membership order (allreduce_order_parity compares each
    result against tree_fixed_fold internally and raises on any
    divergence)."""
    payloads = order_sensitive_payloads(4)
    result = allreduce_order_parity(n_peers=4, payloads=payloads)
    assert result.shape == payloads[0].shape
    assert result.dtype == np.float32
    assert np.isfinite(result).all()
    # Sanity anchor independent of ordering: the fp64 sum of the fp32
    # results must be close to the fp64 sum of inputs.
    np.testing.assert_allclose(
        result.astype(np.float64),
        sum(p.astype(np.float64) for p in payloads),
        rtol=1e-4, atol=1e-2,
    )
