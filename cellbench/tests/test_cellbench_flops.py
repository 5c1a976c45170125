"""The frozen counts of ``cellbench/flops``, pinned."""

import itertools

import numpy as np
import pytest

from cellbench.flops import impala, peaks, same_out, transformer
from cellbench.flops.flash import bound_seconds, kernel_work, visible_pairs
from cellbench.lookup import Cell
from cellbench.tests.pending import PendingCell


@pytest.fixture(scope="module")
def impala_cfg():
    return Cell("impala_learn_b256").config


@pytest.fixture(scope="module")
def transformer_cfg():
    return PendingCell().config


def test_impala_forward_flops_a_frame(impala_cfg):
    assert impala.forward_flops_per_frame(impala_cfg) == 108_449_280


def test_impala_train_step_flops_at_b256_t20(impala_cfg):
    flops = impala.train_flops_per_step(impala_cfg, {"frames": 21 * 256})
    assert flops == 3 * 21 * 256 * 108_449_280
    assert round(flops / 1e12, 3) == 1.749


def test_transformer_conv_flops_a_frame(transformer_cfg):
    assert transformer.conv_flops_per_frame(transformer_cfg) == (7_225_344,
                                                                15_859_712)


def test_transformer_train_step_flops_count_attention_pairs(transformer_cfg):
    base = transformer.train_flops_per_step(
        transformer_cfg, {"frames": 2048 * 8, "pairs": 0})
    more = transformer.train_flops_per_step(
        transformer_cfg, {"frames": 2048 * 8, "pairs": 1000})
    # 3 x layers x heads x 4·D a pair
    assert more - base == 3 * 2 * 4 * 4 * 32 * 1000


def _pairs_brute(done):
    T, B = done.shape
    seg = np.cumsum(done, axis=0)
    return sum(1 for b in range(B) for i in range(T) for j in range(i + 1)
               if seg[i, b] == seg[j, b])


@pytest.mark.parametrize("seed", range(4))
def test_visible_pairs_against_brute_force(seed):
    rng = np.random.default_rng(seed)
    done = rng.random((37, 5)) < 0.1
    assert visible_pairs(done) == _pairs_brute(done)


def test_visible_pairs_without_resets_is_the_causal_triangle():
    assert visible_pairs(np.zeros((2048, 8), bool)) == 8 * 2048 * 2049 // 2


def test_flash_kernel_work_counts_each_byte_once():
    work = kernel_work(B=2, H=3, T=5, D=4, elt=4, pairs=7)
    x = 2 * 3 * 5 * 4 * 4
    seg, row = 2 * 2 * 5 * 4, 2 * 3 * 5 * 4
    assert work["fwd"] == (4 * 4 * 3 * 7, 4 * x + seg + row)
    assert work["dq"][0] == 6 * 4 * 3 * 7
    assert work["dkdv"][0] == 8 * 4 * 3 * 7
    assert work["dkdv"][1] - work["dq"][1] == x  # one more output


def test_bound_is_the_larger_of_bytes_and_flops():
    assert bound_seconds({"k": (10.0, 4.0)}, 5.0, 1.0) == 4.0
    assert bound_seconds({"k": (10.0, 1.0)}, 5.0, 1.0) == 2.0


def _pool_bytes_brute(cfg, frames):
    elt = 2
    h, w, _ = cfg["obs_shape"]
    total = 0
    for ch in cfg["channels"]:
        ho = -(-h // 2)
        pad = max((ho - 1) * 2 + 3 - h, 0)
        hp = h + pad
        inp = frames * ch * hp * hp * elt
        out = frames * ch * ho * ho * elt
        total += 3 * inp + 2 * out
        h = w = ho
    return total


def test_pool_bytes_against_the_padded_shapes(impala_cfg):
    frames = 21 * 256
    assert impala.pool_bytes_per_step(impala_cfg, {"frames": frames}) == \
        _pool_bytes_brute(impala_cfg, frames)
    # 84 -> 85 padded -> 42, 42 -> 43 -> 21, 21 -> 23 -> 11
    assert [same_out(n, 3, 2) for n in (84, 42, 21)] == [
        (42, (0, 1)), (21, (0, 1)), (11, (1, 1))]


@pytest.mark.parametrize("name,bf16,f32", [
    ("NVIDIA H100 80GB HBM3", 989e12, 165e12),
    ("NVIDIA H100 PCIe", 756e12, 126e12),
])
def test_peaks_by_card_name(name, bf16, f32):
    p = peaks.card_peaks(name)
    assert p["bf16"] == bf16 and p["f32"] == pytest.approx(f32)


def test_unknown_card_has_no_peak():
    assert peaks.card_peaks("NVIDIA A100-SXM4-80GB") is None


def test_same_out_matches_a_brute_force_search():
    for size, window, stride in itertools.product(range(1, 30), (3, 4, 8),
                                                  (1, 2, 4)):
        out, (lo, hi) = same_out(size, window, stride)
        assert out == -(-size // stride)
        assert (size + lo + hi - window) // stride + 1 == out
        assert 0 <= hi - lo <= 1
