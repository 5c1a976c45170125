"""The port's FLOP accounting against moolib_tpu.utils.flops, and its own
H100 peak table (NVIDIA's dense bf16 figures, matched on the name
torch.cuda.get_device_name() gives)."""

import pytest

from moolib_tpu.utils import flops as jflops
from moolib_tpu_torch.utils import flops as tflops

VARIANTS = [
    {},
    {"use_lstm": True},
    {"channels": (32, 64, 64), "hidden_size": 512},
    {"height": 64, "width": 48, "in_channels": 16, "num_actions": 18},
]


@pytest.mark.parametrize("kw", VARIANTS, ids=["default", "lstm", "channels",
                                              "geometry"])
def test_layer_walk_matches_reference(kw):
    assert list(tflops.impala_layer_walk(**kw)) == list(
        jflops.impala_layer_walk(**kw))
    assert tflops.impala_forward_flops(**kw) == jflops.impala_forward_flops(
        **kw)
    assert tflops.impala_train_flops(5376, **kw) == jflops.impala_train_flops(
        5376, **kw)


def test_unit_counts_match_reference():
    assert tflops.conv2d_flops(42, 42, 3, 3, 16, 32) == jflops.conv2d_flops(
        42, 42, 3, 3, 16, 32)
    assert tflops.dense_flops(3872, 256) == jflops.dense_flops(3872, 256)
    assert tflops.lstm_flops(256, 256) == jflops.lstm_flops(256, 256)
    assert tflops.TRAIN_FLOPS_MULTIPLIER == jflops.TRAIN_FLOPS_MULTIPLIER


def test_h100_peak_table():
    assert tflops.device_peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert tflops.device_peak_flops("NVIDIA H100 PCIe") == 756e12
    assert tflops.device_peak_flops("NVIDIA A100-SXM4-80GB") is None
    # The TPU table is the reference's, not the port's.
    assert tflops.device_peak_flops("TPU v4") is None
