"""Model FLOPs of ``TransformerNet`` over pixels: the conv torso, each
block's projections and MLP, the heads, and attention's visible pairs;
a train step is 3x the forward. LayerNorm, GELU, the embedding and the
softmax are left out, and so is the backward's recomputation."""

from . import same_out
from .flash import kernel_work


def conv_flops_per_frame(cfg):
    """FLOPs a frame of conv0 (8x8 stride 4) and conv1 (4x4 stride 2)."""
    h, w, c = cfg["obs_shape"]
    h0, _ = same_out(h, 8, 4)
    w0, _ = same_out(w, 8, 4)
    conv0 = 2 * h0 * w0 * 8 * 8 * c * 32
    h1, _ = same_out(h0, 4, 2)
    w1, _ = same_out(w0, 4, 2)
    conv1 = 2 * h1 * w1 * 4 * 4 * 32 * cfg["d_model"]
    return conv0, conv1


def dense_flops_per_frame(cfg) -> int:
    d = cfg["d_model"]
    block = 2 * d * 3 * d + 2 * d * d + 2 * 2 * d * cfg["mlp_ratio"] * d
    return cfg["num_layers"] * block + 2 * d * cfg["num_actions"] + 2 * d


def attention_flops(cfg, pairs: int) -> int:
    """Forward FLOPs of attention over ``pairs`` visible pairs a head,
    every layer."""
    d_head = cfg["d_model"] // cfg["num_heads"]
    return cfg["num_layers"] * cfg["num_heads"] * 4 * d_head * pairs


def train_flops_per_step(cfg, shapes) -> int:
    frame = sum(conv_flops_per_frame(cfg)) + dense_flops_per_frame(cfg)
    fwd = shapes["frames"] * frame + attention_flops(cfg, shapes["pairs"])
    return 3 * fwd


def attention_work_per_step(cfg, shapes):
    """{kernel: (FLOPs, bytes)} of a train step's flash kernels, every
    layer together (the model attends in f32)."""
    B, T = shapes["batch"], shapes["frames"] // shapes["batch"]
    H = cfg["num_heads"]
    D = cfg["d_model"] // H
    one = kernel_work(B, H, T, D, 4, shapes["pairs"])
    return {k: (cfg["num_layers"] * f, cfg["num_layers"] * b)
            for k, (f, b) in one.items()}

