"""Model FLOPs of the IMPALA deep network and the bytes of its max-pools;
a frozen copy of ``moolib_tpu_torch/utils/flops.py``'s layer walk.

A MAC counts as 2 FLOPs and a train step as 3x the forward pass (the
forward, then the backward's two products of the forward's shape). The
elementwise layers, V-trace and the optimizer are left out.
"""

import math

from . import same_out


def conv2d_flops(h_out, w_out, kh, kw, c_in, c_out):
    return 2 * h_out * w_out * kh * kw * c_in * c_out


def layer_walk(cfg):
    """(name, FLOPs a frame) of every layer with a product."""
    h, w, c = cfg["obs_shape"]
    for i, ch in enumerate(cfg["channels"]):
        yield f"s{i}.conv", conv2d_flops(h, w, 3, 3, c, ch)
        h, w = math.ceil(h / 2), math.ceil(w / 2)  # "SAME" pool, stride 2
        for j in range(4):
            yield f"s{i}.res{j // 2}.conv{j % 2}", conv2d_flops(h, w, 3, 3,
                                                                ch, ch)
        c = ch
    hidden = cfg["hidden_size"]
    yield "fc", 2 * h * w * c * hidden
    yield "policy", 2 * hidden * cfg["num_actions"]
    yield "baseline", 2 * hidden


def forward_flops_per_frame(cfg) -> int:
    return sum(f for _, f in layer_walk(cfg))


def train_flops_per_step(cfg, shapes) -> int:
    """Model FLOPs of one train step over ``shapes["frames"]`` frames."""
    return 3 * shapes["frames"] * forward_flops_per_frame(cfg)


def pool_bytes_per_step(cfg, shapes) -> int:
    """The bytes the three stride-2 "SAME" max-pools of a train step need:
    the forward reads its padded input and writes its output; the
    backward reads the output's gradient and the input and writes the
    input's gradient."""
    elt = 2 if cfg["compute_dtype"] == "bfloat16" else 4
    n = shapes["frames"]
    h, w, _ = cfg["obs_shape"]
    total = 0
    for ch in cfg["channels"]:
        ho, (lo_h, hi_h) = same_out(h, 3, 2)
        wo, (lo_w, hi_w) = same_out(w, 3, 2)
        inp = n * ch * (h + lo_h + hi_h) * (w + lo_w + hi_w) * elt
        out = n * ch * ho * wo * elt
        total += (inp + out) + (out + inp + inp)
        h, w = ho, wo
    return total
