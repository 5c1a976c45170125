"""A causal transformer agent over pixels, as the measured
``TransformerNet`` defines it: a conv torso (8x8 stride 4 to 32
channels, relu, 4x4 stride 2 to ``d_model``, relu, both with flax's
"SAME" zero padding, then the mean over space), a learned positional
embedding, ``num_layers`` pre-LayerNorm blocks (eps 1e-6) of causal
multi-head self-attention (no biases on its projections) and a tanh-GELU
MLP, a final LayerNorm, and the policy and baseline heads.

Attention is causal over the unroll and masked to one segment: the
segment of frame t is the number of ``done`` flags up to and including
t. The pixels scaled by 1/255 and the positional embedding are rounded
to ``compute_dtype`` (bf16) once each, as the configuration states;
everything else computes in f32. Attention here is the dense softmax.
"""

import math

import torch
import torch.nn.functional as F

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _same_pads(size, window, stride):
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def param_specs(cfg):
    d, c = cfg["d_model"], cfg["obs_shape"][-1]
    m = cfg["mlp_ratio"] * d
    specs = [("conv0.weight", (32, c, 8, 8), "lecun"),
             ("conv0.bias", (32,), "zeros"),
             ("conv1.weight", (d, 32, 4, 4), "lecun"),
             ("conv1.bias", (d,), "zeros"),
             ("pos_emb.weight", (cfg["max_len"], d), "embedding")]
    for i in range(cfg["num_layers"]):
        b = f"blocks.{i}"
        specs += [(f"{b}.ln1.weight", (d,), "ones"),
                  (f"{b}.ln1.bias", (d,), "zeros"),
                  (f"{b}.attn.qkv.weight", (3 * d, d), "lecun"),
                  (f"{b}.attn.out.weight", (d, d), "lecun"),
                  (f"{b}.ln2.weight", (d,), "ones"),
                  (f"{b}.ln2.bias", (d,), "zeros"),
                  (f"{b}.mlp_in.weight", (m, d), "lecun"),
                  (f"{b}.mlp_in.bias", (m,), "zeros"),
                  (f"{b}.mlp_out.weight", (d, m), "lecun"),
                  (f"{b}.mlp_out.bias", (d,), "zeros")]
    A = cfg["num_actions"]
    specs += [("ln_f.weight", (d,), "ones"), ("ln_f.bias", (d,), "zeros"),
              ("policy.weight", (A, d), "lecun"),
              ("policy.bias", (A,), "zeros"),
              ("baseline.weight", (1, d), "lecun"),
              ("baseline.bias", (1,), "zeros")]
    return specs


def _conv_same(x, w, b, stride, prec):
    kh, kw = w.shape[-2:]
    ph = _same_pads(x.shape[-2], kh, stride)
    pw = _same_pads(x.shape[-1], kw, stride)
    return prec.conv(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, b,
                     stride=stride)


def _attention(q, k, v, seg):
    """Dense causal segment-masked softmax attention, [B, H, T, D]."""
    T = q.shape[-2]
    s = torch.matmul(q / math.sqrt(q.shape[-1]), k.transpose(-1, -2))
    causal = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    visible = (seg[:, None, :, None] == seg[:, None, None, :]) & causal
    s = s.masked_fill(~visible, float("-inf"))
    return torch.matmul(torch.softmax(s, dim=-1), v)


def forward(p, obs, done, cfg, prec):
    T, B = obs.shape[:2]
    d, H = cfg["d_model"], cfg["num_heads"]
    dtype = _DTYPES[cfg["compute_dtype"]]
    x = (obs.reshape(T * B, *obs.shape[2:]).to(dtype) / 255.0).float()
    x = x.permute(0, 3, 1, 2)
    x = F.relu(_conv_same(x, p["conv0.weight"], p["conv0.bias"], 4, prec))
    x = F.relu(_conv_same(x, p["conv1.weight"], p["conv1.bias"], 2, prec))
    x = x.mean(dim=(2, 3)).reshape(T, B, d)
    x = x + p["pos_emb.weight"][:T].to(dtype).float()[:, None, :]
    seg = torch.cumsum(done.to(torch.int64), dim=0).T  # [B, T]
    for i in range(cfg["num_layers"]):
        b = f"blocks.{i}"
        h = F.layer_norm(x, (d,), p[f"{b}.ln1.weight"], p[f"{b}.ln1.bias"],
                         1e-6)
        q, k, v = prec.linear(h, p[f"{b}.attn.qkv.weight"]).chunk(3, dim=-1)

        def heads(t):
            return t.reshape(T, B, H, d // H).permute(1, 2, 0, 3)

        o = _attention(heads(q), heads(k), heads(v), seg)
        o = o.permute(2, 0, 1, 3).reshape(T, B, d)
        x = x + prec.linear(o, p[f"{b}.attn.out.weight"])
        h = F.layer_norm(x, (d,), p[f"{b}.ln2.weight"], p[f"{b}.ln2.bias"],
                         1e-6)
        h = F.gelu(prec.linear(h, p[f"{b}.mlp_in.weight"],
                               p[f"{b}.mlp_in.bias"]), approximate="tanh")
        x = x + prec.linear(h, p[f"{b}.mlp_out.weight"],
                            p[f"{b}.mlp_out.bias"])
    x = F.layer_norm(x, (d,), p["ln_f.weight"], p["ln_f.bias"], 1e-6)
    logits = F.linear(x, p["policy.weight"], p["policy.bias"])
    baseline = F.linear(x, p["baseline.weight"], p["baseline.bias"])
    return logits, baseline.squeeze(-1), x
