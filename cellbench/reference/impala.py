"""IMPALA's deep network (Espeholt et al. 2018, arXiv:1802.01561,
Fig. 3, right) over uint8 frames, no LSTM: three sections of a 3x3
convolution, a 3x3 stride-2 max-pool and two residual blocks (relu,
conv, relu, conv, add), then relu, a dense layer of ``hidden_size`` with
relu, and the policy and baseline heads.

Departures from the paper, as the measured network has them: the
max-pool pads as flax's "SAME" does (asymmetric where the stride does
not divide the size, with -inf), the dense layer flattens each frame in
(h, w, c) order, and the pixels are scaled by 1/255. Parameters are
named as the program names them; the reference computes all in f32.
"""

import torch.nn.functional as F

#: Without a recurrent core, each frame's outputs depend on that frame
#: alone (``step.leaf_terms``).
FRAMES_INDEPENDENT = True


def _same_pads(size, window, stride):
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def param_specs(cfg):
    """[(name, shape, init)]: ``lecun`` (normal over the fan-in) or
    ``zeros``."""
    specs = []
    h, w, c = cfg["obs_shape"]
    for i, ch in enumerate(cfg["channels"]):
        convs = [f"sequences.{i}.conv"] + [
            f"sequences.{i}.res{r}.conv{k}" for r in (0, 1) for k in (0, 1)]
        for j, name in enumerate(convs):
            c_in = c if j == 0 else ch
            specs += [(f"{name}.weight", (ch, c_in, 3, 3), "lecun"),
                      (f"{name}.bias", (ch,), "zeros")]
        h, w, c = -(-h // 2), -(-w // 2), ch
    hidden, A = cfg["hidden_size"], cfg["num_actions"]
    specs += [("fc.weight", (hidden, h * w * c), "lecun"),
              ("fc.bias", (hidden,), "zeros"),
              ("policy.weight", (A, hidden), "lecun"),
              ("policy.bias", (A,), "zeros"),
              ("baseline.weight", (1, hidden), "lecun"),
              ("baseline.bias", (1,), "zeros")]
    return specs


def _pool(x):
    ph = _same_pads(x.shape[-2], 3, 2)
    pw = _same_pads(x.shape[-1], 3, 2)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, 3, 2)


def forward(p, obs, done, cfg, prec):
    """(logits [T, B, A], baseline [T, B], the heads' input [T, B, F]) of
    uint8 ``obs`` [T, B, H, W, C]; ``done`` is unused without a recurrent
    core."""
    T, B = obs.shape[:2]
    x = (obs.reshape(T * B, *obs.shape[2:]).float() / 255.0)
    x = x.permute(0, 3, 1, 2)
    for i in range(len(cfg["channels"])):
        s = f"sequences.{i}"
        x = prec.conv(x, p[f"{s}.conv.weight"], p[f"{s}.conv.bias"],
                      padding=1)
        x = _pool(x)
        for r in (0, 1):
            y = prec.conv(F.relu(x), p[f"{s}.res{r}.conv0.weight"],
                          p[f"{s}.res{r}.conv0.bias"], padding=1)
            y = prec.conv(F.relu(y), p[f"{s}.res{r}.conv1.weight"],
                          p[f"{s}.res{r}.conv1.bias"], padding=1)
            x = x + y
    x = F.relu(x).permute(0, 2, 3, 1).reshape(T * B, -1)
    x = F.relu(prec.linear(x, p["fc.weight"], p["fc.bias"]))
    x = x.reshape(T, B, -1)
    logits = F.linear(x, p["policy.weight"], p["policy.bias"])
    baseline = F.linear(x, p["baseline.weight"], p["baseline.bias"])
    return logits, baseline.squeeze(-1), x
