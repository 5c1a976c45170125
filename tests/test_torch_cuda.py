"""The port's CUDA kernels on the card, held against their plain versions.

These tests need an NVIDIA Hopper card and nvcc; without them they skip.
They import only torch and the port, so they run on a host without JAX:

    pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch
import torch.nn.functional as F

from moolib_tpu_torch import ImpalaNet, TransformerNet, make_grad_step
from moolib_tpu_torch.models.common import same_pads
from moolib_tpu_torch.models.impala import _conv, _max_pool_same
from moolib_tpu_torch.ops import _kernels
from moolib_tpu_torch.ops import attention as tattn

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a")
    return torch.device("cuda")


def _segments(layout, gen, B, Tq, Tk, causal, device):
    """(seg_q, seg_k) int32 for a segment layout of the kernel tests."""
    def episodes(T, every):
        phase = torch.randint(0, every, (B, 1), generator=gen, device=device)
        done = (torch.arange(T, device=device) + phase) % every == 0
        return torch.cumsum(done.int(), dim=1, dtype=torch.int32)

    t = torch.arange(Tq, device=device)
    if layout == "random":
        seg_q = (torch.rand((B, Tq), generator=gen, device=device) < 0.05)
        seg_q = torch.cumsum(seg_q.int(), dim=1, dtype=torch.int32)
        return seg_q, seg_q if causal else torch.zeros_like(seg_q)
    if layout == "resets":
        seg_q = episodes(Tq, 200)
    elif layout == "alternating":
        # Not monotone: every 64-key tile holds both ids, none is skipped.
        seg_q = ((t // 37) % 2).int().expand(B, Tq).contiguous()
    elif layout == "boundaries":
        # At a multiple of 64 and one step either side of one.
        seg_q = ((t >= 128).int() + (t >= 191).int() + (t >= 257).int())
        seg_q = seg_q.expand(B, Tq).contiguous()
    elif layout == "disjoint":
        seg_q = episodes(Tq, 40)
        return seg_q, episodes(Tk, 40) + 1000  # every row fully masked
    elif layout == "tq_ne_tk":
        return episodes(Tq, 70), episodes(Tk, 70)
    else:
        raise ValueError(layout)
    return seg_q, seg_q


LAYOUTS = [  # (layout, Tq, Tk)
    ("random", 100, 100),
    ("resets", 300, 300),
    ("resets", 2047, 2047),
    ("alternating", 300, 300),
    ("boundaries", 320, 320),
    ("disjoint", 100, 100),
    ("tq_ne_tk", 200, 333),
]


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: f"{x[0]}-{x[1]}")
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_matches_plain(card, D, dtype, causal, layout):
    """Segment layouts that the tile skip must get right (monotone resets,
    non-monotone ids, boundaries at and beside a tile edge, kv ids that
    no query shares, Tq != Tk), at ragged lengths (100, 300, 2047 leave
    ragged query and key tiles); in the "random" layout non-causal kv
    segments leave some rows fully masked."""
    name, Tq, Tk = layout
    gen = torch.Generator(device=card).manual_seed(D + Tq)
    B, H = 2, 3
    q = torch.randn((B, H, Tq, D), generator=gen, device=card).to(dtype)
    k, v = (torch.randn((B, H, Tk, D), generator=gen, device=card).to(dtype)
            for _ in range(2))
    seg_q, seg_k = _segments(name, gen, B, Tq, Tk, causal, card)
    o, lse = _kernels.flash_fwd(q, k, v, seg_q, seg_k, causal)
    o_ref, lse_ref = tattn._flash_forward_plain(q, k, v, seg_q, seg_k,
                                                causal)
    torch.cuda.synchronize()
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_ref))
    if name == "disjoint":
        assert torch.isinf(lse).all() and torch.all(o == 0)
    fin = torch.isfinite(lse_ref)
    torch.testing.assert_close(lse[fin], lse_ref[fin], atol=1e-4, rtol=0)
    # f32: summation order only; bf16: one rounding of the f32 result.
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(o.float(), o_ref.float(), atol=1e-4,
                               rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [21, 2048])
def test_flash_kernel_is_repeatable(card, dtype, T):
    """No atomics and a fixed order of tiles: two launches give the same
    bits (T=21 runs the SIMT design, T=2048 the wgmma one)."""
    gen = torch.Generator(device=card).manual_seed(T)
    q, k, v = (torch.randn((2, 4, T, 32), generator=gen, device=card)
               .to(dtype) for _ in range(3))
    seg, _ = _segments("resets", gen, 2, T, T, True, card)
    o1, lse1 = _kernels.flash_fwd(q, k, v, seg, seg, True)
    o2, lse2 = _kernels.flash_fwd(q, k, v, seg, seg, True)
    assert torch.equal(o1, o2) and torch.equal(lse1, lse2)


def test_flash_wrapper_refuses_misaligned_rows(card):
    """K and V rows come by 16-byte bulk copies: an input that starts off
    a 16-byte boundary is refused before any launch."""
    q = torch.zeros(1 * 1 * 128 * 32 + 1, device=card)[1:].view(1, 1, 128, 32)
    seg = torch.zeros((1, 128), dtype=torch.int32, device=card)
    before = _kernels.FLASH_FWD.launches
    with pytest.raises(ValueError, match="aligned"):
        _kernels.flash_fwd(q, q, q, seg, seg, True)
    assert _kernels.FLASH_FWD.launches == before


@pytest.mark.parametrize("T", [64, 300])
def test_auto_dispatch_launches_the_kernel(card, T):
    """Any T, ragged ones (300 is no multiple of the reference's 256
    blocks) and explicit block knobs included, reaches the kernel."""
    gen = torch.Generator(device=card).manual_seed(0)
    q, k, v = (torch.randn((2, 4, T, 32), generator=gen, device=card)
               for _ in range(3))
    before = _kernels.FLASH_FWD.launches
    out = tattn.attention(q, k, v, backend="auto", causal=True,
                          block_q=256, block_k=256)
    assert _kernels.FLASH_FWD.launches == before + 1
    torch.testing.assert_close(
        out, tattn.dense_attention(q, k, v, causal=True), atol=1e-4, rtol=0
    )


def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    q = torch.zeros((1, 1, 8, 48), device=card)
    seg = torch.zeros((1, 8), dtype=torch.int32, device=card)
    stat = torch.zeros((1, 1, 8), device=card)
    with pytest.raises(ValueError, match="head dims"):
        _kernels.flash_fwd(q, q, q, seg, seg, True)
    with pytest.raises(ValueError, match="head dims"):
        _kernels.flash_bwd_dq(q, q, q, seg, seg, stat, stat, q, True)
    q = torch.zeros((1, 1, 8, 32), device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        _kernels.flash_fwd(q, q, q, seg, seg, True)
    q = torch.zeros((1, 1, 8, 32), device=card)
    with pytest.raises(ValueError, match="lse"):
        _kernels.flash_bwd_dkdv(q, q, q, seg, seg, stat[..., :4], stat, q,
                                True)
    q = torch.zeros((1, 1, 65, 32), device=card)
    seg = torch.zeros((1, 65), dtype=torch.int32, device=card)
    stat = torch.zeros((1, 1, 65), device=card)
    with pytest.raises(ValueError, match="Tq, Tk <= 64"):
        _kernels.flash_bwd_tile(q, q, q, seg, seg, q, stat, q, True)


@pytest.mark.parametrize("T", [21, 300])
def test_auto_backward_launches_every_kernel_once(card, T):
    """autograd through attention(backend="auto") on the model's causal
    segmented path against dense attention's autograd: at T = 21 one
    fused backward launch (no dQ or dK/dV kernel), at T = 300 the dQ and
    dK/dV kernels once each."""
    gen = torch.Generator(device=card).manual_seed(1)
    B, H, D = 4, 4, 32
    q, k, v = (torch.randn((B, H, T, D), generator=gen, device=card)
               .requires_grad_() for _ in range(3))
    seg = torch.zeros((B, T), dtype=torch.int32, device=card)
    seg[:, 9:] = 1
    seg[:, 150:] = 2
    w = torch.randn((B, H, T, D), generator=gen, device=card)
    before = [kern.launches for kern in _kernels.KERNELS]
    out = tattn.attention(q, k, v, backend="auto", causal=True,
                          segment_ids=seg)
    got = torch.autograd.grad((out * w).sum(), (q, k, v))
    # flash_fwd, flash_bwd_dq, flash_bwd_dkdv, flash_bwd_tile
    want_launches = [1, 0, 0, 1] if T <= 64 else [1, 1, 1, 0]
    assert [kern.launches - n for kern, n in
            zip(_kernels.KERNELS, before)] == want_launches
    ref = tattn.dense_attention(q, k, v, causal=True, segment_ids=seg)
    want = torch.autograd.grad((ref * w).sum(), (q, k, v))
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, atol=1e-4, rtol=0)


# The forward's layouts (past one tile: the wgmma kernels) and layouts of
# at most one tile (the fused kernel); T = 21 is the train step's.
BACKWARD_LAYOUTS = LAYOUTS + [
    ("random", 21, 21),
    ("resets", 64, 64),
    ("alternating", 50, 50),
    ("disjoint", 40, 40),
    ("tq_ne_tk", 21, 60),
]


def _backward_case(card, D, dtype, causal, layout, seed):
    name, Tq, Tk = layout
    gen = torch.Generator(device=card).manual_seed(seed)
    B, H = 2, 3
    q, do = (torch.randn((B, H, Tq, D), generator=gen, device=card)
             .to(dtype) for _ in range(2))
    k, v = (torch.randn((B, H, Tk, D), generator=gen, device=card).to(dtype)
            for _ in range(2))
    seg_q, seg_k = _segments(name, gen, B, Tq, Tk, causal, card)
    o, lse = _kernels.flash_fwd(q, k, v, seg_q, seg_k, causal)
    return q, k, v, seg_q, seg_k, o, lse, do


@pytest.mark.parametrize("layout", BACKWARD_LAYOUTS,
                         ids=lambda x: f"{x[0]}-{x[1]}-{x[2]}")
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_kernels_match_plain(card, D, dtype, causal, layout):
    """Both backward designs (the fused kernel at Tq, Tk <= 64, the dQ and
    dK/dV kernels past it), each chosen by shape through _flash_backward,
    against the plain backward over the forward's segment layouts (ragged
    tiles on both sides; fully masked rows in "random" non-causal and
    "disjoint"). Tolerance: f32, summation order (1e-4 of each
    gradient's largest entry); bf16 gradients, one rounding of the f32
    result on top (2**-7 relative); dq exactly 0 on fully masked rows."""
    args = _backward_case(card, D, dtype, causal, layout, D + layout[1])
    q, k, v, seg_q, seg_k, o, lse, do = args
    design = _kernels.flash_bwd_design(q.shape[2], k.shape[2])
    kerns = ([_kernels.FLASH_BWD_TILE] if design == "tile"
             else [_kernels.FLASH_BWD_DQ, _kernels.FLASH_BWD_DKDV])
    before = [kern.launches for kern in kerns]
    got = tattn._flash_backward(*args, causal)
    torch.cuda.synchronize()
    assert [kern.launches - n for kern, n in zip(kerns, before)] == [1] * len(
        kerns)
    want = tattn._flash_backward_plain(*args, causal)
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    for g, ref in zip(got, want):
        assert g.dtype == dtype
        scale = float(ref.float().abs().max())
        torch.testing.assert_close(g.float(), ref.float(),
                                   atol=1e-4 * scale, rtol=rtol)
    masked = torch.isinf(lse).reshape(q.shape[:3])
    if layout[0] == "disjoint":
        assert masked.all()
    assert torch.all(got[0][masked] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [21, 2048])
def test_flash_backward_is_repeatable(card, dtype, T):
    """Every output row has one owner (no atomics) and tiles run in a
    fixed order: two backward passes give the same bits (T = 21 runs the
    fused kernel, T = 2048 the wgmma kernels)."""
    args = _backward_case(card, 32, dtype, True, ("resets", T, T), T)
    first = tattn._flash_backward(*args, True)
    second = tattn._flash_backward(*args, True)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# The main paths' shapes [B, H, T, D]: the act step (32 envs x BATCH 4 at
# T=1) and the learn batch (32 envs, T+1 = 21).
PARITY_SHAPES = {"act": (128, 4, 1, 32), "train": (32, 4, 21, 32)}


def _kernel_call(name, shape, device):
    """A seeded call of kernel ``name``'s wrapper at ``shape`` (resets
    every 200 steps, causal), returning its outputs."""
    B, H, T, D = shape
    gen = torch.Generator(device=device).manual_seed(T)
    q, k, v, do = (torch.randn(shape, generator=gen, device=device)
                   for _ in range(4))
    seg, _ = _segments("resets", gen, B, T, T, True, device)
    o, lse = _kernels.flash_fwd(q, k, v, seg, seg, True)
    if name == "flash_fwd":
        return lambda: _kernels.flash_fwd(q, k, v, seg, seg, True)
    if name == "flash_bwd_tile":
        return lambda: _kernels.flash_bwd_tile(q, k, v, seg, seg, o, lse, do,
                                               True)
    delta = tattn._flash_delta(o, do)
    fn = getattr(_kernels, name)
    return lambda: fn(q, k, v, seg, seg, lse, delta, do, True)


@pytest.mark.parametrize("shape", sorted(PARITY_SHAPES))
@pytest.mark.parametrize("name", ["flash_fwd", "flash_bwd_tile",
                                  "flash_bwd_dq", "flash_bwd_dkdv"])
def test_kernel_replays_bitwise_under_paritywatch(card, name, shape):
    """Each kernel's wrapper, three calls on one seeded input at a main
    path's shape, under ParityWatch: the same bits every time, and each
    call one launch."""
    from moolib_tpu_torch.testing import ParityWatch

    call = _kernel_call(name, PARITY_SHAPES[shape], card)
    kern = getattr(_kernels, name.upper())
    before = kern.launches
    ParityWatch(runs=3, enabled=True, label=f"{name} {shape}").check(call)
    assert kern.launches - before == 3


def test_flash_backward_wrappers_refuse_misaligned_rows(card):
    """Rows come by 16-byte bulk copies (float4 loads in the fused
    kernel): an input that starts off a 16-byte boundary is refused
    before any launch."""
    for T in (21, 128):
        x = torch.zeros(T * 32 + 1, device=card)[1:].view(1, 1, T, 32)
        seg = torch.zeros((1, T), dtype=torch.int32, device=card)
        stat = torch.zeros((1, 1, T), device=card)
        before = [kern.launches for kern in _kernels.KERNELS]
        with pytest.raises(ValueError, match="aligned"):
            _kernels.flash_bwd_dq(x, x, x, seg, seg, stat, stat, x, True)
        with pytest.raises(ValueError, match="aligned"):
            _kernels.flash_bwd_dkdv(x, x, x, seg, seg, stat, stat, x, True)
        if T <= 64:
            with pytest.raises(ValueError, match="aligned"):
                _kernels.flash_bwd_tile(x, x, x, seg, seg, x, stat, x, True)
        assert [kern.launches for kern in _kernels.KERNELS] == before


def test_conv_torso_backward_is_f32_not_tf32(card):
    """The grad step holds cuDNN's TF32 off through the backward too: the
    conv weights' gradients on the card agree with the CPU's to 1e-5 of
    their largest entry, which TF32 (10 mantissa bits) would not."""
    gen = torch.Generator(device=card).manual_seed(2)
    T, B, A = 6, 4, 6
    net = TransformerNet(A, (84, 84, 4), d_model=64, num_layers=1,
                         num_heads=2, device=card, generator=gen)
    cpu = TransformerNet(A, (84, 84, 4), d_model=64, num_layers=1,
                         num_heads=2, attention_backend="dense", device="cpu")
    cpu.load_state_dict(net.state_dict())
    cg = torch.Generator().manual_seed(3)
    batch = {
        "obs": torch.randint(0, 256, (T + 1, B, 84, 84, 4), generator=cg,
                             dtype=torch.uint8),
        "done": torch.zeros((T + 1, B), dtype=torch.bool),
        "rewards": torch.randn((T + 1, B), generator=cg),
        "actions": torch.randint(0, A, (T, B), generator=cg),
        "behavior_logits": torch.randn((T, B, A), generator=cg),
        "core_state": (),
    }
    on_card = {k: v.to(card) if torch.is_tensor(v) else v
               for k, v in batch.items()}
    prev = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
        got, _ = make_grad_step()(net, on_card)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    want, _ = make_grad_step()(cpu, batch)
    for name in ("conv0.weight", "conv1.weight"):
        scale = float(want[name].abs().max())
        torch.testing.assert_close(got[name].cpu(), want[name],
                                   atol=1e-5 * scale, rtol=0)


def test_train_step_replays_bitwise_on_the_card(card):
    """A seeded IMPALA train step of the pixel TransformerNet, three runs
    from one state under ParityWatch: parameters, RMSprop's state and the
    metrics bit for bit. cuDNN's weight-gradient algorithm of the conv
    torso summed in another order on every call until the learner held
    its deterministic algorithms on."""
    import copy

    from moolib_tpu_torch import ClippedRMSprop, make_impala_train_step
    from moolib_tpu_torch.learner import make_train_state, train_state_to_host
    from moolib_tpu_torch.testing import ParityWatch

    gen = torch.Generator(device=card).manual_seed(2)
    T, B, A = 6, 16, 6
    net0 = TransformerNet(A, (84, 84, 4), device=card, generator=gen)
    batch = {
        "obs": torch.randint(0, 256, (T + 1, B, 84, 84, 4), generator=gen,
                             device=card, dtype=torch.uint8),
        "done": torch.zeros((T + 1, B), dtype=torch.bool, device=card),
        "rewards": torch.randn((T + 1, B), generator=gen, device=card),
        "actions": torch.randint(0, A, (T, B), generator=gen, device=card),
        "behavior_logits": torch.randn((T, B, A), generator=gen,
                                       device=card),
        "core_state": (),
    }
    step = make_impala_train_step()

    def update():
        net = copy.deepcopy(net0)
        opt = ClippedRMSprop(net.parameters(), 6e-4, max_norm=40.0)
        state, metrics = step(make_train_state(net, opt), batch)
        return {"state": train_state_to_host(state), "metrics": metrics}

    ParityWatch(runs=3, enabled=True, label="train step").check(update)


def _tie_margin(net, obs) -> float:
    """The smallest gap, relative to its layer's largest value, in the
    f32 forward of ``net`` (on the CPU) between a max-pool window's two
    largest inputs, or between a relu's input and zero. Below the card's
    and the CPU's rounding differences (~1e-7 of a layer's scale), the
    two may pick another window maximum or relu side, and a position's
    gradient goes elsewhere: a discrete difference, not summation
    order."""
    T, B = obs.shape[:2]
    x = (obs.float() / 255.0).reshape(T * B, *obs.shape[2:])
    x = x.permute(0, 3, 1, 2)
    gaps = []

    def relu_gap(v):
        gaps.append(float(v.abs().min()) / float(v.abs().max()))

    with torch.no_grad():
        for seq in net.sequences:
            y = _conv(x, seq.conv, torch.float32)
            ph = same_pads(y.shape[-2], 3, 2)
            pw = same_pads(y.shape[-1], 3, 2)
            win = F.pad(y, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
            win = win.unfold(2, 3, 2).unfold(3, 3, 2).flatten(-2)
            top2 = win.topk(2).values
            gaps.append(float((top2[..., 0] - top2[..., 1]).min())
                        / float(y.abs().max()))
            x = _max_pool_same(y)
            for block in (seq.res0, seq.res1):
                relu_gap(x)
                h = _conv(F.relu(x), block.conv0, torch.float32)
                relu_gap(h)
                x = x + _conv(F.relu(h), block.conv1, torch.float32)
        relu_gap(x)
        flat = F.relu(x).permute(0, 2, 3, 1).reshape(T * B, -1)
        relu_gap(F.linear(flat, net.fc.weight, net.fc.bias))
    return min(gaps)


def _impala_case(card, use_lstm):
    """A CPU ImpalaNet with random biases, its copy on the card, and a
    learn batch [T+1=3, B=2] of 24x24x4 frames (small, so that a seed
    without near ties exists: see _tie_margin), on the CPU."""
    T, B, A = 2, 2, 6
    for seed in range(40):
        gen = torch.Generator().manual_seed(seed)
        cpu = ImpalaNet(A, (24, 24, 4), use_lstm=use_lstm, device="cpu",
                        generator=gen)
        with torch.no_grad():
            for name, p in cpu.named_parameters():
                if name.endswith("bias") or name.endswith("bias_hh"):
                    p.normal_(0.0, 0.1, generator=gen)
        obs = torch.randint(0, 256, (T + 1, B, 24, 24, 4), generator=gen,
                            dtype=torch.uint8)
        if _tie_margin(cpu, obs) > 2e-6:
            break
    else:
        pytest.fail("no seed of 40 without near ties")
    net = ImpalaNet(A, (24, 24, 4), use_lstm=use_lstm, device=card)
    net.load_state_dict(cpu.state_dict())
    done = torch.zeros((T + 1, B), dtype=torch.bool)
    done[1, 0] = True
    batch = {
        "obs": obs, "done": done,
        "rewards": torch.randn((T + 1, B), generator=gen),
        "actions": torch.randint(0, A, (T, B), generator=gen),
        "behavior_logits": torch.randn((T, B, A), generator=gen),
        "core_state": (tuple(torch.randn((B, 256), generator=gen)
                             for _ in range(2)) if use_lstm else ()),
    }
    return cpu, net, batch


def _to(batch, device):
    return {k: (v.to(device) if torch.is_tensor(v) else
                tuple(t.to(device) for t in v)) for k, v in batch.items()}


@pytest.mark.parametrize("use_lstm", [False, True])
def test_impala_net_f32_forward_and_gradients_match_the_cpu(card, use_lstm):
    """f32 ImpalaNet on the card, with cuDNN's TF32 switch left at
    PyTorch's default (on): the model holds it off in the forward and the
    grad step through the backward, so the forward and one step's
    gradients agree with the CPU's to 1e-5 of each tensor's largest entry
    (TF32's 10 mantissa bits would give ~1e-3)."""
    cpu, net, batch = _impala_case(card, use_lstm)
    on_card = _to(batch, card)
    prev = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        with torch.no_grad():
            got = net(on_card["obs"], on_card["done"], on_card["core_state"])
        grads, _ = make_grad_step()(net, on_card)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    with torch.no_grad():
        want = cpu(batch["obs"], batch["done"], batch["core_state"])
    want_grads, _ = make_grad_step()(cpu, batch)
    for g, w in zip(torch.utils._pytree.tree_leaves(got),
                    torch.utils._pytree.tree_leaves(want)):
        torch.testing.assert_close(g.cpu(), w, rtol=0,
                                   atol=1e-5 * float(w.abs().max()))
    for name, w in want_grads.items():
        torch.testing.assert_close(grads[name].cpu(), w, rtol=0,
                                   atol=1e-5 * float(w.abs().max()),
                                   msg=lambda m: f"{name}: {m}")


def test_impala_net_bf16_forward_matches_the_cpu(card):
    """bf16 compute dtype at full frame size: cuDNN's bf16 products
    against the CPU's, each rounded to bf16 after its own summation
    order, within 2e-2 of the largest entry (the tolerance the CPU tests
    hold the port's bf16 forward to against the reference)."""
    gen = torch.Generator().manual_seed(0)
    cpu = ImpalaNet(6, use_lstm=True, compute_dtype=torch.bfloat16,
                    device="cpu", generator=gen)
    net = ImpalaNet(6, use_lstm=True, compute_dtype=torch.bfloat16,
                    device=card)
    net.load_state_dict(cpu.state_dict())
    obs = torch.randint(0, 256, (3, 2, 84, 84, 4), generator=gen,
                        dtype=torch.uint8)
    done = torch.tensor([[False, False], [True, False], [False, True]])
    state = tuple(torch.randn((2, 256), generator=gen) for _ in range(2))
    with torch.no_grad():
        got = net(obs.to(card), done.to(card), tuple(s.to(card)
                                                     for s in state))
        want = cpu(obs, done, state)
    for g, w in zip(torch.utils._pytree.tree_leaves(got),
                    torch.utils._pytree.tree_leaves(want)):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g.cpu(), w, rtol=0,
                                   atol=2e-2 * float(w.abs().max()))


def test_rpc_handlers_get_cuda_tensors_and_reply_with_them(card):
    """A batched define(..., device="cuda") and a Replica(rpc, ...,
    device="cuda") both receive CUDA tensors; their CUDA-tensor replies
    reach the CPU peer as host arrays equal to the handlers' results."""
    import numpy as np

    from moolib_tpu_torch import Replica
    from moolib_tpu_torch.rpc import Rpc

    host, client = Rpc("cuda-host"), Rpc("cuda-client")
    seen, results = [], {}

    def batched(x):
        seen.append(x.device.type)
        out = x * 2 + 1
        for row in out:
            results[float(row[0])] = row.cpu().numpy()
        return out

    def model(scale, batch):
        seen.append(batch["x"].device.type)
        return {"y": batch["x"].float() * scale}

    rep = Replica(host, model, 3.0, service="card", batch_size=4,
                  device="cuda")
    try:
        host.define("twice", batched, batch_size=4, device="cuda")
        host.listen("127.0.0.1:0")
        client.connect(host.debug_info()["listen"][0])
        xs = [np.full(5, i, np.float32) for i in range(6)]
        futs = [client.async_("cuda-host", "twice", x) for x in xs]
        for x, fut in zip(xs, futs):
            got = fut.result(timeout=60)
            assert isinstance(got, np.ndarray)
            np.testing.assert_array_equal(got, results[float(x[0] * 2 + 1)])
            np.testing.assert_array_equal(got, x * 2 + 1)
        futs = [client.call_with_deadline("cuda-host", "card.infer", 60.0,
                                          {"x": np.arange(4) + i})
                for i in range(3)]
        for i, fut in enumerate(futs):
            np.testing.assert_array_equal(fut.result(timeout=60)["y"],
                                          (np.arange(4) + i) * 3.0)
        assert seen and set(seen) == {"cuda"}, seen
    finally:
        rep.close()
        client.close()
        host.close()


def test_stage_host_async_copy_is_exact(card):
    """Every CUDA leaf becomes a HostStaged whose pinned host tensor, once
    its event completes, holds the leaf's bits; host leaves pass through."""
    from moolib_tpu_torch.utils import HostStaged, stage_host_async

    gen = torch.Generator(device="cuda").manual_seed(0)
    tree = {"w": torch.randn((64, 33), generator=gen, device="cuda"),
            "h": torch.randn(1000, generator=gen,
                             device="cuda").to(torch.bfloat16),
            "t": torch.randn((8, 6), generator=gen, device="cuda").t(),
            "i": torch.arange(17, device="cuda"),
            "cpu": torch.ones(3), "n": 5}
    staged = stage_host_async(tree)
    assert staged["cpu"] is tree["cpu"] and staged["n"] == 5
    for k in ("w", "h", "t", "i"):
        s = staged[k]
        assert isinstance(s, HostStaged) and s.host.is_pinned()
        got = s.result()
        assert s.is_ready()
        assert got.dtype == tree[k].dtype and got.shape == tree[k].shape
        assert torch.equal(got, tree[k].cpu()), k


def _broker_pump(ref):
    """Module-level thread target holding only a weakref between ticks."""
    import time

    while True:
        self = ref()
        if self is None or self.stop.is_set():
            return
        self.broker.update()
        del self
        time.sleep(0.05)


class _PortCluster:
    """A port Broker and port Accumulators, in this process."""

    def __init__(self):
        import threading
        import weakref

        from moolib_tpu_torch.rpc import Rpc
        from moolib_tpu_torch.rpc.broker import Broker

        self.broker_rpc = Rpc("broker")
        self.broker_rpc.listen("127.0.0.1:0")
        self.addr = self.broker_rpc.debug_info()["listen"][0]
        self.broker = Broker(self.broker_rpc)
        self.stop = threading.Event()
        self._closed = False
        self.thread = threading.Thread(
            target=_broker_pump, args=(weakref.ref(self),), daemon=True)
        self.thread.start()
        self.peers = []

    def accumulator(self, name, **kw):
        from moolib_tpu_torch.parallel import Accumulator
        from moolib_tpu_torch.rpc import Rpc

        rpc = Rpc(name)
        rpc.listen("127.0.0.1:0")
        rpc.connect(self.addr)
        acc = Accumulator(rpc, **kw)
        self.peers.append((rpc, acc))
        return acc

    def pump(self, until, timeout=30.0):
        import time

        deadline = time.monotonic() + timeout
        while not until():
            assert time.monotonic() < deadline, [
                a.get_gradient_stats() for _, a in self.peers]
            for _, a in self.peers:
                a.update()
            time.sleep(0.005)

    def close(self):
        if self._closed:
            return
        self._closed = True
        self.stop.set()
        self.thread.join(timeout=5)
        assert not self.thread.is_alive()
        for rpc, acc in self.peers:
            acc.close()
            rpc.close()
        self.broker_rpc.close()


def test_reduce_gradients_of_card_tensors_never_waits_for_the_card(card):
    """reduce_gradients stages card gradients and returns under CUDA's
    sync debug mode "error" (any wait for the card would raise); the
    reduced mean is the host's exact division of the staged bits."""
    cluster = _PortCluster()
    try:
        acc = cluster.accumulator("card-peer", virtual_batch_size=3)
        cluster.pump(lambda: acc.connected() and acc.wants_gradients())
        gen = torch.Generator(device="cuda").manual_seed(1)
        grads = {"w": torch.randn((256, 128), generator=gen, device="cuda"),
                 "h": torch.randn(512, generator=gen,
                                  device="cuda").to(torch.bfloat16)}
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(3):  # the third call compacts landed parts
                acc.reduce_gradients({k: v * 1.0 for k, v in grads.items()},
                                     batch_size=1)
        finally:
            torch.cuda.set_sync_debug_mode(prev)
        cluster.pump(acc.has_gradients)
        mean, count = acc.result_gradients()
        assert count == 3
        w = grads["w"].cpu().numpy()
        assert mean["w"].tobytes() == (((w + w) + w) / 3).tobytes()
        h = grads["h"].cpu()
        assert torch.equal(mean["h"], ((h + h) + h) / 3)
    finally:
        cluster.close()


def test_train_state_round_trips_through_get_state_and_set_state(card):
    """A card TrainState after one step (parameters and ClippedRMSprop's
    nu) handed from a leader to a joiner: bit for bit on the joiner's
    card."""
    import threading

    from moolib_tpu_torch import (ClippedRMSprop, make_impala_train_step,
                                  make_train_state)
    from moolib_tpu_torch.learner import load_train_state, train_state_to_host

    def train_state(seed):
        net = TransformerNet(6, (5,), d_model=64, num_layers=1, num_heads=2,
                             device="cuda",
                             generator=torch.Generator(
                                 device="cuda").manual_seed(seed))
        return make_train_state(net, ClippedRMSprop(
            net.parameters(), 6e-4, decay=0.99, eps=0.01, max_norm=40.0))

    gen = torch.Generator(device="cuda").manual_seed(3)
    T, B = 4, 2
    batch = {"obs": torch.randn((T + 1, B, 5), generator=gen, device="cuda"),
             "done": torch.rand((T + 1, B), generator=gen,
                                device="cuda") < 0.25,
             "rewards": torch.randn((T + 1, B), generator=gen,
                                    device="cuda"),
             "actions": torch.randint(0, 6, (T, B), generator=gen,
                                      device="cuda"),
             "behavior_logits": torch.randn((T, B, 6), generator=gen,
                                            device="cuda"),
             "core_state": ()}
    lead, _ = make_impala_train_step()(train_state(0), batch)
    held = {"joiner": train_state(1)}
    lock = threading.Lock()

    def get_state():
        with lock:
            return train_state_to_host(lead)

    def set_state(payload):
        with lock:
            held["joiner"] = load_train_state(held["joiner"], payload)

    cluster = _PortCluster()
    try:
        leader = cluster.accumulator("lead", virtual_batch_size=2,
                                     get_state=get_state)
        leader.set_model_version(1)
        joiner = cluster.accumulator("join", virtual_batch_size=2,
                                     set_state=set_state)
        cluster.pump(lambda: joiner.connected()
                     and joiner.get_gradient_stats()["synced"])
    finally:
        cluster.close()
    got = held["joiner"]
    assert got.step == 1
    for (n, a), b in zip(lead.model.named_parameters(),
                         got.model.parameters()):
        assert b.device.type == "cuda" and torch.equal(a, b), n
        nu = got.optimizer.state[b]["nu"]
        assert nu.device.type == "cuda", n
        assert torch.equal(lead.optimizer.state[a]["nu"], nu), n


def _synthetic_env_fn(episode_length):
    import functools

    from moolib_tpu_torch.examples.envs import create_synthetic_atari

    return functools.partial(create_synthetic_atari, num_actions=6,
                             episode_length=episode_length)


def test_envpool_stages_steps_onto_the_card(card):
    """EnvPool(device="cuda"): every field of every step on the card,
    equal bit for bit to a host pool's numpy views of the same envs."""
    import numpy as np

    from moolib_tpu_torch import EnvPool

    env_fn = _synthetic_env_fn(3)  # a reset every third step
    with EnvPool(env_fn, num_processes=2, batch_size=8) as host, \
            EnvPool(env_fn, num_processes=2, batch_size=8,
                    device="cuda") as dev:
        for step in range(5):
            actions = (np.arange(8) + step) % 6
            want = {k: np.array(v) for k, v in
                    host.step(step % 2, actions).result(60).items()}
            got = dev.step(step % 2, actions).result(60)
            assert sorted(got) == sorted(want)
            for k, v in got.items():
                assert v.device.type == "cuda", k
                assert np.array_equal(v.cpu().numpy(), want[k]), (step, k)


def test_experiment_loop_trains_the_transformer_through_the_kernels(card):
    """train() of the experiment with model=transformer on the card, at a
    small size: updates with finite losses, and the act and grad steps
    went through the flash forward and the fused backward."""
    import math

    from moolib_tpu_torch.examples.vtrace.experiment import (VtraceConfig,
                                                             train)

    for kern in _kernels.KERNELS:
        kern.launches = 0
    cfg = VtraceConfig(env="synthetic", model="transformer", num_actions=4,
                       episode_length=40, total_steps=640,
                       actor_batch_size=4, learn_batch_size=4,
                       virtual_batch_size=4, num_actor_processes=2,
                       unroll_length=4, log_interval_steps=320,
                       stats_interval=1e9, seed=0)
    logs = train(cfg, log_fn=lambda *_: None)
    launches = {kern.name: kern.launches for kern in _kernels.KERNELS}
    assert logs and logs[-1]["updates"] >= 1
    assert math.isfinite(logs[-1]["total_loss"])
    assert launches["flash_fwd"] > 0 and launches["flash_bwd_tile"] > 0, \
        launches


# -- the MoE transformer and the NetHack agent ---------------------------------


def test_moe_transformer_on_the_card_matches_the_cpu(card):
    """TransformerNet(mlp="moe") at a small size on the card against the
    CPU: the router probabilities at the f32 tolerance, the top-2 sets
    of the tokens whose two best experts do not nearly tie equal; then,
    with the card's routing fed to the CPU (moe.RouteReplay), the aux and
    one IMPALA step's gradients (the aux folded in) at the f32
    tolerances."""
    from moolib_tpu_torch.parallel import moe

    gen = torch.Generator().manual_seed(0)
    kw = dict(d_model=32, num_layers=2, num_heads=1, num_experts=4,
              mlp="moe", attention_backend="auto")  # head dim 32
    cpu = TransformerNet(6, (5,), device="cpu", generator=gen, **kw)
    net = TransformerNet(6, (5,), device=card, **kw)
    net.load_state_dict(cpu.state_dict())
    T, B = 21, 4
    batch = {
        "obs": torch.randn((T + 1, B, 5), generator=gen),
        "done": torch.rand((T + 1, B), generator=gen) < 0.1,
        "rewards": torch.randn((T + 1, B), generator=gen),
        "actions": torch.randint(0, 6, (T, B), generator=gen),
        "behavior_logits": torch.randn((T, B, 6), generator=gen),
        "core_state": (),
    }

    def apply(model, obs, done, core_state):
        return model(obs, done, core_state, return_aux=True)

    routes = moe.RouteReplay()
    with routes.record():
        grads, metrics = make_grad_step(apply)(net, _to(batch, card))
    assert len(routes.recorded) == 2
    with routes.replay():
        want_grads, want_metrics = make_grad_step(apply)(cpu, batch)
    assert not routes.recorded and routes.tokens == 2 * (T + 1) * B
    assert routes.prob_err <= 1e-5
    # A token's top-2 set may differ only where its two best experts
    # nearly tie.
    assert all(m <= 1e-5 for m in routes.margins), routes.margins
    for name in ("total_loss", "moe_lb_loss", "moe_z_loss",
                 "moe_drop_fraction"):
        torch.testing.assert_close(metrics[name].cpu(), want_metrics[name],
                                   rtol=0, atol=1e-5 * max(
                                       1.0, float(want_metrics[name].abs())))
    for name, w in want_grads.items():
        torch.testing.assert_close(grads[name].cpu(), w, rtol=0,
                                   atol=1e-4 * float(w.abs().max()),
                                   msg=lambda m: f"{name}: {m}")


def _nethack_batch(gen, T, B, A):
    return {
        "obs": {"glyphs": torch.randint(0, 5976, (T + 1, B, 21, 79),
                                        generator=gen).to(torch.int16),
                "blstats": 50.0 * torch.randn((T + 1, B, 27), generator=gen)},
        "done": torch.tensor([[False] * B, [True] + [False] * (B - 1),
                              [False] * B])[:T + 1],
        "rewards": torch.randn((T + 1, B), generator=gen),
        "actions": torch.randint(0, A, (T, B), generator=gen),
        "behavior_logits": torch.randn((T, B, A), generator=gen),
        "core_state": tuple(torch.randn((B, 256), generator=gen)
                            for _ in range(2)),
    }


def _nested_to(x, device):
    if torch.is_tensor(x):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _nested_to(v, device) for k, v in x.items()}
    return tuple(_nested_to(v, device) for v in x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nethack_net_on_the_card_matches_the_cpu(card, dtype):
    """NetHackNet with its LSTM on the card against the CPU: f32 forward
    and one IMPALA step's gradients within 1e-5 / 1e-4 of each tensor's
    largest entry (its convolutions held in full f32); bf16 forward
    within 2e-2 (cuDNN's and the CPU's bf16 products rounded after their
    own summation orders)."""
    from moolib_tpu_torch import NetHackNet

    gen = torch.Generator().manual_seed(0)
    cpu = NetHackNet(23, compute_dtype=dtype, device="cpu", generator=gen)
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if name.endswith("bias") or name.endswith("bias_hh"):
                p.normal_(0.0, 0.1, generator=gen)
    net = NetHackNet(23, compute_dtype=dtype, device=card)
    net.load_state_dict(cpu.state_dict())
    batch = _nethack_batch(gen, 2, 2, 23)
    on_card = _nested_to(batch, card)
    with torch.no_grad():
        got = net(on_card["obs"], on_card["done"], on_card["core_state"])
        want = cpu(batch["obs"], batch["done"], batch["core_state"])
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for g, w in zip(torch.utils._pytree.tree_leaves(got),
                    torch.utils._pytree.tree_leaves(want)):
        torch.testing.assert_close(g.cpu(), w, rtol=0,
                                   atol=tol * float(w.abs().max()))
    if dtype == torch.float32:
        grads, _ = make_grad_step()(net, on_card)
        want_grads, _ = make_grad_step()(cpu, batch)
        for name, w in want_grads.items():
            torch.testing.assert_close(grads[name].cpu(), w, rtol=0,
                                       atol=1e-4 * float(w.abs().max()),
                                       msg=lambda m: f"{name}: {m}")


def _small_train_state(seed):
    from moolib_tpu_torch import ClippedRMSprop, make_train_state

    net = TransformerNet(6, (5,), d_model=64, num_layers=1, num_heads=2,
                         device="cuda",
                         generator=torch.Generator(
                             device="cuda").manual_seed(seed))
    return make_train_state(net, ClippedRMSprop(
        net.parameters(), 6e-4, decay=0.99, eps=0.01, max_norm=40.0))


def _small_batch(seed, T=4, B=2):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {"obs": torch.randn((T + 1, B, 5), generator=gen, device="cuda"),
            "done": torch.rand((T + 1, B), generator=gen,
                               device="cuda") < 0.25,
            "rewards": torch.randn((T + 1, B), generator=gen, device="cuda"),
            "actions": torch.randint(0, 6, (T, B), generator=gen,
                                     device="cuda"),
            "behavior_logits": torch.randn((T, B, 6), generator=gen,
                                           device="cuda"),
            "core_state": ()}


def test_train_state_published_from_the_card_restores_onto_it(card,
                                                              tmp_path):
    """A card TrainState after one step, published from a StateStore to
    two followers; its store is deleted; a fresh store restores by quorum
    2 and loads it onto another card model: parameters and ClippedRMSprop's
    nu equal bit for bit, and so does the state read back off the card.
    (A torch leaf's pickle names its storage by address, so two encodings
    of equal tensors are compared by value, not by bytes.)"""
    import shutil

    from moolib_tpu_torch import make_impala_train_step
    from moolib_tpu_torch.learner import load_train_state, train_state_to_host
    from moolib_tpu_torch.rpc import Rpc
    from moolib_tpu_torch.statestore import StateStore

    lead, _ = make_impala_train_step()(_small_train_state(0), _small_batch(3))
    host = train_state_to_host(lead)
    rpcs = [Rpc(f"cuda-ss{i}") for i in range(3)]
    stores = []
    try:
        for r in rpcs:
            r.listen("127.0.0.1:0")
        for r in rpcs[1:]:
            rpcs[0].connect(r.debug_info()["listen"][0])
        stores = [StateStore(str(tmp_path / f"s{i}"), r, chunk_bytes=4096)
                  for i, r in enumerate(rpcs)]
        acks = stores[0].publish(1, host, peers=("cuda-ss1", "cuda-ss2"))
        assert all(acks.values()), acks
        stores[0].close()
        shutil.rmtree(tmp_path / "s0")
        stores[0] = StateStore(str(tmp_path / "s0"), rpcs[0],
                               chunk_bytes=4096)
        v, restored = stores[0].restore(("cuda-ss1", "cuda-ss2"), quorum=2)
        assert v == 1
        got = load_train_state(_small_train_state(1), restored)
        torch.cuda.synchronize()
        back = train_state_to_host(got)
        assert back["step"] == host["step"] == 1
        assert back["groups"] == host["groups"]
        for n, t in host["params"].items():
            assert torch.equal(back["params"][n], t), n
            for k, x in host["optimizer"][n].items():
                assert torch.equal(back["optimizer"][n][k], x), (n, k)
        for (n, a), b in zip(lead.model.named_parameters(),
                             got.model.parameters()):
            assert b.device.type == "cuda" and torch.equal(a, b), n
            assert torch.equal(lead.optimizer.state[a]["nu"],
                               got.optimizer.state[b]["nu"]), n
    finally:
        for s in stores:
            s.close()
        for r in rpcs:
            r.close()


def test_publish_from_statestore_into_a_card_replica(card, tmp_path):
    """A version put into a StateStore reaches a Replica on the card
    through publish_from_statestore and a Router: its replies follow
    those parameters (the CPU forward of the same weights) and its
    health reports the version."""
    import time

    from moolib_tpu_torch import Replica, Router
    from moolib_tpu_torch.rpc import Rpc
    from moolib_tpu_torch.serving import publish_from_statestore
    from moolib_tpu_torch.statestore import StateStore

    net = TransformerNet(6, (5,), d_model=64, num_layers=1, num_heads=2,
                         device="cuda").eval()
    cpu = TransformerNet(6, (5,), d_model=64, num_layers=1, num_heads=2,
                         device="cpu").eval()

    def forward(params, x):
        if getattr(forward, "params", None) is not params:
            net.load_state_dict({k: torch.as_tensor(v)
                                 for k, v in params.items()})
            forward.params = params
        (logits, _), _ = net(x["obs"].transpose(0, 1),
                             x["done"].transpose(0, 1), ())
        return logits.transpose(0, 1)

    new = TransformerNet(6, (5,), d_model=64, num_layers=1, num_heads=2,
                         device="cpu", generator=torch.Generator()
                         .manual_seed(9)).state_dict()
    cpu.load_state_dict(new)
    rep_rpc, front = Rpc("cuda-pub-rep"), Rpc("cuda-pub-front")
    rep = router = store = None
    try:
        rep_rpc.listen("127.0.0.1:0")
        front.connect(rep_rpc.debug_info()["listen"][0])
        rep = Replica(rep_rpc, forward, {k: v.cpu() for k, v in
                                         net.state_dict().items()},
                      service="pub", batch_size=1, device="cuda")
        router = Router(front, ["cuda-pub-rep"], service="pub")
        deadline = time.monotonic() + 30.0
        while not router.routable() and time.monotonic() < deadline:
            time.sleep(0.02)
        assert router.routable() == ["cuda-pub-rep"]
        store = StateStore(str(tmp_path / "store"), front)
        store.put(7, new)
        v, acks = publish_from_statestore(router, store)
        assert v == 7 and acks == {"cuda-pub-rep": True}
        gen = torch.Generator().manual_seed(2)
        x = {"obs": torch.randn((3, 5), generator=gen).numpy(),
             "done": (torch.rand(3, generator=gen) < 0.3).numpy()}
        got = torch.as_tensor(router.infer(x, budget_s=60.0))
        with torch.no_grad():
            (want, _), _ = cpu(torch.from_numpy(x["obs"])[:, None],
                               torch.from_numpy(x["done"])[:, None], ())
        # f32: the flash kernel against dense attention, summation order.
        torch.testing.assert_close(got, want[:, 0], rtol=1e-4, atol=1e-4)
        assert front.sync("cuda-pub-rep", "pub.health")["model_version"] == 7
    finally:
        for obj in (store, router, rep):
            if obj is not None:
                obj.close()
        front.close()
        rep_rpc.close()


# -- multi-device on one card --------------------------------------------------


def test_nccl_world_of_one_dp_step_is_bitwise_the_plain_step(card, tmp_path):
    """An NCCL world of 1 on the card: make_impala_train_step(mesh=...)
    from a seeded state equals the plain step bit for bit (the all-reduce
    of one rank is the identity, the mean divides by 1), the flash
    kernels included."""
    import torch.distributed as dist

    from moolib_tpu_torch import (ClippedRMSprop, make_impala_train_step,
                                  make_train_state)
    from moolib_tpu_torch.parallel.mesh import make_mesh

    gen = torch.Generator(device=card).manual_seed(3)
    T, B, A = 20, 8, 6
    batch = {
        "obs": torch.randint(0, 256, (T + 1, B, 84, 84, 4), generator=gen,
                             device=card, dtype=torch.uint8),
        "done": torch.rand((T + 1, B), generator=gen, device=card) < 0.05,
        "rewards": torch.randn((T + 1, B), generator=gen, device=card),
        "actions": torch.randint(0, A, (T, B), generator=gen, device=card),
        "behavior_logits": torch.randn((T, B, A), generator=gen,
                                       device=card),
        "core_state": (),
    }

    def run(mesh):
        net = TransformerNet(A, (84, 84, 4), compute_dtype=torch.bfloat16,
                             device=card, generator=torch.Generator(
                                 device=card).manual_seed(4))
        opt = ClippedRMSprop(net.parameters(), 6e-4, decay=0.99, eps=0.01,
                             max_norm=40.0)
        state = make_train_state(net, opt)
        step = make_impala_train_step(mesh=mesh)
        for _ in range(2):
            state, metrics = step(state, batch)
        return ({n: p.detach().clone() for n, p in net.named_parameters()},
                {n: opt.state[p]["nu"].clone()
                 for n, p in net.named_parameters()}, metrics)

    plain = run(None)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        meshed = run(make_mesh(device=card))
    finally:
        dist.destroy_process_group()
    for a, b in zip(meshed, plain):
        for k in b:
            assert torch.equal(a[k], b[k]), k


@pytest.fixture
def card_world(card, tmp_path):
    """4 gloo ranks sharing the card (exchanges through the host)."""
    from moolib_tpu_torch.testing.spmd import SpmdWorld

    with SpmdWorld(4, str(tmp_path / "spmd"), backend="gloo",
                   device="cuda") as w:
        yield w


def _pipeline_memory(world, kind, **kw):
    import torch_spmd_cases as cases

    shape = dict(n_stages=4, mb=8, F=32, n_micro=16)
    shape.update(kw)
    return world.run(cases.pipeline_memory, kind, *shape.values())


def test_remat_reduces_pipeline_backward_memory(card_world):
    """The reference's test on XLA's compiled temp memory, on each rank's
    peak card memory: remat keeps less for the backward."""
    plain = _pipeline_memory(card_world, "gpipe")
    remat = _pipeline_memory(card_world, "remat")
    for p, r in zip(plain, remat):
        assert r["temp"] < p["temp"], (r, p)


def test_1f1b_peak_memory_leq_gpipe_remat(card_world):
    gpipe = _pipeline_memory(card_world, "remat")
    f1b = _pipeline_memory(card_world, "1f1b")
    for g, f in zip(gpipe, f1b):
        assert f["temp"] <= g["temp"], (f, g)


def test_per_device_pipeline_memory_scales_with_shard_not_stream(card_world):
    n_stages, mb, F, n_micro = 4, 8, 16, 32
    shard_bytes = (n_micro // n_stages) * mb * F * 4
    full_bytes = n_micro * mb * F * 4
    budget = 6 * shard_bytes + 4 * n_stages * F * (F + 1)
    for m in _pipeline_memory(card_world, "forward", F=F, n_micro=n_micro):
        assert m["total"] < budget, (m, budget)
        assert m["total"] < full_bytes, (m, full_bytes)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attn_bench_head_width_kernels_match_plain(card, dtype):
    """Every kernel of attn_bench's path at [1, 8, 512, 128], causal, no
    segments (its head width, several 64-row tiles): flash_fwd, then
    flash_bwd_dq and flash_bwd_dkdv on its o and lse with a seeded dO,
    each held against its plain version at the tolerances above, each
    launched once."""
    gen = torch.Generator(device=card).manual_seed(128)
    B, H, T, D = 1, 8, 512, 128
    q, k, v, do = (torch.randn((B, H, T, D), generator=gen, device=card)
                   .to(dtype) for _ in range(4))
    seg = torch.zeros((B, T), dtype=torch.int32, device=card)
    kerns = (_kernels.FLASH_FWD, _kernels.FLASH_BWD_DQ,
             _kernels.FLASH_BWD_DKDV)
    before = [kern.launches for kern in kerns]
    o, lse = _kernels.flash_fwd(q, k, v, seg, seg, True)
    delta = tattn._flash_delta(o, do)
    dq = _kernels.flash_bwd_dq(q, k, v, seg, seg, lse, delta, do, True)
    dk, dv = _kernels.flash_bwd_dkdv(q, k, v, seg, seg, lse, delta, do,
                                     True)
    torch.cuda.synchronize()
    assert [kern.launches - n for kern, n in zip(kerns, before)] == [1] * 3
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    o_ref, lse_ref = tattn._flash_forward_plain(q, k, v, seg, seg, True)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=1e-4,
                               rtol=rtol)
    want = tattn._flash_backward_plain(q, k, v, seg, seg, o, lse, do, True)
    for g, ref in zip((dq, dk, dv), want):
        assert g.dtype == dtype
        scale = float(ref.float().abs().max())
        torch.testing.assert_close(g.float(), ref.float(),
                                   atol=1e-4 * scale, rtol=rtol)
