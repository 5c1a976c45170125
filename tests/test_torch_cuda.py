"""The port's CUDA kernels on the card, held against their plain versions.

These tests need an NVIDIA Hopper card and nvcc; without them they skip.
They import only torch and the port, so they run on a host without JAX:

    pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

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


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_matches_plain(card, D, dtype, causal):
    """T=100 leaves ragged query and key tiles; segments leave some rows
    fully masked in the non-causal case (kv segments differ)."""
    gen = torch.Generator(device=card).manual_seed(D)
    B, H, T = 2, 3, 100
    q, k, v = (torch.randn((B, H, T, D), generator=gen, device=card)
               .to(dtype) for _ in range(3))
    seg_q = (torch.rand((B, T), generator=gen, device=card) < 0.05).int()
    seg_q = torch.cumsum(seg_q, dim=1, dtype=torch.int32)
    seg_k = seg_q if causal else torch.zeros_like(seg_q)
    o, lse = _kernels.flash_fwd(q, k, v, seg_q, seg_k, causal)
    o_ref, lse_ref = tattn._flash_forward_plain(q, k, v, seg_q, seg_k,
                                                causal)
    torch.cuda.synchronize()
    assert torch.equal(torch.isinf(lse), torch.isinf(lse_ref))
    fin = torch.isfinite(lse_ref)
    torch.testing.assert_close(lse[fin], lse_ref[fin], atol=1e-4, rtol=0)
    # f32: summation order only; bf16: one rounding of the f32 result.
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(o.float(), o_ref.float(), atol=1e-4,
                               rtol=rtol)


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
    with pytest.raises(ValueError, match="head dims"):
        _kernels.flash_fwd(q, q, q, seg, seg, True)
    q = torch.zeros((1, 1, 8, 32), device=card, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        _kernels.flash_fwd(q, q, q, seg, seg, True)
