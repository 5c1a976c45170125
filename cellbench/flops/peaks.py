"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheets, dense rates without sparsity, at the part's full power limit),
matched on the lower-cased name ``torch.cuda.get_device_name()`` gives.

``f32`` is the faster way to get an f32-exact product: 67 TFLOP/s on the
CUDA cores, or the tensor cores' TF32 rate split three ways (3xTF32,
495 / 3 = 165 TFLOP/s), so no f32-exact kernel can read over 100%.
"""

from typing import Optional

H100_SXM = {"bf16": 989e12, "f32": max(67e12, 495e12 / 3),
            "hbm_bytes_per_s": 3.35e12}
H100_PCIE = {"bf16": 756e12, "f32": max(51e12, 378e12 / 3),
             "hbm_bytes_per_s": 2.0e12}

_CARDS = (
    ("h100 80gb hbm3", H100_SXM),  # the SXM part's name
    ("h100 sxm", H100_SXM),
    ("h100 pcie", H100_PCIE),
)


def card_peaks(device_name: str) -> Optional[dict]:
    """The peaks of the card ``device_name`` names, or None if unknown."""
    name = device_name.lower()
    for key, peaks in _CARDS:
        if key in name:
            return peaks
    return None
