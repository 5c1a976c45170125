"""Host-to-device staging of a completed batch; the counterpart of
:func:`moolib_tpu.ops.batcher.stage_batch`. The rest of the reference's
``Batcher`` is not ported yet."""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch

from ..utils import nest

__all__ = ["stage_batch"]


def stage_batch(batch: Any, device: Union[str, torch.device]) -> Any:
    """Every leaf becomes a contiguous host tensor and moves to ``device``.

    For a CUDA device the host copy is pinned and the upload is
    asynchronous on the current stream, so it overlaps whatever the host
    does next; the caching host allocator keeps the pinned block alive
    until the copy has run."""
    device = torch.device(device)

    def _stage(x):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x)
        )
        if device.type == "cuda" and t.device.type == "cpu":
            return t.contiguous().pin_memory().to(device, non_blocking=True)
        return t.to(device)

    return nest.map_structure(_stage, batch)
