"""Input normalisation on the device (PyTorch).

Port of `relpose_gnn_tpu/data/pipeline.py::make_normalizer`: the host moves
raw uint8 pixels, the device converts them to normalised float32.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def to_float01(images: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> float32 in [0, 1] by TRUE division, bit for bit
    what the host's `images.astype(float32) / 255` gives.  The divisor is
    a tensor on purpose: given a Python scalar, torch's CUDA division
    multiplies by the reciprocal instead, which rounds differently and
    would break the uint8 == quantised-float identity of the service."""
    return images.float() / torch.full((), 255.0, device=images.device)


def make_normalizer(mean: np.ndarray, std: np.ndarray,
                    device: torch.device | str
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """uint8 (or float) images [..., 3] -> float32 `(x / 255 - mean) / std`
    (the /255 only for uint8), on `device`.  The same expression as the JAX
    normaliser, not the `* (1 / std)` form of its per-record variant."""
    mean_t = torch.as_tensor(np.asarray(mean, np.float32), device=device)
    std_t = torch.as_tensor(np.asarray(std, np.float32), device=device)

    def normalize(images: torch.Tensor) -> torch.Tensor:
        x = images.to(device)
        x = to_float01(x) if x.dtype == torch.uint8 else x.float()
        return (x - mean_t) / std_t

    return normalize
