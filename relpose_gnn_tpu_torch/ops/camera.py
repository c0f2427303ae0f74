"""Host-side intrinsics-aware cropping.

Port of `crop_by_intrinsic` from `relpose_gnn_tpu/ops/camera.py`, which
the raw-frame NetVLAD preprocessing needs.  The rest of the JAX module
(the batched camera geometry, the scene and query preprocessing) is in
ROADMAP.md, 'Modules to port', slice 8b (geometry and classical
retrieval).
"""

from __future__ import annotations

import numpy as np

from relpose_gnn_tpu_torch.data.image_io import resize_bilinear


def crop_by_intrinsic(img: np.ndarray, cur_k: np.ndarray,
                      new_k: np.ndarray) -> np.ndarray:
    """FOV-preserving crop: rescale by the focal ratio (PIL's bilinear
    resample of the uint8-quantised image, `data/image_io.py::
    resize_bilinear`), then center-crop to the new principal-point extent.
    Only crops to a smaller FOV; float input in [0, 1] comes back as
    float32 in [0, 1], uint8 as uint8."""
    cur_fov_x = 2 * np.arctan(cur_k[0, 2] / cur_k[0, 0])
    new_fov_x = 2 * np.arctan(new_k[0, 2] / new_k[0, 0])
    cur_fov_y = 2 * np.arctan(cur_k[1, 2] / cur_k[1, 1])
    new_fov_y = 2 * np.arctan(new_k[1, 2] / new_k[1, 1])
    if cur_fov_x < new_fov_x or cur_fov_y < new_fov_y:
        raise ValueError("new camera FOV larger than current")

    ratio = new_k[0, 0] / cur_k[0, 0]
    h, w = img.shape[:2]
    nw, nh = int(ratio * w), int(ratio * h)
    u8 = (img if img.dtype == np.uint8
          else (np.clip(img, 0, 1) * 255).astype(np.uint8))
    resized = resize_bilinear(u8, (nw, nh))
    if img.dtype != np.uint8:
        resized = resized.astype(np.float32) / 255.0

    out_h, out_w = int(2 * new_k[1, 2]), int(2 * new_k[0, 2])
    y0 = (nh - out_h) // 2
    x0 = (nw - out_w) // 2
    return resized[y0:y0 + out_h, x0:x0 + out_w]
