"""Batched camera geometry on tensors, and host-side image helpers.

Port of `relpose_gnn_tpu/ops/camera.py` (the reference's graph-generation
camera operators, SURVEY.md section 2.2 E4-E7):
  * `x_2d_coords`, `pi`, `pi_inv`, `inv_pose`, `transform_points`,
    `camera_center_from_Tcw`, `camera_pose_inv`: batched over leading
    dimensions, on whatever device the inputs live;
  * `decode_depth_mm`: uint16 millimetres -> metres, 65535 invalid;
  * `preprocess_scene`, `preprocess_query`: back-projected, centred world
    points and the normalised query pose with scaled intrinsics;
  * `rel_distance`, `rel_rot_angle`: pose metrics;
  * `solve_pnp_ransac`: a host call into OpenCV (imported when called;
    the card's machine has no cv2, and there it raises as the JAX
    function does without OpenCV);
  * `crop_by_intrinsic`: the FOV-preserving crop of the NetVLAD input,
    with the port's own PIL-exact resize (`data/image_io.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from relpose_gnn_tpu_torch import resolve_device
from relpose_gnn_tpu_torch.data.image_io import resize_bilinear
from relpose_gnn_tpu_torch.ops import pose as pose_ops


def x_2d_coords(h: int, w: int, device=None) -> torch.Tensor:
    """Pixel grid [H, W, 2] in (x, y) order, float32 (`device` None: the
    card)."""
    dev = resolve_device(device)
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([grid_x, grid_y], dim=-1)


def pi(K: torch.Tensor, X: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Project camera-frame points X [..., P, 3] through K [..., 3, 3] ->
    (x_2d [..., P, 2], depth [..., P, 1]); |z| < 1e-12 reads 1e-12."""
    fx, fy = K[..., 0:1, 0], K[..., 1:2, 1]
    cx, cy = K[..., 0:1, 2], K[..., 1:2, 2]
    z = X[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
    u = fx * X[..., 0] / z_safe + cx
    v = fy * X[..., 1] / z_safe + cy
    return torch.stack([u, v], dim=-1), z[..., None]


def pi_inv(K: torch.Tensor, x_2d: torch.Tensor,
           d: torch.Tensor) -> torch.Tensor:
    """Unproject pixels x_2d [..., P, 2] at depths d [..., P, 1] ->
    camera-frame points [..., P, 3]."""
    fx, fy = K[..., 0:1, 0], K[..., 1:2, 1]
    cx, cy = K[..., 0:1, 2], K[..., 1:2, 2]
    X = (x_2d[..., 0] - cx) * d[..., 0] / fx
    Y = (x_2d[..., 1] - cy) * d[..., 0] / fy
    return torch.stack([X, Y, d[..., 0]], dim=-1)


def inv_pose(R: torch.Tensor,
             t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, t) -> (R^T, -R^T t)."""
    Rt = torch.swapaxes(R, -1, -2)
    return Rt, -torch.einsum("...ij,...j->...i", Rt, t)


def transform_points(R: torch.Tensor, t: torch.Tensor,
                     X: torch.Tensor) -> torch.Tensor:
    """R X + t over point sets X [..., P, 3]."""
    return torch.einsum("...ij,...pj->...pi", R, X) + t[..., None, :]


def camera_center_from_Tcw(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Camera centre C = -R^T t."""
    return -torch.einsum("...ji,...j->...i", R, t)


def camera_pose_inv(R: torch.Tensor, t: torch.Tensor):
    """Tcw -> Twc."""
    return inv_pose(R, t)


def decode_depth_mm(depth_u16: torch.Tensor) -> torch.Tensor:
    """Integer depth in millimetres -> float32 metres; 65535 -> 0
    (invalid).  Any integer dtype; the comparison is made on the float32
    value, which holds every uint16 exactly, and the division is by a
    tensor (on CUDA a division by a Python scalar multiplies by its
    reciprocal)."""
    d = depth_u16.to(torch.float32)
    d = torch.where(d == 65535.0, torch.zeros_like(d), d)
    return d / torch.tensor(1000.0, device=d.device)


def preprocess_scene(rgb: torch.Tensor, depth: torch.Tensor,
                     K: torch.Tensor, Tcw: torch.Tensor) -> dict:
    """Back-project scene frames to centred world points and concatenate
    RGB|XYZ.

    rgb [L, H, W, 3], depth [L, H, W] (metres), K [L, 3, 3], Tcw
    [L, 3, 4] -> dict with `scene_input` [L, H, W, 6], `X_world`
    [L, H, W, 3], `valid_mask` [L, H, W], `scene_center` [3] (the
    reference's random rotation augmentation defaults to identity and is
    left out, as in the JAX function)."""
    l, h, w = depth.shape
    x2d = x_2d_coords(h, w, depth.device).reshape(1, h * w, 2)
    d = depth.reshape(l, h * w, 1)
    X_cam = pi_inv(K, x2d.expand(l, h * w, 2).to(depth.dtype), d)
    Rwc, twc = inv_pose(Tcw[:, :3, :3], Tcw[:, :3, 3])
    X_world = transform_points(Rwc, twc, X_cam)          # [L, H*W, 3]
    scene_center = torch.mean(X_world.reshape(-1, 3), dim=0)
    X_world = (X_world - scene_center).reshape(l, h, w, 3)
    return {"scene_input": torch.cat([rgb.to(X_world.dtype), X_world],
                                     dim=-1),
            "X_world": X_world,
            "valid_mask": depth > 1e-5,
            "scene_center": scene_center}


def preprocess_query(Tcw: torch.Tensor, K: torch.Tensor,
                     scene_center: torch.Tensor, out_hw: tuple[int, int],
                     in_hw: tuple[int, int]) -> dict:
    """Normalised query pose (the camera re-centred on the scene centroid)
    and the intrinsics scaled to the output size.  Tcw [..., 3, 4],
    K [..., 3, 3]."""
    Rwc, twc = inv_pose(Tcw[..., :3, :3], Tcw[..., :3, 3])
    Rcw, tcw = inv_pose(Rwc, twc - scene_center)
    out_h, out_w = out_hw
    in_h, in_w = in_hw
    scale = torch.tensor([[out_w / in_w, 1.0, out_w / in_w],
                          [1.0, out_h / in_h, out_h / in_h],
                          [1.0, 1.0, 1.0]], dtype=torch.float32,
                         device=K.device)
    return {"norm_Tcw": torch.cat([Rcw, tcw[..., None]], dim=-1),
            "K_scaled": K * scale}


def rel_distance(T1: torch.Tensor, T2: torch.Tensor) -> torch.Tensor:
    """Distance between the camera centres of two [..., 3, 4] poses."""
    c1 = camera_center_from_Tcw(T1[..., :3, :3], T1[..., :3, 3])
    c2 = camera_center_from_Tcw(T2[..., :3, :3], T2[..., :3, 3])
    return torch.linalg.vector_norm(c1 - c2, dim=-1)


def rel_rot_angle(T1: torch.Tensor, T2: torch.Tensor) -> torch.Tensor:
    """Relative rotation angle in degrees between two [..., 3, 4] poses."""
    R = torch.einsum("...ij,...kj->...ik", T1[..., :3, :3], T2[..., :3, :3])
    q = pose_ops.mat2quat(R)
    return 2.0 * torch.arccos(torch.clamp(torch.abs(q[..., 0]), 0.0, 1.0)) \
        * (180.0 / np.pi)


def solve_pnp_ransac(x_2d: np.ndarray, X_3d: np.ndarray, K: np.ndarray,
                     reproj_threshold: float = 1.0,
                     iterations: int = 100):
    """RANSAC PnP (EPnP inside) from 2D-3D correspondences: a host call
    into `cv2.solvePnPRansac`.  Returns (R [3, 3], t [3], inlier mask
    [P]) of the world->camera pose, or None where OpenCV finds none;
    raises RuntimeError where OpenCV is absent."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("OpenCV required for PnP") from e

    x_2d = np.ascontiguousarray(x_2d, np.float64).reshape(-1, 1, 2)
    X_3d = np.ascontiguousarray(X_3d, np.float64).reshape(-1, 1, 3)
    ok, rvec, tvec, inliers = cv2.solvePnPRansac(
        X_3d, x_2d, np.asarray(K, np.float64), None,
        reprojectionError=reproj_threshold, iterationsCount=iterations,
        flags=cv2.SOLVEPNP_EPNP)
    if not ok:
        return None
    R, _ = cv2.Rodrigues(rvec)
    mask = np.zeros(len(x_2d), bool)
    if inliers is not None:
        mask[inliers.ravel()] = True
    return R, tvec.ravel(), mask


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
