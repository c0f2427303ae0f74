"""Point-set and camera-trajectory alignment (Horn / Umeyama), batched.

Port of `relpose_gnn_tpu/ops/align.py` (reference pose_utils.py:877-1146):
similarity alignment of 3-D point sets (`align_3d_pts`), the rigid
variant, 2-D alignment, and the alignment of a whole camera trajectory.
Closed forms through `torch.linalg.svd`, over leading batch dimensions, on
the inputs' device.

`torch.linalg.svd` may give singular vectors of other signs than
`jnp.linalg.svd`; the rotation U diag(1, .., det) V^T does not depend on
them where the singular values are distinct, which is where the rotation
is unique at all.  The products take the port's precision policy, TF32
off (pinned by the entry points, `cli.pin_full_fp32`).
"""

from __future__ import annotations

import torch

from relpose_gnn_tpu_torch.ops import pose as pose_ops


def _center(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    mu = torch.mean(x, dim=-2, keepdim=True)
    return x - mu, mu


def _proper_rotation(w: torch.Tensor, d: int, batch_shape) -> torch.Tensor:
    """SVD of the correlation matrix -> nearest proper rotation (det = +1
    through the reference's S[d-1, d-1] = -1 correction)."""
    u, _, vt = torch.linalg.svd(w)
    det = torch.linalg.det(u) * torch.linalg.det(vt)
    sign = torch.cat([torch.ones(tuple(batch_shape) + (d - 1,),
                                 dtype=w.dtype, device=w.device),
                      det[..., None]], dim=-1)
    return torch.einsum("...ik,...k,...kj->...ij", u, sign, vt)


def _horn_scale(xc: torch.Tensor, yc: torch.Tensor) -> torch.Tensor:
    """Horn's symmetric scale sqrt(sum |yc|^2 / sum |xc|^2), the
    reference's `np.sqrt(r2 / r1)` (not Umeyama's sum(sigma) / var_x)."""
    r1 = torch.sum(xc * xc, dim=(-1, -2))
    r2 = torch.sum(yc * yc, dim=(-1, -2))
    return torch.sqrt(r2 / torch.clamp_min(r1, 1e-12))


def _translation(s, R, mx, my):
    return my[..., 0, :] - s[..., None] * torch.einsum(
        "...ij,...j->...i", R, mx[..., 0, :])


def align_pts(x: torch.Tensor, y: torch.Tensor, with_scale: bool = True
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Least-squares similarity transform y ~= s R x + t over point sets
    [..., N, D]: returns (s [...], R [..., D, D], t [..., D]).  Rotation
    from the SVD of the correlation matrix with the det = +1 correction,
    scale from the radii ratio (`_horn_scale`)."""
    xc, mx = _center(x)
    yc, my = _center(y)
    cov = torch.einsum("...ni,...nj->...ij", yc, xc)
    R = _proper_rotation(cov, x.shape[-1], x.shape[:-2])
    s = (_horn_scale(xc, yc) if with_scale
         else torch.ones(x.shape[:-2], dtype=x.dtype, device=x.device))
    return s, R, _translation(s, R, mx, my)


def align_3d_pts(x: torch.Tensor, y: torch.Tensor):
    """3-D similarity alignment."""
    return align_pts(x, y, with_scale=True)


def align_3d_pts_noscale(x: torch.Tensor, y: torch.Tensor):
    """Rigid (no-scale) 3-D alignment."""
    return align_pts(x, y, with_scale=False)


def align_2d_pts(x: torch.Tensor, y: torch.Tensor):
    """2-D similarity alignment."""
    return align_pts(x, y, with_scale=True)


def apply_similarity(s, R, t, x: torch.Tensor) -> torch.Tensor:
    """y = s R x + t, batched over points."""
    return (s[..., None, None] * torch.einsum("...ij,...nj->...ni", R, x)
            + t[..., None, :])


def align_camera_poses(t_pred: torch.Tensor, q_pred: torch.Tensor,
                       t_gt: torch.Tensor, q_gt: torch.Tensor,
                       with_scale: bool = True,
                       use_rotation_constraint: bool = True):
    """Align a predicted camera trajectory to the ground truth: a
    similarity fit on the camera centres, applied to positions and
    orientations.

    `use_rotation_constraint` (the reference's default): the orientations'
    sum_i R2_i R1_i^T is added to the correlation matrix before the SVD,
    which pins the rotation where the centres alone leave it free (a
    straight path); False is `align_pts` on the centres.

    t [..., N, 3], q [..., N, 4] (w, x, y, z), camera-to-world.  Returns
    (t_aligned, q_aligned, (s, R, t_align))."""
    if use_rotation_constraint:
        xc, mx = _center(t_pred)
        yc, my = _center(t_gt)
        r1 = pose_ops.quat2mat(q_pred)              # [..., N, 3, 3]
        r2 = pose_ops.quat2mat(q_gt)
        w = torch.einsum("...ni,...nj->...ij", yc, xc)
        w = w + torch.sum(torch.einsum("...nij,...nkj->...nik", r2, r1),
                          dim=-3)
        R = _proper_rotation(w, 3, t_pred.shape[:-2])
        s = (_horn_scale(xc, yc) if with_scale
             else torch.ones(t_pred.shape[:-2], dtype=t_pred.dtype,
                             device=t_pred.device))
        t_align = _translation(s, R, mx, my)
    else:
        s, R, t_align = align_pts(t_pred, t_gt, with_scale=with_scale)
    t_new = apply_similarity(s, R, t_align, t_pred)
    q_align = pose_ops.mat2quat(R)
    q_new = pose_ops.qmult(
        q_align[..., None, :].expand(q_pred.shape), q_pred)
    return t_new, q_new, (s, R, t_align)
