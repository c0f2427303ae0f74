"""Quaternion algebra on pose tensors (PyTorch).

Port of the quaternion part of `relpose_gnn_tpu/ops/pose.py` (`vdot` to
`calc_vo`, reference pose_utils.py:17-172), which
`training/criterion.py::mapnet_online_criterion` needs, and of its
rotation-matrix conversions and host pose preprocessing (`mat2quat`,
`quat2mat`, `process_poses*`), which the loaders need.  The rest of the
JAX module (the `calc_vo*` family, angular errors, alignment) is in
ROADMAP.md, 'Modules to port', the rest of the model zoo.

Conventions, as in the JAX module: quaternions are [w, x, y, z] (scalar
first); a pose7 is [t(3), q(4)].  Every function is batched over leading
dimensions and differentiable.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-8


def vdot(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """Row-wise dot product along the last dim."""
    return torch.sum(v1 * v2, dim=-1)


def normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2-normalise along `dim` (norm floored at 1e-8)."""
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp_min(n, _EPS)


def qmult(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product, renormalised; shapes broadcast, last dim 4."""
    q1s, q1v = q1[..., :1], q1[..., 1:]
    q2s, q2v = q2[..., :1], q2[..., 1:]
    qs = q1s * q2s - torch.sum(q1v * q2v, dim=-1, keepdim=True)
    q1v, q2v = torch.broadcast_tensors(q1v, q2v)
    qv = q1v * q2s + q2v * q1s + torch.linalg.cross(q1v, q2v, dim=-1)
    return normalize(torch.cat([qs, qv], dim=-1))


def qinv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of a unit quaternion."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def qexp(w: torch.Tensor) -> torch.Tensor:
    """Log-quaternion [..., 3] -> unit quaternion [..., 4], exact at 0
    (second-order Taylor below |w| = 1e-8, a floored norm above)."""
    n2 = torch.sum(w * w, dim=-1, keepdim=True)
    small = n2 < _EPS * _EPS
    n = torch.sqrt(torch.clamp_min(n2, _EPS * _EPS))
    cos = torch.where(small, 1.0 - 0.5 * n2, torch.cos(n))
    sinc = torch.where(small, 1.0 - n2 / 6.0, torch.sin(n) / n)
    return torch.cat([cos, sinc * w], dim=-1)


def qlog(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] -> log-quaternion [..., 3]; 0 where the
    vector part vanishes, else arccos(q0) v / |v|."""
    v = q[..., 1:]
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    n = torch.sqrt(torch.clamp_min(n2, _EPS * _EPS))
    ang = torch.arccos(torch.clamp(q[..., :1], -1.0, 1.0))
    return torch.where(n2 < _EPS * _EPS, torch.zeros_like(v), ang * v / n)


def rotate_vec_by_q(t: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rotate vectors t by unit quaternions q:
    t' = t + 2 qs (qv x t) + 2 qv x (qv x t)."""
    qs, qv = q[..., :1], q[..., 1:]
    qv, t = torch.broadcast_tensors(qv, t)
    b = torch.linalg.cross(qv, t, dim=-1)
    c = 2.0 * torch.linalg.cross(qv, b, dim=-1)
    return t + 2.0 * b * qs + c


def compose_pose_quaternion(p1: torch.Tensor,
                            p2: torch.Tensor) -> torch.Tensor:
    """Compose two pose7s: apply p2 after p1."""
    p1t, p1q = p1[..., :3], p1[..., 3:]
    p2t, p2q = p2[..., :3], p2[..., 3:]
    q = qmult(p1q, p2q)
    t = p1t + rotate_vec_by_q(p2t, p1q)
    return torch.cat([t, q], dim=-1)


def invert_pose_quaternion(p: torch.Tensor) -> torch.Tensor:
    """Invert a pose7."""
    t, q = p[..., :3], p[..., 3:]
    q_inv = qinv(q)
    return torch.cat([-rotate_vec_by_q(t, q_inv), q_inv], dim=-1)


def calc_vo(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """Relative pose of p1 expressed in the p0 frame (pose7)."""
    return compose_pose_quaternion(invert_pose_quaternion(p0), p1)


# ---------------------------------------------------------------------------
# Rotation matrix <-> quaternion, and the loaders' pose preprocessing
# ---------------------------------------------------------------------------

def mat2quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] (w,x,y,z).

    Shepperd's branchless method: all four candidate quadruples, the one
    with the largest pivot (first on ties) selected."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp_min(x, _EPS * _EPS))

    s_w = safe_sqrt(1.0 + tr)
    q_w = torch.stack([0.5 * s_w, 0.5 * (m21 - m12) / s_w,
                       0.5 * (m02 - m20) / s_w, 0.5 * (m10 - m01) / s_w], -1)
    s_x = safe_sqrt(1.0 + m00 - m11 - m22)
    q_x = torch.stack([0.5 * (m21 - m12) / s_x, 0.5 * s_x,
                       0.5 * (m01 + m10) / s_x, 0.5 * (m02 + m20) / s_x], -1)
    s_y = safe_sqrt(1.0 - m00 + m11 - m22)
    q_y = torch.stack([0.5 * (m02 - m20) / s_y, 0.5 * (m01 + m10) / s_y,
                       0.5 * s_y, 0.5 * (m12 + m21) / s_y], -1)
    s_z = safe_sqrt(1.0 - m00 - m11 + m22)
    q_z = torch.stack([0.5 * (m10 - m01) / s_z, 0.5 * (m02 + m20) / s_z,
                       0.5 * (m12 + m21) / s_z, 0.5 * s_z], -1)

    best = torch.argmax(torch.stack([tr, m00, m11, m22], -1), -1)[..., None]
    q = torch.where(best == 0, q_w,
                    torch.where(best == 1, q_x,
                                torch.where(best == 2, q_y, q_z)))
    return normalize(q)


def quat2mat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] (w,x,y,z) -> rotation matrix [..., 3, 3]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


# The JAX package evaluates `mat2quat` and `qlog` on its default float32
# and widens the result to float64; these host helpers do the same, so
# stored log-quaternions agree to float32 rounding.

def _mat2quat_f32(R: np.ndarray) -> np.ndarray:
    return mat2quat(torch.from_numpy(np.asarray(R, np.float32))).numpy()


def _qlog_f32(q: np.ndarray) -> np.ndarray:
    return qlog(torch.from_numpy(np.asarray(q, np.float32))).numpy()


def process_poses(poses_in: np.ndarray, mean_t: np.ndarray, std_t: np.ndarray,
                  align_R: np.ndarray, align_t: np.ndarray,
                  align_s: float, sign_zero_quirk: bool = False
                  ) -> np.ndarray:
    """Raw Nx12 row-major [R|t] poses -> Nx6 float64 [t, logq], aligned
    and normalized: rotation aligned by `align_R`, quaternion put in the
    w >= 0 hemisphere and log-mapped; translation aligned, scaled, then
    mean/std-normalized.

    `sign_zero_quirk=True` multiplies by `sign(w)` as the reference does,
    which zeroes the quaternion (logq = 0) when w == 0 exactly; the default
    keeps the true pi*axis log map."""
    poses_in = np.asarray(poses_in, dtype=np.float64)
    n = len(poses_in)
    t = poses_in[:, [3, 7, 11]]
    R = poses_in.reshape(n, 3, 4)[:, :3, :3]
    q = _mat2quat_f32(align_R[None] @ R)
    if sign_zero_quirk:
        q = q * np.sign(q[:, :1])
    else:
        q = q * np.where(q[:, :1] >= 0, 1.0, -1.0)
    logq = _qlog_f32(q)
    t = (t - align_t) @ align_R.T * align_s
    t = (t - mean_t) / std_t
    return np.concatenate([t, logq], axis=1).astype(np.float64)


def process_poses_cambridge(pose_4x4: np.ndarray) -> np.ndarray:
    """4x4 pose -> 6-dof [t, logq]."""
    R = np.asarray(pose_4x4)[:3, :3]
    t = np.asarray(pose_4x4)[:3, -1]
    q = _mat2quat_f32(R[None])[0]
    if q[0] < 0:
        q = -q
    logq = _qlog_f32(q[None])[0]
    return np.concatenate([t, logq])


def process_poses_cambridge_norod(pose_7: np.ndarray) -> np.ndarray:
    """[t(3), q(4)] -> [t(3), logq(3)]."""
    pose_7 = np.asarray(pose_7, dtype=np.float64)
    t, q = pose_7[:3], pose_7[3:].copy()
    if q[0] < 0:
        q = -q
    logq = _qlog_f32(q[None])[0]
    return np.concatenate([t, logq])
