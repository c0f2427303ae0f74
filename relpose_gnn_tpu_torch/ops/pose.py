"""Quaternion algebra on pose tensors (PyTorch).

Port of the quaternion part of `relpose_gnn_tpu/ops/pose.py` (`vdot` to
`calc_vo`, reference pose_utils.py:17-172), which
`training/criterion.py::mapnet_online_criterion` needs.  The rest of the
JAX module (log-quaternion poses, alignment) is in ROADMAP.md, 'Modules to
port', the rest of the model zoo.

Conventions, as in the JAX module: quaternions are [w, x, y, z] (scalar
first); a pose7 is [t(3), q(4)].  Every function is batched over leading
dimensions and differentiable.
"""

from __future__ import annotations

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
