"""Pose-graph optimisation: Gauss-Newton on the SE(3) manifold, in torch.

Port of `relpose_gnn_tpu/ops/pgo.py` (reference utils/pose_utils.py:
526-874).  The state is N pose7s [t, q]; unary residuals pull each node
toward its predicted pose, pairwise residuals hold relative-pose (VO)
measurements on consecutive edges (`PoseGraph`) or on all pairs
(`PoseGraphFC`); increments apply through the quaternion exponential map.

As in the JAX module, the Jacobian of the residual with respect to the
6-dof increment comes from forward-mode differentiation at the identity
increment (`torch.func.jacfwd`, in place of the reference's analytic
blocks), then H = J^T J + damping I, one solve, and the next iterate; a
Python loop of `n_iters` such steps stands in for the `lax.scan`.

Residuals:
    unary:     (z_i - pose_i) / sqrt(s)                     (t and q parts)
    pairwise:  R(q_i)^-1 (t_j - t_i) - vo_t                 / sqrt(srx)
               (q_i^-1 * q_j) - vo_q  (plain 4-vector diff) / sqrt(srq)

The Jacobian is DENSE, [R, 6N] with R = 7N + 7E residual rows: a chain of
N poses has 7(2N - 1) rows, the fully connected graph 7N + 7N(N-1)/2, so
at N = 256 the fully connected J alone is 230272 x 1536 float32 = 1.4 GB
(and `jacfwd` holds intermediates of that size), against 3 MB for the
chain.
"""

from __future__ import annotations

import numpy as np
import torch

from relpose_gnn_tpu_torch import resolve_device
from relpose_gnn_tpu_torch.ops import pose as pose_ops


def _retract(z: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Apply a [N, 6] manifold increment to [N, 7] poses: additive on t,
    right-multiplied exponential map on q."""
    t = z[:, :3] + delta[:, :3]
    q = pose_ops.qmult(z[:, 3:], pose_ops.qexp(delta[:, 3:]))
    return torch.cat([t, q], dim=1)


def _residuals(z, poses, vos, src, dst, weights) -> torch.Tensor:
    """Stacked weighted residual vector."""
    w_ax, w_aq, w_rx, w_rq = weights
    w_abs = torch.tensor([w_ax] * 3 + [w_aq] * 4, dtype=z.dtype,
                         device=z.device)
    r_abs = (z - poses) * w_abs
    ti, tj = z[src, :3], z[dst, :3]
    qi_inv = pose_ops.qinv(z[src, 3:])
    rt = pose_ops.rotate_vec_by_q(tj - ti, qi_inv) - vos[:, :3]
    rq = pose_ops.qmult(qi_inv, z[dst, 3:]) - vos[:, 3:]
    return torch.cat([r_abs.reshape(-1), (w_rx * rt).reshape(-1),
                      (w_rq * rq).reshape(-1)])


def _optimize(z, poses, vos, src, dst, weights, n_iters: int,
              damping: float) -> torch.Tensor:
    def res_of_delta(delta, z):
        return _residuals(_retract(z, delta), poses, vos, src, dst, weights)

    jac = torch.func.jacfwd(res_of_delta)
    eye = torch.eye(6 * z.shape[0], dtype=z.dtype, device=z.device)
    for _ in range(n_iters):
        delta0 = torch.zeros(z.shape[0], 6, dtype=z.dtype, device=z.device)
        J = jac(delta0, z).reshape(-1, 6 * z.shape[0])      # [R, 6N]
        r = res_of_delta(delta0, z)
        H = J.T @ J + damping * eye
        dx = -torch.linalg.solve(H, J.T @ r).reshape(-1, 6)
        z = _retract(z, dx)
    return z


def chain_edges(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Consecutive edges (PoseGraph)."""
    return np.arange(n - 1), np.arange(1, n)


def fc_edges(n: int) -> tuple[np.ndarray, np.ndarray]:
    """All i < j pairs, row-major (PoseGraphFC)."""
    src, dst = np.triu_indices(n, k=1)
    return src, dst


def optimize_pose_graph(pred_poses, vos, fc: bool = False, sax: float = 1.0,
                        saq: float = 1.0, srx: float = 1.0, srq: float = 1.0,
                        n_iters: int = 10, damping: float = 1e-9,
                        device=None,
                        dtype: torch.dtype = torch.float32) -> np.ndarray:
    """PGO initialised at `pred_poses` [N, 7] with VO measurements `vos`
    [E, 7] (E = N-1 chained, N(N-1)/2 fully connected); returns the
    optimised [N, 7] as numpy.

    Weights are 1/sqrt(sigma), as the reference's Cholesky factor of the
    information.  Runs on `device` (None: the card) in float32 as the JAX
    function does (TF32 off, as the entry points pin it); `dtype=torch.float64` gives a reference evaluation."""
    dev = resolve_device(device)
    z0 = torch.tensor(np.asarray(pred_poses), dtype=dtype, device=dev)
    n = z0.shape[0]
    src, dst = fc_edges(n) if fc else chain_edges(n)
    if len(vos) != len(src):
        raise ValueError(f"{len(vos)} VO measurements for {len(src)} "
                         f"{'fully connected' if fc else 'chained'} edges "
                         f"of {n} poses")
    weights = (1.0 / np.sqrt(sax), 1.0 / np.sqrt(saq),
               1.0 / np.sqrt(srx), 1.0 / np.sqrt(srq))
    out = _optimize(z0, z0, torch.tensor(np.asarray(vos), dtype=dtype,
                                         device=dev),
                    torch.as_tensor(src, device=dev),
                    torch.as_tensor(dst, device=dev), weights, n_iters,
                    damping)
    return out.cpu().numpy()


def vos_from_target_poses(target_poses, rotate_frame: bool = False,
                          device=None) -> np.ndarray:
    """Consecutive VO measurements [N-1, 7] from ground-truth poses
    [N, 7].

    `rotate_frame=False` is the reference driver's convention: the
    WORLD-frame translation difference and the relative quaternion.  That
    is inconsistent with the residual, which rotates the translation
    difference into the source frame; the quirk is kept for parity.
    `rotate_frame=True` gives measurements consistent with the residual
    (the ground truth is then a fixed point of the optimisation)."""
    t = np.asarray(target_poses)
    dev = resolve_device(device)

    def f32(a):   # the JAX function's arrays: float32 on the device
        return torch.tensor(a, dtype=torch.float32, device=dev)

    q0 = f32(t[:-1, 3:])
    dt = f32(t[1:, :3] - t[:-1, :3])
    vos_t = (pose_ops.rotate_vec_by_q(dt, pose_ops.qinv(q0)) if rotate_frame
             else dt)
    vos_q = pose_ops.qmult(pose_ops.qinv(q0), f32(t[1:, 3:]))
    return torch.cat([vos_t, vos_q], dim=1).cpu().numpy()


def optimize_poses(pred_poses, vos=None, fc_vos: bool = False,
                   target_poses=None, sax: float = 1, saq: float = 1,
                   srx: float = 1, srq: float = 1, n_iters: int = 10,
                   device=None) -> np.ndarray | None:
    """The reference's `optimize_poses` driver: VOs from `target_poses`
    (chained) where none are given; None where there are neither."""
    if vos is None:
        if target_poses is None:
            return None
        vos = vos_from_target_poses(target_poses, device=device)
    return optimize_pose_graph(pred_poses, vos, fc=fc_vos, sax=sax, saq=saq,
                               srx=srx, srq=srq, n_iters=n_iters,
                               device=device)
