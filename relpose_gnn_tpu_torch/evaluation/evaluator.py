"""Pose error statistics (numpy float64).

Port of `relpose_gnn_tpu/evaluation/evaluator.py::{PoseErrors,
compute_pose_errors, evaluate_dataset, save_poses}` (reference
testing/test.py:236-276).  Re-implemented
here because the JAX package's `evaluation` package imports jax.  Errors
are computed in float64 on the host: float32 arccos noise near 0 degrees
would bias small medians.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterable

import numpy as np


@dataclasses.dataclass
class PoseErrors:
    median_t: float
    mean_t: float
    median_q: float
    mean_q: float
    t_errors: np.ndarray
    q_errors: np.ndarray
    pred_poses: np.ndarray  # [L, 7] = [t, quat]
    targ_poses: np.ndarray  # [L, 7]

    def __str__(self):
        return (f"Error in translation: median {self.median_t:3.2f} m, "
                f"mean {self.mean_t:3.2f} m\t"
                f"Error in rotation: median {self.median_q:3.2f} degrees, "
                f"mean {self.mean_q:3.2f} degrees")


def _qexp(w: np.ndarray) -> np.ndarray:
    """log-quaternion [.., 3] -> unit quaternion [w, x, y, z]."""
    n = np.linalg.norm(w, axis=-1, keepdims=True)
    return np.concatenate([np.cos(n), np.sinc(n / np.pi) * w], axis=-1)


def _quat_angular_error(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """Angle between unit quaternions, in degrees."""
    d = np.clip(np.abs(np.sum(q1 * q2, axis=-1)), -1.0, 1.0)
    return 2.0 * np.arccos(d) * 180.0 / np.pi


def compute_pose_errors(pred6: np.ndarray, targ6: np.ndarray,
                        pose_mean: np.ndarray | None = None,
                        pose_std: np.ndarray | None = None) -> PoseErrors:
    """pose6 [L, 6] = [t, log q] predictions and targets -> errors: both
    mapped to unit quaternions, translations un-normalised (Cambridge
    stats), then L2 and angular errors with median and mean."""
    pred6 = np.asarray(pred6, np.float64)
    targ6 = np.asarray(targ6, np.float64)
    pred_q, targ_q = _qexp(pred6[:, 3:]), _qexp(targ6[:, 3:])
    pred_t, targ_t = pred6[:, :3], targ6[:, :3]
    if pose_std is not None:
        pred_t, targ_t = pred_t * pose_std, targ_t * pose_std
    if pose_mean is not None:
        pred_t, targ_t = pred_t + pose_mean, targ_t + pose_mean
    t_err = np.linalg.norm(pred_t - targ_t, axis=-1)
    q_err = _quat_angular_error(pred_q, targ_q)
    return PoseErrors(
        median_t=float(np.median(t_err)), mean_t=float(np.mean(t_err)),
        median_q=float(np.median(q_err)), mean_q=float(np.mean(q_err)),
        t_errors=t_err, q_errors=q_err,
        pred_poses=np.concatenate([pred_t, pred_q], axis=1),
        targ_poses=np.concatenate([targ_t, targ_q], axis=1))


def save_poses(save_dir: str, scene: str, errors: PoseErrors,
               tag: str = "relpose_gnn_tpu",
               rel_paths: list | None = None) -> str:
    """Export predictions in the reference's npz convention, the median
    errors in the file name (testing/test.py:38-42, :278-284); the
    query-image paths under `rel_path` where given.  Returns the path."""
    os.makedirs(save_dir, exist_ok=True)
    fname = (f"{tag}_{scene}_{errors.median_t:.2f}_"
             f"{errors.median_q:.1f}.npz")
    path = os.path.join(save_dir, fname)
    arrays = dict(
        abs_t=errors.pred_poses[:, :3], abs_q=errors.pred_poses[:, 3:],
        targ_t=errors.targ_poses[:, :3], targ_q=errors.targ_poses[:, 3:])
    if rel_paths is not None:
        if len(rel_paths) != len(errors.pred_poses):
            raise ValueError(
                f"len(rel_paths): {len(rel_paths)} != "
                f"{len(errors.pred_poses)} len(pred_poses)")
        arrays["rel_path"] = np.asarray(rel_paths)
    np.savez(path, **arrays)
    return path


def evaluate_dataset(eval_step: Callable, state, batches: Iterable[dict],
                     pose_mean: np.ndarray | None = None,
                     pose_std: np.ndarray | None = None) -> PoseErrors:
    """Run the eval step (`training/trainer.py::make_eval_step`) over an
    iterable of device batches and reduce to pose errors."""
    from relpose_gnn_tpu_torch.training.trainer import check_fuse_ok

    preds, targs = [], []
    for batch in batches:
        out = eval_step(state, batch)
        check_fuse_ok(out, "evaluate_dataset")
        preds.append(out["pred"].float().cpu().numpy())
        targs.append(out["target"].float().cpu().numpy())
    return compute_pose_errors(np.concatenate(preds), np.concatenate(targs),
                               pose_mean=pose_mean, pose_std=pose_std)
