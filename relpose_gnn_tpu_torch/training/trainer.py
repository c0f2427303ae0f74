"""Pose fusion for evaluation (PyTorch).

Port of two functions of `relpose_gnn_tpu/training/trainer.py`:
`fuse_pose_estimates` and `check_fuse_ok`, which the cached-serving step
uses.  The trainer itself (train and eval steps, edge dropout) arrives with
the training slice.
"""

from __future__ import annotations

import torch


def fuse_pose_estimates(est: torch.Tensor, mask: torch.Tensor,
                        fuse: str) -> torch.Tensor:
    """Fuse per-source absolute-pose estimates for one query node.

    est [B, N, 6] (the estimate from each potential source node), mask
    [B, N] (True where an edge source -> query exists) -> [B, 6].
    'mean' is the masked mean; 'median' the masked per-dimension median
    (sort with a +inf fill, average the two middle entries).

    PRECONDITION: every row has at least one True in `mask`; a zero-edge
    row fuses to zeros ('mean') or +inf ('median').  The eval step reports
    it as `fuse_ok` and `check_fuse_ok` raises."""
    if fuse == "mean":
        w = mask.to(est.dtype)[..., None]
        return torch.sum(est * w, 1) / torch.clamp_min(torch.sum(w, 1), 1.0)
    if fuse != "median":
        raise ValueError(f"fuse={fuse!r} (want 'mean' or 'median')")
    big = torch.where(mask[..., None], est,
                      torch.full_like(est, float("inf")))
    srt = torch.sort(big, dim=1).values
    cnt = torch.sum(mask, dim=1)
    n = est.shape[1]
    lo = torch.clamp((cnt - 1) // 2, 0, n - 1)
    hi = torch.clamp(cnt // 2, 0, n - 1)

    def take(k):
        idx = k[:, None, None].expand(-1, 1, est.shape[2])
        return torch.gather(srt, 1, idx)[:, 0]

    return 0.5 * (take(lo) + take(hi))


def check_fuse_ok(out: dict, where: str) -> None:
    """Raise on an eval step's false `fuse_ok` flag (see
    fuse_pose_estimates' precondition); no-op without the flag."""
    if "fuse_ok" in out and not bool(out["fuse_ok"]):
        raise ValueError(
            f"{where}: a query row has ZERO incoming edges in the fuse "
            "mask; fuse='mean'/'median' would silently produce an all-zero "
            "pose or a +inf median for it.  The adjacency feeding this "
            "eval is pathological (or was rebuilt with knn too small)")
