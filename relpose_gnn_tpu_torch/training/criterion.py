"""Pose regression criteria with learnable homoscedastic weights (PyTorch).

Port of `relpose_gnn_tpu/training/criterion.py` (reference
modules/criterion.py):

    loss = exp(-sax) * L1(pred_t, targ_t) + sax
         + exp(-saq) * L1(pred_q, targ_q) + saq

The weights (`sax`, `saq`, and `srx`, `srq` for the VO terms) are learnable
float32 scalars: `init_criterion_params` returns a `torch.nn.ParameterDict`
that the trainer hands to the same Adam as the model (train.py:203-211).
Every function takes such a mapping, or any mapping of scalar tensors.

The dense-graph form takes an [..., N, N] edge mask so that the mean is
over the E real edges only, as torch's `nn.L1Loss` over E edges.  Over
several ranks (`shard`, parallel/sharding.py::DataShard) that mean is the
global batch's: the JAX trainer divides the global sum by the global
count, while DistributedDataParallel averages the ranks' gradients.  So
the count is all-reduced and each rank's sum is scaled by the number of
ranks: the mean of the ranks' losses is then the global loss, and their
averaged gradients its gradient, whatever each rank's own count.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.distributed as dist
import torch.nn as nn

from relpose_gnn_tpu_torch.ops.pose import calc_vo


def _scalars(device=None, **values) -> nn.ParameterDict:
    return nn.ParameterDict({
        k: nn.Parameter(torch.tensor(float(v), dtype=torch.float32,
                                     device=device))
        for k, v in values.items()})


def init_criterion_params(sax: float = 0.0, saq: float = 0.0,
                          device=None) -> nn.ParameterDict:
    return _scalars(device, sax=sax, saq=saq)


def init_mapnet_criterion_params(sax: float = -1.0, saq: float = -4.0,
                                 srx: float = -1.0, srq: float = -4.0,
                                 device=None) -> nn.ParameterDict:
    return _scalars(device, sax=sax, saq=saq, srx=srx, srq=srq)


def _masked_l1(pred: torch.Tensor, targ: torch.Tensor,
               mask: torch.Tensor | None, shard=None) -> torch.Tensor:
    """Mean absolute error; with `mask` (broadcast over the feature axis)
    the mean over unmasked positions only.  With `shard`, this rank's
    share of the global mean, times the number of ranks (module
    docstring); the ranks' rows are equal in number, so an unmasked mean
    needs no change."""
    err = torch.abs(pred - targ)
    if mask is None:
        return torch.mean(err)
    w = mask.to(err.dtype)[..., None]
    total = torch.sum(err * w)
    count = torch.sum(w) * err.shape[-1]
    if shard is not None:
        count = count.detach().clone()
        dist.all_reduce(count, group=shard.group)
        total = total * shard.size
    return total / torch.clamp_min(count, 1.0)


def _weighted(params: Mapping, key: str, loss: torch.Tensor) -> torch.Tensor:
    return torch.exp(-params[key]) * loss + params[key]


def pose_net_criterion(params: Mapping, pred: torch.Tensor,
                       targ: torch.Tensor, mask: torch.Tensor | None = None,
                       shard=None) -> tuple:
    """Homoscedastic L1 on [..., 6] = [t(3), logq(3)] poses.
    Returns (total, t_loss, q_loss); with `shard`, each rank's share
    (their mean over the ranks is the global batch's value)."""
    t_loss = _masked_l1(pred[..., :3], targ[..., :3], mask, shard)
    q_loss = _masked_l1(pred[..., 3:], targ[..., 3:], mask, shard)
    loss = _weighted(params, "sax", t_loss) + _weighted(params, "saq",
                                                        q_loss)
    return loss, t_loss, q_loss


def pose_net_trans_criterion(params: Mapping, pred: torch.Tensor,
                             targ: torch.Tensor,
                             mask: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Translation-only form (criterion.py:63-85)."""
    return _weighted(params, "sax",
                     _masked_l1(pred[..., :3], targ[..., :3], mask))


def pose_net_rot_criterion(params: Mapping, pred: torch.Tensor,
                           targ: torch.Tensor,
                           mask: torch.Tensor | None = None) -> torch.Tensor:
    """Rotation-only form (criterion.py:88-110)."""
    return _weighted(params, "saq",
                     _masked_l1(pred[..., 3:], targ[..., 3:], mask))


def quaternion_loss(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Huynh's quaternion distance mean(1 - <q1, q2>^2)."""
    d = torch.sum(q1 * q2, dim=-1)
    return torch.mean(1.0 - d * d)


def _abs_loss(params: Mapping, pred: torch.Tensor,
              targ: torch.Tensor) -> torch.Tensor:
    return (_weighted(params, "sax", _masked_l1(pred[..., :3],
                                                targ[..., :3], None))
            + _weighted(params, "saq", _masked_l1(pred[..., 3:],
                                                  targ[..., 3:], None)))


def mapnet_online_criterion(params: Mapping, pred: torch.Tensor,
                            targ: torch.Tensor,
                            gps_mode: bool = False) -> torch.Tensor:
    """`MapNetOnlineCriterion` (criterion.py:171-244).

    pred [B, 2T, 7]: T absolute predictions of labelled frames, then T of
    the unlabelled VO frames.  gps_mode=False: the last T become T-1
    geometric VOs (`calc_vo` on consecutive pose7s) and targ is
    [B, 2T-1, 7]; gps_mode=True: they are compared as they are with T GPS
    rows (translation [:2] only, no rotation term), targ [B, 2T, 7]."""
    t = pred.shape[-2] // 2
    pred_abs, pred_vos = pred[..., :t, :], pred[..., t:, :]
    targ_abs, targ_vos = targ[..., :t, :], targ[..., t:, :]
    expect = 2 * t if gps_mode else 2 * t - 1
    if targ.shape[-2] != expect:
        raise ValueError(f"targ rows {targ.shape[-2]} != {expect} for "
                         f"gps_mode={gps_mode}")
    abs_loss = _abs_loss(params, pred_abs, targ_abs)
    if not gps_mode:
        pred_vos = calc_vo(pred_vos[..., :-1, :], pred_vos[..., 1:, :])
    idx = 2 if gps_mode else 3
    vo_loss = _weighted(params, "srx", _masked_l1(pred_vos[..., :idx],
                                                  targ_vos[..., :idx], None))
    if not gps_mode:
        vo_loss = vo_loss + _weighted(
            params, "srq", _masked_l1(pred_vos[..., 3:], targ_vos[..., 3:],
                                      None))
    return abs_loss + vo_loss


def pose_net_criterion_original(params: Mapping, pred: torch.Tensor,
                                targ: torch.Tensor) -> torch.Tensor:
    """`PoseNetCriterion_original` (criterion.py:299-321): MSE on
    [t(3), quat(4)], the target quaternion L2-normalised first."""
    targ_q = targ[..., 3:]
    targ_q = targ_q / torch.clamp_min(
        torch.linalg.vector_norm(targ_q, dim=-1, keepdim=True), 1e-12)
    t_loss = torch.mean((pred[..., :3] - targ[..., :3]) ** 2)
    q_loss = torch.mean((pred[..., 3:] - targ_q) ** 2)
    return _weighted(params, "sax", t_loss) + _weighted(params, "saq",
                                                        q_loss)


def mapnet_criterion(params: Mapping, pred: torch.Tensor,
                     targ: torch.Tensor) -> torch.Tensor:
    """Absolute + consecutive-VO loss (criterion.py:113-168); pred and
    targ [B, T, 6], VOs as plain differences."""
    pred_vos = pred[..., 1:, :] - pred[..., :-1, :]
    targ_vos = targ[..., 1:, :] - targ[..., :-1, :]
    vo_loss = (_weighted(params, "srx", _masked_l1(pred_vos[..., :3],
                                                   targ_vos[..., :3], None))
               + _weighted(params, "srq", _masked_l1(pred_vos[..., 3:],
                                                     targ_vos[..., 3:],
                                                     None)))
    return _abs_loss(params, pred, targ) + vo_loss
