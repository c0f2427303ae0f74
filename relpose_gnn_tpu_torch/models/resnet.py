"""ResNet node encoder (PyTorch), torchvision parameter names.

Port of `relpose_gnn_tpu/models/resnet.py`: the torchvision BasicBlock
ResNet34/18 trunk with the classifier replaced by a mean pool and
`Linear(512, feat_dim)`.  Parameter names are torchvision's (`conv1`,
`bn1`, `layer1.0.conv1`, `layer1.0.downsample.0`, `fc`), so the module
loads the `feature_extractor.*` part of a PoseNetX_R2 state dict.

* The public layout is NHWC [B, H, W, 3], as in the JAX module.  The
  permute to NCHW is a view with channels-last strides, so cuDNN runs the
  convolutions in NHWC without a copy.
* `dtype` is the compute dtype; parameters stay float32 and are cast
  where they are used (the JAX module's `dtype=` semantics).  The mean pool
  and `fc` run in float32, as in the JAX module.
* `folded=True` is the serving form: BN folded into the convs
  (models/fold_bn.py), convs carry a bias, no BN modules.
* `s2d_stem=True` is the space-to-depth form of the 7x7/s2 stem: 2x2
  pixel blocks packed into 4 x in_channels channels, a 4x4/s1 `conv1`
  (the 7x7 kernel padded to 8x8 and regrouped by
  `fold_bn.py::space_to_depth_conv1`) with padding ((2, 1), (2, 1)).
  The same function as the 7x7 stem up to float summation order.
* `in_channels` is 3 but for the pair encoders (6: two images
  channel-concatenated); the keys are the same.
* BatchNorm has flax's semantics in both modes.  It normalises in
  float32 whatever the compute dtype and casts the result to it.  Eval
  (`train=False`) uses the float32 running statistics as they are (no
  copies in the compute dtype).  Train uses the batch's biased mean and
  variance and updates the running buffers once per forward as flax's
  `BatchNorm(momentum=0.9)` does: `ra = 0.9 ra + 0.1 stat`, with the
  BIASED variance (`F.batch_norm(training=True)` would store the
  unbiased one, so it is given no buffers).  `num_batches_tracked`
  stays 0, as in the JAX exporter's state dicts.
* Over several ranks (`shard`, parallel/sharding.py::DataShard) train
  mode normalises with the GLOBAL batch's statistics, as flax's BatchNorm
  does under a batch split over the data axis: two all-reduces a layer,
  the per-channel sum and count for the mean, then the centred squares
  for the (two-pass, biased) variance, through
  `torch.distributed.nn.functional.all_reduce` so that the gradient flows
  through them; every rank then folds the same statistics into its
  running buffers.  `COUNTS["bn_all_reduce"]` counts these all-reduces.
  (`nn.SyncBatchNorm` merges Welford partials, not this variance.)
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

_BN_EPS = 1e-5

# all-reduces issued by train-mode BatchNorm over several ranks
COUNTS = {"bn_all_reduce": 0}


def _conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    dt = x.dtype
    bias = None if conv.bias is None else conv.bias.to(dt)
    return F.conv2d(x, conv.weight.to(dt), bias, conv.stride, conv.padding)


# flax's BatchNorm momentum: the share of the old running statistic kept
_BN_MOMENTUM = 0.9


def _global_stats(x32: torch.Tensor, group) -> tuple:
    """(mean, biased variance, x32 - mean) per channel of NCHW `x32` over
    every rank of `group`, two-pass: the sum and count, then the centred
    squares."""
    import torch.distributed.nn.functional as dist_fn
    c = x32.shape[1]
    count = torch.full((1,), x32.numel() // c, dtype=x32.dtype,
                       device=x32.device)
    sums = dist_fn.all_reduce(torch.cat([x32.sum(dim=(0, 2, 3)), count]),
                              group=group)
    n = sums[c]
    mean = sums[:c] / n
    d = x32 - mean[None, :, None, None]
    var = dist_fn.all_reduce((d * d).sum(dim=(0, 2, 3)), group=group) / n
    COUNTS["bn_all_reduce"] += 2
    return mean, var, d


def _bn(x: torch.Tensor, bn: nn.BatchNorm2d | None, train: bool = False,
        update_stats: bool = True, shard=None) -> torch.Tensor:
    """BatchNorm over NCHW `x`, computed in float32 and cast back to
    x.dtype.  train: normalise with the batch's statistics (the global
    batch's over the ranks of `shard`) and, if `update_stats`, fold them
    into the running buffers; else normalise with the running buffers."""
    if bn is None:
        return x
    x32 = x.float()
    if not train:
        return F.batch_norm(x32, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, training=False, eps=bn.eps).to(x.dtype)
    if shard is not None:
        mean, var, d = _global_stats(x32, shard.group)
        scale = bn.weight * torch.rsqrt(var + bn.eps)
        y = d * scale[None, :, None, None] + bn.bias[None, :, None, None]
        mean, var = mean.detach(), var.detach()
    else:
        y = F.batch_norm(x32, None, None, bn.weight, bn.bias, training=True,
                         eps=bn.eps)
    if update_stats:
        with torch.no_grad():
            if shard is None:
                var, mean = torch.var_mean(x32, dim=(0, 2, 3),
                                           unbiased=False)
            bn.running_mean.mul_(_BN_MOMENTUM).add_(
                mean, alpha=1 - _BN_MOMENTUM)
            bn.running_var.mul_(_BN_MOMENTUM).add_(
                var, alpha=1 - _BN_MOMENTUM)
    return y.to(x.dtype)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """NHWC [B, H, W, C] -> [B, ceil(H/2), ceil(W/2), 4C]: each 2x2 pixel
    block packed into channels (dy * 2C + dx * C + c), an odd extent
    padded with a zero row or column first (the JAX stem's packing)."""
    b, h, w, c = x.shape
    x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
    h2, w2 = (h + h % 2) // 2, (w + w % 2) // 2
    x = x.reshape(b, h2, 2, w2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h2, w2, 4 * c)


class BasicBlock(nn.Module):
    """torchvision BasicBlock: 3x3-BN-ReLU-3x3-BN + projection shortcut."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 folded: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1, bias=folded)
        self.bn1 = None if folded else nn.BatchNorm2d(planes, eps=_BN_EPS)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=folded)
        self.bn2 = None if folded else nn.BatchNorm2d(planes, eps=_BN_EPS)
        self.downsample = None
        if stride != 1 or in_planes != planes:
            layers = [nn.Conv2d(in_planes, planes, 1, stride, bias=folded)]
            if not folded:
                layers.append(nn.BatchNorm2d(planes, eps=_BN_EPS))
            self.downsample = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, train: bool = False,
                update_stats: bool = True, shard=None) -> torch.Tensor:
        bn = functools.partial(_bn, train=train, update_stats=update_stats,
                               shard=shard)
        y = F.relu(bn(_conv(x, self.conv1), self.bn1))
        y = bn(_conv(y, self.conv2), self.bn2)
        residual = x
        if self.downsample is not None:
            residual = _conv(x, self.downsample[0])
            residual = bn(residual, self.downsample[1]
                          if len(self.downsample) > 1 else None)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """BasicBlock ResNet trunk + mean pool + `fc` projection.

    forward: [B, H, W, 3] NHWC -> float32 [B, feat_dim]; `train` picks
    batch statistics for BN and updates the running ones unless
    `update_stats` is False (a recomputation under
    `torch.utils.checkpoint` passes False); `shard` (a DataShard) takes
    them over the global batch of its ranks."""

    def __init__(self, stage_sizes: Sequence[int], feat_dim: int = 2048,
                 dtype: torch.dtype | None = None, folded: bool = False,
                 s2d_stem: bool = False, in_channels: int = 3):
        super().__init__()
        self.dtype = dtype
        self.s2d_stem = s2d_stem
        self.conv1 = (nn.Conv2d(4 * in_channels, 64, 4, 1, bias=folded)
                      if s2d_stem else
                      nn.Conv2d(in_channels, 64, 7, 2, 3, bias=folded))
        self.bn1 = None if folded else nn.BatchNorm2d(64, eps=_BN_EPS)
        in_planes = 64
        for stage, num_blocks in enumerate(stage_sizes):
            planes = 64 * 2 ** stage
            blocks = []
            for block in range(num_blocks):
                stride = 2 if stage > 0 and block == 0 else 1
                blocks.append(BasicBlock(in_planes, planes, stride, folded))
                in_planes = planes
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)
        self.fc = nn.Linear(in_planes, feat_dim)

    def forward(self, x: torch.Tensor, train: bool = False,
                update_stats: bool = True, shard=None) -> torch.Tensor:
        x = x.to(self.dtype or x.dtype)
        if self.s2d_stem:
            x = F.pad(space_to_depth(x).permute(0, 3, 1, 2), (2, 1, 2, 1))
        else:
            x = x.permute(0, 3, 1, 2)  # NCHW view
        x = F.relu(_bn(_conv(x, self.conv1), self.bn1, train, update_stats,
                       shard))
        # pads with -inf, like flax max_pool's padding=((1, 1), (1, 1))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage in range(self.num_stages):
            for block in getattr(self, f"layer{stage + 1}"):
                x = block(x, train, update_stats, shard)
        x = torch.mean(x.float(), dim=(2, 3))
        return F.linear(x, self.fc.weight, self.fc.bias)
