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
* Inference only: BN always uses its running statistics.  The train-mode
  forward arrives with the training slice.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

_BN_EPS = 1e-5


def _conv(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    dt = x.dtype
    bias = None if conv.bias is None else conv.bias.to(dt)
    return F.conv2d(x, conv.weight.to(dt), bias, conv.stride, conv.padding)


def _bn(x: torch.Tensor, bn: nn.BatchNorm2d | None) -> torch.Tensor:
    if bn is None:
        return x
    dt = x.dtype
    return F.batch_norm(x, bn.running_mean.to(dt), bn.running_var.to(dt),
                        bn.weight.to(dt), bn.bias.to(dt), training=False,
                        eps=bn.eps)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(_bn(_conv(x, self.conv1), self.bn1))
        y = _bn(_conv(y, self.conv2), self.bn2)
        residual = x
        if self.downsample is not None:
            residual = _conv(x, self.downsample[0])
            residual = _bn(residual, self.downsample[1]
                           if len(self.downsample) > 1 else None)
        return F.relu(y + residual)


class ResNet(nn.Module):
    """BasicBlock ResNet trunk + mean pool + `fc` projection.

    forward: [B, H, W, 3] NHWC -> float32 [B, feat_dim]."""

    def __init__(self, stage_sizes: Sequence[int], feat_dim: int = 2048,
                 dtype: torch.dtype | None = None, folded: bool = False):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=folded)
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype or x.dtype).permute(0, 3, 1, 2)  # NCHW view
        x = F.relu(_bn(_conv(x, self.conv1), self.bn1))
        # pads with -inf, like flax max_pool's padding=((1, 1), (1, 1))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        x = torch.mean(x.float(), dim=(2, 3))
        return F.linear(x, self.fc.weight, self.fc.bias)
