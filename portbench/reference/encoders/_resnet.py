"""torchvision's BasicBlock ResNet as the program states it, shared by
the ResNet encoders: the 7x7/2 stem as published, BatchNorm after every
conv (unfolded: the reference works the serving fold out again), mean
pool, and the classifier replaced by `fc: 512 -> feat_dim`."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.params import add_bn, add_linear

MODULE = "feature_extractor"
BN_EPS = 1e-5


def spec(stages, feat_dim: int) -> list:
    """The parameters of a ResNet with `stages` blocks a stage."""
    prefix = MODULE + "."
    out = [(f"{prefix}conv1.weight", (64, 3, 7, 7), "fan_in")]
    add_bn(out, f"{prefix}bn1", 64)
    in_planes = 64
    for s, n in enumerate(stages):
        planes = 64 * 2 ** s
        for b in range(n):
            stride = 2 if s > 0 and b == 0 else 1
            p = f"{prefix}layer{s + 1}.{b}."
            out.append((p + "conv1.weight", (planes, in_planes, 3, 3),
                        "fan_in"))
            add_bn(out, p + "bn1", planes)
            out.append((p + "conv2.weight", (planes, planes, 3, 3),
                        "fan_in"))
            add_bn(out, p + "bn2", planes)
            if stride != 1 or in_planes != planes:
                out.append((p + "downsample.0.weight",
                            (planes, in_planes, 1, 1), "fan_in"))
                add_bn(out, p + "downsample.1", planes)
            in_planes = planes
    add_linear(out, f"{prefix}fc", feat_dim, in_planes)
    return out


def _bn(x, sd, name, train):
    """BatchNorm over NCHW: the batch's biased statistics (train) or the
    running ones."""
    if train:
        var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
    else:
        mean, var = sd[name + ".running_mean"], sd[name + ".running_var"]
    scale = sd[name + ".weight"] * torch.rsqrt(var + BN_EPS)
    shift = sd[name + ".bias"] - mean * scale
    return x * scale[None, :, None, None] + shift[None, :, None, None]


def forward(sd, stages, x, prec, train=False):
    """[B, H, W, 3] normalised images -> [B, feat]."""
    prefix = MODULE + "."

    def conv(t, name, stride, pad):
        return prec.conv(t, sd[prefix + name + ".weight"], None, stride, pad)

    def bn(t, name):
        return prec.q(_bn(t, sd, prefix + name, train))

    x = x.permute(0, 3, 1, 2)
    x = F.relu(bn(conv(x, "conv1", 2, 3), "bn1"))
    x = F.max_pool2d(x, 3, 2, 1)
    in_planes = 64
    for s, n in enumerate(stages):
        planes = 64 * 2 ** s
        for b in range(n):
            stride = 2 if s > 0 and b == 0 else 1
            p = f"layer{s + 1}.{b}."
            y = F.relu(bn(conv(x, p + "conv1", stride, 1), p + "bn1"))
            y = bn(conv(y, p + "conv2", 1, 1), p + "bn2")
            if stride != 1 or in_planes != planes:
                x = bn(conv(x, p + "downsample.0", stride, 0),
                       p + "downsample.1")
            x = prec.q(F.relu(y + x))
            in_planes = planes
    x = x.mean(dim=(2, 3))
    return prec.linear(x, sd[prefix + "fc.weight"], sd[prefix + "fc.bias"])
