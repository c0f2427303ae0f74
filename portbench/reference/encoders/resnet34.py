"""ResNet34 (He et al., Deep Residual Learning for Image Recognition,
CVPR 2016), torchvision's form: the node encoder of `backbone:
"resnet34"`."""

from __future__ import annotations

from portbench.reference.encoders import _resnet

MODULE = _resnet.MODULE
STAGES = (3, 4, 6, 3)


def spec(m: dict) -> list:
    return _resnet.spec(STAGES, m["feat_dim"])


def forward(sd, m, x, prec, train=False):
    return _resnet.forward(sd, STAGES, x, prec, train)
