"""Inference-time BatchNorm folding for the ResNet trunk (PyTorch).

Port of `relpose_gnn_tpu/models/fold_bn.py`.  At eval, BN with running
statistics is a per-channel affine map, so it folds into the conv before it:

    W' = W * scale / sqrt(var + eps)       (per output channel)
    b' = bias_bn - scale * mean / sqrt(var + eps)   (+ conv bias * g)

The folded trunk is `ResNet(..., folded=True)`: convs carry a bias, no BN
modules.  Works on torchvision-named state dicts.
"""

from __future__ import annotations

import dataclasses

import torch

from relpose_gnn_tpu_torch.models.posenet import RelPoseGNN, RelPoseGNNConfig

_EPS = 1e-5

_BN_SUFFIX = ("weight", "bias", "running_mean", "running_var",
              "num_batches_tracked")


def _fold_one(w: torch.Tensor, conv_bias: torch.Tensor | None,
              sd: dict, bn: str) -> tuple[torch.Tensor, torch.Tensor]:
    g = sd[f"{bn}.weight"].float() / torch.sqrt(
        sd[f"{bn}.running_var"].float() + _EPS)
    kernel = w.float() * g[:, None, None, None]
    bias = sd[f"{bn}.bias"].float() - sd[f"{bn}.running_mean"].float() * g
    if conv_bias is not None:
        bias = bias + conv_bias.float() * g
    return kernel, bias


def _conv_of(bn: str) -> str:
    """torchvision name of the conv a BN follows (prefix kept):
    `bn1` -> `conv1`, `bn2` -> `conv2`, `downsample.1` -> `downsample.0`."""
    if bn.endswith("downsample.1"):
        return bn[:-1] + "0"
    return bn[:-3] + "conv" + bn[-1]


def fold_resnet_bn(sd: dict, prefix: str = "") -> dict:
    """Unfolded ResNet state dict (torchvision names under `prefix`) ->
    the state dict of `ResNet(folded=True)`.  Other entries pass through."""
    out = dict(sd)
    bns = [k[:-len(".running_var")] for k in sd
           if k.startswith(prefix) and k.endswith(".running_var")]
    for bn in bns:
        conv = _conv_of(bn)
        out[f"{conv}.weight"], out[f"{conv}.bias"] = _fold_one(
            sd[f"{conv}.weight"], sd.get(f"{conv}.bias"), sd, bn)
        for s in _BN_SUFFIX:
            out.pop(f"{bn}.{s}", None)
    return out


def fold_relpose_backbone(model: RelPoseGNN
                          ) -> tuple[RelPoseGNNConfig, RelPoseGNN]:
    """A RelPoseGNN with an unfolded ResNet -> (folded_cfg, folded model)
    with the BN folded into the trunk; GNN and head weights unchanged.
    The new model is on the old one's device."""
    if model.cfg.bn_folded:
        raise ValueError("the backbone is already folded")
    folded_cfg = dataclasses.replace(model.cfg, bn_folded=True)
    device = next(model.parameters()).device
    with torch.device(device):
        folded = RelPoseGNN(folded_cfg)
    folded.load_state_dict(
        fold_resnet_bn(model.state_dict(), prefix="feature_extractor."),
        strict=True)
    return folded_cfg, folded.eval()
