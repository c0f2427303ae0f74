"""Inference-time BatchNorm folding for the ResNet trunk (PyTorch).

Port of `relpose_gnn_tpu/models/fold_bn.py`.  At eval, BN with running
statistics is a per-channel affine map, so it folds into the conv before it:

    W' = W * scale / sqrt(var + eps)       (per output channel)
    b' = bias_bn - scale * mean / sqrt(var + eps)   (+ conv bias * g)

The folded trunk is `ResNet(..., folded=True)`: convs carry a bias, no BN
modules.  Works on torchvision-named state dicts.

`space_to_depth_conv1` rewrites the 7x7/s2 stem into its space-to-depth
form (`ResNet(s2d_stem=True)`), a weight transform that needs no
retraining; `fold_relpose_backbone(model, s2d_stem=True)` applies it after
the fold, the serving form `RelocalizationService(s2d_stem=True)` asks for.
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


def space_to_depth_conv1(w: torch.Tensor) -> torch.Tensor:
    """A 7x7/s2 stem kernel [O, C, 7, 7] -> its space-to-depth form
    [O, 4C, 4, 4] (JAX fold_bn.py::space_to_depth_conv1, in torch's
    layout): zero-pad the kernel to 8x8 on the leading taps (output pixel
    o reads input rows 2o-3..2o+3; the 8-tap window 2o-4..2o+3 starts on
    an even pixel and its tap 0 meets a zero), then regroup each 2x2 block
    of taps into channels,

        K_s2d[o, dy*2C + dx*C + c, ki, kj] = K8[o, c, 2ki + dy, 2kj + dx],

    the packing of `resnet.py::space_to_depth`.  A bias is unchanged."""
    if tuple(w.shape[2:]) != (7, 7):
        raise ValueError(f"want a 7x7 stem kernel, got {tuple(w.shape)}")
    o, c = w.shape[:2]
    k8 = torch.zeros((o, c, 8, 8), dtype=torch.float32, device=w.device)
    k8[:, :, 1:, 1:] = w.float()
    k8 = k8.reshape(o, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
    return k8.reshape(o, 4 * c, 4, 4).contiguous()


def fold_relpose_backbone(model: RelPoseGNN, s2d_stem: bool = False
                          ) -> tuple[RelPoseGNNConfig, RelPoseGNN]:
    """A RelPoseGNN with an unfolded ResNet -> (folded_cfg, folded model)
    with the BN folded into the trunk; GNN and head weights unchanged.
    With `s2d_stem` the stem is also rewritten into its space-to-depth
    form.  The new model is on the old one's device.  Only ResNet
    backbones fold (the ViT has no BatchNorm)."""
    if model.cfg.bn_folded:
        raise ValueError("the backbone is already folded")
    if not model.cfg.backbone.startswith("resnet"):
        raise ValueError(f"backbone {model.cfg.backbone!r} has no "
                         "BatchNorm to fold")
    folded_cfg = dataclasses.replace(model.cfg, bn_folded=True,
                                     s2d_stem=s2d_stem)
    device = next(model.parameters()).device
    with torch.device(device):
        folded = RelPoseGNN(folded_cfg)
    sd = fold_resnet_bn(model.state_dict(), prefix="feature_extractor.")
    if s2d_stem and not model.cfg.s2d_stem:
        sd["feature_extractor.conv1.weight"] = space_to_depth_conv1(
            sd["feature_extractor.conv1.weight"])
    folded.load_state_dict(sd, strict=True)
    return folded_cfg, folded.eval()
