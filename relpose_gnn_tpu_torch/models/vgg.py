"""VGG16 convolutional trunk (NetVLAD encoder backbone), PyTorch.

Port of `relpose_gnn_tpu/models/vgg.py`: torchvision `vgg16.features[:-1]`
as the reference's NetVLAD encoder uses it: thirteen 3x3 conv+ReLU layers,
a 2x2 max pool after each of the first four stages, the final pool dropped,
output stride 16, 512 channels.

The module is an `nn.Sequential` in torchvision's layer order, so its
parameters carry torchvision's indices (`0.weight`, `2.weight`, `5.weight`,
..., `28.weight`): under the name `encoder` it loads the released
`netvlad_vgg16.tar` keys as they are.

NHWC at the public boundary, like the JAX module; the permute to NCHW is a
view with channels-last strides.  `dtype` is the compute dtype; parameters
stay float32 and are cast where they are used.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

# torchvision cfg 'D': channels per conv, 'M' = 2x2 max pool
VGG16_CFG: Sequence = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
                       512, 512, 512, "M", 512, 512, 512)


class VGG16Features(nn.Sequential):
    """Conv trunk: [B, H, W, 3] -> [B, H/16, W/16, 512]."""

    def __init__(self, dtype: torch.dtype | None = None):
        layers: list[nn.Module] = []
        in_ch = 3
        for c in VGG16_CFG:
            if c == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(in_ch, c, 3, padding=1), nn.ReLU()]
                in_ch = c
        super().__init__(*layers)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype or x.dtype).permute(0, 3, 1, 2)  # NCHW view
        for layer in self:
            if isinstance(layer, nn.Conv2d):
                x = F.conv2d(x, layer.weight.to(x.dtype),
                             layer.bias.to(x.dtype), padding=1)
            else:
                x = layer(x)
        return x.permute(0, 2, 3, 1)
