"""ViT node encoder (PyTorch), timm parameter names.

Port of `relpose_gnn_tpu/models/vit.py` (`TransformerBlock`, `ViTEncoder`):
a pre-norm ViT (patchify -> transformer -> CLS readout -> linear
projection to `feat_dim`), ViT-B/16 by default.  The math is the flax
module's, where it differs from torch's defaults:

  * LayerNorm eps 1e-6 (flax's; torch's default is 1e-5), statistics and
    normalisation in float32 whatever the compute dtype, the result cast
    back to it;
  * GELU with `approximate="tanh"` (`jax.nn.gelu`'s default; timm uses the
    exact one);
  * attention as flax `MultiHeadDotProductAttention` computes it: per-head
    q, k and v with bias, q DIVIDED by sqrt(head_dim) before the product,
    softmax over the keys, then the output projection.  The product runs
    through `F.scaled_dot_product_attention` with scale 1 (flash attention
    on the card).  The JAX package computes this attention in plain XLA, so
    it is no TPU kernel;
  * trailing image rows and columns that do not fill a patch are cropped;
  * the `fc` head runs in float32 on the CLS row.

Parameter names are timm's (`patch_embed.proj`, `cls_token`, `pos_embed`,
`blocks.{i}.norm1`, `.attn.qkv` (q, k and v fused, [3 dim, dim]),
`.attn.proj`, `.ls1.gamma`, `.norm2`, `.mlp.fc1`, `.mlp.fc2`,
`.ls2.gamma`, `norm`) plus the port's `fc`, so a released timm/DINOv2
state dict loads with strict=True apart from `fc`
(training/checkpoints.py::load_vit_weights).

flax sizes `pos_embed` from the batch the module is initialised with; a
torch module is built eagerly, so `image_hw` names the input size (default
256x341, the stores' frames: a 16x21 grid at patch 16, 337 tokens).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from relpose_gnn_tpu_torch.models.dense import dense

LN_EPS = 1e-6


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    """flax `nn.LayerNorm(dtype=x.dtype)`: float32 statistics and affine
    map, the result in x's dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps).to(x.dtype)


class LayerScale(nn.Module):
    """DINOv2's per-channel residual gamma (timm `LayerScale`)."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Attention(nn.Module):
    """flax `MultiHeadDotProductAttention(num_heads, dtype)` on self
    attention, with q, k and v fused in one `qkv` linear."""

    def __init__(self, dim: int, heads: int,
                 dtype: torch.dtype | None = None):
        super().__init__()
        if dim % heads:
            raise ValueError(f"dim {dim} is not a multiple of heads {heads}")
        self.heads = heads
        self.dtype = dtype
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        hd = d // self.heads
        qkv = dense(x, self.qkv, self.dtype)
        q, k, v = qkv.reshape(b, t, 3, self.heads, hd).permute(2, 0, 3, 1, 4)
        q = q / math.sqrt(hd)
        y = F.scaled_dot_product_attention(q, k, v, scale=1.0)
        return dense(y.transpose(1, 2).reshape(b, t, d), self.proj,
                     self.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(dense(x, self.fc1, self.dtype), approximate="tanh")
        return dense(h, self.fc2, self.dtype)


class TransformerBlock(nn.Module):
    """Pre-norm block: x + ls1(attn(norm1(x))), then
    x + ls2(mlp(norm2(x)))."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 dtype: torch.dtype | None = None,
                 layer_scale: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads, dtype)
        self.ls1 = LayerScale(dim) if layer_scale else None
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, dim * mlp_ratio, dtype)
        self.ls2 = LayerScale(dim) if layer_scale else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.attn(layer_norm(x, self.norm1))
        if self.ls1 is not None:
            y = self.ls1(y)
        x = x + y
        y = self.mlp(layer_norm(x, self.norm2))
        if self.ls2 is not None:
            y = self.ls2(y)
        return x + y


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, patch)


class ViTEncoder(nn.Module):
    """forward: [B, H, W, 3] NHWC -> float32 [B, feat_dim].  H and W need
    not be multiples of `patch`; the trailing remainder is cropped, and the
    grid left must be the one `image_hw` gives."""

    def __init__(self, feat_dim: int = 2048, patch: int = 16, dim: int = 768,
                 depth: int = 12, heads: int = 12,
                 dtype: torch.dtype | None = None, layer_scale: bool = False,
                 image_hw: tuple[int, int] = (256, 341)):
        super().__init__()
        self.patch, self.dim, self.heads = patch, dim, heads
        self.dtype = dtype
        self.layer_scale = layer_scale
        self.grid = (image_hw[0] // patch, image_hw[1] // patch)
        self.patch_embed = PatchEmbed(patch, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, self.grid[0] * self.grid[1] + 1, dim))
        self.blocks = nn.ModuleList(
            TransformerBlock(dim, heads, dtype=dtype, layer_scale=layer_scale)
            for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc = nn.Linear(dim, feat_dim)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        del train  # no BatchNorm, no dropout
        b, h, w, _ = x.shape
        p = self.patch
        hp, wp = h // p, w // p
        if (hp, wp) != self.grid:
            raise ValueError(
                f"a {h}x{w} input makes a {hp}x{wp} patch grid; this "
                f"encoder's pos_embed was built for {self.grid[0]}x"
                f"{self.grid[1]} (image_hw)")
        x = x[:, :hp * p, :wp * p, :].to(self.dtype or x.dtype)
        conv = self.patch_embed.proj
        x = F.conv2d(x.permute(0, 3, 1, 2), conv.weight.to(x.dtype),
                     conv.bias.to(x.dtype), stride=p)
        x = x.flatten(2).transpose(1, 2)               # [B, hp*wp, dim]
        cls = self.cls_token.to(x.dtype).expand(b, 1, self.dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        for block in self.blocks:
            x = block(x)
        x = layer_norm(x, self.norm)
        return F.linear(x[:, 0].float(), self.fc.weight, self.fc.bias)
