"""NetVLAD pooling + the full image-retrieval encoder (PyTorch).

Port of `relpose_gnn_tpu/models/netvlad.py`: soft assignment and residual
aggregation as two einsums,

    a[n, p, k]   = softmax_k(conv1x1(x))            soft assignment
    vlad[n,k,c]  = sum_p a[n,p,k] * x[n,p,c]  -  (sum_p a[n,p,k]) * cent[k,c]

then intra-normalisation over c in float32, flatten, final L2.  Output
[B, num_clusters * dim] = [B, 32768] at the published size.

Parameter names are the released `netvlad_vgg16.tar`'s: `encoder.N.weight`
/ `.bias` (torchvision VGG16 indices), `pool.centroids`,
`pool.conv.weight`; `load_state_dict(strict=True)` takes that file's state
dict and `models/convert.py::netvlad_state_dict_from_jax`'s output.

Feature maps are NHWC at the public functions, and flattened over (H, W)
in that order, like the JAX module.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from relpose_gnn_tpu_torch.models.vgg import VGG16Features

_EPS = 1e-12


def _l2norm(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x / max(||x||, eps): the norm is clamped, not the sum of squares."""
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=dim,
                                                        keepdim=True), _EPS)


class NetVLAD(nn.Module):
    """[B, H, W, C] feature map -> [B, K * C] VLAD descriptor."""

    def __init__(self, num_clusters: int = 64, dim: int = 512,
                 normalize_input: bool = True, vladv2: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.num_clusters = num_clusters
        self.dim = dim
        self.normalize_input = normalize_input
        self.dtype = dtype
        # vladv1: the assignment conv has no bias
        self.conv = nn.Conv2d(dim, num_clusters, 1, bias=vladv2)
        self.centroids = nn.Parameter(torch.rand(num_clusters, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        if self.normalize_input:
            x = _l2norm(x, dim=-1)           # across the descriptor dim
        dt = self.dtype or torch.promote_types(x.dtype,
                                               self.conv.weight.dtype)
        flat_x = x.reshape(b, -1, self.dim)                   # [B, P, C]
        # the 1x1 conv is a matrix product over C at every position
        w = self.conv.weight.reshape(self.num_clusters, self.dim).to(dt)
        bias = None if self.conv.bias is None else self.conv.bias.to(dt)
        assign = F.linear(flat_x.to(dt), w, bias)             # [B, P, K]
        flat_a = torch.softmax(assign, dim=-1)
        flat_x = flat_x.to(flat_a.dtype)
        agg = torch.einsum("bpk,bpc->bkc", flat_a, flat_x)    # [B, K, C]
        mass = torch.sum(flat_a, dim=1)                       # [B, K]
        vlad = agg - mass[..., None] * self.centroids[None]
        vlad = _l2norm(vlad.float(), dim=-1)                  # intra-norm
        return _l2norm(vlad.reshape(b, -1), dim=-1)           # final L2


class NetVLADEncoder(nn.Module):
    """VGG16 trunk + NetVLAD pooling, the retrieval descriptor model:
    [B, H, W, 3] ImageNet-normalised images -> float32 [B, K * 512]."""

    def __init__(self, num_clusters: int = 64, encoder_dim: int = 512,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.num_clusters = num_clusters
        self.encoder_dim = encoder_dim
        self.encoder = VGG16Features(dtype=dtype)
        self.pool = NetVLAD(num_clusters=num_clusters, dim=encoder_dim,
                            dtype=dtype)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.pool(self.encoder(images))
