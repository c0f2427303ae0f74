"""RelPoseGNN with a second, pair-image edge encoder (PoseNetX3), PyTorch.

Port of `relpose_gnn_tpu/models/pair_encoder.py` (reference
modules/posenet.py:254-377): besides the node ResNet (`encoder`), a ResNet
with a 6-channel stem (`edge_encoder`) encodes every ordered image pair,
channel-concatenated in min/max index order, into its initial edge
feature; two untied `simpleConvEdge` layers (no node update) follow.  The
pair backbone runs over all N^2 pairs, the cost that made the production
models project pooled features instead; kept for the ablation.

forward(images [B, N, H, W, 3], adj [B, N, N]) -> (pred_abs [B, N, 6],
pred_rel [B, N, N, 6]), the JAX module's two-tuple.  Dropout (on the node
states) as models/posenet.py::dropout, its mask from `generator`.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from relpose_gnn_tpu_torch.models.gnn import DenseEdgeGNNNoUpdate
from relpose_gnn_tpu_torch.models.legacy import (LegacyGraphModel,
                                                 pair_images, pose_heads)
from relpose_gnn_tpu_torch.models.resnet import ResNet


class RelPoseGNNPairEncoder(LegacyGraphModel):
    def __init__(self, feat_dim: int = 2048, edge_dim: int = 2048,
                 droprate: float = 0.5, eval_dropout: bool = False,
                 use_gnn: bool = True, stage_sizes=(3, 4, 6, 3),
                 dtype: torch.dtype | None = None):
        super().__init__(feat_dim, droprate, eval_dropout, use_gnn,
                         stage_sizes, dtype)
        self.encoder = ResNet(self.stage_sizes, feat_dim, dtype=dtype)
        self.edge_encoder = ResNet(self.stage_sizes, edge_dim, dtype=dtype,
                                   in_channels=6)
        if use_gnn:
            for i in (1, 2):
                self.add_module(f"gnn{i}", DenseEdgeGNNNoUpdate(
                    feat_dim, edge_dim, feat_dim, dtype=dtype))
        self.fc_xyz = nn.Linear(feat_dim, 3)
        self.fc_wpqr = nn.Linear(feat_dim, 3)
        self.fc_xyz_R = nn.Linear(edge_dim, 3)
        self.fc_wpqr_R = nn.Linear(edge_dim, 3)

    def forward(self, images: torch.Tensor, adj: torch.Tensor,
                train: bool = False,
                generator: torch.Generator | None = None):
        b, n = images.shape[:2]
        x = F.relu(self._encode(images, train))
        e = F.relu(self.edge_encoder(pair_images(images), train))
        e = e.reshape(b, n, n, -1)
        if self.use_gnn:
            for layer in (self.gnn1, self.gnn2):   # two UNTIED layers
                x, e = layer(x, e, adj)
                x, e = F.relu(x), F.relu(e)
        x = self._drop(x, train, generator)
        return (pose_heads(x, self.fc_xyz, self.fc_wpqr),
                pose_heads(e, self.fc_xyz_R, self.fc_wpqr_R))
