"""The legacy PoseNetX family (PyTorch), buildable by name in models/zoo.py.

Port of `relpose_gnn_tpu/models/legacy.py` (reference modules/posenet.py):

  * `PoseNetX`       backbone -> relu -> [simpleConv] -> absolute heads
  * `PoseNetX2`      + relative heads on min/max pair features
  * `PoseNetXLight`  projected pair-feature edges + 2 untied
                     `simpleConvEdge` layers, static graph
  * `PoseNetXOX`     edges only: a 6-channel pair ResNet, zero node
                     states, relative heads only
  * `PoseNetXR4`     2 untied `simpleConvEdge_upt` layers with dropout
                     between them, static graph

Each takes images [B, N, H, W, 3] and adj [B, N, N] and returns
`(pred_abs [B, N, 6], pred_rel [B, N, N, 6] | None, adj, aux)`, the
contract of RelPoseGNN.  Submodules carry the JAX names (`encoder`,
`edge_encoder`, `proj_edge`, `gnn1`, `gnn2`, `mlp`, the heads); the
ResNets inside have torchvision's.  The reference's uncalled submodules
(PoseNetX's `gnn2`) do not exist here, as in the JAX package.

PoseNetXOX's "absolute" output is its relative prediction at the first N
edges of the fully connected construction order (`fc_edge_index(n)`),
per graph.  Every dropout site is flax's (models/posenet.py::dropout):
active with `train=True` or at eval with `eval_dropout=True` (the
reference's `F.dropout(training=True)` quirk), its masks drawn from the
`generator` the caller passes.  The attention blocks of the
`simpleConvEdge` and `simpleConvEdge_upt` layers run the attention core
(the CUDA kernel on the card) at C = out_dim / 8.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from relpose_gnn_tpu_torch.models.dense import dense
from relpose_gnn_tpu_torch.models.gnn import (MLP2, DenseConv, DenseEdgeGNN,
                                              DenseEdgeGNNNoUpdate)
from relpose_gnn_tpu_torch.models.posenet import dropout
from relpose_gnn_tpu_torch.models.resnet import ResNet
from relpose_gnn_tpu_torch.ops import graph as graph_ops


def pose_heads(x: torch.Tensor, fc_xyz: nn.Linear,
               fc_wpqr: nn.Linear) -> torch.Tensor:
    """[t(3), logq(3)] from the two heads (flax `nn.Dense` dtypes)."""
    return torch.cat([dense(x, fc_xyz), dense(x, fc_wpqr)], dim=-1)


class LegacyGraphModel(nn.Module):
    """What the family shares: the node ResNet, dropout settings."""

    def __init__(self, feat_dim: int, droprate: float, eval_dropout: bool,
                 use_gnn: bool, stage_sizes, dtype):
        super().__init__()
        self.feat_dim, self.droprate = feat_dim, droprate
        self.eval_dropout, self.use_gnn = eval_dropout, use_gnn
        self.stage_sizes, self.dtype = tuple(stage_sizes), dtype

    def _drop(self, x, train, generator):
        if self.droprate > 0 and (train or self.eval_dropout):
            return dropout(x, self.droprate, generator)
        return x

    def _encode(self, images: torch.Tensor, train: bool) -> torch.Tensor:
        b, n, h, w, _ = images.shape
        return self.encoder(images.reshape(b * n, h, w, 3),
                            train).reshape(b, n, -1)


class PoseNetX(LegacyGraphModel):
    """posenet.py:106-170: absolute pose only, an optional edge-less GNN
    (one `simpleConv`)."""

    def __init__(self, feat_dim: int = 2048, droprate: float = 0.5,
                 eval_dropout: bool = False, use_gnn: bool = True,
                 stage_sizes=(3, 4, 6, 3), dtype: torch.dtype | None = None):
        super().__init__(feat_dim, droprate, eval_dropout, use_gnn,
                         stage_sizes, dtype)
        self.encoder = ResNet(self.stage_sizes, feat_dim, dtype=dtype)
        if use_gnn:
            self.gnn1 = DenseConv(feat_dim, feat_dim, dtype)
        self.fc_xyz = nn.Linear(feat_dim, 3)
        self.fc_wpqr = nn.Linear(feat_dim, 3)

    def _nodes(self, images, adj, train, generator):
        x = F.relu(self._encode(images, train))
        if self.use_gnn:
            x = F.relu(self.gnn1(x, adj))
        return self._drop(x, train, generator)

    def forward(self, images: torch.Tensor, adj: torch.Tensor,
                train: bool = False,
                generator: torch.Generator | None = None):
        x = self._nodes(images, adj, train, generator)
        return (pose_heads(x, self.fc_xyz, self.fc_wpqr), None, adj,
                {"node_feats": x})


class PoseNetX2(PoseNetX):
    """posenet.py:172-254: PoseNetX + relative heads on min/max pair
    features of the (post-dropout) node states."""

    def __init__(self, feat_dim: int = 2048, droprate: float = 0.5,
                 eval_dropout: bool = False, use_gnn: bool = True,
                 stage_sizes=(3, 4, 6, 3), dtype: torch.dtype | None = None):
        super().__init__(feat_dim, droprate, eval_dropout, use_gnn,
                         stage_sizes, dtype)
        self.fc_xyz_R = nn.Linear(2 * feat_dim, 3)
        self.fc_wpqr_R = nn.Linear(2 * feat_dim, 3)

    def forward(self, images: torch.Tensor, adj: torch.Tensor,
                train: bool = False,
                generator: torch.Generator | None = None):
        x = self._nodes(images, adj, train, generator)
        pair = graph_ops.edge_pair_features(x)
        return (pose_heads(x, self.fc_xyz, self.fc_wpqr),
                pose_heads(pair, self.fc_xyz_R, self.fc_wpqr_R), adj,
                {"node_feats": x})


class PoseNetXLight(LegacyGraphModel):
    """posenet.py:380-489: edges projected from the PRE-relu backbone
    output's pair features, two UNTIED `simpleConvEdge` layers (no node
    update), static graph."""

    def __init__(self, feat_dim: int = 2048, edge_dim: int = 2048,
                 droprate: float = 0.5, eval_dropout: bool = False,
                 use_gnn: bool = True, stage_sizes=(3, 4, 6, 3),
                 dtype: torch.dtype | None = None):
        super().__init__(feat_dim, droprate, eval_dropout, use_gnn,
                         stage_sizes, dtype)
        self.encoder = ResNet(self.stage_sizes, feat_dim, dtype=dtype)
        self.proj_edge = nn.Linear(2 * feat_dim, edge_dim)
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
        x = self._encode(images, train)
        e = F.relu(dense(graph_ops.edge_pair_features(x), self.proj_edge))
        x = F.relu(x)
        if self.use_gnn:
            for layer in (self.gnn1, self.gnn2):
                x, e = layer(x, e, adj)
                x, e = F.relu(x), F.relu(e)
        x = self._drop(x, train, generator)
        e = self._drop(e, train, generator)
        return (pose_heads(x, self.fc_xyz, self.fc_wpqr),
                pose_heads(e, self.fc_xyz_R, self.fc_wpqr_R), adj,
                {"node_feats": x})


def pair_images(images: torch.Tensor) -> torch.Tensor:
    """[B, N, H, W, 3] -> [B N N, H, W, 6]: each ordered pair's images in
    min/max index order (`edge_pair_features` on the pixels),
    channel-concatenated."""
    b, n, h, w, _ = images.shape
    pair = graph_ops.edge_pair_features(images.reshape(b, n, -1))
    pair = pair.reshape(b * n * n, 2, h, w, 3)
    return torch.cat([pair[:, 0], pair[:, 1]], dim=-1)


class PoseNetXOX(LegacyGraphModel):
    """posenet.py:491-610: edges only.  Each ordered pair's images
    (min/max order, 6 channels) through `edge_encoder`; node states start
    as zeros; two untied `simpleConvEdge` layers; relative heads only, the
    "absolute" output gathered from the first N construction-order
    edges."""

    def __init__(self, feat_dim: int = 1024, edge_dim: int = 1024,
                 droprate: float = 0.5, eval_dropout: bool = False,
                 use_gnn: bool = True, stage_sizes=(3, 4, 6, 3),
                 dtype: torch.dtype | None = None):
        super().__init__(feat_dim, droprate, eval_dropout, use_gnn,
                         stage_sizes, dtype)
        self.edge_encoder = ResNet(self.stage_sizes, edge_dim, dtype=dtype,
                                   in_channels=6)
        if use_gnn:
            for i in (1, 2):
                self.add_module(f"gnn{i}", DenseEdgeGNNNoUpdate(
                    feat_dim, edge_dim, feat_dim, dtype=dtype))
        self.fc_xyz_R = nn.Linear(edge_dim, 3)
        self.fc_wpqr_R = nn.Linear(edge_dim, 3)

    def forward(self, images: torch.Tensor, adj: torch.Tensor,
                train: bool = False,
                generator: torch.Generator | None = None):
        b, n = images.shape[:2]
        e = F.relu(self.edge_encoder(pair_images(images), train))
        e = e.reshape(b, n, n, -1)
        x = torch.zeros((b, n, self.feat_dim), dtype=e.dtype,
                        device=e.device)
        if self.use_gnn:
            x, e = self.gnn1(x, e, adj)
            x, e = F.relu(x), F.relu(e)
            x, e = self.gnn2(x, e, adj)
            e = F.relu(e)            # no relu on x after gnn2 (:592)
        e = self._drop(e, train, generator)
        pred_rel = pose_heads(e, self.fc_xyz_R, self.fc_wpqr_R)
        ei = torch.from_numpy(graph_ops.fc_edge_index(n)[:, :n]).to(
            pred_rel.device)
        return pred_rel[:, ei[0], ei[1]], pred_rel, adj, {"node_feats": x}


class PoseNetXR4(LegacyGraphModel):
    """posenet.py:765-919: PoseNetX_R2 semantics with two UNTIED
    `simpleConvEdge_upt` layers and dropout BETWEEN them, static graph."""

    def __init__(self, feat_dim: int = 1024, edge_dim: int = 1024,
                 droprate: float = 0.5, eval_dropout: bool = False,
                 use_gnn: bool = True, use_ap: bool = True,
                 stage_sizes=(3, 4, 6, 3), dtype: torch.dtype | None = None):
        super().__init__(feat_dim, droprate, eval_dropout, use_gnn,
                         stage_sizes, dtype)
        self.use_ap = use_ap
        self.encoder = ResNet(self.stage_sizes, feat_dim, dtype=dtype)
        self.proj_edge = nn.Linear(2 * feat_dim, edge_dim)
        if use_gnn:
            for i in (1, 2):
                self.add_module(f"gnn{i}", DenseEdgeGNN(
                    feat_dim, edge_dim, feat_dim, dtype=dtype))
        else:
            self.mlp = MLP2(edge_dim, edge_dim, edge_dim, dtype)
        head_in = feat_dim if use_ap else 2 * feat_dim
        self.fc_xyz = nn.Linear(head_in, 3)
        self.fc_wpqr = nn.Linear(head_in, 3)
        self.fc_xyz_R = nn.Linear(edge_dim, 3)
        self.fc_wpqr_R = nn.Linear(edge_dim, 3)

    def forward(self, images: torch.Tensor, adj: torch.Tensor,
                train: bool = False,
                generator: torch.Generator | None = None):
        x = self._encode(images, train)
        e = F.relu(dense(graph_ops.edge_pair_features(x), self.proj_edge))
        if self.use_gnn:
            x, e = self.gnn1(x, e, adj)
            x, e = F.relu(x), F.relu(e)
            x = self._drop(x, train, generator)      # between the layers
            e = self._drop(e, train, generator)
            x, e = self.gnn2(x, e, adj)
            x, e = F.relu(x), F.relu(e)
        else:
            e = self.mlp(e)
        x = self._drop(x, train, generator)
        e = self._drop(e, train, generator)
        xa = x if self.use_ap else graph_ops.edge_pair_features(x)
        return (pose_heads(xa, self.fc_xyz, self.fc_wpqr),
                pose_heads(e, self.fc_xyz_R, self.fc_wpqr_R), adj,
                {"node_feats": x})
