"""RelPoseGNN, the relative-pose regression model (PyTorch, inference).

Port of `relpose_gnn_tpu/models/posenet.py` (`RelPoseGNNConfig`,
`RelPoseGNN.encode_nodes`, `RelPoseGNN.from_embeddings`): ResNet node
encoder + edge-featured GNN + absolute and relative pose heads, on a batch
of fixed-size graphs as dense tensors.

    images : [B, N, H, W, 3]   NHWC, like the JAX model
    adj    : [B, N, N] bool    static graph (replaced by the dynamic kNN
                               graph when cfg.knn > 0)
    out    : pred_abs [B, N, 6], pred_rel [B, N, N, 6], adj [B, N, N], aux

Parameter names are the reference PoseNetX_R2 state dict's
(`feature_extractor.*`, `proj_edge`, `gnn1.*`, `fc_xyz`, `fc_wpqr`,
`fc_xyz_R`, `fc_wpqr_R`), so `load_state_dict(strict=True)` takes
`models/convert.py::state_dict_from_jax` output and the JAX exporter's.

This slice is the eval path: dropout is the identity (the JAX model's
deterministic eval).  What the JAX config offers beyond it raises
NotImplementedError naming the ROADMAP.md queue that will bring it.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from relpose_gnn_tpu_torch.models.attention import AttentionBlock
from relpose_gnn_tpu_torch.models.dense import dense
from relpose_gnn_tpu_torch.models.gnn import DenseEdgeGNN
from relpose_gnn_tpu_torch.models.resnet import ResNet
from relpose_gnn_tpu_torch.ops import graph as graph_ops

_STAGES = {"resnet34": (3, 4, 6, 3), "resnet18": (2, 2, 2, 2)}


@dataclasses.dataclass(frozen=True)
class RelPoseGNNConfig:
    """Static hyperparameters; the same fields and presets as the JAX
    config, minus the training-only and not-yet-ported knobs."""

    num_nodes: int = 8
    feat_dim: int = 2048
    edge_dim: int = 2048
    node_dim: int = 2048
    droprate: float = 0.5
    knn: int = 4                # >0: dynamic kNN graph per forward
    gnn_recursion: int = 2      # number of GNN applications
    num_gnn_layers: int = 1     # distinct (untied) layer modules, cycled
    use_gnn: bool = True
    use_attention: bool = False  # model-level attention on node features
    use_ap: bool = True         # absolute head reads node features
    eval_dropout: bool = False  # the reference's dropout-at-eval quirk
    backbone: str = "resnet34"
    dtype: torch.dtype | None = None  # compute dtype (torch.bfloat16 to serve)
    bn_folded: bool = False     # serving form: BN folded into the convs
    compact_edges: bool = False  # GNN on the compact edge list

    @classmethod
    def preset(cls, name: str, **overrides) -> "RelPoseGNNConfig":
        """'R1' = PoseNetX_LIGHT_KNN (two untied layers); 'R2' =
        PoseNetX_R2 dims 1024; 'R3' = PoseNetX_R2 dims 2048, the
        production config."""
        base = {
            "R1": dict(feat_dim=2048, edge_dim=2048, node_dim=2048,
                       num_gnn_layers=2, gnn_recursion=2),
            "R2": dict(feat_dim=1024, edge_dim=1024, node_dim=1024,
                       num_gnn_layers=1, gnn_recursion=2),
            "R3": dict(feat_dim=2048, edge_dim=2048, node_dim=2048,
                       num_gnn_layers=1, gnn_recursion=2),
        }[name]
        base.update(overrides)
        return cls(**base)


def _refuse_unported(c: RelPoseGNNConfig) -> None:
    if c.eval_dropout:
        raise NotImplementedError(
            "eval_dropout=True (stochastic dropout at eval) needs the "
            "dropout RNG of the training slice: ROADMAP.md, 'Modules to "
            "port', training")
    if c.backbone not in _STAGES:
        raise NotImplementedError(
            f"backbone={c.backbone!r}: only resnet34/resnet18 are ported; "
            "the ViT encoder is in ROADMAP.md, 'Modules to port', the rest "
            "of the model zoo")
    if not (c.use_gnn and c.use_ap):
        raise NotImplementedError(
            "use_gnn=False / use_ap=False ablations are in ROADMAP.md, "
            "'Modules to port', the rest of the model zoo")


class RelPoseGNN(nn.Module):
    def __init__(self, cfg: RelPoseGNNConfig):
        super().__init__()
        _refuse_unported(cfg)
        self.cfg = c = cfg
        self.feature_extractor = ResNet(_STAGES[c.backbone], c.feat_dim,
                                        dtype=c.dtype, folded=c.bn_folded)
        self.proj_edge = nn.Linear(2 * c.feat_dim, c.edge_dim)
        if c.use_attention:
            self.att = AttentionBlock(c.feat_dim, dtype=c.dtype)
        for i in range(c.num_gnn_layers):
            self.add_module(f"gnn{i + 1}", DenseEdgeGNN(
                c.feat_dim if i == 0 else c.node_dim, c.edge_dim,
                c.node_dim, dtype=c.dtype))
        self.fc_xyz = nn.Linear(c.node_dim, 3)
        self.fc_wpqr = nn.Linear(c.node_dim, 3)
        self.fc_xyz_R = nn.Linear(c.edge_dim, 3)
        self.fc_wpqr_R = nn.Linear(c.edge_dim, 3)

    def encode_nodes(self, images: torch.Tensor) -> torch.Tensor:
        """[B, N, H, W, 3] -> float32 [B, N, feat_dim]."""
        b, n = images.shape[:2]
        flat = images.reshape((b * n,) + images.shape[2:])
        return self.feature_extractor(flat).reshape(b, n, -1).float()

    def forward(self, images: torch.Tensor, adj: torch.Tensor):
        return self.from_embeddings(self.encode_nodes(images), adj)

    def from_embeddings(self, x: torch.Tensor, adj: torch.Tensor):
        """[B, N, feat] node embeddings -> (pred_abs, pred_rel, adj, aux).

        aux["node_feats"] is the PRE-GNN x: the kNN graph is built from it
        and the eval anchor is its nearest neighbour of node 0."""
        c = self.cfg
        if c.use_attention:
            x = self.att(x)
        x_pre_gnn = x

        edges = None
        if c.knn > 0:
            if c.compact_edges:
                adj, src, tgt = graph_ops.knn_edge_list(x, c.knn)
                edges = (src, tgt, torch.ones(src.shape, dtype=torch.bool,
                                              device=src.device))
            else:
                adj = graph_ops.knn_adjacency(x, c.knn)
        elif c.compact_edges:
            edges = graph_ops.adj_edge_list(adj)

        if edges is not None:
            e = graph_ops.edge_pair_features_compact(x, edges[0], edges[1])
        else:
            e = graph_ops.edge_pair_features(x)
        e = F.relu(dense(e, self.proj_edge))

        for r in range(c.gnn_recursion):
            layer = getattr(self, f"gnn{r % c.num_gnn_layers + 1}")
            x, e = layer(x, e, adj, edges=edges)
            x = F.relu(x)
            e = F.relu(e)

        pred_abs = torch.cat([dense(x, self.fc_xyz),
                              dense(x, self.fc_wpqr)], dim=-1)
        pred_rel = torch.cat([dense(e, self.fc_xyz_R),
                              dense(e, self.fc_wpqr_R)], dim=-1)
        if edges is not None:
            # compact per-edge predictions back on the dense API grid
            # (zero at non-edges, which no protocol consumer reads)
            pred_rel = graph_ops.scatter_edge_values(
                pred_rel, edges[0], edges[1], edges[2], x.shape[-2])
        aux = {"node_feats": x_pre_gnn, "node_feats_post": x}
        return pred_abs, pred_rel, adj, aux


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights: every conv and linear weight drawn from
    N(0, 1/fan_in) (flax's lecun_normal, untruncated), biases zero, BN at
    its identity (scale 1, shift 0, running mean 0, var 1).  Draws on the
    generator's device, in module order."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            w = torch.randn(m.weight.shape, generator=generator,
                            device=generator.device)
            m.weight.copy_(w / math.sqrt(fan_in))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
