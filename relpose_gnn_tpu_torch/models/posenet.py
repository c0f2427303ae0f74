"""RelPoseGNN, the relative-pose regression model (PyTorch).

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

`train=True` is the training forward: BatchNorm on batch statistics
(running ones updated, models/resnet.py) and dropout after the GNN with
flax's semantics (keep with probability 1 - rate, scale kept values by
1 / (1 - rate); separate draws for x and e).  Dropout also fires at eval
with `eval_dropout=True`, the reference's quirk.  Its masks come from the
`generator` the caller passes, never from the global RNG.  Over several
ranks (`shard`, parallel/sharding.py::DataShard) the batch is this rank's
rows of a global one: BatchNorm takes the global batch's statistics and
dropout draws the global batch's masks and keeps this rank's rows, so two
ranks compute what one process computes on the whole batch.  `remat=True`
recomputes the backbone's activations in the backward
(`torch.utils.checkpoint`); the recomputation leaves the BN running
statistics alone.

`backbone="vit"` swaps the ResNet for the ViT-B/16 encoder
(models/vit.py), held under `encoder.*` with timm's names: the preset
R3-vit.  flax sizes the ViT's position table from the batch it is
initialised with; a torch module is built eagerly, so `vit_image_hw`
names that input size.  R3-32 is R3 on 32-node graphs.  The ablations
`use_gnn=False` (an MLP on the edge features, `mlp`) and `use_ap=False`
(the absolute heads on pair features, pred_abs [B, N, N, 6]) are the JAX
model's; so is `s2d_stem`, the serving form of the stem that
`models/fold_bn.py::fold_relpose_backbone(s2d_stem=True)` builds.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from relpose_gnn_tpu_torch.models.attention import AttentionBlock
from relpose_gnn_tpu_torch.models.dense import dense
from relpose_gnn_tpu_torch.models.gnn import MLP2, DenseEdgeGNN
from relpose_gnn_tpu_torch.models.resnet import ResNet
from relpose_gnn_tpu_torch.models.vit import LayerScale, ViTEncoder
from relpose_gnn_tpu_torch.ops import graph as graph_ops
from relpose_gnn_tpu_torch.parallel.sharding import (copy_to_model,
                                                     gather_from_model)

_STAGES = {"resnet34": (3, 4, 6, 3), "resnet18": (2, 2, 2, 2)}


@dataclasses.dataclass(frozen=True)
class RelPoseGNNConfig:
    """Static hyperparameters; the same fields and presets as the JAX
    config, and `vit_image_hw` (the ViT's input size, see the module
    docstring)."""

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
    remat: bool = False         # recompute the backbone in the backward
    bn_folded: bool = False     # serving form: BN folded into the convs
    s2d_stem: bool = False      # serving form: space-to-depth stem
    vit_layer_scale: bool = False  # backbone="vit": DINOv2 LayerScale
    vit_image_hw: tuple = (256, 341)  # backbone="vit": the input size
    compact_edges: bool = False  # GNN on the compact edge list

    @classmethod
    def preset(cls, name: str, **overrides) -> "RelPoseGNNConfig":
        """'R1' = PoseNetX_LIGHT_KNN (two untied layers); 'R2' =
        PoseNetX_R2 dims 1024; 'R3' = PoseNetX_R2 dims 2048, the
        production config; the stretch configs 'R3-vit' (R3 with the
        ViT-B/16 node encoder) and 'R3-32' (R3 on 32-node graphs).
        Overrides win over the preset."""
        base = {
            "R1": dict(feat_dim=2048, edge_dim=2048, node_dim=2048,
                       num_gnn_layers=2, gnn_recursion=2),
            "R2": dict(feat_dim=1024, edge_dim=1024, node_dim=1024,
                       num_gnn_layers=1, gnn_recursion=2),
            "R3": dict(feat_dim=2048, edge_dim=2048, node_dim=2048,
                       num_gnn_layers=1, gnn_recursion=2),
            "R3-vit": dict(feat_dim=2048, edge_dim=2048, node_dim=2048,
                           num_gnn_layers=1, gnn_recursion=2,
                           backbone="vit"),
            "R3-32": dict(feat_dim=2048, edge_dim=2048, node_dim=2048,
                          num_gnn_layers=1, gnn_recursion=2, num_nodes=32),
        }[name]
        base.update(overrides)
        return cls(**base)


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None, shard=None) -> torch.Tensor:
    """flax `nn.Dropout(rate)`: keep with probability 1 - rate and scale
    what is kept by 1 / (1 - rate); the mask is drawn from `generator`,
    for the global batch of `shard`'s ranks (this rank's rows of it kept)
    where a shard is given."""
    if generator is None:
        raise ValueError("dropout is active (train=True or "
                         "eval_dropout=True with droprate > 0) and "
                         "needs a torch.Generator")
    keep_prob = 1.0 - rate
    if keep_prob == 0.0:
        return torch.zeros_like(x)
    shape = x.shape if shard is None else (
        (shard.size * x.shape[0],) + tuple(x.shape[1:]))
    keep = torch.rand(shape, generator=generator,
                      device=generator.device) < keep_prob
    if shard is not None:
        keep = keep[shard.rows(x.shape[0])]
    return torch.where(keep.to(x.device), x / keep_prob,
                       torch.zeros_like(x))


def make_backbone(c: RelPoseGNNConfig) -> nn.Module:
    """The node encoder of `c.backbone`: a ResNet trunk or the ViT."""
    if c.backbone in _STAGES:
        return ResNet(_STAGES[c.backbone], c.feat_dim, dtype=c.dtype,
                      folded=c.bn_folded, s2d_stem=c.s2d_stem)
    if c.backbone == "vit":
        return ViTEncoder(c.feat_dim, dtype=c.dtype,
                          layer_scale=c.vit_layer_scale,
                          image_hw=tuple(c.vit_image_hw))
    raise ValueError(f"unknown backbone {c.backbone!r}")


class RelPoseGNN(nn.Module):
    def __init__(self, cfg: RelPoseGNNConfig):
        super().__init__()
        self.cfg = c = cfg
        if c.backbone == "vit":
            self.encoder = make_backbone(c)
        else:
            self.feature_extractor = make_backbone(c)
        self.proj_edge = nn.Linear(2 * c.feat_dim, c.edge_dim)
        if c.use_attention:
            self.att = AttentionBlock(c.feat_dim, dtype=c.dtype)
        if c.use_gnn:
            for i in range(c.num_gnn_layers):
                self.add_module(f"gnn{i + 1}", DenseEdgeGNN(
                    c.feat_dim if i == 0 else c.node_dim, c.edge_dim,
                    c.node_dim, dtype=c.dtype))
        else:
            self.mlp = MLP2(c.edge_dim, c.edge_dim, c.edge_dim, c.dtype)
        x_dim = c.node_dim if c.use_gnn else c.feat_dim
        if not c.use_ap:   # the heads read pair features
            x_dim *= 2
        self.fc_xyz = nn.Linear(x_dim, 3)
        self.fc_wpqr = nn.Linear(x_dim, 3)
        self.fc_xyz_R = nn.Linear(c.edge_dim, 3)
        self.fc_wpqr_R = nn.Linear(c.edge_dim, 3)
        self.tp = None    # a ModelShard under tensor parallelism

    def set_model_shard(self, tp) -> None:
        """Run the split layers of parallel/sharding.py::TensorParallel on
        this rank's blocks (their parameters already cut to them): the
        GNN MLPs and `proj_edge`, whose output columns are gathered."""
        self.tp = tp
        for i in range(self.cfg.num_gnn_layers if self.cfg.use_gnn else 0):
            layer = getattr(self, f"gnn{i + 1}")
            for mlp in (layer.edge_model.edge_mlp, layer.mlp,
                        layer.mlp_updating):
                mlp.tp = tp

    def _proj_edge(self, e: torch.Tensor) -> torch.Tensor:
        """`proj_edge`, column-parallel under tensor parallelism: this
        rank's output columns (its weight rows, the whole bias's block),
        gathered whole for the GNN."""
        if self.tp is None:
            return dense(e, self.proj_edge)
        lin = self.proj_edge
        dt = torch.promote_types(e.dtype, lin.weight.dtype)
        bias = copy_to_model(lin.bias, self.tp)[self.tp.cols(
            lin.bias.shape[0])]
        local = F.linear(copy_to_model(e, self.tp).to(dt),
                         lin.weight.to(dt), bias.to(dt))
        return gather_from_model(local, self.tp)

    def encode_nodes(self, images: torch.Tensor, train: bool = False,
                     shard=None) -> torch.Tensor:
        """[B, N, H, W, 3] -> float32 [B, N, feat_dim]."""
        b, n = images.shape[:2]
        flat = images.reshape((b * n,) + images.shape[2:])
        if self.cfg.remat and train and torch.is_grad_enabled():
            # the backward reruns the backbone; only the first run may
            # fold its batch statistics into the running ones
            first = [True]

            def run(x):
                out = (self.encoder(x) if self.cfg.backbone == "vit" else
                       self.feature_extractor(x, True, first[0], shard))
                first[0] = False
                return out

            feats = torch.utils.checkpoint.checkpoint(run, flat,
                                                      use_reentrant=False)
        elif self.cfg.backbone == "vit":
            feats = self.encoder(flat)
        else:
            feats = self.feature_extractor(flat, train, shard=shard)
        return feats.reshape(b, n, -1).float()

    def forward(self, images: torch.Tensor, adj: torch.Tensor,
                train: bool = False,
                generator: torch.Generator | None = None, shard=None):
        return self.from_embeddings(self.encode_nodes(images, train, shard),
                                    adj, train=train, generator=generator,
                                    shard=shard)

    def _dropout(self, x: torch.Tensor, generator: torch.Generator | None,
                 shard=None) -> torch.Tensor:
        """`dropout` at the config's rate (one method, so that a test can
        put another framework's masks in its place)."""
        return dropout(x, self.cfg.droprate, generator, shard)

    def from_embeddings(self, x: torch.Tensor, adj: torch.Tensor,
                        train: bool = False,
                        generator: torch.Generator | None = None,
                        shard=None):
        """[B, N, feat] node embeddings -> (pred_abs, pred_rel, adj, aux).

        aux["node_feats"] is the PRE-GNN x: the kNN graph is built from it
        and the eval anchor is its nearest neighbour of node 0.  Dropout
        (train or eval_dropout) draws its masks from `generator` (the
        global batch's, over `shard`'s ranks)."""
        c = self.cfg
        if c.use_attention:
            x = self.att(x)
        x_pre_gnn = x

        edges = None
        use_compact = c.compact_edges and c.use_gnn
        if c.knn > 0:
            if use_compact:
                adj, src, tgt = graph_ops.knn_edge_list(x, c.knn)
                edges = (src, tgt, torch.ones(src.shape, dtype=torch.bool,
                                              device=src.device))
            else:
                adj = graph_ops.knn_adjacency(x, c.knn)
        elif use_compact:
            edges = graph_ops.adj_edge_list(adj)

        if edges is not None:
            e = graph_ops.edge_pair_features_compact(x, edges[0], edges[1])
        else:
            e = graph_ops.edge_pair_features(x)
        e = F.relu(self._proj_edge(e))

        if c.use_gnn:
            for r in range(c.gnn_recursion):
                layer = getattr(self, f"gnn{r % c.num_gnn_layers + 1}")
                x, e = layer(x, e, adj, edges=edges)
                x = F.relu(x)
                e = F.relu(e)
        else:
            e = self.mlp(e)

        if c.droprate > 0 and (train or c.eval_dropout):
            drop = (self._dropout if shard is None
                    else functools.partial(self._dropout, shard=shard))
            x = drop(x, generator)
            e = drop(e, generator)

        # use_ap=False: the absolute heads on pair features, [B, N, N, 6]
        xa = x if c.use_ap else graph_ops.edge_pair_features(x)
        pred_abs = torch.cat([dense(xa, self.fc_xyz),
                              dense(xa, self.fc_wpqr)], dim=-1)
        pred_rel = torch.cat([dense(e, self.fc_xyz_R),
                              dense(e, self.fc_wpqr_R)], dim=-1)
        if edges is not None:
            # compact per-edge predictions back on the dense API grid
            # (zero at non-edges, which no protocol consumer reads)
            pred_rel = graph_ops.scatter_edge_values(
                pred_rel, edges[0], edges[1], edges[2], x.shape[-2])
        aux = {"node_feats": x_pre_gnn, "node_feats_post": x}
        return pred_abs, pred_rel, adj, aux


# the standard deviation of a unit normal truncated to [-2, 2]: flax's
# variance_scaling divides by it so that the truncated draw keeps the
# variance it asks for
_TRUNC_STD = 0.87962566103423978


def _truncated_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Unit normals truncated to [-2, 2], drawn on the generator's device
    as `jax.random.truncated_normal` draws them: a uniform between the
    bounds' CDF values through the inverse error function."""
    lo, hi = (math.erf(b / math.sqrt(2.0)) for b in (-2.0, 2.0))
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = u * (hi - lo) + lo
    return (torch.erfinv(u) * math.sqrt(2.0)).clamp_(-2.0, 2.0)


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator,
                   fan_in: int) -> None:
    w.copy_(_truncated_normal(w.shape, generator)
            / (_TRUNC_STD * math.sqrt(fan_in)))


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights as flax initialises the JAX model: every conv
    and linear weight from `lecun_normal` (a normal truncated at two
    standard deviations, scaled to variance 1/fan_in), biases zero, BN at
    its identity (scale 1, shift 0, running mean 0, var 1), LayerNorm at
    scale 1 and shift 0; the ViT's `pos_embed` from normal(0.02), its CLS
    token zero, LayerScale gammas one; an LSTM as flax's
    `OptimizedLSTMCell`: each gate's input kernel `lecun_normal`, its
    hidden kernel orthogonal, biases zero.  Draws on the generator's
    device, in module order."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            _lecun_normal_(m.weight, generator, m.weight[0].numel())
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.reset_parameters()
        elif isinstance(m, ViTEncoder):
            m.cls_token.zero_()
            m.pos_embed.normal_(0.0, 0.02, generator=generator)
        elif isinstance(m, LayerScale):
            m.gamma.fill_(1.0)
        elif isinstance(m, nn.LSTM):
            for name, p in m.named_parameters():
                if name.startswith("bias"):
                    p.zero_()
                    continue
                for gate in p.chunk(4, dim=0):      # i, f, g, o
                    if name.startswith("weight_ih"):
                        _lecun_normal_(gate, generator, gate.shape[1])
                    else:
                        nn.init.orthogonal_(gate, generator=generator)
