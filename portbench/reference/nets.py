"""The configurations' forward passes, plain and functional.

Every function takes `sd` (weights by `params.py`'s names) and a
`Precision`.  Layouts are the program's public ones: images NHWC
[B, H, W, 3], node features [B, N, D]; the GNN runs on the compact kNN
edge list (each target's k nearest sources, targets in order), which is
what the configuration computes: a dense grid gives the same values on the
edges and computes the others for nothing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import encoders
from portbench.reference.params import VGG16_CFG

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class Precision:
    """Where the reference rounds.  "float32": nowhere (the reference).
    "fp8": the control, computed in the step below the bfloat16 the
    configurations state.  As the program rounds every activation to
    bfloat16, this rounds to float8 e4m3 (one scale per tensor, its largest
    magnitude at 448) every operand and result of a product
    (convolutions, linear layers, the attention products, the NetVLAD
    aggregation) and every normalised or summed activation; statistics
    and reductions stay float32, as the program keeps them.  Under
    autograd the rounding is passed straight through."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"precision {name!r}: float32 or fp8")
        self.name = name

    def q(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return t
        amax = t.detach().abs().amax().clamp_min(1e-30)
        scale = 448.0 / amax
        tq = (t * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
        return t + (tq - t).detach()

    def linear(self, x, w, b=None):
        return self.q(F.linear(self.q(x), self.q(w), b))

    def conv(self, x, w, b, stride, padding):
        return self.q(F.conv2d(self.q(x), self.q(w), b, stride, padding))


def encode(sd, m, x, prec, train=False):
    """The node encoder of model config `m` (`encoders/<backbone>.py`):
    [B, H, W, 3] -> [B, feat]."""
    return encoders.find(m["backbone"]).forward(sd, m, x, prec, train)


def _l2(x, dim):
    return x / torch.clamp_min(torch.linalg.vector_norm(x, dim=dim,
                                                        keepdim=True), 1e-12)


def netvlad_input(images01, hw):
    """[B, H, W, 3] in [0, 1] -> NetVLAD's input: antialiased bilinear
    resize (half-pixel centres) to `hw`, then ImageNet normalisation."""
    x = F.interpolate(images01.permute(0, 3, 1, 2), size=tuple(hw),
                      mode="bilinear", antialias=True, align_corners=False)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return (x.permute(0, 2, 3, 1) - mean) / std


def netvlad(sd, r, x, prec):
    """VGG16 (thirteen 3x3 conv + ReLU, 2x2 max pool after the first four
    stages) then NetVLAD: input L2 over channels, soft assignment,
    residual aggregation, intra-normalisation, final L2.  [B, K * C]."""
    x = x.permute(0, 3, 1, 2)
    i = 0
    for c in VGG16_CFG:
        if c == "M":
            x = F.max_pool2d(x, 2, 2)
            i += 1
        else:
            x = F.relu(prec.conv(x, sd[f"encoder.{i}.weight"],
                                 sd[f"encoder.{i}.bias"], 1, 1))
            i += 2
    k, dim = r["num_clusters"], r["encoder_dim"]
    b = x.shape[0]
    flat = _l2(x.permute(0, 2, 3, 1), -1).reshape(b, -1, dim)
    a = torch.softmax(prec.linear(flat, sd["pool.conv.weight"].reshape(k, dim)),
                      dim=-1)
    agg = torch.einsum("bpk,bpc->bkc", prec.q(a), prec.q(flat))
    vlad = agg - a.sum(1)[..., None] * sd["pool.centroids"][None]
    return _l2(_l2(vlad, -1).reshape(b, -1), -1)


def sq_dists(x):
    """Squared L2 distances [B, N, D] -> [B, N, N], from the differences."""
    return ((x[:, :, None, :] - x[:, None, :, :]) ** 2).sum(-1)


def knn(x, k):
    """Each target's k nearest sources (self excluded, ties lower index
    first): (src, tgt) int64 [B, N k], targets in order; and `margin`
    [B, N], the gap between the k-th and the (k+1)-th distance over the
    (k+1)-th (how far a target is from a tie)."""
    b, n, _ = x.shape
    d = sq_dists(x)
    d = torch.where(torch.eye(n, dtype=torch.bool, device=x.device),
                    torch.full_like(d, float("inf")), d)
    dt = d.transpose(-1, -2)
    vals, order = torch.sort(dt, dim=-1, stable=True)
    src = order[..., :k].reshape(b, n * k)
    tgt = torch.arange(n, device=x.device).repeat_interleave(k).expand(b, -1)
    if k + 1 < n:
        margin = (vals[..., k] - vals[..., k - 1]) / vals[..., k].clamp_min(
            1e-30)
    else:
        margin = torch.ones(b, n, device=x.device)
    return src, tgt, margin


def nearest(x, node=0):
    """(index of `node`'s nearest other node [B], its margin over the
    second nearest, as `knn`'s)."""
    d = sq_dists(x)[:, node]
    d[:, node] = float("inf")
    vals, order = torch.sort(d, dim=-1, stable=True)
    margin = (vals[:, 1] - vals[:, 0]) / vals[:, 1].clamp_min(1e-30)
    return order[:, 0], margin


def core_plain(phi, theta, g, prec):
    """The attention core y_i = sum_j softmax_j(phi_i theta_j) g_j over
    rows [E, C], materialising [E, C, C]."""
    f = prec.q(phi)[:, :, None] * prec.q(theta)[:, None, :]
    return torch.einsum("eij,ej->ei", torch.softmax(f, dim=-1), prec.q(g))


def _gather(x, idx):
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def gnn_layer(sd, x, e, src, tgt, k, prec, core):
    """`simpleConvEdge_upt` on the edge list: e' = MLP([x_s, x_t, e]),
    msg = Att(MLP([x_s, e'])), mean of msg at each target (k edges each),
    x' = MLP([x, mean])."""
    def lin(t, name):
        return prec.linear(t, sd[f"gnn1.{name}.weight"],
                           sd[f"gnn1.{name}.bias"])

    def mlp(t, name):
        return lin(F.relu(lin(t, name + ".0")), name + ".2")

    xs, xt = _gather(x, src), _gather(x, tgt)
    e_new = mlp(torch.cat([xs, xt, e], -1), "edge_model.edge_mlp")
    msg = mlp(torch.cat([xs, e_new], -1), "mlp")
    lead, width = msg.shape[:-1], msg.shape[-1]
    flat = msg.reshape(-1, width)
    y = core(lin(flat, "att.phi"), lin(flat, "att.theta"),
             lin(flat, "att.g"), prec)
    msg = prec.q(msg + lin(y, "att.W").reshape(*lead, width))
    b, n = x.shape[:2]
    aggr = prec.q(msg.reshape(b, n, k, width).mean(2))
    return mlp(torch.cat([x, aggr], -1), "mlp_updating"), e_new


def edges_of(adj, k):
    """A graph given as adjacency adj [B, N, N] (adj[s, t]: s is one of
    target t's k sources) -> (src, tgt) as `knn` lists them; None where a
    target has other than k sources."""
    b, n, _ = adj.shape
    per_target = adj.transpose(-1, -2)
    if not bool((per_target.sum(-1) == k).all()):
        return None
    src = torch.sort(per_target.to(torch.int8), dim=-1, descending=True,
                     stable=True).indices[..., :k].reshape(b, n * k)
    tgt = torch.arange(n, device=adj.device).repeat_interleave(k).expand(b,
                                                                        -1)
    return src, tgt


def relpose_edges(sd, m, x, prec, core=core_plain, drop=None, edges=None):
    """Node embeddings [B, N, feat] -> the relative poses of the kNN edges:
    (pred_rel [B, N k, 6], src, tgt, knn margin [B, N] or None).
    `edges` = (src, tgt) takes a given graph instead of the kNN one;
    `drop(x, e)` applies training's dropout after the GNN, where given."""
    k = m["knn"]
    if edges is None:
        src, tgt, margin = knn(x, k)
    else:
        (src, tgt), margin = edges, None
    lo, hi = torch.minimum(src, tgt), torch.maximum(src, tgt)
    e = F.relu(prec.linear(torch.cat([_gather(x, lo), _gather(x, hi)], -1),
                           sd["proj_edge.weight"], sd["proj_edge.bias"]))
    for _ in range(m["gnn_recursion"]):
        x, e = gnn_layer(sd, x, e, src, tgt, k, prec, core)
        x, e = F.relu(x), F.relu(e)
    if drop is not None:
        x, e = drop(x, e)
    pred = torch.cat([prec.linear(e, sd[f"{h}.weight"], sd[f"{h}.bias"])
                      for h in ("fc_xyz_R", "fc_wpqr_R")], -1)
    return pred, src, tgt, margin
