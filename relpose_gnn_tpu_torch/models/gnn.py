"""Edge-featured message-passing GNN layers (PyTorch).

Port of `relpose_gnn_tpu/models/gnn.py`.  The production layer is
`DenseEdgeGNN`, the dense equivalent of the reference layer
`simpleConvEdge_upt` (my_gnn_layer.py:277-311):

    e'[s,t]  = MLP_edge([x_s, x_t, e_st])
    msg[s,t] = Att(MLP_msg([x_s, e'_st]))
    aggr[t]  = mean over {s : adj[s,t]} of msg[s,t]
    x'[t]    = MLP_upd([x_t, aggr[t]])

Parameter names follow the reference state dict: `edge_model.edge_mlp`,
`mlp`, `mlp_updating` (each `Seq(Linear, ReLU, Linear)`, so `.0`/`.2`) and
`att`.  `dtype` is the compute dtype; parameters stay float32 and are cast
where they are used.

The ablation layers follow it: `EdgeModelAtt`, `DenseEdgeGNNSplit`,
`DenseEdgeGNNGated`, `DenseEdgeGNNNoUpdate`, `EdgeConvRotDense`,
`ConvMapGNN` (conv-map node states, BatchNorm) and `DenseConv`, with
`cosine_gate`.  They keep the JAX module's submodule names (`edge_mlp`,
`msg_mlp`, `upd_mlp`, `att`, `mlp1`, `mlp2`, `gate_mlp`, `mlp`, `mlp0`,
`{edge,message,update}_conv{1,2}` / `_bn{1,2}`): the reference released no
checkpoint of them.  Where the reference message reads PyG's
`message(x_i, x_j, e)`, the operands are target-then-source (`"t"` before
`"s"`) -- in Split, Gated, NoUpdate and DenseConv -- while the production
layer's message is source-first; the operand tags are the JAX lists as
they stand.  flax sizes a layer's inputs on first call, torch at
construction: `node_dim` is the width of the incoming x, `in_edge_dim`
that of the incoming e (default `edge_dim`).

Tensor parallelism (parallel/sharding.py::TensorParallel): an MLP given a
`ModelShard` (`.tp`) holds this rank's block of the hidden features, its
first linear's output rows and bias and its second linear's input
columns; its input passes `copy_to_model` and the second product's
partial sums `reduce_from_model` before the (whole) bias is added.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from relpose_gnn_tpu_torch.models.attention import AttentionBlock
from relpose_gnn_tpu_torch.models.dense import dense
from relpose_gnn_tpu_torch.models.resnet import _bn, _conv
from relpose_gnn_tpu_torch.ops.graph import (compact_mean_aggregate,
                                             gather_rows,
                                             masked_mean_aggregate)
from relpose_gnn_tpu_torch.parallel.sharding import (copy_to_model,
                                                     reduce_from_model)


class MLP2(nn.Sequential):
    """Linear -> ReLU -> Linear (the reference's `Seq(Linear, ReLU,
    Linear)`), with parameters `0.*` and `2.*`."""

    def __init__(self, in_dim: int, hidden: int, out: int,
                 dtype: torch.dtype | None = None):
        super().__init__(nn.Linear(in_dim, hidden), nn.ReLU(),
                         nn.Linear(hidden, out))
        self.dtype = dtype
        self.tp = None    # a ModelShard under tensor parallelism

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return dense(F.relu(dense(x, self[0], self.dtype)), self[2],
                         self.dtype)
        h = F.relu(dense(copy_to_model(x, self.tp), self[0], self.dtype))
        return self._second(h, h.dtype)

    def _second(self, h: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        """The row-parallel second linear: this rank's partial product,
        summed over the model group, then the bias."""
        fc2 = self[2]
        part = F.linear(h, fc2.weight.to(dt))
        return reduce_from_model(part, self.tp) + fc2.bias.to(dt)


class PairMLP2(MLP2):
    """MLP2 over node pairs in split-weight form.

    fc1's weight is stored in the concat layout (`[hidden, sum(in_dims)]`
    in torch's orientation) and sliced per operand, in the order of
    `operands`: a sequence of (tensor, kind) with kind 's' ([.., N, D],
    the source node), 't' ([.., N, D], the target node) or 'e' (edge
    features).  Node operands are multiplied once per node, then
    broadcast over the [.., N, N] grid (dense mode) or gathered to the
    compact edge list (`src`/`tgt` int [.., E]; 'e' operands are then
    [.., E, De]).  The same function as the concat MLP2 up to float
    summation order."""

    def __init__(self, in_dims: Sequence[int], hidden: int, out: int,
                 dtype: torch.dtype | None = None):
        super().__init__(sum(in_dims), hidden, out, dtype)
        self.in_dims = tuple(in_dims)

    def forward(self, operands, src: torch.Tensor | None = None,
                tgt: torch.Tensor | None = None) -> torch.Tensor:
        if len(operands) != len(self.in_dims):
            raise ValueError(f"{len(operands)} operands for in_dims "
                             f"{self.in_dims}")
        if (src is None) != (tgt is None):
            raise ValueError("pass both src and tgt, or neither")
        fc1, fc2 = self[0], self[2]
        dt = self.dtype or fc1.weight.dtype
        h = None
        off = 0
        for (arr, kind), d in zip(operands, self.in_dims):
            if arr.shape[-1] != d:
                raise ValueError(f"operand of width {arr.shape[-1]} where "
                                 f"{d} was declared")
            if self.tp is not None:
                arr = copy_to_model(arr, self.tp)
            part = F.linear(arr.to(dt), fc1.weight[:, off:off + d].to(dt))
            off += d
            if kind == "s":
                part = (gather_rows(part, src) if src is not None
                        else part[..., :, None, :])
            elif kind == "t":
                part = (gather_rows(part, tgt) if tgt is not None
                        else part[..., None, :, :])
            elif kind != "e":
                raise ValueError(f"operand kind {kind!r} (want s, t or e)")
            h = part if h is None else h + part
        h = F.relu(h + fc1.bias.to(dt))
        if self.tp is not None:
            return self._second(h, dt)
        return F.linear(h, fc2.weight.to(dt), fc2.bias.to(dt))


class _EdgeModel(nn.Module):
    """Holds `edge_mlp` under the reference's `edge_model.` prefix."""

    def __init__(self, edge_mlp: PairMLP2):
        super().__init__()
        self.edge_mlp = edge_mlp


class DenseEdgeGNN(nn.Module):
    """`simpleConvEdge_upt` over a dense grid or a compact edge list.

    `node_dim` is the width of the incoming node features x, `in_edge_dim`
    that of the incoming edge features e (default `edge_dim`).

    forward(x [.., N, node_dim], e, adj [.., N, N], edges=None):
      * dense grid (edges None): e is [.., N, N, De], every ordered pair is
        computed, aggregation is the masked mean over `adj`;
      * compact (edges=(src, tgt, emask), each [.., E]): e is [.., E, De]
        and only listed edges are computed.
    Returns (x' [.., N, out_dim], e' like e with width edge_dim)."""

    def __init__(self, node_dim: int, edge_dim: int, out_dim: int,
                 in_edge_dim: int | None = None, use_attention: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        d, de = node_dim, in_edge_dim or edge_dim
        self.edge_model = _EdgeModel(
            PairMLP2((d, d, de), edge_dim, edge_dim, dtype))
        self.mlp = PairMLP2((d, edge_dim), out_dim, out_dim, dtype)
        self.att = AttentionBlock(out_dim, dtype) if use_attention else None
        self.mlp_updating = MLP2(d + out_dim, out_dim, out_dim, dtype)

    def forward(self, x: torch.Tensor, e: torch.Tensor, adj: torch.Tensor,
                edges: tuple[torch.Tensor, torch.Tensor, torch.Tensor]
                | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        src, tgt, emask = edges if edges is not None else (None, None, None)
        e_new = self.edge_model.edge_mlp([(x, "s"), (x, "t"), (e, "e")],
                                         src, tgt)
        msg = self.mlp([(x, "s"), (e_new, "e")], src, tgt)
        if self.att is not None:
            msg = self.att(msg)
        if edges is not None:
            aggr = compact_mean_aggregate(msg, tgt, emask, x.shape[-2])
        else:
            aggr = masked_mean_aggregate(msg, adj)
        dt = torch.promote_types(x.dtype, aggr.dtype)
        x_new = self.mlp_updating(torch.cat([x.to(dt), aggr.to(dt)], -1))
        return x_new, e_new


class EdgeModelAtt(nn.Module):
    """`simpleEdgeModelAtt` (my_gnn_layer.py:203-221): the edge update MLP
    then an AttentionBlock on its output (sized by the output width, the
    only configuration of the reference that runs)."""

    def __init__(self, node_dim: int, edge_dim: int, out_dim: int,
                 dtype: torch.dtype | None = None):
        super().__init__()
        d = node_dim
        self.edge_mlp = PairMLP2((d, d, edge_dim), out_dim, out_dim, dtype)
        self.att = AttentionBlock(out_dim, dtype)

    def forward(self, x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
        return self.att(self.edge_mlp([(x, "s"), (x, "t"), (e, "e")]))


class DenseEdgeGNNSplit(nn.Module):
    """`simpleConvEdge2` (my_gnn_layer.py:355-391): split-head message
    concat(mlp1([x_t, x_s, e']), mlp2([x_t, x_s, e'])), mean-aggregated;
    the aggregate is the new node state ([.., N, 2 out_dim])."""

    def __init__(self, node_dim: int, edge_dim: int, out_dim: int,
                 in_edge_dim: int | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        d, de = node_dim, in_edge_dim or edge_dim
        self.edge_mlp = PairMLP2((d, d, de), edge_dim, edge_dim, dtype)
        self.mlp1 = PairMLP2((d, d, edge_dim), out_dim, out_dim, dtype)
        self.mlp2 = PairMLP2((d, d, edge_dim), out_dim, out_dim, dtype)

    def forward(self, x: torch.Tensor, e: torch.Tensor, adj: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        e_new = self.edge_mlp([(x, "s"), (x, "t"), (e, "e")])
        ops = [(x, "t"), (x, "s"), (e_new, "e")]   # PyG: target first
        msg = torch.cat([self.mlp1(ops), self.mlp2(ops)], dim=-1)
        return masked_mean_aggregate(msg, adj), e_new


class DenseEdgeGNNGated(nn.Module):
    """`simpleConvEdge_upt_att` (my_gnn_layer.py:314-352): the message
    MLP on [x_t, x_s, e'] times a sigmoid gate MLP on e', mean-aggregated,
    then the node update MLP on [x, aggr]."""

    def __init__(self, node_dim: int, edge_dim: int, out_dim: int,
                 in_edge_dim: int | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        d, de = node_dim, in_edge_dim or edge_dim
        self.edge_mlp = PairMLP2((d, d, de), edge_dim, edge_dim, dtype)
        self.msg_mlp = PairMLP2((d, d, edge_dim), out_dim, out_dim, dtype)
        self.gate_mlp = MLP2(edge_dim, out_dim, out_dim, dtype)
        self.upd_mlp = MLP2(d + out_dim, out_dim, out_dim, dtype)

    def forward(self, x: torch.Tensor, e: torch.Tensor, adj: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        e_new = self.edge_mlp([(x, "s"), (x, "t"), (e, "e")])
        msg = self.msg_mlp([(x, "t"), (x, "s"), (e_new, "e")])
        gate = torch.sigmoid(self.gate_mlp(e_new))
        aggr = masked_mean_aggregate(msg * gate, adj)
        dt = torch.promote_types(x.dtype, aggr.dtype)
        return self.upd_mlp(torch.cat([x.to(dt), aggr.to(dt)], -1)), e_new


class DenseEdgeGNNNoUpdate(nn.Module):
    """`simpleConvEdge` (my_gnn_layer.py:242-274): the production edge
    update, a message MLP on [x_t, x_s, e'] (then the attention block),
    mean-aggregated; the aggregate is the new node state."""

    def __init__(self, node_dim: int, edge_dim: int, out_dim: int,
                 in_edge_dim: int | None = None, use_attention: bool = True,
                 dtype: torch.dtype | None = None):
        super().__init__()
        d, de = node_dim, in_edge_dim or edge_dim
        self.edge_mlp = PairMLP2((d, d, de), edge_dim, edge_dim, dtype)
        self.msg_mlp = PairMLP2((d, d, edge_dim), out_dim, out_dim, dtype)
        self.att = AttentionBlock(out_dim, dtype) if use_attention else None

    def forward(self, x: torch.Tensor, e: torch.Tensor, adj: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        e_new = self.edge_mlp([(x, "s"), (x, "t"), (e, "e")])
        msg = self.msg_mlp([(x, "t"), (x, "s"), (e_new, "e")])
        if self.att is not None:
            msg = self.att(msg)
        return masked_mean_aggregate(msg, adj), e_new


class EdgeConvRotDense(nn.Module):
    """`EdgeConvRot` (my_gnn_layer.py:415-449), flow 'target_to_source':
    messages MLP([x_s, x_t, e]) (`mlp`), or MLP(e) (`mlp0`) when the node
    features are at most 5 wide, mean-aggregated at the SOURCE.  Returns
    (aggregate [.., N, out_dim], messages [.., N, N, out_dim])."""

    def __init__(self, node_dim: int, edge_dim: int, out_dim: int,
                 dtype: torch.dtype | None = None):
        super().__init__()
        if node_dim > 5:
            self.mlp = MLP2(2 * node_dim + edge_dim, out_dim, out_dim, dtype)
        else:
            self.mlp0 = MLP2(edge_dim, out_dim, out_dim, dtype)

    def forward(self, x: torch.Tensor, e: torch.Tensor, adj: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
        n = x.shape[-2]
        if x.shape[-1] > 5:
            grid = x.shape[:-2] + (n, n, x.shape[-1])
            xs = x[..., :, None, :].expand(grid)
            xt = x[..., None, :, :].expand(grid)
            dt = torch.promote_types(x.dtype, e.dtype)
            msg = self.mlp(torch.cat([xs.to(dt), xt.to(dt), e.to(dt)], -1))
        else:
            msg = self.mlp0(e)
        m = adj.to(msg.dtype)[..., None]
        s = torch.sum(msg * m, dim=-2)
        cnt = torch.sum(m, dim=-2)
        return s / torch.clamp(cnt, min=1.0), msg


def cosine_gate(x_i: torch.Tensor, x_j: torch.Tensor) -> torch.Tensor:
    """Channelwise sigmoid(cosine similarity) (`batch_cosine_similarity`,
    my_gnn_layer.py:12-43): features viewed as [..., C, P], the cosine
    over P per channel, through a sigmoid."""
    num = torch.sum(x_i * x_j, dim=-1)
    den = torch.linalg.norm(x_i, dim=-1) * torch.linalg.norm(x_j, dim=-1)
    return torch.sigmoid(num / torch.clamp(den, min=1e-8))


class ConvMapGNN(nn.Module):
    """`myGNN` (my_gnn_layer.py:46-176) on conv-map node states
    [B, N, H, W, C] and edge maps [B, N, N, H, W, Ce]: edge, message and
    update are each two 3x3 conv + BatchNorm + ReLU layers on
    channel-concatenated maps, the aggregation a masked SUM at the
    targets (aggr='add'), with an optional cosine gate on the message.
    BatchNorm as flax's (momentum 0.9, eps 1e-5, float32 statistics):
    `train=True` normalises with the batch's two-pass statistics and
    updates the running ones (models/resnet.py::_bn).

    `in_channels` / `edge_channels` are the widths of x and e (default
    `channels`)."""

    def __init__(self, channels: int, in_channels: int | None = None,
                 edge_channels: int | None = None,
                 use_attention: bool = False,
                 dtype: torch.dtype | None = None):
        super().__init__()
        c, ce = in_channels or channels, edge_channels or channels
        self.channels, self.use_attention, self.dtype = (
            channels, use_attention, dtype)
        for name, cin in (("edge", 2 * c + ce), ("message", 2 * c + channels),
                          ("update", c + channels)):
            for layer in (1, 2):
                self.add_module(f"{name}_conv{layer}", nn.Conv2d(
                    cin if layer == 1 else channels, channels, 3, 1, 1))
                self.add_module(f"{name}_bn{layer}",
                                nn.BatchNorm2d(channels, eps=1e-5))

    def _conv_stack(self, name: str, x: torch.Tensor,
                    train: bool) -> torch.Tensor:
        """NHWC [M, H, W, Cin] -> [M, H, W, channels]."""
        x = x.to(self.dtype or x.dtype).permute(0, 3, 1, 2)
        for layer in (1, 2):
            x = _conv(x, getattr(self, f"{name}_conv{layer}"))
            x = F.relu(_bn(x, getattr(self, f"{name}_bn{layer}"), train))
        return x.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, e: torch.Tensor, adj: torch.Tensor,
                train: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
        b, n, h, w, c = x.shape
        k = self.channels
        xs = x[:, :, None].expand(b, n, n, h, w, c)
        xt = x[:, None, :].expand(b, n, n, h, w, c)
        dt = torch.promote_types(x.dtype, e.dtype)
        e_in = torch.cat([xs.to(dt), xt.to(dt), e.to(dt)], -1)
        e_new = self._conv_stack("edge", e_in.reshape(b * n * n, h, w, -1),
                                 train).reshape(b, n, n, h, w, k)
        m_in = torch.cat([xt.to(e_new.dtype), xs.to(e_new.dtype), e_new], -1)
        msg = self._conv_stack("message", m_in.reshape(b * n * n, h, w, -1),
                               train).reshape(b, n, n, h, w, k)
        if self.use_attention:
            gate = cosine_gate(
                xt.reshape(b, n, n, h * w, c).transpose(-1, -2),
                xs.reshape(b, n, n, h * w, c).transpose(-1, -2))
            msg = msg * gate[:, :, :, None, None, :].to(msg.dtype)
        mask = adj.to(msg.dtype)[..., None, None, None]
        aggr = torch.sum(msg * mask, dim=1)                # over sources
        u_in = torch.cat([x.to(aggr.dtype), aggr], -1)
        x_new = self._conv_stack("update", u_in.reshape(b * n, h, w, -1),
                                 train).reshape(b, n, h, w, k)
        return x_new, e_new


class DenseConv(nn.Module):
    """The edge-less `simpleConv` (my_gnn_layer.py:394-412): message
    MLP([x_t, x_s]), mean-aggregated; no node update."""

    def __init__(self, node_dim: int, out_dim: int,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.msg_mlp = PairMLP2((node_dim, node_dim), out_dim, out_dim, dtype)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        return masked_mean_aggregate(self.msg_mlp([(x, "t"), (x, "s")]), adj)
