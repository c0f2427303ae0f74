"""Edge-featured message-passing GNN layer (PyTorch).

Port of `relpose_gnn_tpu/models/gnn.py` (`MLP2`, `PairMLP2`,
`DenseEdgeGNN`), the dense equivalent of the reference layer
`simpleConvEdge_upt` (my_gnn_layer.py:277-311):

    e'[s,t]  = MLP_edge([x_s, x_t, e_st])
    msg[s,t] = Att(MLP_msg([x_s, e'_st]))
    aggr[t]  = mean over {s : adj[s,t]} of msg[s,t]
    x'[t]    = MLP_upd([x_t, aggr[t]])

Parameter names follow the reference state dict: `edge_model.edge_mlp`,
`mlp`, `mlp_updating` (each `Seq(Linear, ReLU, Linear)`, so `.0`/`.2`) and
`att`.  `dtype` is the compute dtype; parameters stay float32 and are cast
where they are used.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from relpose_gnn_tpu_torch.models.attention import AttentionBlock
from relpose_gnn_tpu_torch.models.dense import dense
from relpose_gnn_tpu_torch.ops.graph import (compact_mean_aggregate,
                                             gather_rows,
                                             masked_mean_aggregate)


class MLP2(nn.Sequential):
    """Linear -> ReLU -> Linear (the reference's `Seq(Linear, ReLU,
    Linear)`), with parameters `0.*` and `2.*`."""

    def __init__(self, in_dim: int, hidden: int, out: int,
                 dtype: torch.dtype | None = None):
        super().__init__(nn.Linear(in_dim, hidden), nn.ReLU(),
                         nn.Linear(hidden, out))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(F.relu(dense(x, self[0], self.dtype)), self[2],
                     self.dtype)


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
