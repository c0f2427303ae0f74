"""Dense graph ops for fixed-size relocalization graphs (PyTorch).

Port of `relpose_gnn_tpu/ops/graph.py`, same layouts:

    x    : [..., N, D]      node features
    adj  : [..., N, N]      bool adjacency, adj[..., s, t] = edge s -> t
    e    : [..., N, N, De]  edge features for every ordered pair
    src, tgt, emask : [..., E]  a compact edge list (int64 / bool)

Two properties carry over exactly, because the eval anchor depends on them:

* Distances are full float32.  The JAX code asks for `Precision.HIGHEST`;
  here the matmul must not take TF32 (`torch.backends.cuda.matmul.
  allow_tf32` is False by default; callers keep it so).
* Ties break lower index first, like `lax.top_k` and `argmin`: every
  top-k is a stable ascending sort, never bare `torch.topk`, whose order
  among equal values is unspecified on CUDA.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Static edge tables (host-side numpy)
# ---------------------------------------------------------------------------


def _roll_chain_edges(n: int, shift: int) -> np.ndarray:
    """Edges (i, i+shift) for i in [0, n-shift)."""
    src = np.arange(n - shift)
    return np.stack([src, src + shift])


def rnn_edge_index(n: int) -> np.ndarray:
    """Chain graph."""
    return _roll_chain_edges(n, 1)


def circ_edge_index(n: int) -> np.ndarray:
    """Ring graph."""
    src = np.arange(n)
    return np.stack([src, np.roll(src, -1)])


def dilated_edge_index(n: int, dilation: int = 2) -> np.ndarray:
    """Dilated ring."""
    src = np.arange(n)
    return np.stack([src, np.roll(src, -dilation)])


def ho_edge_index(n: int, hoc: int = 2) -> np.ndarray:
    """Higher-order chain: chords up to distance `hoc`."""
    return np.concatenate([_roll_chain_edges(n, s + 1) for s in range(hoc)],
                          axis=1)


def fc_edge_index(n: int, bidirectional: bool = True) -> np.ndarray:
    """Fully-connected edge list in reference construction order: all
    (i, i+s) pairs grouped by increasing separation s, then the flipped
    copies appended.  For n=8 this is [2, 56]."""
    e = np.concatenate([_roll_chain_edges(n, s + 1) for s in range(n - 1)],
                       axis=1)
    if bidirectional:
        e = np.concatenate([e, e[::-1]], axis=1)
    return e


def fc_rand_edge_index(n: int, hoc: int = 2, rand_edge_factor: float = 0.2,
                       rng: np.random.Generator | None = None) -> np.ndarray:
    """'fc+rand': chords up to `hoc` plus random longer chords (one
    uniform draw per candidate from `rng`, in the JAX op's order),
    bidirectionalized."""
    rng = rng or np.random.default_rng()
    parts = [_roll_chain_edges(n, s + 1) for s in range(hoc)]
    for s in range(hoc, n - 1):
        cand = _roll_chain_edges(n, s + 1)
        keep = rng.random(cand.shape[1]) < rand_edge_factor
        parts.append(cand[:, keep])
    e = np.concatenate(parts, axis=1)
    return np.concatenate([e, e[::-1]], axis=1)


EDGE_BUILDERS = {
    "rnn": rnn_edge_index,
    "circ": circ_edge_index,
    "dilated": dilated_edge_index,
    "ho": ho_edge_index,
    "fc": fc_edge_index,
    "fc+rand": fc_rand_edge_index,
}


def build_edge_index(graph_structure: str, n: int) -> np.ndarray | None:
    """Edge list for a named graph structure ('ind' -> no edges), every
    structure bidirectional."""
    if graph_structure == "ind":
        return None
    e = EDGE_BUILDERS[graph_structure](n)
    if graph_structure not in ("fc", "fc+rand"):  # those already flipped
        e = np.concatenate([e, e[::-1]], axis=1)
    return e


def edge_index_to_adj(edge_index: np.ndarray, n: int) -> np.ndarray:
    """[2, E] edge list -> dense [N, N] bool adjacency (adj[s, t])."""
    adj = np.zeros((n, n), dtype=bool)
    adj[edge_index[0], edge_index[1]] = True
    return adj


def fc_adjacency(n: int) -> np.ndarray:
    """Dense fully-connected (no self-loop) adjacency [N, N]."""
    return ~np.eye(n, dtype=bool)


def first_edge_anchor(edge_index: np.ndarray, ref_node: int = 0) -> int:
    """Source node of the `ref_node`-th edge into node 0 (the query) in
    construction order; for `fc_edge_index` and ref_node 0 that is node
    1.  With knn > 0 the dynamic graph's order encodes distance instead:
    use `nearest_neighbor` there."""
    into_query = np.flatnonzero(edge_index[1] == 0)
    if ref_node >= len(into_query):
        raise ValueError(
            f"only {len(into_query)} edges into node 0; ref_node="
            f"{ref_node} out of range")
    return int(edge_index[0, into_query[ref_node]])


# ---------------------------------------------------------------------------
# Device ops
# ---------------------------------------------------------------------------


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [..., N, D], idx int [..., E] -> x[..., idx, :] as [..., E, D]."""
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape,
                                                      x.shape[-1]))


def pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances [..., N, D] -> [..., N, N], in the same
    ||a||^2 - 2ab + ||b||^2 form and order as the JAX op."""
    sq = torch.sum(x * x, dim=-1)
    inner = torch.matmul(x, x.transpose(-1, -2))
    d = sq[..., :, None] - 2.0 * inner + sq[..., None, :]
    return torch.clamp_min(d, 0.0)


def _knn_neighbors(x: torch.Tensor, k: int) -> torch.Tensor:
    """[..., N, D] -> nbr [..., t, k]: each target t's k nearest sources
    (self excluded) in ascending distance, ties lower index first."""
    n = x.shape[-2]
    d = pairwise_sq_dists(x)
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    d = torch.where(eye, torch.full_like(d, float("inf")), d)
    order = torch.sort(d.transpose(-1, -2), dim=-1, stable=True).indices
    return order[..., :k]


def _nbr_to_adj(nbr: torch.Tensor, n: int) -> torch.Tensor:
    """nbr [..., t, k] -> bool adj [..., s, t]."""
    adj_t = torch.zeros(nbr.shape[:-1] + (n,), dtype=torch.bool,
                        device=nbr.device)
    adj_t.scatter_(-1, nbr, True)
    return adj_t.transpose(-1, -2)


def knn_adjacency(x: torch.Tensor, k: int) -> torch.Tensor:
    """Dynamic kNN graph as a dense bool mask adj[..., s, t]: for each
    node t, edges from its k nearest neighbours s (not symmetric)."""
    return _nbr_to_adj(_knn_neighbors(x, k), x.shape[-2])


def knn_edge_list(x: torch.Tensor, k: int
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kNN graph as (adj, src, tgt), src/tgt int64 [..., N*k], grouped
    by target node, each target's sources in ascending distance."""
    n = x.shape[-2]
    nbr = _knn_neighbors(x, k)
    adj = _nbr_to_adj(nbr, n)
    src = nbr.reshape(nbr.shape[:-2] + (n * k,))
    tgt = torch.arange(n, device=x.device).repeat_interleave(k)
    return adj, src, tgt.expand(src.shape)


def adj_edge_list(adj: torch.Tensor, e_max: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compact static-shape edge list from a dense adjacency:
    (src, tgt, emask), each [..., e_max] (default N*(N-1)).  Real edges
    fill the first slots in row-major (s, t) order; slots past a graph's
    edge count have emask False."""
    n = adj.shape[-1]
    if e_max is None:
        e_max = n * (n - 1)
    flat = adj.reshape(adj.shape[:-2] + (n * n,))
    # the JAX op's score: true entries first, row-major within each class
    pos = torch.arange(n * n, dtype=torch.float32, device=adj.device)
    score = flat.float() * (2.0 * n * n) - pos
    idx = torch.sort(score, dim=-1, descending=True,
                     stable=True).indices[..., :e_max]
    emask = torch.gather(flat, -1, idx)
    return idx // n, idx % n, emask


def edge_pair_features_compact(x: torch.Tensor, src: torch.Tensor,
                               tgt: torch.Tensor) -> torch.Tensor:
    """e0[i] = concat(x[min(src_i, tgt_i)], x[max(src_i, tgt_i)]).
    x [..., N, D], src/tgt [..., E] -> [..., E, 2D]."""
    lo = torch.minimum(src, tgt)
    hi = torch.maximum(src, tgt)
    return torch.cat([gather_rows(x, lo), gather_rows(x, hi)], dim=-1)


def edge_pair_features(x: torch.Tensor) -> torch.Tensor:
    """e0[s, t] = concat(x[min(s,t)], x[max(s,t)]): [..., N, D] ->
    [..., N, N, 2D]."""
    n = x.shape[-2]
    shape = x.shape[:-2] + (n, n, x.shape[-1])
    xs = x[..., :, None, :].expand(shape)
    xt = x[..., None, :, :].expand(shape)
    ar = torch.arange(n, device=x.device)
    lower = (ar[:, None] <= ar[None, :])[..., None]
    lo = torch.where(lower, xs, xt)
    hi = torch.where(lower, xt, xs)
    return torch.cat([lo, hi], dim=-1)


def compact_mean_aggregate(msg: torch.Tensor, tgt: torch.Tensor,
                           emask: torch.Tensor, n: int) -> torch.Tensor:
    """Mean of compact edge messages at their targets: msg [..., E, D],
    tgt [..., E], emask [..., E] -> [..., N, D]; isolated nodes get 0.
    The same one-hot matmul as the JAX op."""
    oh = F.one_hot(tgt, n).to(msg.dtype) * emask.to(msg.dtype)[..., None]
    s = torch.einsum("...en,...ed->...nd", oh, msg)
    cnt = torch.sum(oh, dim=-2)[..., None]
    return s / torch.clamp_min(cnt, 1.0)


def masked_mean_aggregate(msg: torch.Tensor,
                          adj: torch.Tensor) -> torch.Tensor:
    """Mean over incoming edges: msg [..., N, N, D], adj [..., N, N] ->
    [..., N, D]; isolated nodes get 0."""
    m = adj.to(msg.dtype)[..., None]
    s = torch.sum(msg * m, dim=-3)
    cnt = torch.sum(m, dim=-3)
    return s / torch.clamp_min(cnt, 1.0)


def scatter_edge_values(vals: torch.Tensor, src: torch.Tensor,
                        tgt: torch.Tensor, emask: torch.Tensor,
                        n: int) -> torch.Tensor:
    """Compact per-edge values [..., E, D] -> the dense [..., N, N, D]
    grid, zero at non-edges (one-hot matmul, as in the JAX op)."""
    oh = F.one_hot(src * n + tgt, n * n).to(vals.dtype)
    oh = oh * emask.to(vals.dtype)[..., None]
    dense = torch.einsum("...eq,...ed->...qd", oh, vals)
    return dense.reshape(dense.shape[:-2] + (n, n, vals.shape[-1]))


def nearest_neighbor(x: torch.Tensor, node: int = 0) -> torch.Tensor:
    """Index of `node`'s nearest neighbour (L2, self excluded), ties lower
    index first: [..., N, D] -> int64 [...]."""
    d = pairwise_sq_dists(x)
    n = x.shape[-2]
    row = d[..., :, node]
    is_self = torch.arange(n, device=x.device) == node
    row = torch.where(is_self, torch.full_like(row, float("inf")), row)
    # argmin returns the first minimum; a stable sort states it outright
    return torch.sort(row, dim=-1, stable=True).indices[..., 0]


def relative_pose_targets(p: torch.Tensor) -> torch.Tensor:
    """RP[s, t] = p[s] - p[t]: [..., N, D] -> [..., N, N, D]."""
    return p[..., :, None, :] - p[..., None, :, :]


def edge_dropout_mask(generator: torch.Generator, n: int, keep_prob: float,
                      batch_shape: tuple = ()) -> torch.Tensor:
    """Symmetric random edge-keep mask [*batch_shape, N, N] over undirected
    pairs: each pair s < t is kept with probability `keep_prob` (one
    uniform draw from `generator`, on its device) and mirrored; the
    diagonal is never kept.  A graph may lose every edge: callers pass
    the mask through `ensure_nonempty` (training/train.py:238-247)."""
    u = torch.rand(tuple(batch_shape) + (n, n), generator=generator,
                   device=generator.device)
    upper = torch.ones(n, n, dtype=torch.bool, device=u.device).triu(1)
    keep_u = (u < keep_prob) & upper
    return keep_u | keep_u.transpose(-1, -2)


def ensure_nonempty(mask: torch.Tensor) -> torch.Tensor:
    """Restore every edge of a graph whose mask dropped them all
    (training/train.py:240-241)."""
    any_edge = torch.any(mask.flatten(-2), dim=-1)[..., None, None]
    return torch.where(any_edge, mask, torch.ones_like(mask))
