"""Serving path: cached database embeddings + query-only encoding (PyTorch).

Port of `relpose_gnn_tpu/evaluation/serving.py` (single device; the JAX
`mesh` branch goes with the multi-GPU slice).  A query graph is
[query | N-1 database neighbours]; database frames never change, so

  1. `embed_database` runs the backbone over each database frame once;
  2. `make_cached_eval_step` encodes only the query image per request and
     gathers the neighbours' cached embeddings, then runs the GNN and heads
     and recovers the absolute pose from the nearest neighbour's:
     `pred = anchor - pred_rel[nbr, query]`.

Everything runs under `torch.inference_mode()`.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from relpose_gnn_tpu_torch.data.pipeline import make_normalizer
from relpose_gnn_tpu_torch.models.posenet import RelPoseGNN
from relpose_gnn_tpu_torch.ops import graph as graph_ops
from relpose_gnn_tpu_torch.training.trainer import (check_fuse_ok,
                                                    fuse_pose_estimates)

_FUSES = ("first", "mean", "median")


def _model_device(model: RelPoseGNN) -> torch.device:
    return next(model.parameters()).device


def make_embed_fn(model: RelPoseGNN
                  ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Single-image-per-node embedder: [B, H, W, 3] -> float32 [B, feat]."""

    @torch.inference_mode()
    def embed(images: torch.Tensor) -> torch.Tensor:
        return model.encode_nodes(images[:, None])[:, 0]

    return embed


def embed_database(model: RelPoseGNN, images: np.ndarray,
                   batch_size: int = 32,
                   device: torch.device | str | None = None) -> torch.Tensor:
    """Embed database frames (already normalised) in chunks of
    `batch_size` -> [M, feat] on `device` (default: the model's)."""
    device = device or _model_device(model)
    embed = make_embed_fn(model)
    out = [embed(torch.as_tensor(images[i:i + batch_size], device=device))
           for i in range(0, len(images), batch_size)]
    return torch.cat(out)


def make_cached_eval_step(model: RelPoseGNN, ref_node: int = 0,
                          static_anchor: int | None = None,
                          fuse: str = "first") -> Callable[..., dict]:
    """Eval over graphs given cached neighbour embeddings.

    The returned step(query_imgs [B, H, W, 3], nbr_emb [B, N-1, feat],
    nbr_poses [B, N-1, 6], adj [B, N, N]) gives {pred [B, 6], nbr [B]}
    (plus `fuse_ok` for fuse 'mean'/'median').  `nbr` is the anchor node:
    `static_anchor` if given (the knn=0 protocol), else the query's nearest
    neighbour in pre-GNN feature space.  'mean'/'median' fuse every
    incoming estimate `nbr_poses[s-1] - pred_rel[s, query]` over the
    EFFECTIVE adjacency (the kNN graph when knn > 0)."""
    if ref_node != 0:
        # node 0 IS the query and nbr_poses[j-1] belongs to node j; another
        # ref_node would anchor on the query's own zero placeholder
        raise ValueError(
            f"make_cached_eval_step requires ref_node == 0 (got "
            f"{ref_node}): the cached layout places the query at node 0")
    if fuse not in _FUSES:
        raise ValueError(f"fuse={fuse!r} (want one of {_FUSES})")

    @torch.inference_mode()
    def eval_step(query_imgs: torch.Tensor, nbr_emb: torch.Tensor,
                  nbr_poses: torch.Tensor, adj: torch.Tensor) -> dict:
        q_emb = model.encode_nodes(query_imgs[:, None])      # [B, 1, feat]
        x = torch.cat([q_emb, nbr_emb.to(q_emb.dtype)], dim=1)
        _, pred_rel, adj_eff, aux = model.from_embeddings(x, adj)
        b = pred_rel.shape[0]
        rows = torch.arange(b, device=pred_rel.device)
        if static_anchor is not None:
            nbr = torch.full((b,), static_anchor, dtype=torch.int64,
                             device=pred_rel.device)
        else:
            nbr = graph_ops.nearest_neighbor(aux["node_feats"],
                                             node=ref_node)
        if fuse == "first":
            anchor = nbr_poses[rows, nbr - 1]    # node j <-> nbr_poses[j-1]
            return {"pred": anchor - pred_rel[rows, nbr, ref_node],
                    "nbr": nbr}
        # the query's own row is a zero placeholder; it is never read since
        # the adjacency has no self edge (mask[:, ref_node] is False)
        poses_full = torch.cat([torch.zeros_like(nbr_poses[:, :1]),
                                nbr_poses], dim=1)
        est = poses_full - pred_rel[:, :, ref_node]         # [B, N, 6]
        mask = adj_eff[:, :, ref_node]                      # [B, N]
        return {"pred": fuse_pose_estimates(est, mask, fuse), "nbr": nbr,
                "fuse_ok": torch.all(torch.sum(mask, dim=1) >= 1)}

    return eval_step


def evaluate_scene_cached(model: RelPoseGNN, packed_ds,
                          database_images: np.ndarray,
                          batch_size: int = 64, embed_batch: int = 32,
                          static_anchor: int | None = None,
                          fuse: str = "first",
                          device: torch.device | str | None = None) -> dict:
    """Cached-serving evaluation over a packed store that carries `nbr_idx`
    (relpose_gnn_tpu.data.packed.PackedGraphDataset).

    `database_images` ([M, H, W, 3], uint8 or raw [0, 1] floats) are
    normalised with the store's stats and embedded once, in chunks of
    `embed_batch`; then each batch of `batch_size` graphs encodes its query
    images and gathers its neighbours' embeddings.  Returns {pred [L, 6],
    target [L, 6]} as numpy pose6 arrays.  `device` defaults to the
    model's."""
    if packed_ds.nbr_idx is None:
        raise ValueError("the packed store has no nbr_idx.npy; rebuild it "
                         "with neighbour indices for cached serving")
    device = torch.device(device or _model_device(model))
    normalize = make_normalizer(packed_ds.mean, packed_ds.std, device)

    embed = make_embed_fn(model)
    cache = torch.cat([
        embed(normalize(torch.from_numpy(
            np.ascontiguousarray(database_images[i:i + embed_batch]))))
        for i in range(0, len(database_images), embed_batch)])
    step = make_cached_eval_step(model, static_anchor=static_anchor,
                                 fuse=fuse)

    preds, targets = [], []
    for start in range(0, len(packed_ds), batch_size):
        idx = np.arange(start, min(start + batch_size, len(packed_ds)))
        batch = packed_ds.batch(idx, with_nbr_idx=True)
        nbr_idx = torch.from_numpy(batch["nbr_idx"].astype(np.int64))
        out = step(normalize(torch.from_numpy(batch["images"][:, 0])),
                   cache[nbr_idx.to(device)],
                   torch.from_numpy(batch["poses"][:, 1:]).to(device),
                   torch.from_numpy(batch["adj"]).to(device))
        check_fuse_ok(out, "evaluate_scene_cached")
        preds.append(out["pred"].float().cpu().numpy())
        targets.append(batch["poses"][:, 0])
    return {"pred": np.concatenate(preds), "target": np.concatenate(targets)}
