"""Offline graph construction: retrieval + subsampling -> packed stores.

Port of `relpose_gnn_tpu/data/graph_builder.py` (reference
dataset_7Scenes_multi.py:266-447, dataset_Cambridge_multi.py:138-298).
For each query frame:
  1. rank the database frames by descriptor similarity, or draw them at
     random (RAND mode);
  2. subsample the neighbours (random 50% drop + random-offset stride +
     top-K, `retrieval/subsample.py`);
  3. assemble the graph: node 0 = query, nodes 1..N-1 = neighbours;
  4. write images (resized, before normalization), pose6 targets, the
     static edge structure, the neighbours' database indices (`nbr_idx`)
     and the query's relative path through `data/packed.py::
     PackedGraphWriter`.

Edge targets are not stored: the trainer computes them from the stored
poses.  The draws come from one `np.random.default_rng(cfg.seed)` in the
JAX `build_graphs`' order, so both packages write the same store byte
for byte.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable

import numpy as np

from relpose_gnn_tpu_torch.data.packed import PackedGraphWriter
from relpose_gnn_tpu_torch.ops import graph as graph_ops
from relpose_gnn_tpu_torch.retrieval import subsample


@dataclasses.dataclass
class GraphBuilderConfig:
    seq_len: int = 8
    graph_structure: str = "fc"
    sampling_period: int = 5       # 7-Scenes: 5, Cambridge: 3
    retrieval_mode: str = "IR"     # 'IR' | 'RAND'
    cross_connect: bool = False
    database_is_query_set: bool = True
    seed: int = 0


def build_graphs(query_dataset, database_dataset, out_root: str,
                 cfg: GraphBuilderConfig,
                 similarity_fn: Callable[[int], np.ndarray] | None = None,
                 invalid_fn: Callable[[int], np.ndarray] | None = None,
                 mean=None, std=None,
                 height: int = 256, width: int = 341) -> int:
    """Write one scene-split of query graphs; returns how many.

    query_dataset / database_dataset expose `__len__`, `poses` [M, 6] and
    `load_image(i) -> [H, W, 3] float in [0, 1] or None`; a query dataset
    with `rel_path(i)` has its paths stored.  similarity_fn(query_index) ->
    [M] similarity over the database (None: RAND mode); invalid_fn(
    query_index) -> bool mask of excluded database entries (the query
    itself, or its sequence under cross-connect).  A query whose image or
    a neighbour's is unreadable, or whose every candidate is excluded, is
    skipped; the header records the count written."""
    rng = np.random.default_rng(cfg.seed)
    n = cfg.seq_len
    n_query = len(query_dataset)
    mean = np.zeros(3) if mean is None else mean
    std = np.ones(3) if std is None else std

    edge_index = graph_ops.build_edge_index(cfg.graph_structure, n)
    adj = (graph_ops.edge_index_to_adj(edge_index, n)
           if edge_index is not None else np.zeros((n, n), bool))

    writer = PackedGraphWriter(out_root, num_graphs=n_query, num_nodes=n,
                               height=height, width=width, mean=mean,
                               std=std)
    written = 0
    n_db = len(database_dataset)
    rel_fn = getattr(query_dataset, "rel_path", None)
    for qi in range(n_query):
        if cfg.retrieval_mode == "RAND" or similarity_fn is None:
            nbrs = rng.choice(n_db, size=n - 1,
                              replace=n_db < n - 1)  # tiny-DB fallback
        else:
            sim = similarity_fn(qi)
            invalid = (invalid_fn(qi) if invalid_fn is not None
                       else np.zeros(n_db, bool))
            order = subsample.rank_and_filter_numpy(sim, invalid)
            nbrs = subsample.subsample_ranked_numpy(
                order, n - 1, cfg.sampling_period, rng)
            if len(nbrs) < n - 1:  # pad with the best-ranked others
                taken = set(nbrs.tolist())
                pad = [i for i in order if i not in taken]
                nbrs = np.concatenate([nbrs, pad[:n - 1 - len(nbrs)]])
            if len(nbrs) < n - 1:
                # the filtered ranking itself is short: cycle it; an empty
                # one means no legal neighbour at all, so skip the query
                if not len(nbrs):
                    warnings.warn(
                        f"query {qi}: every database frame is excluded "
                        "by the retrieval mask; skipping this graph")
                    continue
                nbrs = np.resize(nbrs, n - 1)

        images = np.zeros((n, height, width, 3), np.float32)
        poses = np.zeros((n, 6), np.float32)
        img0 = query_dataset.load_image(qi)
        if img0 is None:
            continue
        images[0] = _fit(img0, height, width)
        poses[0] = query_dataset.poses[qi]
        ok = True
        for j, dbi in enumerate(nbrs[:n - 1]):
            img = database_dataset.load_image(int(dbi))
            if img is None:
                ok = False
                break
            images[j + 1] = _fit(img, height, width)
            poses[j + 1] = database_dataset.poses[int(dbi)]
        if not ok:
            continue
        writer.add(images, poses, adj,
                   nbr_idx=np.asarray(nbrs[:n - 1], np.int32),
                   rel_path=rel_fn(qi) if rel_fn is not None else None)
        written += 1

    writer.finalize()
    return written


def _fit(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Center-crop/pad an [H', W', 3] image to exactly [height, width]."""
    h, w = img.shape[:2]
    out = np.zeros((height, width, 3), np.float32)
    ch, cw = min(h, height), min(w, width)
    y0, x0 = (h - ch) // 2, (w - cw) // 2
    oy, ox = (height - ch) // 2, (width - cw) // 2
    out[oy:oy + ch, ox:ox + cw] = img[y0:y0 + ch, x0:x0 + cw]
    return out


def self_exclusion_mask(n_db: int, query_index: int,
                        database_is_query_set: bool,
                        cross_connect: bool = False,
                        group_len: int | None = None,
                        seq_ids: np.ndarray | None = None,
                        query_seq: int | None = None) -> np.ndarray:
    """Invalid-candidate mask: the query itself, or under cross-connect
    its whole source sequence, so that training graphs connect across
    sequences only.

    The sequence comes from `seq_ids` [n_db] + `query_seq` (the loaders'
    per-frame `.seq_id`, robust to skipped frames and ragged sequences),
    else from `group_len` blocks (`index // group_len`, valid only when
    every sequence has exactly group_len frames).  The reference's 'heads'
    exception (one training sequence) is the caller's to apply."""
    mask = np.zeros(n_db, bool)
    if not database_is_query_set:
        return mask
    if cross_connect and seq_ids is not None:
        if query_seq is None:
            raise ValueError("seq_ids needs the query's query_seq")
        mask |= np.asarray(seq_ids) == query_seq
    elif cross_connect and group_len:
        g = query_index // group_len
        mask[g * group_len:(g + 1) * group_len] = True
    if query_index < n_db:
        mask[query_index] = True
    return mask
