"""Packed graph dataset: contiguous memmapped arrays instead of 26k pickles.

The port's own copy of `PackedGraphDataset` and `PackedGraphWriter` from the
JAX package's `data/packed.py` (numpy only, same on-disk layout: a store
written by either package reads byte for byte with the other's reader),
and of `ConcatPackedDataset`, the multi-scene training feed.

The reference materializes one `data_NNNNNN.pt` pickle per query graph
(dataset_7Scenes_multi.py:437-447) and pays a file open + unpickle per item.
Here a scene-split is three memmapped arrays plus a JSON header:

    meta.json     {num_graphs, num_nodes, height, width, dtype, mean, std}
    images.npy    [M, N, H, W, 3]  uint8 (resized, un-normalized) or float16
    poses.npy     [M, N, 6]        float32 pose6 targets (query at node 0)
    adj.npy       [M, N, N]        bool static graph structure

uint8 storage + on-device normalization cuts feed bandwidth 4x vs the
reference's float32 tensors (SURVEY.md §7 input-pipeline note); `mean`/`std`
in the header are the per-scene stats the device pipeline applies.
"""

from __future__ import annotations

import dataclasses
import json
import os
import os.path as osp

import numpy as np


@dataclasses.dataclass
class PackedGraphDataset:
    root: str
    mode: str = "r"

    def __post_init__(self):
        with open(osp.join(self.root, "meta.json")) as f:
            self.meta = json.load(f)
        m = self.meta
        shape_img = (m["num_graphs"], m["num_nodes"], m["height"],
                     m["width"], 3)
        self.images = np.load(osp.join(self.root, "images.npy"),
                              mmap_mode=self.mode)
        self.poses = np.load(osp.join(self.root, "poses.npy"),
                             mmap_mode=self.mode)
        self.adj = np.load(osp.join(self.root, "adj.npy"),
                           mmap_mode=self.mode)
        # optional: database indices of each graph's neighbor nodes
        # (enables the cached-embedding serving path, evaluation/serving.py)
        nbr_path = osp.join(self.root, "nbr_idx.npy")
        self.nbr_idx = (np.load(nbr_path, mmap_mode=self.mode)
                        if osp.isfile(nbr_path) else None)
        # A store with skipped frames keeps its preallocated memmap length;
        # the header's num_graphs is authoritative — slice down to it.
        assert (self.images.shape[0] >= shape_img[0]
                and self.images.shape[1:] == shape_img[1:]), (
            self.images.shape, shape_img)
        rows = m["num_graphs"]
        self.images = self.images[:rows]
        self.poses = self.poses[:rows]
        self.adj = self.adj[:rows]
        if self.nbr_idx is not None:
            self.nbr_idx = self.nbr_idx[:rows]
        # optional: per-graph query-image relative paths (the reference maps
        # graph files back to RGB paths via TestSplit.txt and embeds them in
        # the npz export, testing/test.py:101-121, :38-42)
        rp_path = osp.join(self.root, "rel_paths.json")
        if osp.isfile(rp_path):
            with open(rp_path) as f:
                self.rel_paths = json.load(f)[:rows]
        else:
            self.rel_paths = None
        self.mean = np.asarray(m["mean"], np.float32)
        self.std = np.asarray(m["std"], np.float32)

    def __len__(self) -> int:
        return self.meta["num_graphs"]

    def batch(self, indices: np.ndarray, with_nbr_idx: bool = False) -> dict:
        """Raw (un-normalized) batch; device pipeline normalizes."""
        out = {"images": np.ascontiguousarray(self.images[indices]),
               "poses": np.ascontiguousarray(self.poses[indices]),
               "adj": np.ascontiguousarray(self.adj[indices])}
        if with_nbr_idx and self.nbr_idx is not None:
            out["nbr_idx"] = np.ascontiguousarray(self.nbr_idx[indices])
        return out


class PackedGraphWriter:
    """Streaming writer: preallocates the memmaps, fills record by record."""

    def __init__(self, root: str, num_graphs: int, num_nodes: int,
                 height: int, width: int, mean, std,
                 dtype: str = "uint8"):
        os.makedirs(root, exist_ok=True)
        self.root = root
        self.meta = {"num_graphs": num_graphs, "num_nodes": num_nodes,
                     "height": height, "width": width, "dtype": dtype,
                     "mean": np.asarray(mean, np.float64).tolist(),
                     "std": np.asarray(std, np.float64).tolist()}
        np_dtype = np.uint8 if dtype == "uint8" else np.float16
        self.images = np.lib.format.open_memmap(
            osp.join(root, "images.npy"), mode="w+", dtype=np_dtype,
            shape=(num_graphs, num_nodes, height, width, 3))
        self.poses = np.lib.format.open_memmap(
            osp.join(root, "poses.npy"), mode="w+", dtype=np.float32,
            shape=(num_graphs, num_nodes, 6))
        self.adj = np.lib.format.open_memmap(
            osp.join(root, "adj.npy"), mode="w+", dtype=bool,
            shape=(num_graphs, num_nodes, num_nodes))
        self.nbr_idx = np.lib.format.open_memmap(
            osp.join(root, "nbr_idx.npy"), mode="w+", dtype=np.int32,
            shape=(num_graphs, num_nodes - 1))
        self._count = 0
        self._rel_paths: list[str] = []

    def add(self, images_01: np.ndarray, poses: np.ndarray,
            adj: np.ndarray, nbr_idx: np.ndarray | None = None,
            rel_path: str | None = None) -> None:
        """images_01: [N, H, W, 3] float RGB in [0,1] (pre-normalization)."""
        i = self._count
        if self.meta["dtype"] == "uint8":
            self.images[i] = np.clip(images_01 * 255.0 + 0.5, 0,
                                     255).astype(np.uint8)
        else:
            self.images[i] = images_01.astype(np.float16)
        self.poses[i] = poses
        self.adj[i] = adj
        if nbr_idx is not None:
            self.nbr_idx[i] = nbr_idx
        else:
            self.nbr_idx[i] = -1
        if rel_path is not None:
            self._rel_paths.append(rel_path)
        self._count += 1

    def finalize(self) -> None:
        # Skipped records (corrupt image / degenerate retrieval) leave the
        # preallocated memmaps longer than the written count; record the real
        # count in the header — PackedGraphDataset slices to it at load.
        assert self._count <= self.meta["num_graphs"], (
            self._count, self.meta["num_graphs"])
        self.meta["num_graphs"] = self._count
        self.images.flush()
        self.poses.flush()
        self.adj.flush()
        self.nbr_idx.flush()
        if self._rel_paths:
            assert len(self._rel_paths) == self._count, (
                len(self._rel_paths), self._count)
            with open(osp.join(self.root, "rel_paths.json"), "w") as f:
                json.dump(self._rel_paths, f)
        with open(osp.join(self.root, "meta.json"), "w") as f:
            json.dump(self.meta, f, indent=1)


class ConcatPackedDataset:
    """ConcatDataset over several scene splits (train.py:129).

    Image dtypes must agree across the stores (the device normaliser
    divides uint8 by 255 and nothing else), and so must the graph shapes;
    both are checked once, here.  Poses and adjacency dtypes promote.
    Every batch carries each row's own scene statistics (`norm_mean`,
    `norm_std` [B, 3]): the reference normalises each scene with its own
    stats.txt."""

    def __init__(self, datasets: list[PackedGraphDataset]):
        self.datasets = datasets
        self._sizes = np.array([len(d) for d in datasets])
        self._offsets = np.concatenate([[0], np.cumsum(self._sizes)])
        self._dtypes: dict[str, np.dtype] = {}
        for d in datasets:
            if "images" in self._dtypes \
                    and d.images.dtype != self._dtypes["images"]:
                raise ValueError(
                    f"mixed image dtypes across concatenated stores "
                    f"({self._dtypes['images']} vs {d.images.dtype} in "
                    f"{d.root}); rebuild the stores with one dtype "
                    "(PackedGraphWriter dtype=)")
            self._dtypes["images"] = d.images.dtype
            for k, a in (("poses", d.poses), ("adj", d.adj)):
                self._dtypes[k] = (
                    a.dtype if k not in self._dtypes
                    else np.promote_types(self._dtypes[k], a.dtype))
        shapes = {d.root: d.images.shape[1:] for d in datasets}
        if len(set(shapes.values())) > 1:
            raise ValueError(
                "concatenated stores have mixed graph shapes (num_nodes, "
                f"H, W, C): { {k: tuple(v) for k, v in shapes.items()} }")
        self._mean_rows = np.stack([d.mean for d in datasets]).astype(
            np.float32)
        self._std_rows = np.stack([d.std for d in datasets]).astype(
            np.float32)

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def batch(self, indices: np.ndarray) -> dict:
        """One gather per member store, its local indices sorted; rows
        come back in the order asked, with their scene's statistics."""
        indices = np.asarray(indices)
        which = np.searchsorted(self._offsets, indices, side="right") - 1
        local = indices - self._offsets[which]
        out: dict[str, np.ndarray] = {}
        for ds_idx in np.unique(which):
            sel = np.flatnonzero(which == ds_idx)
            order = np.argsort(local[sel], kind="stable")
            rec = self.datasets[int(ds_idx)].batch(local[sel][order])
            for k, arr in rec.items():
                if k not in out:
                    out[k] = np.empty((len(indices),) + arr.shape[1:],
                                      self._dtypes.get(k, arr.dtype))
                out[k][sel[order]] = arr
        out["norm_mean"] = self._mean_rows[which]
        out["norm_std"] = self._std_rows[which]
        return out

    @property
    def mean(self):
        return self.datasets[0].mean

    @property
    def std(self):
        return self.datasets[0].std
