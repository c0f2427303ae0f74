"""Cambridge Landmarks dataset parser.

Port of `relpose_gnn_tpu/data/cambridge.py` (reference
datasets/cambridge_landmark.py:18-165):
  * split files `dataset_train.txt` / `dataset_test.txt`, rows starting
    with 'seq' only: `path tx ty tz qw qx qy qz` (camera-to-world);
  * quaternion -> R (float32, as the JAX package computes it), world-to-
    camera `t = -R @ c`, assembled into a 4x4, then pose6 [t, logq];
  * outlier skip when |t| > 10000;
  * translation normalization by the mean/std stats file.

Frames decode with the port's own PNG decoder and resize
(`data/image_io.py`).
"""

from __future__ import annotations

import dataclasses
import os.path as osp

import numpy as np
import torch

from relpose_gnn_tpu_torch.data import transforms as T
from relpose_gnn_tpu_torch.ops import pose as pose_ops

CAMBRIDGE_SCENES = ("KingsCollege", "OldHospital", "StMarysChurch",
                    "ShopFacade", "GreatCourt")


def load_pose_stats(stats_file: str) -> tuple[np.ndarray, np.ndarray]:
    """Two-row stats file (mean_t, std_t), `Cambridge_pose_stats.txt`."""
    mean_t, std_t = np.loadtxt(stats_file)
    return mean_t, std_t


@dataclasses.dataclass
class CambridgeLandmark:
    scene: str
    data_path: str
    train: bool
    image_size: int = 256
    pose_stats_file: str | None = None
    normalize_translation: bool = True
    color_jitter: bool = False  # jitter for training graphs
    normalize_images: bool = True  # False: raw [0,1] for build_graphs
    seed: int = 7

    def __post_init__(self):
        base = osp.join(osp.expanduser(str(self.data_path)), self.scene)
        split = "dataset_train.txt" if self.train else "dataset_test.txt"
        with open(osp.join(base, split)) as f:
            rows = [line.split() for line in f if line.startswith("seq")]

        self._jitter_rng = np.random.default_rng(self.seed)
        self.c_imgs: list[str] = []
        # per-frame source sequence from the 'seqN/...' prefix; a prefix
        # that is not 'seqN' gets a distinct negative id of its own, so
        # cross-connect never merges such frames into one pseudo-sequence
        seq_ids: list[int] = []
        unparsed_prefix_ids: dict[str, int] = {}
        poses = []
        for row in rows:
            t_c2w = np.asarray([float(v) for v in row[1:4]])
            q = np.asarray([float(v) for v in row[4:8]])
            q = q / np.linalg.norm(q)
            R = pose_ops.quat2mat(torch.from_numpy(
                np.asarray(q, np.float32)[None]))[0].numpy().astype(
                    np.float64)
            t = -R @ t_c2w
            if np.abs(t).max() > 10000:
                continue
            T4 = np.eye(4)
            T4[:3, :3] = R
            T4[:3, 3] = t
            poses.append(pose_ops.process_poses_cambridge(T4))
            self.c_imgs.append(osp.join(base, row[0]))
            prefix = row[0].split("/")[0]
            if prefix[:3] == "seq" and prefix[3:].isdigit():
                seq_ids.append(int(prefix[3:]))
            else:
                seq_ids.append(unparsed_prefix_ids.setdefault(
                    prefix, -1 - len(unparsed_prefix_ids)))

        self.seq_id = np.asarray(seq_ids, np.int32)
        self.poses = np.asarray(poses, np.float32)
        if self.normalize_translation:
            if not self.pose_stats_file:
                raise ValueError("normalize_translation needs a "
                                 "pose_stats_file")
            mean_t, std_t = load_pose_stats(self.pose_stats_file)
            self.poses[:, :3] = (self.poses[:, :3] - mean_t) / std_t
        # Cambridge image normalization (dataset_Cambridge_multi.py:161)
        self.mean = np.array([0.5, 0.5, 0.5], np.float32)
        self.std = np.array([0.25, 0.25, 0.25], np.float32)

    def __len__(self) -> int:
        return len(self.poses)

    def load_image(self, index: int) -> np.ndarray | None:
        x = T.load_and_preprocess(self.c_imgs[index], self.image_size)
        if x is None:
            return None
        if self.color_jitter:
            x = T.color_jitter(self._jitter_rng, x, 0.5, 0.5, 0.5, 0.2)
        if self.normalize_images:
            return T.normalize(x, self.mean, self.std)
        return x

    def __getitem__(self, index: int):
        img = None
        while img is None:
            img = self.load_image(index)
            pose = self.poses[index]
            path = self.c_imgs[index]
            index += 1
        return img, pose, path
