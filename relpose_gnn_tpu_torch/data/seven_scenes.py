"""7-Scenes dataset parser.

Port of `relpose_gnn_tpu/data/seven_scenes.py` (reference
datasets/seven_scenes.py:17-174):
  * splits from `TrainSplit.txt` / `TestSplit.txt` ("sequenceN" lines,
    comments skipped);
  * per-frame 4x4 pose files `frame-%06d.pose.txt` (first 12 values of the
    flattened matrix);
  * both the flat `seq-NN/` layout and the `rgb/ depth/ poses/` sub-layout;
  * poses converted to pose6 `[t, logq]` by `ops/pose.py::process_poses`;
  * corrupt images: `load_image` -> None; `__getitem__` skips forward;
  * `real=True` SLAM/VO mode: per-sequence `<vo_lib>_poses/seq-NN.txt`
    pose tables + `<vo_lib>_vo_stats.pkl` Sim(3) alignment, with `gt_idx`
    mapping served frames back to ground-truth rows.

Colour and depth frames decode and resize with the port's own PNG library
(`data/image_io.py`), which gives PIL's pixels bit for bit; nothing here
imports PIL.  Depth frames (modes 1 and 2) are 16-bit gray PNGs (8-bit
gray is read too, as PIL reads it); `load_depth` gives None where PIL's
`Image.open` fails on the file (the JAX loader's rule) and raises where
the image data is damaged, as PIL does when it reads the pixels.
The bundled per-scene statistics are the port's own copy under
`data/stats/`.
"""

from __future__ import annotations

import dataclasses
import os
import os.path as osp
import pickle
import re
from pathlib import Path

import numpy as np

from relpose_gnn_tpu_torch.data import image_io
from relpose_gnn_tpu_torch.data import transforms as T
from relpose_gnn_tpu_torch.ops.pose import process_poses

SEVEN_SCENES = ("heads", "chess", "redkitchen", "pumpkin", "office", "fire",
                "stairs")

# leave-one-out file-index ranges of the prebuilt multi-scene graph store
# (dataset_7Scenes_multi.py:80-110)
SCENE_FILE_INDEX_RANGES = {
    "heads": (-1, 1000),
    "chess": (999, 5000),
    "redkitchen": (4999, 12000),
    "pumpkin": (11999, 16000),
    "office": (15999, 22000),
    "fire": (21999, 24000),
    "stairs": (23999, 26000),
}

_STATS_DIR = osp.join(osp.dirname(osp.abspath(__file__)), "stats")
BUNDLED_STATS_DIR = osp.join(_STATS_DIR, "7scenes")
BUNDLED_CAMBRIDGE_POSE_STATS = osp.join(_STATS_DIR, "Cambridge",
                                        "Cambridge_pose_stats.txt")


class _ArrayUnpickler(pickle.Unpickler):
    """Unpickles plain containers of numpy arrays and nothing else: a
    `vo_stats.pkl` is a dataset file, not one this program wrote."""

    _ALLOWED = {("numpy", "ndarray"), ("numpy", "dtype"),
                ("numpy.core.multiarray", "_reconstruct"),
                ("numpy._core.multiarray", "_reconstruct"),
                ("numpy.core.multiarray", "scalar"),
                ("numpy._core.multiarray", "scalar")}

    def find_class(self, module, name):
        if (module, name) not in self._ALLOWED:
            raise pickle.UnpicklingError(
                f"vo_stats: refusing to load {module}.{name}")
        return super().find_class(module, name)


def _load_vo_stats(path: str) -> dict:
    with open(path, "rb") as f:
        return _ArrayUnpickler(f).load()


@dataclasses.dataclass
class SevenScenes:
    """Lazy image/pose dataset for one scene."""

    scene: str
    data_path: str
    train: bool
    image_size: int = 256
    mean: np.ndarray | None = None  # per-scene stats normalization
    std: np.ndarray | None = None
    mode: int = 0  # 0: RGB, 1: depth, 2: (RGB, depth)
    real: bool = False  # True: SLAM/VO poses + per-seq alignment stats
    vo_lib: str = "orbslam"  # 'libviso2' frame indices are 1-based

    def __post_init__(self):
        base = osp.join(osp.expanduser(str(self.data_path)), self.scene)
        split = "TrainSplit.txt" if self.train else "TestSplit.txt"
        with open(osp.join(base, split)) as f:
            seqs = [int(line.split("sequence")[-1]) for line in f
                    if not line.startswith("#")]

        self.c_imgs: list[str] = []
        self.d_imgs: list[str] = []
        # each served frame's row in the ground-truth pose stream: arange
        # with real=False; with real=True only the frames the VO system
        # tracked
        self.gt_idx = np.empty((0,), np.int64)
        # per-frame source sequence (the cross-connect exclusion)
        self.seq_id = np.empty((0,), np.int32)
        gt_offset = 0
        pose_blocks: list[np.ndarray] = []
        for seq in seqs:
            seq_dir = osp.join(base, f"seq-{seq:02d}")
            if not osp.isfile(osp.join(seq_dir, "frame-000000.color.png")):
                pose_dir = osp.join(seq_dir, "poses")
                rgb_dir = osp.join(seq_dir, "rgb")
                depth_dir = osp.join(seq_dir, "depth")
            else:
                pose_dir = rgb_dir = depth_dir = seq_dir
            n_frames = len([n for n in os.listdir(pose_dir)
                            if "pose.txt" in n])
            if self.real:
                # rows [frame_idx, R|t flattened (12)]; alignment Sim(3)
                # {'R', 't', 's'} from the per-sequence stats pickle
                pss = np.loadtxt(osp.join(base, f"{self.vo_lib}_poses",
                                          f"seq-{seq:02d}.txt"), ndmin=2)
                frame_idx = pss[:, 0].astype(np.int64)
                if self.vo_lib == "libviso2":
                    frame_idx = frame_idx - 1
                raw = pss[:, 1:13]
                vo = _load_vo_stats(osp.join(
                    seq_dir, f"{self.vo_lib}_vo_stats.pkl"))
                align_R = np.asarray(vo["R"], np.float64)
                align_t = np.asarray(vo["t"], np.float64).reshape(3)
                align_s = float(vo["s"])
            else:
                frame_idx = np.arange(n_frames)
                raw = np.asarray([
                    np.loadtxt(osp.join(
                        pose_dir, f"frame-{i:06d}.pose.txt")).flatten()[:12]
                    for i in frame_idx])
                align_R, align_t, align_s = np.eye(3), np.zeros(3), 1.0
            self.gt_idx = np.hstack([self.gt_idx, gt_offset + frame_idx])
            self.seq_id = np.hstack([
                self.seq_id, np.full(len(frame_idx), seq, np.int32)])
            gt_offset += n_frames
            for i in frame_idx:
                self.c_imgs.append(
                    osp.join(rgb_dir, f"frame-{i:06d}.color.png"))
                self.d_imgs.append(
                    osp.join(depth_dir, f"frame-{i:06d}.depth.png"))
            # per-sequence alignment, no translation normalization
            pose_blocks.append(process_poses(
                raw, np.zeros(3), np.ones(3), align_R, align_t, align_s))
        self.poses = np.vstack(pose_blocks).astype(np.float32)

    def __len__(self) -> int:
        return len(self.poses)

    def load_image(self, index: int) -> np.ndarray | None:
        return T.load_and_preprocess(self.c_imgs[index], self.image_size,
                                     self.mean, self.std)

    def rel_path(self, index: int) -> str:
        """Image path relative to the dataset root."""
        return str(Path(self.c_imgs[index]).relative_to(
            osp.expanduser(str(self.data_path))))

    def load_depth(self, index: int) -> np.ndarray | None:
        """Depth frame in metres [H, W] (mm, 65535 = invalid -> 0 after
        the resize), resized like the RGB (PIL's bilinear resample of the
        16-bit frame)."""
        try:
            img = image_io.decode_gray_png(self.d_imgs[index])
        except image_io.CorruptPNG as e:
            if e.in_header:    # where Image.open fails
                return None
            raise
        if img is None:
            return None
        size = T.short_side_size(img.shape[0], img.shape[1],
                                 self.image_size)
        if img.dtype == np.uint16:
            img = image_io.resize_bilinear16(img, size)
        else:
            img = image_io.resize_bilinear(img[..., None], size)[..., 0]
        d = img.astype(np.float32)
        d[img == 65535] = 0.0
        return d / 1000.0

    def _load_mode(self, index: int):
        if self.mode == 0:
            return self.load_image(index)
        if self.mode == 1:
            return self.load_depth(index)
        if self.mode == 2:
            c, d = self.load_image(index), self.load_depth(index)
            return None if (c is None or d is None) else (c, d)
        raise ValueError(f"bad mode {self.mode}")

    def __getitem__(self, index: int):
        """(image(s), pose6 [6], relative path); skips forward over
        corrupt images."""
        img = None
        while img is None:
            img = self._load_mode(index)
            pose = self.poses[index]
            path = self.c_imgs[index]
            index += 1
        rel = str(Path(path).relative_to(
            osp.expanduser(str(self.data_path))))
        return img, pose, rel


def test_split_rgb_paths(data_path: str, scene: str,
                         expected_count: int | None = None) -> list[str]:
    """RGB filenames of a scene's TestSplit sequences in the reference's
    linear order: each sequence's `sorted(seq-NN/*.color.*)`, else its
    `rgb/` sub-layout.  With `expected_count`, raises IOError where the
    graph-store count differs."""
    base = Path(osp.expanduser(str(data_path))) / scene
    filenames: list[str] = []
    with open(base / "TestSplit.txt") as f:
        for line in f:
            hit = re.search(r"[\d]+$", line.strip())
            if hit is None:
                continue
            seq_dir = base / f"seq-{int(hit.group()):02d}"
            rgbs = sorted(seq_dir.glob("*.color.*"))
            if not rgbs:
                rgbs = sorted((seq_dir / "rgb").glob("*.color.*"))
            filenames.extend(str(p) for p in rgbs)
    if expected_count is not None and len(filenames) != expected_count:
        raise IOError(
            f"Not the same number of filenames as test graph files! "
            f"{len(filenames)} filenames != {expected_count} graphs")
    return filenames


def leave_one_out_file_mask(file_indices: np.ndarray,
                            excluded_scenes) -> np.ndarray:
    """Keep-mask (True = keep) over a prebuilt multi-scene graph store's
    file indices: an excluded scene's files, by the index ranges of
    `SCENE_FILE_INDEX_RANGES`, are dropped."""
    if isinstance(excluded_scenes, str):
        excluded_scenes = (excluded_scenes,)
    idx = np.asarray(file_indices)
    keep = np.ones(len(idx), bool)
    for scene in excluded_scenes or ():
        lo, hi = SCENE_FILE_INDEX_RANGES[scene]
        keep &= ~((idx > lo) & (idx < hi))
    return keep


def load_scene_stats(stats_dir: str | None, scene: str
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Per-scene RGB stats file 'stats.txt' (mean row, var row) ->
    (mean, std=sqrt(var)) float32; stats_dir None reads the bundled
    published statistics."""
    stats_dir = stats_dir or BUNDLED_STATS_DIR
    stats = np.loadtxt(osp.join(stats_dir, scene, "stats.txt"))
    return stats[0].astype(np.float32), np.sqrt(stats[1]).astype(np.float32)
